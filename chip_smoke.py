#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   the card's name and ``nvidia-smi`` name / power limit
  2. build    nvcc of ``src/repro_torch/csrc/*.cu`` for sm_90a: seconds and
              the ``-Xptxas -v`` register / shared-memory / spill summary
  3. kernels  each CUDA kernel against its plain PyTorch version on the card
              (B1, B2, B3 at the 1024-token shapes, B2 and B3 again at the
              training shape, seq 4096, B3 and B2 on one 12288-token block
              of 4 query heads over one kv head, B4 at a decode step, B5 on
              ragged rows and the legacy decode shape, B6 on a 256-query chunk
              after cached prefixes, B4 and B6 also on one rank's shard at
              SP degree 2 and 8, B7 on ragged rows with offsets and a
              zero-length row, rectangular MQA, a window over 1000 rows and
              the ragged_bwd path's shape), and timed (``ms``: CUDA
              events, median of bursts after warm-up; ``device_ms``: calls
              queued behind a device sleep, which the host's pace cannot
              stretch) beside the plain version, a PyTorch library call
              where one computes the same function, and the card's bound
              for the work: B1, B2, B4, B5 and B6 at the serving shapes,
              B3 (and B2 again) at the training shape, B7 at the
              ragged_bwd path's shape; B1 beside two SDPA calls (a
              boolean mask, and is_causal with enable_gqa), B2 at seq 4096
              beside SDPA's forward (o only, no merge), B3 and B7 beside
              SDPA's backward, B4 and B6 beside references (SDPA on their
              keys gathered densely beforehand); B3, B4, B6 and B7 run
              twice on every check and must give the same bits; CTAs per
              SM and shared memory of the bf16 forward and backward
              kernels
  3a. kernels_ulysses  B1 and B3 at the shape Ulysses gives them (q
              (1,4096,4,80) over one kv head, the 8 zigzag shards
              concatenated, and sorted), bf16 and f32 against their plain
              versions; ``device_ms`` and bound of each on bf16
  3b. kernels_d128  every kernel at head size 128 (GPT-7B, minitron-8b,
              deepseek-7b): phase 3's check cases again at D = 128, bf16
              and f32 (among them B4 and B6 on one rank's 64-page shard at
              SP degree 8, the shapes dense_serve's P = 8 runs give them:
              4 decode slots at rank 5, and q (1,256,32,128) after a
              512-token prefix at rank 3), then B1, B2 and B3 at GPT-7B's
              training shape (q,
              k, v (1,4096,32,128), causal), B4 at minitron-8b's decode
              step (4 slots at ~1K context, 32q/8kv, pages of 16), B6 at
              its 256-query chunk after a 1024-token prefix, B5 at the
              legacy decode shape and B7 at the ragged_bwd shape, each
              held against its plain version at the same tolerances and
              timed beside its bound and SDPA where one computes the
              function; the ``-Xptxas -v`` lines of the D = 128 kernels
  3c. kernels_d256  every kernel at head size 256 (paligemma-3b, GPT-3B):
              phase 3's check cases again at D = 256, bf16 and f32, B4
              and B6 among them, and prefix-LM cases (one block, a zigzag
              ring step straddling the prefix, per-row positions); B4 and
              B6 at pages of 128, 96 (B6 also 48) under windows that
              start inside a page, and B4 at 32 query heads on one kv
              head; then B1, B2 and B3 at paligemma's training shape (q
              (1,4096,8,256), k/v (1,4096,1,256), causal, a 512-position
              prefix), B5 at its ``--legacy`` decode shape, B7 at the
              ragged_bwd shape with 8q/1kv, B4 at GPT-3B's decode step (4
              slots at ~1K context, 12 heads of 256) and B6 at its
              256-query chunk after a 1024-token prefix, at pages of 16
              and 128, each held against its plain version and timed
              beside its bound and SDPA; the D = 256 kernels' ``-Xptxas
              -v`` lines and CTAs per SM
  4. ring     StarTrail on a ThreadMesh(c=2, r=2): P = 8 ranks as threads
              on the one card, N = 2048 tokens of 32q/8kv heads of 80,
              bf16, causal + window; each rank runs the forward (B2 in
              every ring step) and then the backward (B3 in every ring
              step) explicitly; o and the gradients are held against plain
              full attention of the sequence and its autograd gradients
  4b. overlap (right after ring) the ring's two issue orders at
              h2o-danube-1.8b's full attention width (32q/8kv heads of 80,
              seq 4096, bf16, zigzag) at P = 8, for StarTrail C = 2 in both
              placements and the ring C = 1, at comm_chunks 1 and 2: the
              pipelined forward's output and the gradients equal the
              unpipelined ones bit for bit, B2 and B3 launch P*R times
              each; ``obs.commlog.overlap_report`` of each gives the
              structural fraction ((R-1)/R pipelined, 0 not) and the
              timed one (the split-phase copies' time on the comm streams
              under a kernel, ``torch.profiler``; unpipelined, every copy
              runs on the compute stream and none on a comm stream), as
              the host paces the run and queued behind a device sleep,
              with the fwd+bwd device ms and wall time; then the train
              step's loss and
              every gradient at train_sp's depth, P = 8, under
              ``pipeline_scan=False`` equal the pipelined ones bit for
              bit; then ``autotune(overlap_frac=<the timed fraction>,
              comm_chunk_grid=(1, 2))`` at 2 layers, whose plan file
              reloads equal and trains one step through ``launch.train
              --plan``
  4a. ragged_bwd  the kernel layer's public entries with per-row (B, S)
              positions: ``dispatch.block_fwd`` (B5), then
              ``dispatch.block_bwd`` (B7), on 4 rows of 1024 tokens at
              different offsets, 32q/8kv heads of 80, bf16, causal, window
              4096; the gradients are held against autograd through the
              plain version
  5. engine   the serving engine at the full width of h2o-danube-1.8b
              (24 layers, seeded random bf16 weights): 8 greedy requests,
              prompts staggered over 64-1024 tokens, 32 new tokens each.
              Each prefill runs StarTrail at P = 1, one ring step per layer
              through B2; each decode step runs B4 once per layer; 4 pure
              decode steps profiled (the all-greedy window), which the
              mean decode step and tokens/s leave out
  5a. sample  sampled decoding on the same model and plan: the engine
              phase's 8 prompts and budgets, even requests greedy, odd ones
              at temperature 0.9 with top-k 0/16/32 and top-p 1.0/0.9/0.8
              in turn, seeds 100 + i, through an engine with an
              ``obs.Registry`` and an enabled ``Tracer``. The greedy
              streams must equal the engine phase's (another batch) and
              every sampled stream its request served alone; the dumped
              registry's token, TTFT and inter-token counts and the trace's
              request b/e pairs and ``engine/step`` spans must match the
              run. Beside: 4 profiled pure decode steps (the mixed window,
              the same steps as the engine phase's), the solo runs' decode
              steps with the tracer on against ``NULL_TRACER`` on alternate
              steps, ``latency_quantiles()``; ``sample`` on CUDA tensors at V = 32000, 4 rows, 4096 draws
              at temperature 1 (top-k 8: every draw in the top 8, the
              chi-square of the counts against the softmax over them below
              24.3, the 0.999 quantile at 7 degrees of freedom; top-p 0.4:
              every draw in the nucleus); ``launch.serve --smoke --kernel
              ref`` on the card with ``--temperature --top-k --top-p
              --metrics-dump --trace-out``
  6. engine_check  one prompt's next-token hidden state and logits under
              the CUDA kernels against the same engine on the plain versions
  7. local    the same prompt's prefill under the local-mode attention
              (``Runtime(attention_impl='local')``: one block per layer
              through B1), held against the engine's StarTrail prefill
  8. profile  ``torch.profiler`` over the engine with 4 slots of 1024-token
              prompts: one prefill plus decode step, then 8 decode steps;
              host and device ms per step, device idle share, top kernels
  8a. prefix  the engine with the prefix cache and 256-token prefill
              chunks: 8 greedy requests sharing a 1024-token prefix, each
              with its own 64-512-token suffix, 32 new tokens each. A
              prompt's first chunk runs B2 per layer; every later chunk and
              every prefix hit runs B6 (the cached pages) and B1 (the
              chunk itself) per layer. Each request's first token and
              next-token hidden state are held against a monolithic prefill
              of its prompt; then TTFT of one request alone with the prefix
              cached and without the cache
  8b. legacy  the static-batch path (``launch.serve.legacy_generate``): 4
              prompts of 1024 tokens prefilled as one batch (B2 per layer),
              then 31 decode steps against the contiguous cache, B5 per
              layer and step; the first decode step's hidden state and
              token are held against the engine's
  8c. host_tier  the pinned-host KV tier, the handoff and preemption on
              the same model, pages of 16 (983 040 B at full width): a
              family prompt (1024-token prefix, 16-token tail), two
              1536-token evictors, the family again with a new tail, 8 new
              tokens each, through a roomy pool (512 pages), a tight pool
              (100 pages) with a 256 MiB tier and the tight pool without
              it. The tier's streams must equal the roomy pool's token for
              token, its connector must spill and reload the family's 64
              blocks and hit 1024 tokens, the re-arrival's suffix prefill
              (B6 on the 1024 reloaded tokens, B1) must run; the tier-off
              engine's streams equal, or its re-arrival's hidden state
              within ``ENGINE_TOL`` of the roomy pool's. The re-arrival's
              TTFT with the tier and without it (median of 3 sequences),
              split by the engine's spans into the admission (the
              evictions' spills), the reload and the prefill;
              the link's GB/s from ``kv_transfer_seconds`` (reload and
              inject h2d, export d2h) against ``hw.HOST_LINK_BW``. Then 4
              prompts of 512-1024 tokens prefilled as 1-token handoff twins
              on one engine, exported, released and added to a decode
              engine (16 new tokens each; a fifth with a budget of 1 needs
              no handoff): the streams equal a unified engine's, the decode
              engine prefills nothing. Then 4 requests (2 greedy, 2 at
              temperature 0.8, top-k 40, top-p 0.9) with the prefix cache;
              after 6 steps one of each is preempted mid-decode and its
              resume request added back: the resume prefill hits the
              cache, and each resumed stream equals the uninterrupted one
              or its first hidden state is within ``ENGINE_TOL`` of a
              monolithic prefill of the same tokens
  9. train    the full-width model trains through ``train.trainer.train``
              with a plan from ``make_plan(c=1, microbatches=4)`` and its
              default recompute (``remat='attn_out'``): seq 4096, global
              batch 4 in 4 microbatches, bf16, AdamW (f32 moments, lr 1e-3,
              no warmup), 4 steps on one repeated ``SyntheticLM`` batch.
              Per layer and microbatch the StarTrail ring step runs forward
              twice (B2: the forward and its recompute) and backward once
              (B3); the loss must be finite and fall
 10. train_check  one loss and gradient of the same model at seq 1024
              under the CUDA kernels against the plain versions
 11. train_profile  ``torch.profiler`` over one full-width train step of
              one sequence under ``remat='none'`` and one under 'attn_out'
 12. resume   checkpoint and restart at full width with the depth cut to 2
              layers: 4 steps straight, and 2 steps with ``ckpt_dir``
              followed by a fresh model resumed from that checkpoint to
              step 4; steps 3-4 must give the same losses
 13. train_sp  training at SP degree 8: ``trainer.train`` on a plan with
              ``n_devices=8, c=2`` runs P = 8 ranks as ThreadMesh(c=2, r=2)
              threads on the one card (team gathers and two ring steps;
              the collectives carry the gradients), each rank holding its
              shards under the 'default' sharding rules. Full width, 4
              of 24 layers (``TRAIN_SP_LAYERS``, cut from 8 for the
              script's time), seq 4096, batch 1, zigzag,
              ``remat='attn_out'``, bf16, 2 AdamW steps on one repeated
              batch (``TRAIN_SP_STEPS``, the script's time): the loss must
              fall, and the first step's loss and
              gradient norm agree with P = 1 on the same weights. Per step
              B2 runs 8 ranks x 2 ring steps x 2 (recompute) x 4 layers =
              128 times and B3 64 times; peak memory, the profiled
              step's device ms and f32 adds beside the 8-layer step that
              stored every parameter whole. Before it, in f32 (the
              CUDA-core kernels), depth 2, seq 1024: the loss and every
              gradient leaf, assembled whole from the unique shards, at
              P = 8 and at 2 data replicas of P = 4, under each of the
              'default', 'fsdp' and 'tp' rules, against P = 1
 13a. train_procs  train_sp's model and shape (4 layers, seq 4096, batch
              1, bf16, ``attn_out``) at (data, C, R) = (1, 2, 1) as four
              rank processes over gloo on the one card
              (``dist.procs.ProcessMesh``, a ``dist.comm.ProcessComm``
              each, each rank holding its shards alone): the fresh model's
              loss and every gradient leaf against the ThreadMesh at the
              same plan, seed and kernels (rel L2 within 2e-3, the worst
              leaf printed), ``TRAIN_SP_STEPS`` trainer steps (B2 4 ranks
              x 2 x 4 layers = 32 and B3 16 a step, summed over the
              ranks; the loss must fall) whose last is checkpointed by
              rank 0 and restored on the ThreadMesh's whole storage, bit
              for bit against the ranks' shards; one more step under
              ``torch.profiler`` in every process and on the threads:
              wall, the card's busy ms (the union of every process's
              device intervals), the host<->device copies, gloo's host
              time, the signature check's calls and host time (and as
              many exchanges in lockstep), the ledger bytes (equal to the
              ThreadMesh's). Then NCCL: with a card a rank (4 cards: this
              plan; 2 or 3: the ring at P = 2) the first step again over
              NCCL against the ThreadMesh; on one card a line saying it
              was not run. ``python3 chip_smoke.py --only train_procs``
              runs the build and this phase alone
 13b. serve_procs  full-width h2o-danube-1.8b (``SERVE_PROCS``: 12 of
              its 24 layers, for the script's time) served at (data, C, R) = (1, 2, 1) by
              four rank processes over gloo on the one card, each drawing
              the weights from seed 0 on the card and keeping its shards
              (``factory.build_rank_model``), each an ``Engine`` of its own
              over its ``ProcessComm`` fed the same requests step by step,
              against the ThreadMesh engine at the same plan, seed and
              kernels: 4 greedy requests of 256-1024 prompt tokens and a
              sampled one (temperature, top-k, top-p) of 384, 8 new tokens
              each, the 1024-token one joining once the rest have
              prefilled (B2, B4); 2 prompts on a 512-token prefix through
              the prefix cache in 256-token chunks (B2, B6, B1, B4); a
              ``--legacy`` batch of 2 x 512 (B2, B5). Every stream equal
              to the threads', the first-token hidden states bit-equal
              (else reported within ``ENGINE_TOL``), every rank's ledger
              equal to its thread's, each run's launches summed over the
              processes equal to the threads'; the host walls of a decode
              step and a prefill chunk on both, the signature check's
              calls and host seconds. NCCL (a card a rank) where there are
              four cards, else a line saying it was not run. ``--only
              serve_procs`` runs the build and this phase alone
 14. schemes  the paper's comparison at the train_sp width (2 layers, seq 4096,
              batch 1, bf16, ``attn_out``, P = 8 ranks on the card) through
              ``trainer.train`` with the obs registry and tracer, 2 steps
              each from the same weights: the ring (C = 1, R = 8: B2
              8*8*2*L and B3 8*8*L a step), DeepSpeed-Ulysses (all-to-all;
              B1 8*2*L and B3 8*L) and StarTrail C = 2 with each ring
              transfer in 2 sub-chunks (train_sp's counts). Each first
              step's loss and grad norm against P = 1 (``TRAIN_SP_TOL``);
              each scheme's forward island (one layer, full width, seq
              4096) through ``obs.commlog.comm_report``: every live kind
              at ratio 1.0 and no byte of a kind the scheme does not
              run, printed beside eqs. 2-4's bytes; the ledger's bytes per step beside
              ``CommLog.per_step``; a profiled step of the ring and Ulysses
 15. autotune  the paper's §3.4 topology scheduler at the schemes phase's
              size: the analytical ranking of the four arrangements at
              P = 8 under the H100 table (``roofline.hw``; µs per layer,
              whole-model s, bytes), then ``plan.autotune.autotune``
              (top 3 plus the analytical worst, 1 warm-up and 2 timed
              steps each, every candidate from the same weights): each
              candidate's measured s per step beside its analytical s, the
              winner, its plan file reloaded equal and holding the
              arrangement its record timed fastest, one step of
              ``launch.train --plan FILE`` (B2 and B3, or B1 and B3 if
              Ulysses won) and ``make_serve_plan(c=None)`` at P = 1 (C = 1)
 16. dense_serve  the engine at the full width of minitron-8b (32 layers,
              d_model 4096, 32q/8kv heads of 128, vocab 256000, ~9.9 B
              seeded bf16 parameters). At P = 1: 8 greedy requests of
              64-1024 prompt tokens, 32 new tokens each (B2 per layer and
              prefill, B4 per layer and decode step). At P = 8, as
              ThreadMesh(c=2, r=2) threads on the one card from the same
              weights, cut to keep the phase near 100 s (the 8 rank threads
              share the GIL: a step takes seconds): 2 of those prompts
              (336 and 1024 tokens) with 2 new tokens each (B2 on every rank,
              ring step and layer of a prefill, B4 on every rank and layer
              of a decode step), then 2 prompts sharing a 512-token prefix
              through the prefix cache and 256-token chunks (B6 and B1 on
              every rank and layer of a suffix chunk, merged across the
              ranks). Every first-token hidden state at P = 8 is held
              against P = 1's (``DENSE_SP_TOL``), the share of tokens that
              agree with P = 1's printed; the engine raises if the ranks
              sample different tokens; a profiled decode step at each P.
              Then at P = 8 one sampled request (prompt 4, temperature 0.8,
              top-k 40, top-p 0.9) beside one greedy (prompt 2), 2 new
              tokens each: the sampled stream equals its solo run, the
              greedy one its stream in the all-greedy run
 17. dense_train  ``trainer.train`` on the paper's GPT-7B (MHA 32/32, head
              size 128) at seq 4096, batch 1, bf16, ``attn_out``, 3 AdamW
              steps on one repeated batch at P = 1, the depth cut from 32
              to 8 layers (the reckoned bytes of both printed: weights,
              gradients and f32 moments of 32 layers exceed 80 GB); the
              loss must fall; B2 2 x 8 and B3 8 a step; the D = 128
              backward kernels' device ms from a profiled step; one loss
              and gradient at seq 1024 under the CUDA kernels against the
              plain versions (``dense_train_check``)
 18. gateway  right after host_tier, on the same full-width model (seeded
              bf16), pages of 16, 4 slots a replica. a. ``gateway.Gateway``
              with two unified replicas on the card sharing the model,
              prefix cache on: two families of 4 requests, each family one
              session behind its own 1024-token system prompt, tails of
              64-256 tokens, 32 new tokens each; each family must land on
              one replica (routed [4, 4], 6 affinity hits), both replicas
              hit their caches, and every stream must equal a single
              engine's fed that replica's requests at the same steps; the
              gateway's pure-decode step wall beside those engines'. b. a
              prefill/decode pair (``plan.make_role_plans``) on one family:
              every request enters replica 0, 4 handoffs, pages out = in >
              0, the decode replica prefills nothing, the streams equal a
              unified engine's. c. two ``frontend.ProcReplica`` workers
              spawned on the card (each its own CUDA context, the weights
              drawn from seed 0: their digests must equal this process's
              model's) behind a ``FrontendServer`` on an ephemeral port:
              6 requests of 64-1024 prompt tokens, 16 new tokens, two of
              them sampled, as concurrent SSE streams through
              ``frontend.client.generate_many``; the merged /metrics must
              carry worker="0" and worker="1"; then the same 6 again with
              one worker hard-killed mid-decode: every stream must finish,
              the one death must be the kill and ``frontend_failovers_total``
              the streams it orphaned; then a drained shutdown that joins
              the workers. Every HTTP stream must equal ``replay`` of the
              run (its admissions and the kill at the same ticks) over two
              in-process ``LocalReplica``s sharing the model. Each
              worker's start seconds, TTFT p50/p95 from the orchestrator's
              histogram and the HTTP run's tokens/s are printed. d. in
              process, ``interactive,batch`` with preemption: 4 batch
              requests fill the slots, an interactive one arrives after 4
              steps; one preemption; every stream not preempted equals
              the run without preemption; both runs equal, stream for
              stream and the victim's resumed tokens included, the same
              traffic driven straight on an ``Engine`` with and without
              the victim preempted at the same tick; where the victim's
              stream differs from its run without preemption (the resume
              recomputes the last block), the first difference must be a
              near-tie: the two runs' sampler inputs within
              ``ENGINE_TOL``'s ``max_abs_over_max``, and the tokens split
              by a top-k cut or an argmax within twice that difference
              (``_first_difference``); a 1 ms TTFT SLO must be refused
              over HTTP with 429 ``slo_ttft_unattainable`` and a
              Retry-After.
              e. ``python -m repro_torch.launch.serve --http --workers 2``
              as two subprocesses started together, one ``--smoke --kernel
              ref`` (the JAX CI's http-smoke), one at full width through
              the CUDA kernels (``--max-slots 4 --page-size 16 --max-len
              2048``), each driven by ``python -m
              repro_torch.frontend.client --verify`` (6 and 8 requests),
              which must print its bit-identical line; SIGTERM must drain
              each to exit 0. The worker processes' launches cannot be
              counted from this process: their check is stream equality
 19. rules    the 'fsdp' and 'tp' sharding rules at full width, 2
              layers, seq 4096, bf16, ``attn_out``: a. one train step under
              each at (data 2, c 2, r 1), global batch 2, from the same
              weights: loss and gradient norm against P = 1
              (``TRAIN_SP_TOL``), B2 8 x 1 x 2 x 2 = 32 and B3 16 a step,
              device ms, f32 adds and peak memory from a profiled step; b.
              ``trainer.train`` under 'default' at P = 8 writes a
              checkpoint at step 2; a P = 1 state restored from it must
              hold the trained parameters and the saved moments bit for
              bit, and one more step from it at P = 1 must give the loss
              and gradient norm of one more step at P = 8 (the trainer
              restoring the same checkpoint)
 20. moe_serve  the MoE family served at full width, seeded bf16, P = 1,
              4 slots, pages of 16: a. phi3.5-moe-42b-a6.6b cut to 16 of
              32 layers (42.1 GB) on the engine phase's 8 requests (B2 per
              layer and prefill, B4 per layer and decode step), replayed
              equal after ``reset()``; b. ``--legacy`` on it, 4 x 1024
              tokens (B2 per layer, B5 per layer and decode step); c.
              llama4-maverick-400b-a17b cut to one period (a dense layer,
              then 128 experts top-1 with a shared expert; 37.1 GB), 4
              requests of 64-1024 tokens, 16 new, replayed; an engine
              with chunked prefill or a prefix-cache plan on it must
              raise. Each run's longest prompt through the CUDA kernels
              against the plain versions: the whole model within
              ``ENGINE_TOL`` for llama4 and reported for phi (its 16 layers
              carry a token that bf16 rounding routes to another expert,
              and a routed output ~1e3 times its input, into every later
              position), and per layer the attention branch on the CUDA
              run's own input (``_moe_layer_check``; for ``--legacy`` the
              first decode step's, ``_moe_decode_layer_check``). Decode
              step wall and device ms beside the weight-read bound (every
              expert is read), the MoE block's device ms, peak memory
 21. moe_train  phi3.5-moe cut to 2 layers, seq 4096, bf16, ``attn_out``:
              first in f32 (the CUDA-core kernels) the whole model's
              next token and its loss and gradients, CUDA against plain,
              within ``ENGINE_TOL`` and ``TRAIN_CHECK_TOL`` (no routing
              choice moves in f32); then in bf16:
              a. P = 1, batch 1, capacity 1.25: the whole model's loss and
              gradients under the CUDA kernels against the plain versions
              (reported, as phase 20 for phi) and each layer's attention
              forward and backward on one input within
              ``TRAIN_CHECK_TOL``; 3 ``trainer.train`` steps on one repeated
              batch (B2 2 x 2 and B3 2 a step), the loss must fall, the
              cross-entropy and the aux term apart; a profiled step; one
              MoE block's, the loss head's and AdamW's device ms. b. P = 8
              on ThreadMesh(c=2, r=1, data=2), global batch 2, capacity
              8.0: one profiled step against P = 1 on the same weights
              (``TRAIN_SP_TOL``), B2 32 and B3 16, the ledger's all-to-all
              bytes per layer equal to 2 x E x cap x D x 2 B x (data -
              1) / data
 22. legacy_sp  ``launch.serve.legacy_generate`` at P = 4 on the plan's
              ThreadMesh(c=2, r=1) at the full width of h2o-danube-1.8b
              (seeded bf16, 24 layers): phase 8b's 4 prompts of 1024
              tokens, 8 greedy tokens (a P = 4 decode step takes ~1.3 s of
              wall), the capacity padded to a multiple of 4. The prefill
              runs B2 on 3 of the 4 ranks' ring steps a layer (the
              causal skip drops query block 0 against key block 1), each
              decode step B5 on every rank and layer; the first decode step's hidden state and logits and
              the prefill's last-layer K/V through the CUDA kernels
              against the plain versions (``ENGINE_TOL``); the share of
              tokens equal to the same batch at P = 1, reported
 23. xlstm_serve  full-width xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM; ~1.06
              B seeded bf16 parameters) through ``--legacy`` at P = 1 and
              at P = 4 (ThreadMesh(c=2, r=1)): 4 prompts of 1024 tokens, 32
              greedy tokens at P = 1 and 8 at P = 4 (a P = 4 decode step
              takes ~0.5 s of wall); per run the prefill's and the decode
              steps' wall, a profiled window of each (device ms, idle
              share, kernel launches), peak memory, and no attention
              kernel launched. First, in f32 on the card: layer 0's mLSTM at P = 4
              against P = 1 (output and state, the cross-shard correction
              exact) and ``chunked_gla`` at the mLSTM's shape against the
              f64 recurrence on the CPU, within 2e-5 of the largest
              magnitude (the CPU's f32 result reported beside). The bf16 tokens'
              agreement between P = 1 and P = 4 is reported: the sLSTM
              starts every rank's recurrence from zero, so they differ by
              construction
 24. xlstm_train  the same model trained, seq 512, batch 1, bf16,
              ``attn_out`` (one recompute region around each mixer),
              AdamW on one repeated batch: 2 steps of all 48 layers at
              P = 1, then 2 at P = 8 on ThreadMesh(c=2, r=2) of its first
              period (8 layers; seq and depth cut for the script's time,
              ``XLSTM_TRAIN``); the loss finite and falling in each, the
              last step of each profiled, peak memory, no attention
              kernel launched. First, in f32: one mLSTM's and
              one sLSTM's gradients (every parameter and the input) on
              the card against the CPU, within 2e-3 of the largest
              magnitude
 25. hybrid_serve  full-width jamba-1.5-large-398b cut to its first five
              layers (Mamba + MLP, Mamba + MoE, Mamba + MLP, Mamba + MoE,
              attention + MLP; 24.0 B seeded bf16 parameters, 48.0 GB;
              the MoE capacity lifted to 8, no token dropped) through
              ``--legacy`` at P = 1 and at P = 4 (ThreadMesh(c=2, r=1)):
              4 prompts of 1024 tokens, 32 greedy tokens at P = 1 and 8
              at P = 4; per run the prefill's and the decode steps' wall,
              a profiled window of each, peak memory, B2 on the attention
              layer's prefill and B5 on every decode step; the attention
              layer's branch (less the residual add, which the seeded MoE
              layers' ~1e3 growth of the stream would round away) in the
              prefill (B2) and the first decode step (B5), on every rank,
              through the CUDA kernels against the plain versions on the
              CUDA run's input (``ENGINE_TOL``). First, in f32: layer 0's Mamba
              block (output, SSM state, conv state) on the card at P = 1
              and at P = 4 with its conv halo against the CPU, within
              2e-5 of the largest magnitude. Last, tokens against the
              full forward's argmax over each generated sequence
              (teacher forcing): the bf16 P = 1 run's agreement reported
              (its seeded MoE routes chaotically, ``HYBRID_F32_SERVE``),
              and in f32 on the first three layers (13.2 B parameters),
              ``--legacy`` at P = 1 on 2 prompts of 256 tokens, 8 new,
              each token equal or a near tie within ``HYBRID_TIE``
              standard deviations of the logits
 26. hybrid_train  jamba cut to one layer (Mamba + MLP), seq 4096, batch
              1, bf16, ``attn_out``, AdamW (bf16 moments, the config's)
              on one repeated batch: 3 steps at P = 1, then 3 at P = 8
              on ThreadMesh(c=2, r=2) from the same seeded weights, the
              conv halo and the state correction between 8 slices at
              full width; the loss finite and falling in each, P = 8's
              first loss and gradient norm against P = 1's
              (``TRAIN_SP_TOL``), the last step of each profiled, peak
              memory, no attention kernel launched. First, in f32: the
              Mamba block's gradients (every parameter and the input) on
              the card at P = 1 and at P = 8 against the CPU, within
              2e-3 of the largest magnitude
 27. encdec_serve  full-width seamless-m4t-large-v2 whole (24 encoder +
              24 decoder layers, 2.04 B, seeded bf16). First the path's
              kernel regimes against their plain versions
              (``ENCDEC_KERNEL_CASES``: B2 under no mask, B1 with one
              query row, B1 and B3 with Sq != Sk; bf16 and f32, device
              ms, bound, SDPA). The encoder prefill of 1 x 4096 frames at
              P = 1 and at P = 4 (ThreadMesh(c=2, r=1)), B2 on every
              rank's ring step of each encoder layer, its output on the
              CUDA kernels against the plain versions (``ENGINE_TOL``).
              ``--legacy`` at P = 1 (2 x 64, 16 new) and at P = 4 (2 x 4,
              3 new): the encoder prefilled over seeded frames, the
              decoder's prompt fed one decode step a token, B1 (cross)
              and B5 (self) on every rank, layer and step; the decoder's
              hidden states over the first 24 (P = 1) and 3 (P = 4) of
              the same tokens on both routes
              (``ENGINE_TOL``); the P = 1 tokens against the full
              forward's argmax, reported in bf16 and checked in f32 at
              full depth (2 x 32, 8 new; near ties within ``HYBRID_TIE``)
 28. encdec_train  the same model, all 48 layers, seq 4096, batch 1,
              ``attn_out``, AdamW on one repeated batch of the pipeline's
              tokens and frames: the first step's gradients against the
              plain kernels' (``TRAIN_CHECK_TOL`` on an f32 copy of the
              model; in bf16 reported, each route beside the f32
              model's: the encoder's query and key gradients are bf16
              noise there), 3 steps at P = 1 (B1
              on every cross-attention, B2 on every self-attention, B3 on
              both); then a 4 + 4-layer cut at batch 2, 2 steps at P = 1
              and 2 at P = 8 (ThreadMesh(c=2, r=1, data=2)) from the same
              weights and batch, P = 8's first loss and gradient norm
              against P = 1's (``TRAIN_SP_TOL``)
 29. vlm_serve  full-width paligemma-3b whole (18 layers, 3.04 B, head size
              256, seeded bf16, seeded patches). The prefill of 1 x 4096
              tokens (512 patches) at P = 1 through StarTrail (B2) and
              through the local route (B1), each against the plain
              versions (``ENGINE_TOL``); ``--legacy`` at P = 1 (2 x 1024,
              128 patches, 32 new) and at P = 4 (ThreadMesh(c=2, r=1); 2 x
              64, 8 patches, 4 new), B2 on the prefill and B5 on every
              rank, layer and decode step, the hidden states teacher
              forced on both routes (``ENGINE_TOL``); the P = 1 tokens
              against the full forward's argmax at the prompt's prefix,
              reported in bf16 and checked in f32 at a 4-layer cut (2 x
              128, 8 new; near ties within ``HYBRID_TIE``)
 30. vlm_train  the same model, all 18 layers, seq 4096 (512 patches),
              batch 1, ``attn_out``, AdamW (f32 moments) on one repeated
              batch of the pipeline's tokens and patches: the first step's
              gradients against the plain kernels' (``TRAIN_CHECK_TOL`` on
              an f32 copy of 4 layers; in bf16 reported at full depth), 3
              steps at P = 1 (B2 and B3 on every layer); then a 2-layer
              cut at batch 2, 2 steps at P = 1 and 2 at P = 8
              (ThreadMesh(c=2, r=1, data=2)), P = 8's first loss and
              gradient norm against P = 1's (``TRAIN_SP_TOL``)
 31. dryrun  the dry run (``launch.dryrun``, the step traced on the meta
              device on the host). (a) Full-width h2o-danube-1.8b at
              decode_32k on the 256-device single-pod plan (data 16, C 2,
              the kernels' meta rules): the trace seconds, the peak GiB
              per device against ``hw.HBM_BYTES`` (it must fit) and the
              three roofline terms on the card's constants. (b) The
              phase-9 train step (seq 4096, batch 4 in 4 microbatches,
              ``attn_out``, P = 1) traced with ``kernel_impl='cuda'``,
              then run on the card twice (B2 and B3 launched), the second
              step timed: the parameters plus AdamW state the trace
              predicts against the bytes of the live storages (they must
              be equal), its ``peak_bytes_per_device`` against
              ``torch.cuda.max_memory_allocated`` over the step (the ratio
              must lie in 0.5-2) and the roofline ``bound_s`` against the
              step's device ms (CUDA events)
 32. gpt3b_serve  the paper's GPT-3B (16 layers, d_model 4096, 12 heads of
              256, MHA, vocab 50304, 4.44 B seeded bf16 parameters) at full
              width through the paged engine with the prefix cache, pages
              of 16: prompts of 64, 512 and 2048 tokens and three sharing
              a 1024-token prefix (two of them prefix hits), 32 new tokens
              each (B2 per cold prefill and layer, B6 and B1 per hit and
              layer, B4 per decode step and layer, all at head size 256; 4
              pure decode steps profiled); the same requests on the plain
              versions: every prompt's next-token hidden state and logits
              and the first decode step's within ``ENGINE_TOL``, the
              tokens' agreement printed; P = 4 on ThreadMesh(c=2, r=1), 2
              prompts, 3 new tokens, first-token hidden states against
              P = 1's (``DENSE_SP_TOL``); ``launch.serve`` in engine mode
              with ``--page-size 128`` on the full-width h2o-danube-1.8b
              (B4 at pages of 128)

Every JSON line carries ``seconds``: the wall time since the line before
(or the phase's own, where the phase reports it).

The paths are phases 4, 4b's runs (overlap: each pipelined and
unpipelined ring run; overlap_train: each train step's value and
gradients; overlap_autotune: the search; overlap_autotune_plan: its
plan's step), 4a, 5, 5a, 7, 8a, 8b, 8c's five runs (roomy,
tier, tier-off, handoff, preempt), 9, 13, 13a, each scheme of 14, 15's search
and its plan's step, 16's four runs, 17, 18's four in-process runs
(gateway, gateway_disagg, frontend_ref, priority), 19's two steps
(rules_fsdp, rules_tp), 20's three runs (moe_serve_phi, moe_legacy,
moe_serve_llama), 21's two (moe_train, moe_train_mesh), 22 (legacy_sp),
23's two (xlstm_serve_p1, xlstm_serve_p4), 24's two (xlstm_train_p1,
xlstm_train_p8), 25's two (hybrid_serve_p1, hybrid_serve_p4), 26's
two (hybrid_train_p1, hybrid_train_p8), 27's four (encdec_prefill_p1,
encdec_prefill_p4, encdec_legacy_p1, encdec_legacy_p4), 28's three
(encdec_train_p1, encdec_train_cut_p1, encdec_train_cut_p8), 29's four
(vlm_prefill_p1, vlm_prefill_local, vlm_legacy_p1, vlm_legacy_p4),
30's three (vlm_train_p1, vlm_train_cut_p1, vlm_train_cut_p8), 31's
measured step (dryrun) and 32's three (gpt3b_serve_p1, gpt3b_serve_p4,
serve_page128):
the launch counters are set to 0 just before each and read just after,
and each must launch exactly the kernels it runs (B2 and B3 in the ring
and in each of 4b's runs;
B5 and B7 in ragged_bwd; B2 and B4 in the engine and in the sample
phase's mixed run; B1 in the local
prefill; B1, B2, B4 and B6 in the prefix phase; B2 and B5 in the legacy
phase; B1, B2, B4 and B6 in the host tier's roomy and tier runs and its
preempt run, B2 and B4 in its tier-off run and its handoff run (the
prefill and the decode engine); B2 and B3 in the train loop, in train_sp,
in train_procs (summed over its rank processes, each counting its own)
and in the ring and
StarTrail schemes and under the fsdp and tp rules; B1 and B3 under
Ulysses; B1, B2 and B3 in the
autotune search, whose candidates are all four arrangements; B1, B2, B4, B5 and B6 in serve_procs (summed over its rank processes
and its engine, prefix and ``--legacy`` runs); B2 and B4
in dense_serve's P = 1, P = 8 and P = 8 sampled runs, B1, B2, B4 and B6
in its prefix run; B2 and B3 in dense_train; B1, B2, B4 and B6 in the
gateway, its prefill/decode pair and the priority run, B2 and B4 in the
front end's replayed reference; B2 and B4 in both MoE engines, B2 and B5
in the MoE legacy run, B2 and B3 in both MoE trainings, B2 and B5 at
P = 4 in legacy_sp, none in the xLSTM runs, B2 and B5 in both hybrid
serving runs, none in the one-layer hybrid trainings, B2 in the encoder
prefills, B1, B2 and B5 in the encdec ``--legacy`` runs, B1, B2 and B3
in the encdec trainings, B2 in the VLM's StarTrail prefill and B1 in its
local one, B2 and B5 in its ``--legacy`` runs, B2 and B3 in its
trainings, all at head size 256; B2 and B3 in the dry run's measured
step; B1, B2, B4 and B6 in GPT-3B's P = 1 run and B2 and B4 in its P = 4
run, all at head size 256, B2 and B4 in ``launch.serve --page-size
128``). Comparison,
timing and profiling launches are not counted. The kernels line's
``launches`` is each kernel's count on the path that runs it (the engine for B2 and B4, the local prefill for B1, the train
loop for B3, the legacy phase for B5, the prefix phase for B6, ragged_bwd
for B7); ``launches_by_path`` gives every path's counts. The
last three lines are the card's ``nvidia-smi`` name and power limit, the
kernels' JSON line and ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before the last line; so does a machine
without a CUDA card, or a directory without the rest of the repository.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = {"float32": 2e-5, "bfloat16": 1e-4}       # see phase_kernels
NEG_INF = -1e30
BWD_TOL = 3e-4                                   # see phase_kernels
LONG_BWD_SEQ = 12288                             # B3's long-block check
LONG_FWD_SEQ = 12288                             # B2's long-block check
REPLACES = {
    "B1": "src/repro/kernels/flash_attention.py:125",
    "B2": "src/repro/kernels/flash_attention.py:148",
    "B3": "src/repro/kernels/flash_attention.py:440",
    "B4": "src/repro/kernels/paged_decode.py:48",
    "B5": "src/repro/kernels/ragged_prefill.py:48",
    "B6": "src/repro/kernels/paged_prefill.py:56",
    "B7": "src/repro/kernels/flash_attention.py:537",
}
SOURCES = {"B1": "src/repro_torch/csrc/flash_fwd.cu",
           "B2": "src/repro_torch/csrc/flash_fwd.cu",
           "B3": "src/repro_torch/csrc/flash_bwd.cu",
           "B4": "src/repro_torch/csrc/paged_decode.cu",
           "B5": "src/repro_torch/csrc/ragged_prefill.cu",
           "B6": "src/repro_torch/csrc/paged_prefill.cu",
           "B7": "src/repro_torch/csrc/ragged_bwd.cu"}
KERNELS = tuple(SOURCES)
ARCH = "h2o-danube-1.8b"


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


_LAST_EMIT = [time.perf_counter()]


def emit(phase, **fields):
    """One JSON line; ``seconds`` is the wall time since the previous line
    (the work this line reports) unless the caller gives its own."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_EMIT[0])
    _LAST_EMIT[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps=20, inner=5):
    """Median over ``reps`` bursts of ``inner`` back-to-back calls, per
    call, from CUDA events (after two warm-up bursts)."""
    import torch

    for _ in range(2 * inner):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls=20, reps=5):
    """Per call, median over ``reps``: CUDA events around ``calls`` calls
    queued behind a ~50 ms device sleep, so the host has enqueued them all
    before the first starts and the card runs them back to back. Unlike
    ``time_ms`` it leaves out the host's time when a call is shorter than
    its Python wrapper."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)          # cycles, ~50 ms
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def hw_table():
    """The card's datasheet peaks the bounds use (``roofline.hw``)."""
    from repro_torch.roofline import hw

    return {"source": "NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet",
            "PEAK_FLOPS_BF16": hw.PEAK_FLOPS_BF16,
            "PEAK_FLOPS_F32": hw.PEAK_FLOPS_F32, "HBM_BW": hw.HBM_BW,
            "NVLINK_BW": hw.NVLINK_BW}


def bound(nbytes, flops, dtype):
    from repro_torch.roofline import hw

    peak = {"bfloat16": hw.PEAK_FLOPS_BF16, "float32": hw.PEAK_FLOPS_F32}
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = flops / peak[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(got, want):
    """Whether two runs' outputs are equal to the bit."""
    import torch

    return all(bool(torch.equal(a, b)) for a, b in zip(got, want))


def partial_err(o, lse, o_ref, lse_ref, tol):
    """(largest |o - o_ref| and |lse - lse_ref| over live rows, whether
    every value is within ``tol`` absolute plus ``tol`` relative, as the
    tests' assert_allclose, and whether every dead row is exact (o = 0,
    lse = -1e30), the number of dead rows)."""
    live = lse_ref > NEG_INF / 2
    pairs = [(o, o_ref), (lse[live], lse_ref[live])]
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in pairs)
    within = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in pairs)
    dead = ~live
    o_dead = dead.transpose(1, 2)                    # (B, S, H)
    exact = bool((lse[dead] == NEG_INF).all()) and \
        bool((o[o_dead] == 0).all())
    return err, within and exact, int(dead.sum())


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _zigzag(rank, n, p):
    from repro_torch.core import startrail as st

    return st.shard_positions(rank, n, p, "zigzag")


def fwd_cases():
    """B1/B2 inputs at the prefill shape: q (1,1024,32,80), k/v (1,1024,8,80)."""
    import torch

    S = 1024
    ar = torch.arange(S, dtype=torch.int32)
    return {
        # name: (pos_q, pos_k, window)
        "causal_w4096": (ar, ar, 4096),
        "window256": (ar, ar, 256),
        "dead_block": (ar, ar + 64, 4096),   # query rows 0..63 see no key
        "zigzag": (_zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2), 4096),
    }


def fwd_inputs(dtype, dev, seed=0, d=80):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, 1024, 32, d), generator=g, device=dev)
    k = torch.randn((1, 1024, 8, d), generator=g, device=dev)
    v = torch.randn((1, 1024, 8, d), generator=g, device=dev)
    o_acc = torch.randn((1, 1024, 32, d), generator=g, device=dev)
    lse_acc = torch.randn((1, 32, 1024), generator=g, device=dev) * 3
    # the running accumulator has seen nothing yet on some rows
    o_acc[:, :96] = 0.0
    lse_acc[:, :, :96] = NEG_INF
    return [t.to(dtype) for t in (q, k, v)], o_acc, lse_acc


def visible_pairs(pos_q, pos_k, window):
    from repro_torch.kernels import ref

    return int(ref.make_mask(pos_q, pos_k, causal=True,
                             window=window).sum())


def bwd_cases():
    """B3 inputs at the 1024-token shape: q (1,Sq,32,80), k/v (1,1024,8,80)."""
    import torch

    S = 1024
    ar = torch.arange(S, dtype=torch.int32)
    return {
        # name: (pos_q, pos_k, window)
        "causal_w4096": (ar, ar, 4096),
        "window256": (ar, ar, 256),
        "dead_block": (ar, ar + 64, 4096),   # query rows 0..63 see no key
        "zigzag": (_zigzag(1, 2 * S, 2), _zigzag(0, 2 * S, 2), 4096),
        "ragged_sq1000": (ar[:1000], ar, 4096),
    }


def bwd_inputs(pos_q, pos_k, window, dtype, dev, seed=0, heads=(32, 8),
               d=80, prefix_len=None):
    """q, k, v, do in ``dtype`` and the global lse and delta of full
    attention over the block under the mask (with ``prefix_len``, the
    prefix-LM's; delta from o rounded to q's dtype, as
    ``core.startrail.startrail_backward`` computes it)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    sq, sk = pos_q.numel(), pos_k.numel()
    hq, hkv = heads
    q = torch.randn((1, sq, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((1, sk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((1, sk, hkv, d), generator=g, device=dev).to(dtype)
    do = torch.randn((1, sq, hq, d), generator=g, device=dev).to(dtype)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos_q, pos_k,
                                          window=window,
                                          prefix_len=prefix_len)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.to(dtype).float()).contiguous()
    return q, k, v, do, lse, delta


def grad_err(got, want, lse, tol):
    """(largest |g - g_ref| over dq, dk, dv, whether every value is within
    ``tol`` absolute plus ``tol`` relative and every dead row's dq is
    exactly 0, the number of dead rows)."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    within = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
                 for a, b in zip(got, want))
    dead = (lse <= NEG_INF / 2).transpose(1, 2)      # (B, Sq, H)
    return err, within and bool((got[0][dead] == 0).all()), int(dead.sum())


def scaled_err(got, want):
    """max |g - g_ref| / (1 + |g_ref|) over dq, dk, dv: what ``grad_err``'s
    tolerance check bounds by ``tol``."""
    return max(float(((a - b).abs() / (1 + b.abs())).max())
               for a, b in zip(got, want))


def bwd_work(q, k, pos_q, pos_k, pairs):
    """(bytes, flops) of B3 / B7: q, k, v, do, lse, delta and the positions
    in once, dq, dk, dv out in f32; 10*D FLOPs per visible pair and query
    head (the recomputed scores, dp, dq, dk, dv)."""
    b, sq, hq, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + 2 * b * hq * sq * 4 + (pos_q.numel() + pos_k.numel()) * 4 \
        + (q.numel() + 2 * k.numel()) * 4
    return nbytes, 10 * d * hq * pairs


def sdpa_bwd_ms(q, k, v, do, mask=None):
    """(event ms, device ms) of the autograd backward alone of
    ``scaled_dot_product_attention`` on the same inputs: causal with GQA
    (the library yardstick of B3), or with the boolean ``mask``
    (B,1,Sq,Sk) and the kv heads repeated beforehand (B7's)."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    if mask is not None:
        k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if mask is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)

    def fn():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    return time_ms(fn, reps=10, inner=2), device_ms(fn, calls=5)


def paged_sdpa(q, pool_k, pool_v, table, lens, ps, window, decode):
    """A reference for B4 (``decode``) and B6, not their function: a
    callable running ``scaled_dot_product_attention`` (o only, no lse) on
    the keys of the table's allocated pages, gathered densely here, before
    any timing, with kv heads repeated and the boolean mask of the kernel's
    key validity and window (no mask when every pair is visible). SP
    degree 1."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref

    b, sq, hq, _ = q.shape
    n = int((table >= 0).any(0).nonzero().max()) + 1
    tb = table[:, :n].long()
    k, v = (p[tb.clamp(min=0)].reshape(b, n * ps, *p.shape[2:])
            for p in (pool_k, pool_v))
    dev = q.device
    pos = torch.arange(n * ps, dtype=torch.int32, device=dev)
    valid = (tb >= 0).repeat_interleave(ps, 1) & \
        (pos[None] < (lens + int(decode))[:, None])
    pos_q = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                         device=dev)[None]
    pos_k = torch.where(valid, pos[None], pos_q.max() + 1)
    mask = ref.make_mask(pos_q, pos_k, causal=True, window=window)[:, None]
    g = hq // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(g, dim=1) for t in (k, v))
    mask = None if bool(mask.all()) else mask
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def paged_cases():
    # name: (sp, rank, window, cache_len per row (row 3 inactive))
    return {
        "sp1": (1, 0, None, [1023, 520, 7, 0]),
        "sp1_window256": (1, 0, 256, [1023, 700, 300, 0]),
        "sp2_rank1": (2, 1, 4096, [2047, 1000, 40, 0]),
        "decode_1k": (1, 0, 4096, [1023, 1010, 1000, 990]),
        # dense_serve's P = 8 decode step: one rank's 64-page shard
        "sp8_rank5": (8, 5, None, [1031, 700, 300, 0]),
    }


# B4 and B6 on the paged shapes page_size 16 does not reach, at every head
# size check_cases runs (h2o's 80 with its 32q/8kv heads, 128, 256), as
# (sp, rank, window, cache lengths, page size, heads): pages of 128 (two
# key tiles each; launch.serve --page-size 128) and 96 (the second tile of
# a page half empty), windows starting inside a page, 32 query heads on
# one kv head (two 16-row slabs, B4's unsplit route)
LARGE_PAGE_DECODE = {
    "page128_window300": (1, 0, 300, [1400, 700, 130, 0], 128, (32, 8)),
    "page96_sp2_rank1": (2, 1, None, [1800, 900, 77, 0], 96, (32, 8)),
    "g32_page16": (1, 0, None, [1023, 500, 7, 0], 16, (32, 1)),
    "g32_page128_window200": (1, 0, 200, [1100, 260, 60, 0], 128, (32, 1)),
}
# B6 likewise, as (cached lengths, window, sp, rank, page size): a window
# sliding past the prefix inside a page, a row with nothing cached, pages
# of 48 (64 does not divide by it) on rank 1 of 2
LARGE_PAGE_PREFILL = {
    "page128_window_slid": ([1024], 256, 1, 0, 128),
    "page96_partial_and_empty": ([1000, 0], None, 1, 0, 96),
    "page48_sp2_rank1": ([700, 50], None, 2, 1, 48),
}



def paged_inputs(dev, sp, cache_len, seed=0, dtype=None, d=80, rank=None,
                 ps=16, heads=(32, 8)):
    """q (4,1,32,d) (``heads``: query and kv heads); pool
    (8192/(ps*sp),ps,8,d) (bf16 unless ``dtype``), rank ``rank``'s shard
    (default 1 when sp > 1) of an 8192-token cache as the engine splits
    it; table (4, min(1024, 2048/sp)/ps): distinct pages for the rank's
    blocks (global block w*sp + rank at entry w) each row has written, -1
    past them, so the last page of a row is partial; a row with cache_len
    0 is an inactive slot."""
    import numpy as np
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    pages, width = 8192 // (ps * sp), min(1024, 2048 // sp) // ps
    hq, hkv = heads
    b = len(cache_len)
    q = torch.randn((b, 1, hq, d), generator=g, device=dev).to(dtype)
    pool_k = torch.randn((pages, ps, hkv, d), generator=g,
                         device=dev).to(dtype)
    pool_v = torch.randn((pages, ps, hkv, d), generator=g,
                         device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pages)
    table = np.full((b, width), -1, np.int32)
    used = 0
    if rank is None:
        rank = 1 if sp > 1 else 0
    for b, cl in enumerate(cache_len):
        if cl == 0:
            continue
        blocks = cl // ps + 1           # global blocks 0 .. cl // ps
        n_local = min(width, (blocks - rank + sp - 1) // sp)
        table[b, :n_local] = perm[used:used + n_local]
        used += n_local
    return (q, pool_k, pool_v, torch.from_numpy(table).to(dev),
            torch.tensor(cache_len, dtype=torch.int32, device=dev))


def paged_work(table, cache_len, sp, rank, window, ps=16, hkv=8, d=80,
               hq=32):
    """(bytes, flops) this data needs: the live pages' K and V read once,
    and 4*D FLOPs per visible key and query head."""
    live_pages = vis = 0
    for b in range(table.shape[0]):
        cl = int(cache_len[b])
        for w in range(table.shape[1]):
            base = (w * sp + rank) * ps
            if table[b, w] < 0 or base > cl:
                continue
            if window is not None and cl - (base + ps - 1) >= window:
                continue
            live_pages += 1
            for p in range(base, base + ps):
                if p <= cl and (window is None or cl - p < window):
                    vis += 1
    rows = table.shape[0]
    kv = 2 * live_pages * ps * hkv * d * 2
    io = (rows * hq * d * 2 + table.size * 4 + rows * 4
          + rows * hq * d * 4 + rows * hq * 4)
    return kv + io, 4 * d * hq * vis


def ragged_cases():
    # name: (Sq, Sk, window, per-row lengths or cache lengths, kind)
    return {
        # prefill rows of 256, 130, 0 (sees no key) and 77 keys
        "ragged_rows": (256, 256, 4096, [256, 130, 0, 77], "lengths"),
        # the legacy decode shape: one query per row at its cache length
        "decode_sq1": (1, 1056, 4096, [1024, 1030, 1041, 1055], "decode"),
        "decode_window256": (1, 1056, 256, [1024, 700, 300, 5], "decode"),
    }


def ragged_inputs(dev, dtype, sq, sk, rows, kind, seed=0, d=80,
                  heads=(32, 8)):
    """q (B,Sq,32,d), k/v (B,Sk,8,d) (or ``heads``) and per-row positions:
    validity is positional, an unseen key sits past every query."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(rows)
    hq, hkv = heads
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    ak = torch.arange(sk, dtype=torch.int32, device=dev)[None]
    r = torch.tensor(rows, dtype=torch.int32, device=dev)[:, None]
    if kind == "lengths":
        pos_q = torch.arange(sq, dtype=torch.int32, device=dev)[None]
        pos_q = pos_q.expand(b, sq)
        pos_k = torch.where(ak < r, ak, sq + sk)
    else:
        pos_q = r
        pos_k = torch.where(ak <= r, ak, r + 1)
    return (q, k, v), pos_q.contiguous(), pos_k.contiguous()


def ragged_work(q, k, pos_q, pos_k, window):
    """(bytes, flops) of B5 on these inputs: q, the keys some query sees
    (K and V), the positions in once, o and lse out in f32; 4*D FLOPs per
    visible pair and query head."""
    from repro_torch.kernels import ref

    mask = ref.make_mask(pos_q, pos_k, causal=True, window=window)
    b, sq, hq, d = q.shape
    keys = int(mask.any(dim=1).sum())
    nbytes = q.numel() * q.element_size() \
        + 2 * keys * k.shape[2] * d * k.element_size() \
        + (pos_q.numel() + pos_k.numel()) * 4 + b * sq * hq * d * 4 \
        + b * hq * sq * 4
    return nbytes, 4 * d * hq * int(mask.sum())


def paged_prefill_cases():
    # name: (cached_len per row, window, unallocated table entries of row 0,
    #        sp, rank)
    return {
        # row 0's last cached page is half filled; row 1 has nothing cached
        "partial_page_and_empty": ([1000, 0], 4096, [], 1, 0),
        "unallocated": ([1024], 4096, [5, 40], 1, 0),
        # queries 1024..1279 in a window of 256: the later ones see no key
        "window_slid": ([1024], 256, [], 1, 0),
        "prefix_1024": ([1024], 4096, [], 1, 0),  # the prefix phase's shape
        # dense_serve's P = 8 suffix chunk after its 512-token prefix: one
        # rank's 64-page shard, its blocks at w*8 + 3
        "sp8_rank3_prefix512": ([512], None, [], 8, 3),
    }


def paged_prefill_inputs(dev, dtype, cached, holes, sq=256, seed=0, d=80,
                         sp=1, rank=0, ps=16, heads=(32, 8)):
    """q (B,256,32,d) (``heads``: query and kv heads); pool
    (8192/(ps*sp),ps,8,d), rank ``rank``'s shard of an 8192-token cache as
    the engine splits it; table (B,ceil(2048/(ps*sp))): distinct pages for
    the rank's blocks (global block w*sp + rank at entry w) of each row's
    prefix and suffix, -1 past them and at ``holes`` in row 0."""
    import numpy as np
    import torch

    pages, width = 8192 // (ps * sp), -(-2048 // (ps * sp))
    hq, hkv = heads
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(cached)
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    pool_k = torch.randn((pages, ps, hkv, d), generator=g,
                         device=dev).to(dtype)
    pool_v = torch.randn((pages, ps, hkv, d), generator=g,
                         device=dev).to(dtype)
    perm = np.random.default_rng(seed).permutation(pages)
    table = np.full((b, width), -1, np.int32)
    used = 0
    for row, cl in enumerate(cached):
        blocks = -(-(cl + sq) // ps)
        n_local = max(0, -(-(blocks - rank) // sp))
        table[row, :n_local] = perm[used:used + n_local]
        used += n_local
    table[0, holes] = -1
    return (q, pool_k, pool_v, torch.from_numpy(table).to(dev),
            torch.tensor(cached, dtype=torch.int32, device=dev))


def paged_prefill_work(table, cached, sq, window, ps=16, hkv=8, d=80,
                       hq=32, sp=1, rank=0):
    """(bytes, flops) this data needs: q in, the K and V of the pages some
    query sees, the table and lengths, o and lse out in f32; 4*D FLOPs per
    visible (query, key) pair and query head; no window is ``window=None``."""
    window = (1 << 30) if window is None else window
    pages = pairs = 0
    for b, cl in enumerate(cached):
        for w in range(table.shape[1]):
            base = (w * sp + rank) * ps
            if table[b, w] < 0 or base >= cl:
                continue
            # query i (position cl + i) sees key p iff cl + i - p < window
            n = sum(min(sq, max(0, window - cl + p))
                    for p in range(base, min(base + ps, cl)))
            pages += n > 0
            pairs += n
    rows = len(cached)
    io = (rows * sq * hq * d * 2 + table.size * 4 + rows * 4
          + rows * sq * hq * d * 4 + rows * hq * sq * 4)
    return 2 * pages * ps * hkv * d * 2 + io, 4 * d * hq * pairs


def large_page_cases(dev, res, d):
    """B4 and B6 at head size ``d`` on ``LARGE_PAGE_DECODE`` and
    ``LARGE_PAGE_PREFILL``, bf16 and f32, against their plain versions at
    ``TOL``, dead rows and the inactive slot exact, the same bits twice.
    Returns the cases checked."""
    import torch

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp

    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case, (sp, rank, window, cls, ps, heads) in \
                LARGE_PAGE_DECODE.items():
            args = (*paged_inputs(dev, sp, cls, seed=31, dtype=dtype,
                                  d=d, rank=rank, ps=ps, heads=heads),
                    rank)
            kw = dict(sp=sp, page_size=ps, window=window)
            o, lse = pd.paged_decode_attention(*args, **kw)
            torch.cuda.synchronize()
            err, ok, _ = partial_err(
                o, lse, *pd.paged_decode_attention_plain(*args, **kw),
                TOL[dname])
            check(ok and bool((lse[3] == NEG_INF).all())
                  and bool((o[3] == 0).all()),
                  f"B4 {case} {dname} D={d}: max err {err} (tol "
                  f"{TOL[dname]}), a dead row or the inactive slot not "
                  f"exact")
            check(same_bits(pd.paged_decode_attention(*args, **kw),
                            (o, lse)),
                  f"B4 {case} {dname} D={d}: two runs differ")
            res["B4"]["max_abs_err"] = max(res["B4"]["max_abs_err"], err)
            checked.append(f"B4/{case}/{dname}")
        for case, (cached, window, sp, rank, ps) in \
                LARGE_PAGE_PREFILL.items():
            args = (*paged_prefill_inputs(dev, dtype, cached, [], seed=32,
                                          d=d, sp=sp, rank=rank, ps=ps),
                    rank)
            kw = dict(sp=sp, page_size=ps, window=window)
            o, lse = pp.paged_prefill_attention(*args, **kw)
            torch.cuda.synchronize()
            err, ok, n_dead = partial_err(
                o, lse, *pp.paged_prefill_attention_plain(*args, **kw),
                TOL[dname])
            check(ok, f"B6 {case} {dname} D={d}: max err {err} (tol "
                      f"{TOL[dname]}) or a dead row not exact")
            if 0 in cached:
                check(bool((lse[cached.index(0)] == NEG_INF).all()),
                      f"B6 {case}: the row with nothing cached is not dead")
            if window is not None:
                check(0 < n_dead < lse.numel(), f"B6 {case}: {n_dead} dead")
            check(same_bits(pp.paged_prefill_attention(*args, **kw),
                            (o, lse)),
                  f"B6 {case} {dname} D={d}: two runs differ")
            res["B6"]["max_abs_err"] = max(res["B6"]["max_abs_err"], err)
            checked.append(f"B6/{case}/{dname}")
        del o, lse, args
    return checked


def ragged_bwd_cases():
    # name: (B, Sq, Sk, Hq, Hkv, window, row offsets, zero-length rows)
    return {
        # rows at their own offsets; row 2's keys all sit past its queries
        "ragged_rows": (4, 256, 256, 32, 8, 4096, [0, 300, 77, 1000], [2]),
        "mqa_rect": (2, 192, 320, 8, 1, 4096, [0, 50], []),
        # 1000 rows: not a multiple of the 64-row tile
        "window256_s1000": (2, 1000, 1000, 32, 8, 256, [0, 17], []),
        # the ragged_bwd path's shape
        "path_4x1024": (4, 1024, 1024, 32, 8, 4096, [0, 1024, 2048, 3072],
                        []),
    }


def ragged_bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, window, offsets,
                      zero_rows, seed=0, d=80, prefix_len=None):
    """q, k, v, do in ``dtype``, the global lse and delta of the block pair
    under the mask (with ``prefix_len``, the prefix-LM's; delta from o
    rounded to q's dtype), and (B,Sq) / (B,Sk) positions: row
    r's queries start at ``offsets[r]`` and its keys end with them (an Sk >
    Sq row sees keys before its first query); the keys of ``zero_rows`` sit
    past every query."""
    import torch

    from repro_torch.kernels import ragged_prefill as rp

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, d), generator=g, device=dev).to(dtype)
    do = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)[:, None]
    pos_q = off + torch.arange(sq, dtype=torch.int32, device=dev)[None]
    pos_k = off + torch.arange(sk, dtype=torch.int32, device=dev)[None] \
        + (sq - sk)
    pos_k[zero_rows] += 2 * (sq + sk)
    o, lse = rp.ragged_prefill_fwd_plain(q, k, v, pos_q, pos_k,
                                         window=window,
                                         prefix_len=prefix_len)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.to(dtype).float()).contiguous()
    return (q, k, v, do, lse, delta, pos_q.contiguous(),
            pos_k.contiguous())


def check_cases(dev, rows, d=80):
    """Every kernel against its plain version on the check cases above,
    bf16 and f32, at head size ``d``: each row's ``max_abs_err`` (and B3's
    and B7's ``max_scaled_err``) rises to the worst case. Returns the
    cases checked."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp

    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        (q, k, v), o_acc, lse_acc = fwd_inputs(dtype, dev, d=d)
        for case, (pq, pk, window) in fwd_cases().items():
            pq, pk = pq.to(dev), pk.to(dev)
            for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
                o, lse = fa.flash_attention_fwd(q, k, v, pq, pk, *acc,
                                                window=window)
                torch.cuda.synchronize()
                o_p, lse_p = fa.flash_attention_fwd_plain(
                    q, k, v, pq, pk, *acc, window=window)
                err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
                check(ok, f"{name} {case} {dname}: max err {err} (tol "
                          f"{TOL[dname]}) or a dead row not exact")
                if case == "dead_block" and name == "B1":
                    check(n_dead >= 64 * 32, f"dead_block: {n_dead} dead")
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                err)
                checked.append(f"{name}/{case}/{dname}")
        for case, (pq, pk, window) in bwd_cases().items():
            pq, pk = pq.to(dev), pk.to(dev)
            args = bwd_inputs(pq, pk, window, dtype, dev, d=d)
            got = fa.flash_attention_bwd(*args, pq, pk, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*args, pq, pk, window=window)
            err, ok, n_dead = grad_err(got, want, args[4], BWD_TOL)
            check(ok, f"B3 {case} {dname}: max err {err} (tol {BWD_TOL}) "
                      f"or a dead row's dq not exactly 0")
            if case == "dead_block":
                check(n_dead >= 64 * 32, f"B3 dead_block: {n_dead} dead")
            again = fa.flash_attention_bwd(*args, pq, pk, window=window)
            check(same_bits(got, again),
                  f"B3 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], err)
            rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                               scaled_err(got, want))
            checked.append(f"B3/{case}/{dname}")
    for dtype, (case, (sp, rank, window, cls)) in (
            (d, c) for d in (torch.bfloat16, torch.float32)
            for c in paged_cases().items()):
        dname = str(dtype).split(".")[-1]
        args = (*paged_inputs(dev, sp, cls, dtype=dtype, d=d, rank=rank),
                rank)
        kw = dict(sp=sp, page_size=16, window=window)
        o, lse = pd.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = pd.paged_decode_attention_plain(*args, **kw)
        err, ok, _ = partial_err(o, lse, o_p, lse_p, TOL[dname])
        check(ok, f"B4 {case} {dname}: max err {err} (tol {TOL[dname]}) "
                  f"or a dead row not exact")
        if cls[-1] == 0:
            check(bool((lse[3] == NEG_INF).all()), f"B4 {case}: inactive")
        check(same_bits(pd.paged_decode_attention(*args, **kw), (o, lse)),
              f"B4 {case} {dname}: two runs differ (no atomics on values: "
              f"they must give the same bits)")
        rows["B4"]["max_abs_err"] = max(rows["B4"]["max_abs_err"], err)
        checked.append(f"B4/{case}/{dname}")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case, (sq, sk, window, rws, kind) in ragged_cases().items():
            (q, k, v), pq, pk = ragged_inputs(dev, dtype, sq, sk, rws, kind,
                                             d=d)
            o, lse = rp.ragged_prefill_fwd(q, k, v, pq, pk, window=window)
            torch.cuda.synchronize()
            o_p, lse_p = rp.ragged_prefill_fwd_plain(q, k, v, pq, pk,
                                                     window=window)
            err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
            check(ok, f"B5 {case} {dname}: max err {err} (tol {TOL[dname]})"
                      f" or a dead row not exact")
            if kind == "lengths":
                check(n_dead >= sq * 32, f"B5 {case}: {n_dead} dead rows")
            rows["B5"]["max_abs_err"] = max(rows["B5"]["max_abs_err"], err)
            checked.append(f"B5/{case}/{dname}")
        for case, (cached, window, holes, sp, rank) in \
                paged_prefill_cases().items():
            args = (*paged_prefill_inputs(dev, dtype, cached, holes, d=d,
                                          sp=sp, rank=rank), rank)
            kw = dict(sp=sp, page_size=16, window=window)
            o, lse = pp.paged_prefill_attention(*args, **kw)
            torch.cuda.synchronize()
            o_p, lse_p = pp.paged_prefill_attention_plain(*args, **kw)
            err, ok, n_dead = partial_err(o, lse, o_p, lse_p, TOL[dname])
            check(ok, f"B6 {case} {dname}: max err {err} (tol {TOL[dname]})"
                      f" or a dead row not exact")
            if 0 in cached:
                check(bool((lse[cached.index(0)] == NEG_INF).all()),
                      f"B6 {case}: the row with nothing cached is not dead")
            if case == "window_slid":
                check(0 < n_dead < lse.numel(), f"B6 {case}: {n_dead} dead")
            check(same_bits(pp.paged_prefill_attention(*args, **kw),
                            (o, lse)),
                  f"B6 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B6"]["max_abs_err"] = max(rows["B6"]["max_abs_err"], err)
            checked.append(f"B6/{case}/{dname}")
        for case, (b, sq, sk, hq, hkv, window, offs, zero) in \
                ragged_bwd_cases().items():
            args = ragged_bwd_inputs(dev, dtype, b, sq, sk, hq, hkv, window,
                                     offs, zero, d=d)
            got = rb.flash_attention_bwd_ragged(*args, window=window)
            torch.cuda.synchronize()
            want = rb.flash_attention_bwd_ragged_plain(*args, window=window)
            err, ok, n_dead = grad_err(got, want, args[4], BWD_TOL)
            check(ok, f"B7 {case} {dname}: max err {err} (tol {BWD_TOL}) "
                      f"or a dead row's dq not exactly 0")
            for r in zero:
                check(n_dead >= sq * hq and all(
                    bool((t[r] == 0).all()) for t in got),
                    f"B7 {case} {dname}: zero-length row {r} not exactly "
                    f"0 in dq, dk, dv")
            again = rb.flash_attention_bwd_ragged(*args, window=window)
            check(same_bits(got, again),
                  f"B7 {case} {dname}: two runs differ (no atomics: they "
                  f"must give the same bits)")
            rows["B7"]["max_abs_err"] = max(rows["B7"]["max_abs_err"], err)
            rows["B7"]["max_scaled_err"] = max(rows["B7"]["max_scaled_err"],
                                               scaled_err(got, want))
            checked.append(f"B7/{case}/{dname}")
            del got, want, again, args
    return checked + large_page_cases(dev, rows, d)


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels import ref

    rows = {n: {"name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n], "max_abs_err": 0.0,
                "device_ms": None, "library_device_ms": None}
            for n in KERNELS}
    for n in ("B3", "B7"):
        rows[n]["max_scaled_err"] = 0.0
    checked = check_cases(dev, rows)

    # timing at the engine's shapes: a 1024-token prefill (bf16, causal,
    # window 4096) and a 4-slot decode step at ~1K context
    (q, k, v), o_acc, lse_acc = fwd_inputs(torch.bfloat16, dev)
    pq = torch.arange(1024, dtype=torch.int32, device=dev)
    pairs = visible_pairs(pq, pq, 4096)
    flops = 4 * 80 * 32 * pairs
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pq, pq)) \
        + 1024 * 32 * 80 * 4 + 32 * 1024 * 4
    acc_io = o_acc.numel() * 4 + lse_acc.numel() * 4
    mask = (pq[None, :] <= pq[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt_r = kt.repeat_interleave(4, dim=1)
    vt_r = vt.repeat_interleave(4, dim=1)
    timing = {
        "B1": dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, pq, pq,
                                                      window=4096)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pq, pq, window=4096)),
            library_ms=None, work=(io, flops, "bfloat16")),
        "B2": dict(
            ms=time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pq, pq, o_acc, lse_acc, window=4096)),
            library_ms=None, work=(io + acc_io, flops, "bfloat16")),
    }
    # B1's yardstick: the faster of SDPA with the boolean mask (kv heads
    # repeated beforehand) and SDPA with is_causal and enable_gqa, the same
    # function at this shape (window 4096 is inert over 1024 keys)
    b1_sdpa = {
        "bool_mask": lambda: F.scaled_dot_product_attention(
            qt, kt_r, vt_r, attn_mask=mask),
        "is_causal_gqa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)}
    b1_library = {n: time_ms(f) for n, f in b1_sdpa.items()}
    b1_library_device = {n: device_ms(f) for n, f in b1_sdpa.items()}
    timing["B1"]["library_ms"] = min(b1_library.values())
    # device time alone (device_ms): a call shorter than its Python
    # wrapper is paced by the host in time_ms
    timing["B1"].update(
        device_ms=device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pq, pq, window=4096)),
        library_device_ms=min(b1_library_device.values()))
    timing["B2"]["device_ms"] = device_ms(lambda: fa.flash_attention_fwd(
        q, k, v, pq, pq, o_acc, lse_acc, window=4096))
    sp, rank, window, cls = paged_cases()["decode_1k"]
    qd, pk_, pv_, table, cl = paged_inputs(dev, sp, cls)
    nb, nf = paged_work(table.cpu().numpy(), cl.cpu().numpy(), sp, rank,
                        window)
    kw = dict(sp=sp, page_size=16, window=window)
    timing["B4"] = dict(
        ms=time_ms(lambda: pd.paged_decode_attention(qd, pk_, pv_, table, cl,
                                                     rank, **kw)),
        plain_ms=time_ms(lambda: pd.paged_decode_attention_plain(
            qd, pk_, pv_, table, cl, rank, **kw)),
        device_ms=device_ms(lambda: pd.paged_decode_attention(
            qd, pk_, pv_, table, cl, rank, **kw)),
        library_ms=None, work=(nb, nf, "bfloat16"))
    paged_refs = {"B4": paged_sdpa(qd, pk_, pv_, table, cl, 16, window,
                                   decode=True)}
    # B5 at the legacy path's first decode step: 4 rows at cache length
    # 1024 against the capacity-sized cache (1024 prompt + 32 new tokens)
    (q5, k5, v5), pq5, pk5 = ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                           [1024] * 4, "decode")
    mask5 = ref.make_mask(pq5, pk5, causal=True, window=4096)[:, None]
    qt5 = q5.transpose(1, 2)
    kt5, vt5 = (t.transpose(1, 2).repeat_interleave(4, dim=1)
                for t in (k5, v5))
    timing["B5"] = dict(
        ms=time_ms(lambda: rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5,
                                                 window=4096)),
        plain_ms=time_ms(lambda: rp.ragged_prefill_fwd_plain(
            q5, k5, v5, pq5, pk5, window=4096)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5, attn_mask=mask5)),
        device_ms=device_ms(lambda: rp.ragged_prefill_fwd(
            q5, k5, v5, pq5, pk5, window=4096)),
        library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt5, kt5, vt5, attn_mask=mask5)),
        work=(*ragged_work(q5, k5, pq5, pk5, 4096), "bfloat16"))
    # B6 at the prefix phase's shape: a 256-query chunk after a 1024-token
    # cached prefix
    args6 = paged_prefill_inputs(dev, torch.bfloat16, [1024], [])
    kw6 = dict(sp=1, page_size=16, window=4096)
    timing["B6"] = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(*args6, 0, **kw6)),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            *args6, 0, **kw6)),
        device_ms=device_ms(lambda: pp.paged_prefill_attention(
            *args6, 0, **kw6)),
        library_ms=None,
        work=(*paged_prefill_work(args6[3].cpu().numpy(), [1024], 256,
                                  4096), "bfloat16"))
    paged_refs["B6"] = paged_sdpa(*args6, 16, 4096, decode=False)
    paged_refs = {n: dict(ms=time_ms(f), device_ms=device_ms(f))
                  for n, f in paged_refs.items()}
    # the training shape: seq 4096, bf16, causal (window 4096 is inert)
    g = torch.Generator(device=dev).manual_seed(3)
    S = TRAIN_SEQ
    q = torch.randn((1, S, 32, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, S, 8, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, S, 8, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((1, S, 32, 80), generator=g, device=dev).bfloat16()
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos, window=4096)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    o_acc = torch.zeros((1, S, 32, 80), device=dev)
    lse_acc = torch.full((1, 32, S), NEG_INF, device=dev)
    pairs = visible_pairs(pos, pos, 4096)
    bargs = (q, k, v, do, lse, delta, pos, pos)
    # both kernels against their plain versions at the shape the train step
    # launches them at, before they are timed there
    got = fa.flash_attention_bwd(*bargs, window=4096)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*bargs, window=4096)
    b3_err, ok, _ = grad_err(got, want, lse, BWD_TOL)
    check(ok, f"B3 train_seq{S} bfloat16: max err {b3_err} (tol {BWD_TOL})")
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], b3_err)
    b3_scaled = scaled_err(got, want)
    rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                       b3_scaled)
    checked.append(f"B3/train_seq{S}/bfloat16")
    del got, want
    # one long block, 12288 tokens of 4 query heads over one kv head: dk
    # sums 4 x 12288 query rows, dq 12288 keys. The tensor cores' f32
    # accumulation truncates, so one MMA chain over the whole block would
    # drift past BWD_TOL; each tile's share is summed apart
    pl = torch.arange(LONG_BWD_SEQ, dtype=torch.int32, device=dev)
    largs = bwd_inputs(pl, pl, LONG_BWD_SEQ, torch.bfloat16, dev, seed=3,
                       heads=(4, 1))
    got = fa.flash_attention_bwd(*largs, pl, pl, window=LONG_BWD_SEQ)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*largs, pl, pl, window=LONG_BWD_SEQ)
    long_err, ok, _ = grad_err(got, want, largs[4], BWD_TOL)
    long_scaled = scaled_err(got, want)
    check(ok, f"B3 long_seq{LONG_BWD_SEQ} bfloat16: max err {long_err} "
              f"(scaled {long_scaled}, tol {BWD_TOL})")
    rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"], long_err)
    rows["B3"]["max_scaled_err"] = max(rows["B3"]["max_scaled_err"],
                                       long_scaled)
    checked.append(f"B3/long_seq{LONG_BWD_SEQ}/bfloat16")
    del got, want, largs
    # the same for the forward: B2 on one 12288-token block of 4 query heads
    # over one kv head, a row summing up to 12288 keys; each tile's P V goes
    # into a fresh accumulator before one f32 multiply-add
    gl = torch.Generator(device=dev).manual_seed(4)
    lq = torch.randn((1, LONG_FWD_SEQ, 4, 80), generator=gl, device=dev)
    lk, lv = (torch.randn((1, LONG_FWD_SEQ, 1, 80), generator=gl,
                          device=dev) for _ in range(2))
    lacc = (torch.randn((1, LONG_FWD_SEQ, 4, 80), generator=gl, device=dev),
            3 * torch.randn((1, 4, LONG_FWD_SEQ), generator=gl, device=dev))
    pl = torch.arange(LONG_FWD_SEQ, dtype=torch.int32, device=dev)
    largs = [t.bfloat16() for t in (lq, lk, lv)] + [pl, pl, *lacc]
    o2, lse2 = fa.flash_attention_fwd(*largs, window=LONG_FWD_SEQ)
    torch.cuda.synchronize()
    o2_p, lse2_p = fa.flash_attention_fwd_plain(*largs, window=LONG_FWD_SEQ)
    long_fwd_err, ok, _ = partial_err(o2, lse2, o2_p, lse2_p,
                                      TOL["bfloat16"])
    check(ok, f"B2 long_seq{LONG_FWD_SEQ} bfloat16: max err {long_fwd_err} "
              f"(tol {TOL['bfloat16']}) or a dead row not exact")
    rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], long_fwd_err)
    checked.append(f"B2/long_seq{LONG_FWD_SEQ}/bfloat16")
    del o2, lse2, o2_p, lse2_p, largs, lq, lk, lv, lacc
    o2, lse2 = fa.flash_attention_fwd(q, k, v, pos, pos, o_acc, lse_acc,
                                      window=4096)
    torch.cuda.synchronize()
    o2_p, lse2_p = fa.flash_attention_fwd_plain(q, k, v, pos, pos, o_acc,
                                                lse_acc, window=4096)
    b2_err, ok, _ = partial_err(o2, lse2, o2_p, lse2_p, TOL["bfloat16"])
    check(ok, f"B2 train_seq{S} bfloat16: max err {b2_err} (tol "
              f"{TOL['bfloat16']}) or a dead row not exact")
    rows["B2"]["max_abs_err"] = max(rows["B2"]["max_abs_err"], b2_err)
    checked.append(f"B2/train_seq{S}/bfloat16")
    del o2, lse2, o2_p, lse2_p
    try:
        lib_ms, lib_dev = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = lib_dev = None
        emit("kernels_note", library_B3=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs, window=4096),
                   reps=10, inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(
            *bargs, window=4096), reps=5, inner=2),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(
            *bargs, window=4096), calls=5),
        library_ms=lib_ms, library_device_ms=lib_dev,
        work=(*bwd_work(q, k, pos, pos, pairs), "bfloat16"))
    fwd_io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + 2 * (o_acc.numel() + lse_acc.numel()) * 4
    b2_4096 = dict(
        ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, o_acc, lse_acc, window=4096), reps=10,
            inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, pos, pos, o_acc, lse_acc, window=4096), reps=5,
            inner=2),
        max_abs_err=b2_err)
    # a reference, not B2's function: SDPA computes o alone, without lse
    # and without the merge into the running accumulator
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b2_4096["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        reps=10, inner=2)
    b2_4096["device_ms"] = device_ms(lambda: fa.flash_attention_fwd(
        q, k, v, pos, pos, o_acc, lse_acc, window=4096), calls=5)
    b2_4096["sdpa_fwd_device_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), calls=5)
    del qt, kt, vt
    b2_4096["bound_ms"], b2_4096["bound_by"] = bound(
        fwd_io, 4 * 80 * 32 * pairs, "bfloat16")
    del q, k, v, do, o, lse, delta, o_acc, lse_acc, bargs
    # B7 at the ragged_bwd path's shape: 4 rows of 1024 tokens at their own
    # offsets, bf16, causal, window 4096
    b, sq, sk, hq, hkv, window, offs, zero = \
        ragged_bwd_cases()["path_4x1024"]
    args7 = ragged_bwd_inputs(dev, torch.bfloat16, b, sq, sk, hq, hkv,
                              window, offs, zero)
    q7, k7, v7, do7, _, _, pq7, pk7 = args7
    mask7 = ref.make_mask(pq7, pk7, causal=True, window=window)
    try:
        lib7, lib7_dev = sdpa_bwd_ms(q7, k7, v7, do7, mask7[:, None])
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib7 = lib7_dev = None
        emit("kernels_note", library_B7=f"SDPA backward refused: {e}")
    timing["B7"] = dict(
        ms=time_ms(lambda: rb.flash_attention_bwd_ragged(*args7,
                                                         window=window),
                   reps=10, inner=2),
        plain_ms=time_ms(lambda: rb.flash_attention_bwd_ragged_plain(
            *args7, window=window), reps=5, inner=2),
        device_ms=device_ms(lambda: rb.flash_attention_bwd_ragged(
            *args7, window=window), calls=5),
        library_ms=lib7, library_device_ms=lib7_dev,
        work=(*bwd_work(q7, k7, pq7, pk7, int(mask7.sum())), "bfloat16"))
    del args7, q7, k7, v7, do7, mask7
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        rows[name].update(t, bound_ms=b_ms, bound_by=b_by,
                          tol=BWD_TOL if name in ("B3", "B7") else TOL)
    emit("kernels", checked=len(checked),
         tolerances="forward: f32 inputs 2e-5 (the JAX kernel tests' own); "
                    "bf16 inputs, upcast to f32 in both versions, 1e-4; "
                    "B3, B7: 3e-4 (the JAX test_bwd_matches_ref bound); "
                    "dead rows exact",
         timing_shapes={"B1/B2": "q (1,1024,32,80) bf16, causal, window "
                                 "4096",
                        "B3, B2_seq4096": "q (1,4096,32,80), k/v "
                                          "(1,4096,8,80) bf16, causal, "
                                          "window 4096",
                        "B4": "q (4,1,32,80) bf16, pool (512,16,8,80), W "
                              "64, ~1K context",
                        "B5": "q (4,1,32,80), k/v (4,1056,8,80) bf16, "
                              "cache length 1024 per row",
                        "B6": "q (1,256,32,80) bf16, pool (512,16,8,80), "
                              "W 128, cached_len 1024",
                        "B7": "q (4,1024,32,80), k/v (4,1024,8,80) bf16, "
                              "(B,S) positions at offsets 0/1024/2048/3072, "
                              "causal, window 4096"},
         library={"B1": "the faster of two scaled_dot_product_attention "
                        "calls (B1_library_ms), o only: the boolean mask "
                        "with kv heads repeated beforehand, and is_causal "
                        "with enable_gqa",
                  "B2_seq4096.sdpa_fwd_ms": "scaled_dot_product_attention "
                                            "(is_causal, enable_gqa): a "
                                            "reference that computes o "
                                            "only, without lse or the "
                                            "merge",
                  "B5": "scaled_dot_product_attention with the boolean "
                        "mask of the positions, kv heads repeated "
                        "beforehand",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal, enable_gqa), timed alone",
                  "B7": "autograd backward of scaled_dot_product_attention"
                        " with the boolean (B,1,Sq,Sk) mask of the "
                        "positions, kv heads repeated beforehand, timed "
                        "alone",
                  "paged_refs": "references, not B4's or B6's function: "
                                "scaled_dot_product_attention (o only, no "
                                "lse) on the allocated pages' keys gathered "
                                "densely beforehand (the gather not timed), "
                                "kv heads repeated, the boolean mask of "
                                "key validity and window (none when every "
                                "pair is visible)"},
         paged_refs=paged_refs,
         B1_library_ms=b1_library, B1_library_device_ms=b1_library_device,
         B2_seq4096=b2_4096,
         **{f"B2_long_seq{LONG_FWD_SEQ}_max_abs_err": long_fwd_err},
         B3_seq4096_max_abs_err=b3_err,
         B3_seq4096_max_scaled_err=b3_scaled,
         **{f"B3_long_seq{LONG_BWD_SEQ}_max_scaled_err": long_scaled},
         bf16_bwd_occupancy_seq4096=fa.bwd_occupancy(80, S, S),
         fwd_occupancy={
             f"D80_seq{S}": fa.fwd_occupancy(80, S, S, 4),
             "D80_decode_sq1_sk1056": fa.fwd_occupancy(80, 1, 1056, 4)},
         **{n: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                   "device_ms", "library_device_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "max_scaled_err") if k in r}
            for n, r in rows.items()})
    return rows


ULYSSES_P = 8                  # the schemes phase's SP degree


def ulysses_positions(kind, n, p=ULYSSES_P):
    """Ulysses' positions at SP degree p: the zigzag shards concatenated in
    linear rank order, as its all-to-all gathers the sequence (unsorted),
    or the same tokens sorted."""
    import torch

    if kind == "sorted":
        return torch.arange(n, dtype=torch.int32)
    return torch.cat([_zigzag(r, n, p) for r in range(p)])


def phase_kernels_ulysses(dev, rows):
    """B1 and B3 at the shape Ulysses gives them at full width and P = 8:
    q (1, 4096, 4, 80) over k/v (1, 4096, 1, 80) (G = 4, one kv head),
    causal, window 4096, the positions in the all-to-all's order and
    sorted; bf16 and f32 against their plain versions (the kernels phase's
    tolerances), then ``device_ms`` and the bound of each on bf16."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    S, W = TRAIN_SEQ, 4096
    out = {}
    for kind in ("zigzag_concat", "sorted"):
        pos = ulysses_positions(kind, S).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v, do, lse, delta = bwd_inputs(pos, pos, W, dtype, dev,
                                                 seed=6, heads=(4, 1))
            o, lse1 = fa.flash_attention_fwd(q, k, v, pos, pos, window=W)
            torch.cuda.synchronize()
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, pos, pos,
                                                      window=W)
            b1_err, ok, _ = partial_err(o, lse1, o_p, lse_p, TOL[dname])
            check(ok, f"B1 ulysses_{kind} {dname}: max err {b1_err} (tol "
                      f"{TOL[dname]}) or a dead row not exact")
            bargs = (q, k, v, do, lse, delta, pos, pos)
            got = fa.flash_attention_bwd(*bargs, window=W)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*bargs, window=W)
            b3_err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            check(ok, f"B3 ulysses_{kind} {dname}: max err {b3_err} (tol "
                      f"{BWD_TOL}) or a dead row's dq not exactly 0")
            rows["B1"]["max_abs_err"] = max(rows["B1"]["max_abs_err"],
                                            b1_err)
            rows["B3"]["max_abs_err"] = max(rows["B3"]["max_abs_err"],
                                            b3_err)
            rows["B3"]["max_scaled_err"] = max(
                rows["B3"]["max_scaled_err"], scaled_err(got, want))
            del o, lse1, o_p, lse_p, got, want
            if dtype != torch.bfloat16:
                continue
            pairs = visible_pairs(pos, pos, W)
            io = sum(t.numel() * t.element_size() for t in (q, k, v)) \
                + 2 * pos.numel() * 4 + q.numel() * 4 + 4 * S * 4
            b1_bound = bound(io, 4 * 80 * 4 * pairs, "bfloat16")
            b3_bound = bound(*bwd_work(q, k, pos, pos, pairs), "bfloat16")
            out[kind] = {
                "visible_pairs": pairs,
                "B1": {"max_abs_err": b1_err,
                       "device_ms": device_ms(lambda: fa.flash_attention_fwd(
                           q, k, v, pos, pos, window=W), calls=10),
                       "bound_ms": b1_bound[0], "bound_by": b1_bound[1]},
                "B3": {"max_abs_err": b3_err,
                       "device_ms": device_ms(lambda: fa.flash_attention_bwd(
                           *bargs, window=W), calls=5),
                       "bound_ms": b3_bound[0], "bound_by": b3_bound[1]}}
            del q, k, v, do, lse, delta, bargs
    emit("kernels_ulysses", shape="q (1,4096,4,80), k/v (1,4096,1,80), "
         "causal, window 4096", tol={"B1": TOL, "B3": BWD_TOL},
         positions={"zigzag_concat": "the 8 zigzag shards concatenated "
                                     "(Ulysses' all-to-all order)",
                    "sorted": "0..4095"}, **out)


# ---------------------------------------------------------------------------
# phase 4: StarTrail forward and backward on a P = 8 ThreadMesh on the card
# ---------------------------------------------------------------------------

# The ring's gradients against autograd of plain attention in f32 from the
# same bf16 inputs. Both see the bf16 inputs exactly; the ring also rounds o
# to bf16 before delta = rowsum(do * o) (as the model's backward does), which
# moves ds by up to a bf16 ulp of delta (2^-8 relative), so allow 1e-2 of
# each gradient's largest magnitude.
# ---------------------------------------------------------------------------
# phase 3b: the kernels at head size 128
# ---------------------------------------------------------------------------

D128 = 128
D128_SEQ = 4096          # GPT-7B's training shape: 32q/32kv heads, causal
MINITRON_CTX = [1023, 1010, 1000, 990]   # 4 decode slots at ~1K context


def phase_kernels_d128(dev, rows):
    """Every kernel at head size 128, the head size of GPT-7B, minitron-8b
    and deepseek-7b: the check cases of phase 3 again (bf16 and f32), then
    each kernel at the shape the dense phases give it, held against its
    plain version at the same ``TOL``/``BWD_TOL`` and timed beside its
    bound and, where one exists, SDPA: B1, B2 and B3 at GPT-7B's training
    shape (q, k, v (1,4096,32,128), causal), B4 at minitron-8b's decode
    step (4 slots at ~1K context, 32q/8kv, pages of 16), B6 at its
    256-query chunk after a 1024-token prefix, B5 at the legacy decode
    shape and B7 at the ragged_bwd shape, each at D = 128 with no window.
    The check cases include B4 and B6 at dense_serve's P = 8 shard shapes
    (``sp8_rank5``, ``sp8_rank3_prefix512``). Each row gains ``d128``; the
    ``-Xptxas -v`` lines of the D = 128 kernels show their registers and
    spills."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels import ref

    d = D128
    res = {n: {"max_abs_err": 0.0} for n in KERNELS}
    for n in ("B3", "B7"):
        res[n]["max_scaled_err"] = 0.0
    checked = check_cases(dev, res, d=d)
    shapes = {}

    def hold(name, what, got, want, lse=None):
        """The kernel's output against the plain version's at the
        phase's tolerances."""
        if lse is None:
            err, ok, _ = partial_err(*got, *want, TOL["bfloat16"])
            tol = TOL["bfloat16"]
        else:
            err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            res[name]["max_scaled_err"] = max(res[name]["max_scaled_err"],
                                              scaled_err(got, want))
            tol = BWD_TOL
        check(ok, f"{name} {what} bfloat16 D=128: max err {err} (tol "
                  f"{tol}) or a dead row not exact")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        checked.append(f"{name}/{what}/bfloat16")

    # B1, B2, B3 at GPT-7B's training shape (MHA, no window)
    g = torch.Generator(device=dev).manual_seed(11)
    S = D128_SEQ
    q, k, v, do = (torch.randn((1, S, 32, d), generator=g,
                               device=dev).bfloat16() for _ in range(4))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o_acc = torch.randn((1, S, 32, d), generator=g, device=dev)
    lse_acc = 3 * torch.randn((1, 32, S), generator=g, device=dev)
    o_acc[:, :96] = 0.0
    lse_acc[:, :, :96] = NEG_INF
    pairs = visible_pairs(pos, pos, None)
    for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
        got = fa.flash_attention_fwd(q, k, v, pos, pos, *acc)
        torch.cuda.synchronize()
        hold(name, f"gpt7b_seq{S}", got,
             fa.flash_attention_fwd_plain(q, k, v, pos, pos, *acc))
        shapes[name] = "q, k, v (1,4096,32,128) bf16, causal" + (
            ", merged into a running (o, lse)" if acc else "")
    del got
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    bargs = (q, k, v, do, lse, delta, pos, pos)
    got = fa.flash_attention_bwd(*bargs)
    torch.cuda.synchronize()
    hold("B3", f"gpt7b_seq{S}", got, fa.flash_attention_bwd_plain(*bargs),
         lse)
    check(same_bits(got, fa.flash_attention_bwd(*bargs)),
          "B3 D=128: two runs differ (no atomics: they must give the same "
          "bits)")
    shapes["B3"] = "q, k, v, do (1,4096,32,128) bf16, causal"
    del got, o
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + q.numel() * 4 + 32 * S * 4
    acc_io = (o_acc.numel() + lse_acc.numel()) * 4
    flops = 4 * d * 32 * pairs
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    timing = {
        "B1": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos), calls=5),
            library_ms=time_ms(sdpa, reps=10, inner=2),
            library_device_ms=device_ms(sdpa, calls=5),
            work=(io, flops, "bfloat16")),
        "B2": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, o_acc, lse_acc), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos, o_acc, lse_acc), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos, o_acc, lse_acc), calls=5),
            library_ms=None, library_device_ms=None,
            sdpa_fwd_device_ms=device_ms(sdpa, calls=5),
            work=(io + acc_io, flops, "bfloat16"))}
    del qt, kt, vt
    try:
        lib_ms, lib_dev = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = lib_dev = None
        emit("kernels_note", library_B3_d128=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(*bargs),
                         reps=5, inner=2),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(*bargs),
                            calls=5),
        library_ms=lib_ms, library_device_ms=lib_dev,
        work=(*bwd_work(q, k, pos, pos, pairs), "bfloat16"))
    occupancy = {"bf16_bwd_seq4096": fa.bwd_occupancy(d, S, S),
                 "fwd_seq4096_g1": fa.fwd_occupancy(d, S, S, 1),
                 "fwd_decode_g4": fa.fwd_occupancy(d, 1, 1024, 4)}
    del q, k, v, do, lse, delta, o_acc, lse_acc, bargs
    free_device()

    # B4 at minitron-8b's decode step, B6 at its 256-query chunk after a
    # 1024-token prefix
    for name, t in paged_timing(dev, hold, "minitron", d, (32, 8),
                                MINITRON_CTX, 16, 12).items():
        shapes[name] = t.pop("shape")
        timing[name] = t
    # B5 at the legacy decode shape
    (q5, k5, v5), pq5, pk5 = ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                           [1024] * 4, "decode", seed=14,
                                           d=d)
    got = rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)
    torch.cuda.synchronize()
    hold("B5", "decode_sq1", got,
         rp.ragged_prefill_fwd_plain(q5, k5, v5, pq5, pk5))
    mask5 = ref.make_mask(pq5, pk5, causal=True)[:, None]
    qt5 = q5.transpose(1, 2)
    kt5, vt5 = (t.transpose(1, 2).repeat_interleave(4, dim=1)
                for t in (k5, v5))

    def sdpa5():
        return F.scaled_dot_product_attention(qt5, kt5, vt5,
                                              attn_mask=mask5)

    timing["B5"] = dict(
        ms=time_ms(lambda: rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)),
        plain_ms=time_ms(lambda: rp.ragged_prefill_fwd_plain(
            q5, k5, v5, pq5, pk5)),
        device_ms=device_ms(lambda: rp.ragged_prefill_fwd(
            q5, k5, v5, pq5, pk5)),
        library_ms=time_ms(sdpa5), library_device_ms=device_ms(sdpa5),
        work=(*ragged_work(q5, k5, pq5, pk5, None), "bfloat16"))
    shapes["B5"] = "q (4,1,32,128), k/v (4,1056,8,128) bf16, cache " \
        "length 1024 per row"
    del got, q5, k5, v5, qt5, kt5, vt5, mask5
    # B7 at the ragged_bwd path's shape
    args7 = ragged_bwd_inputs(dev, torch.bfloat16, 4, 1024, 1024, 32, 8,
                              None, [0, 1024, 2048, 3072], [], seed=15, d=d)
    got = rb.flash_attention_bwd_ragged(*args7)
    torch.cuda.synchronize()
    hold("B7", "path_4x1024", got,
         rb.flash_attention_bwd_ragged_plain(*args7), args7[4])
    q7, k7, v7, do7, _, _, pq7, pk7 = args7
    mask7 = ref.make_mask(pq7, pk7, causal=True)
    try:
        lib7, lib7_dev = sdpa_bwd_ms(q7, k7, v7, do7, mask7[:, None])
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib7 = lib7_dev = None
        emit("kernels_note", library_B7_d128=f"SDPA backward refused: {e}")
    timing["B7"] = dict(
        ms=time_ms(lambda: rb.flash_attention_bwd_ragged(*args7), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: rb.flash_attention_bwd_ragged_plain(
            *args7), reps=5, inner=2),
        device_ms=device_ms(lambda: rb.flash_attention_bwd_ragged(*args7),
                            calls=5),
        library_ms=lib7, library_device_ms=lib7_dev,
        work=(*bwd_work(q7, k7, pq7, pk7, int(mask7.sum())), "bfloat16"))
    shapes["B7"] = "q (4,1024,32,128), k/v (4,1024,8,128) bf16, (B,S) " \
        "positions at offsets 0/1024/2048/3072, causal"
    del got, args7, q7, k7, v7, do7, mask7
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        res[name].update(t, bound_ms=b_ms, bound_by=b_by, shape=shapes[name])
        rows[name]["d128"] = res[name]
    ptxas = [line for line in _build.build_info()["ptxas"]
             if "Li128E" in line]
    emit("kernels_d128", checked=len(checked), head_dim=d,
         tolerances="as phase 3: forward f32 2e-5, bf16 1e-4; B3, B7 3e-4; "
                    "dead rows exact",
         library={"B1": "scaled_dot_product_attention(is_causal), o only",
                  "B2.sdpa_fwd_device_ms": "the same call: a reference "
                                           "without lse or the merge",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal), timed alone",
                  "B4/B6.gathered_sdpa_device_ms": "references: SDPA on "
                                                   "the pages' keys "
                                                   "gathered beforehand",
                  "B5": "scaled_dot_product_attention with the boolean "
                        "mask, kv heads repeated beforehand",
                  "B7": "autograd backward of scaled_dot_product_attention"
                        " with the boolean mask, kv heads repeated"},
         occupancy=occupancy, ptxas_d128=ptxas, kernels=res)


D256 = 256
VLM_HEADS = (8, 1)       # paligemma-3b: 8 query heads on one kv head
D256_SEQ = 4096          # paligemma-3b's training and prefill shape
D256_PREFIX = 512        # its image prefix there (an eighth)
# prefix-LM cases at head size 256 (8q/1kv over 1024 tokens): shared
# positions (B1, B2, B3), as (positions, prefix_len): one block, and a ring
# step of P = 2 whose keys straddle the prefix's end; per-row positions (B5,
# B7), as (row offsets, prefix_len)
D256_PREFIX_CASES = {"causal_p128": ("arange", 128),
                     "zigzag_p300": ("zigzag", 300)}
D256_RAGGED_PREFIX = ([0, 40], 100)
GPT3B_HEADS = (12, 12)   # GPT-3B: MHA, 12 heads of 256
GPT3B_CTX = [1023, 1010, 1000, 990]      # 4 decode slots at ~1K context
def _d256_prefix_cases(dev, res):
    """B1, B2, B3, B5 and B7 under the prefix-LM mask at head size 256,
    bf16 and f32, against their plain versions (``TOL`` / ``BWD_TOL``; no
    row is dead: every query sees the prefix). Returns the cases checked."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp

    checked = []
    S = 1024
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case, (kind, pre) in D256_PREFIX_CASES.items():
            pq, pk = (ar, ar) if kind == "arange" else (
                _zigzag(1, 2 * S, 2).to(dev), _zigzag(0, 2 * S, 2).to(dev))
            q, k, v, do, lse, delta = bwd_inputs(pq, pk, None, dtype, dev,
                                                 heads=VLM_HEADS, d=D256,
                                                 prefix_len=pre)
            g = torch.Generator(device=dev).manual_seed(1)
            o_acc = torch.randn(q.shape, generator=g, device=dev)
            lse_acc = 3 * torch.randn(lse.shape, generator=g, device=dev)
            for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
                got = fa.flash_attention_fwd(q, k, v, pq, pk, *acc,
                                             prefix_len=pre)
                torch.cuda.synchronize()
                want = fa.flash_attention_fwd_plain(q, k, v, pq, pk, *acc,
                                                    prefix_len=pre)
                err, ok, n_dead = partial_err(*got, *want, TOL[dname])
                check(ok and n_dead == 0, f"{name} prefix {case} {dname} "
                      f"D=256: max err {err} (tol {TOL[dname]}), {n_dead} "
                      f"dead rows")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                checked.append(f"{name}/prefix_{case}/{dname}")
            args = (q, k, v, do, lse, delta, pq, pk)
            got = fa.flash_attention_bwd(*args, prefix_len=pre)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(*args, prefix_len=pre)
            err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            check(ok, f"B3 prefix {case} {dname} D=256: max err {err} (tol "
                      f"{BWD_TOL})")
            res["B3"]["max_abs_err"] = max(res["B3"]["max_abs_err"], err)
            res["B3"]["max_scaled_err"] = max(res["B3"]["max_scaled_err"],
                                              scaled_err(got, want))
            checked.append(f"B3/prefix_{case}/{dname}")
        offsets, pre = D256_RAGGED_PREFIX
        args = ragged_bwd_inputs(dev, dtype, 2, 256, 256, *VLM_HEADS, None,
                                 offsets, [], d=D256, prefix_len=pre)
        got = rp.ragged_prefill_fwd(*args[:3], *args[6:], prefix_len=pre)
        torch.cuda.synchronize()
        want = rp.ragged_prefill_fwd_plain(*args[:3], *args[6:],
                                           prefix_len=pre)
        err, ok, _ = partial_err(*got, *want, TOL[dname])
        check(ok, f"B5 prefix {dname} D=256: max err {err} (tol "
                  f"{TOL[dname]}) or a dead row not exact")
        res["B5"]["max_abs_err"] = max(res["B5"]["max_abs_err"], err)
        got = rb.flash_attention_bwd_ragged(*args, prefix_len=pre)
        torch.cuda.synchronize()
        want = rb.flash_attention_bwd_ragged_plain(*args, prefix_len=pre)
        err, ok, _ = grad_err(got, want, args[4], BWD_TOL)
        check(ok, f"B7 prefix {dname} D=256: max err {err} (tol {BWD_TOL})")
        res["B7"]["max_abs_err"] = max(res["B7"]["max_abs_err"], err)
        res["B7"]["max_scaled_err"] = max(res["B7"]["max_scaled_err"],
                                          scaled_err(got, want))
        checked += [f"B5/prefix/{dname}", f"B7/prefix/{dname}"]
        del got, want, args
    return checked


def paged_timing(dev, hold, label, d, heads, ctx, ps, seed):
    """B4 at a decode step (``ctx``: 4 slots' cache lengths) and B6 at a
    256-query chunk after a 1024-token prefix, ``heads`` (query, kv) of
    size ``d`` in pages of ``ps``: each held against its plain version
    (``hold``) and timed beside it, its bound and SDPA on the keys gathered
    beforehand. Returns {"B4": timing, "B6": timing}, each with its
    shape."""
    import torch

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp

    hq, hkv = heads
    kw = dict(sp=1, page_size=ps)
    args4 = (*paged_inputs(dev, 1, ctx, seed=seed, d=d, ps=ps, heads=heads),
             0)
    got = pd.paged_decode_attention(*args4, **kw)
    torch.cuda.synchronize()
    hold("B4", f"{label}_decode_page{ps}", got,
         pd.paged_decode_attention_plain(*args4, **kw))
    ref4 = paged_sdpa(*args4[:5], ps, None, decode=True)
    table, cl = args4[3].cpu().numpy(), args4[4].cpu().numpy()
    t4 = dict(
        ms=time_ms(lambda: pd.paged_decode_attention(*args4, **kw)),
        plain_ms=time_ms(lambda: pd.paged_decode_attention_plain(
            *args4, **kw)),
        device_ms=device_ms(lambda: pd.paged_decode_attention(*args4,
                                                              **kw)),
        library_ms=None, library_device_ms=None,
        gathered_sdpa_device_ms=device_ms(ref4),
        splits=pd.decode_splits(len(ctx), hkv, d, table.shape[1], ps,
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count),
        work=(*paged_work(table, cl, 1, 0, None, ps=ps, hkv=hkv, d=d,
                          hq=hq), "bfloat16"),
        shape=f"q ({len(ctx)},1,{hq},{d}) bf16, pool ({8192 // ps},{ps},"
              f"{hkv},{d}), W {table.shape[1]}, cache lengths "
              f"{'/'.join(map(str, ctx))}")
    del got, args4, ref4
    args6 = (*paged_prefill_inputs(dev, torch.bfloat16, [1024], [],
                                   seed=seed + 1, d=d, ps=ps, heads=heads),
             0)
    got = pp.paged_prefill_attention(*args6, **kw)
    torch.cuda.synchronize()
    hold("B6", f"{label}_chunk_page{ps}", got,
         pp.paged_prefill_attention_plain(*args6, **kw))
    ref6 = paged_sdpa(*args6[:5], ps, None, decode=False)
    t6 = dict(
        ms=time_ms(lambda: pp.paged_prefill_attention(*args6, **kw)),
        plain_ms=time_ms(lambda: pp.paged_prefill_attention_plain(
            *args6, **kw)),
        device_ms=device_ms(lambda: pp.paged_prefill_attention(*args6,
                                                               **kw)),
        library_ms=None, library_device_ms=None,
        gathered_sdpa_device_ms=device_ms(ref6),
        work=(*paged_prefill_work(args6[3].cpu().numpy(), [1024], 256,
                                  None, ps=ps, hkv=hkv, d=d, hq=hq),
              "bfloat16"),
        shape=f"q (1,256,{hq},{d}) bf16, pool ({8192 // ps},{ps},{hkv},"
              f"{d}), W {args6[3].shape[1]}, cached_len 1024")
    del got, args6, ref6
    free_device()
    return {"B4": t4, "B6": t6}


def phase_kernels_d256(dev, rows):
    """Every kernel at head size 256 (paligemma-3b, GPT-3B): the check
    cases of phase 3 again at D = 256 (bf16 and f32), B4 and B6 among them
    at pages of 16, 128, 96 and 48 and 32 query heads a kv head, the
    prefix-LM cases (``D256_PREFIX_CASES``); then each at the shape
    the VLM and GPT-3B phases give it, held against its plain version at
    ``TOL``/``BWD_TOL`` and timed beside its bound and SDPA: B1, B2 and B3
    at paligemma's training and prefill shape (q (1,4096,8,256), k/v
    (1,4096,1,256), causal, a 512-position prefix), B5 at its ``--legacy``
    decode shape (2 rows, one query of 8 heads against 1056 cached keys),
    B7 at the ragged_bwd shape with 8q/1kv, B4 at GPT-3B's decode step and
    B6 at its 256-query chunk, each at pages of 16 and 128. Each row gains
    ``d256``; the ``-Xptxas -v`` lines of the D = 256 kernels show their
    registers and spills."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp
    from repro_torch.kernels import ref

    d, (hq, hkv) = D256, VLM_HEADS
    res = {n: {"max_abs_err": 0.0} for n in KERNELS}
    for n in ("B3", "B7"):
        res[n]["max_scaled_err"] = 0.0
    checked = check_cases(dev, res, d=d)
    checked += _d256_prefix_cases(dev, res)
    free_device()
    shapes, page128 = {}, {}

    def hold(name, what, got, want, lse=None):
        if lse is None:
            err, ok, _ = partial_err(*got, *want, TOL["bfloat16"])
            tol = TOL["bfloat16"]
        else:
            err, ok, _ = grad_err(got, want, lse, BWD_TOL)
            res[name]["max_scaled_err"] = max(res[name]["max_scaled_err"],
                                              scaled_err(got, want))
            tol = BWD_TOL
        check(ok, f"{name} {what} bfloat16 D=256: max err {err} (tol "
                  f"{tol}) or a dead row not exact")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        checked.append(f"{name}/{what}/bfloat16")

    # B1, B2, B3 at paligemma's training shape, with its prefix
    g = torch.Generator(device=dev).manual_seed(21)
    S, pre = D256_SEQ, D256_PREFIX
    q, do = (torch.randn((1, S, hq, d), generator=g, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((1, S, hkv, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    o_acc = torch.randn((1, S, hq, d), generator=g, device=dev)
    lse_acc = 3 * torch.randn((1, hq, S), generator=g, device=dev)
    kw = dict(prefix_len=pre)
    pairs = int(ref.make_mask(pos, pos, causal=True, prefix_len=pre).sum())
    for name, acc in (("B1", ()), ("B2", (o_acc, lse_acc))):
        got = fa.flash_attention_fwd(q, k, v, pos, pos, *acc, **kw)
        torch.cuda.synchronize()
        hold(name, f"paligemma_seq{S}", got,
             fa.flash_attention_fwd_plain(q, k, v, pos, pos, *acc, **kw))
        shapes[name] = f"q (1,{S},8,256), k/v (1,{S},1,256) bf16, causal " \
            f"with a {pre}-position prefix" + (
                ", merged into a running (o, lse)" if acc else "")
    del got
    o, lse = fa.flash_attention_fwd_plain(q, k, v, pos, pos, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         o.bfloat16().float()).contiguous()
    bargs = (q, k, v, do, lse, delta, pos, pos)
    got = fa.flash_attention_bwd(*bargs, **kw)
    torch.cuda.synchronize()
    hold("B3", f"paligemma_seq{S}", got,
         fa.flash_attention_bwd_plain(*bargs, **kw), lse)
    check(same_bits(got, fa.flash_attention_bwd(*bargs, **kw)),
          "B3 D=256: two runs differ (no atomics: they must give the same "
          "bits)")
    shapes["B3"] = f"q, do (1,{S},8,256), k/v (1,{S},1,256) bf16, causal " \
        f"with a {pre}-position prefix"
    del got, o
    io = sum(t.numel() * t.element_size() for t in (q, k, v, pos, pos)) \
        + q.numel() * 4 + hq * S * 4
    acc_io = (o_acc.numel() + lse_acc.numel()) * 4
    flops = 4 * d * hq * pairs
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
              for t in (k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    timing = {
        "B1": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, **kw), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos, **kw), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos, **kw), calls=5),
            library_ms=time_ms(sdpa, reps=10, inner=2),
            library_device_ms=device_ms(sdpa, calls=5),
            work=(io, flops, "bfloat16")),
        "B2": dict(ms=time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, pos, pos, o_acc, lse_acc, **kw), reps=10, inner=2),
            plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, pos, pos, o_acc, lse_acc, **kw), reps=5, inner=2),
            device_ms=device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, pos, pos, o_acc, lse_acc, **kw), calls=5),
            library_ms=None, library_device_ms=None,
            sdpa_fwd_device_ms=device_ms(sdpa, calls=5),
            work=(io + acc_io, flops, "bfloat16"))}
    del qt, kt, vt
    try:
        lib_ms, lib_dev = sdpa_bwd_ms(q, k, v, do)
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib_ms = lib_dev = None
        emit("kernels_note", library_B3_d256=f"SDPA backward refused: {e}")
    timing["B3"] = dict(
        ms=time_ms(lambda: fa.flash_attention_bwd(*bargs, **kw), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: fa.flash_attention_bwd_plain(*bargs, **kw),
                         reps=5, inner=2),
        device_ms=device_ms(lambda: fa.flash_attention_bwd(*bargs, **kw),
                            calls=5),
        library_ms=lib_ms, library_device_ms=lib_dev,
        work=(*bwd_work(q, k, pos, pos, pairs), "bfloat16"))
    occupancy = {"bf16_bwd_seq4096": fa.bwd_occupancy(d, S, S),
                 "fwd_seq4096_g8": fa.fwd_occupancy(d, S, S, hq),
                 "fwd_decode_g8": fa.fwd_occupancy(d, 1, 1056, hq)}
    del q, k, v, do, lse, delta, o_acc, lse_acc, bargs
    free_device()
    # B5 at the --legacy decode shape (VLM_SERVE's P = 1 run)
    (q5, k5, v5), pq5, pk5 = ragged_inputs(dev, torch.bfloat16, 1, 1056,
                                           [1024, 1040], "decode", seed=24,
                                           d=d, heads=VLM_HEADS)
    got = rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)
    torch.cuda.synchronize()
    hold("B5", "legacy_decode_g8", got,
         rp.ragged_prefill_fwd_plain(q5, k5, v5, pq5, pk5))
    mask5 = ref.make_mask(pq5, pk5, causal=True)[:, None]
    qt5 = q5.transpose(1, 2)
    kt5, vt5 = (t.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
                for t in (k5, v5))

    def sdpa5():
        return F.scaled_dot_product_attention(qt5, kt5, vt5,
                                              attn_mask=mask5)

    timing["B5"] = dict(
        ms=time_ms(lambda: rp.ragged_prefill_fwd(q5, k5, v5, pq5, pk5)),
        plain_ms=time_ms(lambda: rp.ragged_prefill_fwd_plain(
            q5, k5, v5, pq5, pk5)),
        device_ms=device_ms(lambda: rp.ragged_prefill_fwd(
            q5, k5, v5, pq5, pk5)),
        library_ms=time_ms(sdpa5), library_device_ms=device_ms(sdpa5),
        work=(*ragged_work(q5, k5, pq5, pk5, None), "bfloat16"))
    shapes["B5"] = "q (2,1,8,256), k/v (2,1056,1,256) bf16, cache " \
        "lengths 1024 and 1040"
    del got, q5, k5, v5, qt5, kt5, vt5, mask5
    # B7 at the ragged_bwd path's shape with paligemma's heads
    args7 = ragged_bwd_inputs(dev, torch.bfloat16, 4, 1024, 1024, hq, hkv,
                              None, [0, 1024, 2048, 3072], [], seed=25, d=d)
    got = rb.flash_attention_bwd_ragged(*args7)
    torch.cuda.synchronize()
    hold("B7", "path_4x1024_g8", got,
         rb.flash_attention_bwd_ragged_plain(*args7), args7[4])
    q7, k7, v7, do7, _, _, pq7, pk7 = args7
    mask7 = ref.make_mask(pq7, pk7, causal=True)
    try:
        lib7, lib7_dev = sdpa_bwd_ms(q7, k7, v7, do7, mask7[:, None])
    except RuntimeError as e:      # no SDPA backend for these inputs
        lib7 = lib7_dev = None
        emit("kernels_note", library_B7_d256=f"SDPA backward refused: {e}")
    timing["B7"] = dict(
        ms=time_ms(lambda: rb.flash_attention_bwd_ragged(*args7), reps=10,
                   inner=2),
        plain_ms=time_ms(lambda: rb.flash_attention_bwd_ragged_plain(
            *args7), reps=5, inner=2),
        device_ms=device_ms(lambda: rb.flash_attention_bwd_ragged(*args7),
                            calls=5),
        library_ms=lib7, library_device_ms=lib7_dev,
        work=(*bwd_work(q7, k7, pq7, pk7, int(mask7.sum())), "bfloat16"))
    shapes["B7"] = "q (4,1024,8,256), k/v (4,1024,1,256) bf16, (B,S) " \
        "positions at offsets 0/1024/2048/3072, causal"
    del got, args7, q7, k7, v7, do7, mask7
    free_device()
    # B4 at GPT-3B's decode step, B6 at its 256-query chunk after a
    # 1024-token prefix, at pages of 16 (the engine phase's) and of 128
    for ps in (128, 16):
        for name, t in paged_timing(dev, hold, "gpt3b", d, GPT3B_HEADS,
                                    GPT3B_CTX, ps, 33).items():
            shapes[name] = t.pop("shape")
            if ps == 128:
                b_ms, b_by = bound(*t.pop("work"))
                page128[name] = dict(t, bound_ms=b_ms, bound_by=b_by,
                                     shape=shapes[name])
            else:
                timing[name] = dict(t, page128=page128[name])
    for name, t in timing.items():
        b_ms, b_by = bound(*t.pop("work"))
        res[name].update(t, bound_ms=b_ms, bound_by=b_by, shape=shapes[name])
    for name in KERNELS:
        rows[name]["d256"] = res[name]
    ptxas = [line for line in _build.build_info()["ptxas"]
             if "Li256E" in line]
    emit("kernels_d256", checked=len(checked), head_dim=d,
         tolerances="as phase 3: forward f32 2e-5, bf16 1e-4; B3, B7 3e-4; "
                    "dead rows exact",
         library={"B1": "scaled_dot_product_attention(is_causal), o only, "
                        "kv heads repeated: causal without the prefix",
                  "B2.sdpa_fwd_device_ms": "the same call: a reference "
                                           "without lse or the merge",
                  "B3": "autograd backward of scaled_dot_product_attention"
                        "(is_causal, enable_gqa), timed alone, without the "
                        "prefix",
                  "B4/B6.gathered_sdpa_device_ms": "references: SDPA on "
                                                   "the pages' keys "
                                                   "gathered beforehand",
                  "B5": "scaled_dot_product_attention with the boolean "
                        "mask, kv heads repeated beforehand",
                  "B7": "autograd backward of scaled_dot_product_attention"
                        " with the boolean mask, kv heads repeated"},
         occupancy=occupancy, ptxas_d256=ptxas, kernels=res)



RING_GRAD_TOL = 1e-2


def phase_ring(dev):
    import torch

    from repro_torch.core import startrail as st
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.kernels import ref

    N, window, c, r = 2048, 1024, 2, 2
    mesh = ThreadMesh(c, r)
    p = mesh.size
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((1, N, 32, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((1, N, 8, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((1, N, 8, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((1, N, 32, 80), generator=g, device=dev).bfloat16()
    cfg = st.StarTrailConfig(seq_len=N, seq_scheme="zigzag", causal=True,
                             window=window, block_impl="cuda")

    def rank_fn(comm):
        gi, ji, ti = (comm.axis_index(a) for a in cfg.axes)
        rank = (gi * r + ji) * c + ti
        pos = st.shard_positions(rank, N, p, "zigzag").to(dev)
        o, res = st.startrail_forward(q[:, pos].contiguous(),
                                      k[:, pos].contiguous(),
                                      v[:, pos].contiguous(), cfg, comm)
        grads = st.startrail_backward(res, o, do[:, pos].contiguous(), cfg,
                                      comm)
        return pos, o, grads

    counts = reset_counts()
    t0 = time.perf_counter()
    res = mesh.run(rank_fn, timeout=300)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(counts)
    out = torch.empty_like(q)
    grads = [torch.empty(t.shape, device=dev) for t in (q, k, v)]
    for pos, o, gs in res:
        out[:, pos] = o
        for full, gr in zip(grads, gs):
            full[:, pos] = gr
    want = ref.mha_reference(q, k, v, causal=True, window=window)
    # both outputs are rounded to bf16 once: allow a bf16 ulp (2^-7
    # relative) twice over, plus 1e-3 absolute near zero
    diff = (out.float() - want.float()).abs()
    lim = 1e-3 + (want.float().abs() / 64)
    err = float(diff.max())
    check(bool((diff <= lim).all()), f"ring: max err {err} beyond bf16 tol")
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o_ref = ref.mha_reference(*leaves, causal=True, window=window)
    want_g = torch.autograd.grad(o_ref, leaves, do.float())
    del o_ref, leaves
    grad_err = {}
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_g):
        grad_err[name] = float((a - b).abs().max() / b.abs().max())
        check(bool(torch.isfinite(a).all())
              and grad_err[name] <= RING_GRAD_TOL,
              f"ring {name}: max err / max |ref| {grad_err[name]} beyond "
              f"{RING_GRAD_TOL}")
    check(launches == launches_of(B2=p * r, B3=p * r),
          f"ring launches {launches}: want B2 {p * r} and B3 {p * r} (every "
          f"ring step of every rank) and nothing else")
    emit("ring", c=c, r=r, P=p, N=N, window=window, dtype="bfloat16",
         max_abs_err=err, tol="1e-3 + |ref|/64",
         grad_err_over_max=grad_err, grad_tol=RING_GRAD_TOL,
         launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# phase 4b: the pipelined ring, its overlap and the overlap-aware search
# ---------------------------------------------------------------------------

# h2o-danube-1.8b's attention at full width, P = 8: (name, scheme, C,
# placement); each at comm_chunks 1 and 2, with the ring pipelined and not
OVERLAP_ARRANGEMENTS = (("st_team_inner", "startrail", 2, "team_inner"),
                        ("st_ring_inner", "startrail", 2, "ring_inner"),
                        ("ring", "ring", 1, "team_inner"))
OVERLAP_CHUNKS = (1, 2)
# the search's size: the autotune phase's 2 layers; the analytical best
# and worst, one timed step each after one warm-up (the script's time)
OVERLAP_AUTOTUNE = {"top_k": 1, "steps": 1, "warmup": 1,
                    "comm_chunk_grid": (1, 2)}


def _ring_fwd_bwd(plan, q, k, v, do, dev):
    """Every rank's explicit StarTrail forward and backward under
    ``plan``'s arrangement, chunks and issue order (phase_ring's run):
    [(o, dq, dk, dv)] in thread order, and the launches."""
    import torch

    from repro_torch.core import startrail as st

    c, r, p, n = plan.c, plan.r, plan.sp_size, q.shape[1]
    st_cfg = st.StarTrailConfig(seq_len=n, seq_scheme="zigzag", causal=True,
                                block_impl="cuda",
                                comm_chunks=plan.comm_chunks,
                                pipeline=plan.pipeline_scan)

    def rank_fn(comm):
        gi, ji, ti = (comm.axis_index(a) for a in st_cfg.axes)
        pos = st.shard_positions((gi * r + ji) * c + ti, n, p,
                                 "zigzag").to(dev)
        o, res = st.startrail_forward(
            *(t[:, pos].contiguous() for t in (q, k, v)), st_cfg, comm)
        return (o,) + tuple(st.startrail_backward(
            res, o, do[:, pos].contiguous(), st_cfg, comm))

    counts = reset_counts()
    out = plan.build_mesh().run(rank_fn, timeout=300)
    torch.cuda.synchronize()
    return out, read_counts(counts)


def phase_overlap(dev, smi):
    """The ring's two issue orders at full width, and what the card hides.

    1. For each of ``OVERLAP_ARRANGEMENTS`` at P = 8 (StarTrail C = 2 in
       both placements, the ring C = 1) and comm_chunks 1 and 2:
       h2o-danube-1.8b's attention (32q/8kv heads of 80, seq 4096, batch
       1, bf16, zigzag, causal) forward and backward on every rank with
       the pipelined order and the unpipelined one: the output and the
       three gradients equal bit for bit, and each run launches B2 and B3
       P*R times each and nothing else (phase_ring's count); then
       ``obs.commlog.overlap_report`` of the plan in each order: the
       structural fraction of the forward's block calls inside a
       transfer's window ((R-1)/R pipelined, 0 not) and the timed one (the
       split-phase copies' device time on the comm streams under a
       kernel; unpipelined, every copy is synchronous, on the compute
       stream, and none may appear on a comm stream), with the fwd+bwd
       device ms and wall time, as the host paces the run and queued
       behind a device sleep (the card paced).
    2. One full-width h2o value-and-gradient of the train step at
       train_sp's depth, P = 8 at (2, 2), under ``pipeline_scan=False``
       and under the default pipelined order, from the same weights and
       batch: the loss and every gradient leaf equal bit for bit.
    3. ``autotune(overlap_frac=<the host-paced timed fraction of the
       model's default arrangement, pipelined, whole transfers>,
       comm_chunk_grid=(1, 2))``
       at the autotune phase's 2 layers; the winner's plan file reloads
       equal, records the fraction and trains one step through
       ``launch.train --plan``."""
    import dataclasses
    import math
    import pathlib
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models.factory import build_model
    from repro_torch.obs import commlog
    from repro_torch.plan import ExecutionPlan, autotune, make_plan
    from repro_torch.train import step as train_step

    t_phase = time.perf_counter()
    full = registry.get(ARCH)
    shape = _train_shape(TRAIN_SEQ)
    n = shape.seq_len
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn((1, n, h, full.head_dim_), generator=g,
                               device=dev).bfloat16()
                   for h in (full.num_heads, full.num_kv_heads,
                             full.num_kv_heads, full.num_heads))
    grid, launches = [], None
    for name, scheme, c, placement in OVERLAP_ARRANGEMENTS:
        for chunks in OVERLAP_CHUNKS:
            plans = {pipe: make_plan(
                full, shape, arch=ARCH, n_devices=ULYSSES_P, c=c,
                scheme=scheme, placement=placement if c > 1 else None,
                comm_chunks=chunks, pipeline_scan=pipe)
                for pipe in (True, False)}
            p, r = plans[True].sp_size, plans[True].r
            runs = {pipe: _ring_fwd_bwd(plan, q, k, v, do, dev)
                    for pipe, plan in plans.items()}
            want = launches_of(B2=p * r, B3=p * r)
            for pipe, (_, got) in runs.items():
                check(got == want,
                      f"overlap {name} chunks {chunks} pipeline {pipe}: "
                      f"launches {got}, want {want} (every ring step of "
                      f"every rank) and nothing else")
            same = all(torch.equal(a, b)
                       for ra, rb in zip(runs[True][0], runs[False][0])
                       for a, b in zip(ra, rb))
            check(same, f"overlap {name} chunks {chunks}: the pipelined "
                  f"ring's output or gradients differ from the "
                  f"unpipelined ring's")
            if launches is None:
                launches = runs[True][1]
            del runs
            reports = {}
            for pipe, plan in plans.items():
                rep = commlog.overlap_report(full, plan, batch=1, device=dev)
                frac = rep["overlap_fraction"]
                check(frac == ((r - 1) / r if pipe else 0.0)
                      and rep["ranks_agree"],
                      f"overlap {name} chunks {chunks} pipeline {pipe}: "
                      f"structural fraction {frac}, want "
                      f"{(r - 1) / r if pipe else 0.0}")
                # pipelined, the ring's copies run on the comm streams;
                # unpipelined, every transfer copies on the compute stream
                timed, queued = rep["timed"], rep["timed_queued"]
                check(all((t["copies"] > 0) == pipe
                          and 0.0 <= t["timed_overlap_fraction"] <= 1.0
                          for t in (timed, queued)),
                      f"overlap {name} chunks {chunks} pipeline {pipe}: "
                      f"timed {timed}, queued {queued}")
                keep = ("timed_overlap_fraction", "device_busy_ms",
                        "kernel_ms", "copy_ms", "copy_hidden_ms", "copies",
                        "wall_s")
                reports[pipe] = {
                    "overlap_fraction": frac,
                    "backward_overlap_fraction": rep["backward"][
                        "overlap_fraction"],
                    "permutes_total": rep["permutes_total"],
                    "permutes_with_overlap_window": rep[
                        "permutes_with_overlap_window"],
                    "host_paced": {k: timed[k] for k in keep},
                    "queued": dict({k: queued[k] for k in keep},
                                   host_ahead=queued["host_ahead"])}
            grid.append({"arrangement": name, "scheme": scheme, "C": c,
                         "R": r, "placement": placement,
                         "comm_chunks": chunks, "bit_equal": same,
                         "pipelined": reports[True],
                         "unpipelined": reports[False]})
            free_device()
    del q, k, v, do
    default = make_plan(full, shape, arch=ARCH, n_devices=ULYSSES_P,
                        comm_chunks=1)
    measured_frac = next(
        e["pipelined"]["host_paced"]["timed_overlap_fraction"] for e in grid
        if (e["C"], e["placement"], e["comm_chunks"]) ==
        (default.c, default.placement, 1))
    grid_s = time.perf_counter() - t_phase

    # 2. the train step's value and gradients in both orders
    cfg = dataclasses.replace(full, num_layers=TRAIN_SP_LAYERS)
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=ULYSSES_P,
                     c=TRAIN_SP_C, placement="team_inner", comm_chunks=1)
    model = build_model(cfg, device=dev, seed=0)
    batch = train_step.to_device(SyntheticLM(
        cfg, shape, seed=0, seq_scheme=plan.seq_scheme,
        sp_size=plan.sp_size).get_batch(0), dev)
    vg, train_launches = {}, {}
    t0 = time.perf_counter()
    for pipe in (True, False):
        run_cfg = dataclasses.replace(plan.run_config(), pipeline_scan=pipe)
        fn = train_step.build_mesh_value_and_grad_fn(
            model, run_cfg, shape, ThreadMesh(plan.c, plan.r),
            timeout=TRAIN_SP_TIMEOUT)
        counts = reset_counts()
        vg[pipe] = fn(batch)
        torch.cuda.synchronize()
        train_launches[pipe] = read_counts(counts)
    train_s = time.perf_counter() - t0
    L = cfg.num_layers
    want = _schemes_launches("startrail", plan, L)
    check(all(v == want for v in train_launches.values()),
          f"overlap train launches {train_launches}: want {want}")
    names = [nm for nm, _ in model.named_parameters()]
    differ = [nm for nm, a, b in zip(names, vg[True][1], vg[False][1])
              if not torch.equal(a, b)]
    loss = {pipe: float(vg[pipe][0]) for pipe in vg}
    check(torch.equal(vg[True][0], vg[False][0]) and not differ
          and math.isfinite(loss[True]),
          f"overlap train: --no-pipeline loss {loss[False]} vs pipelined "
          f"{loss[True]}, gradients differ in {differ}")
    del vg, model, batch
    free_device()

    # 3. the overlap-aware search and its plan file
    cfg = dataclasses.replace(full, num_layers=SCHEMES_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        counts = reset_counts()
        t0 = time.perf_counter()
        tuned = autotune.autotune(
            cfg, shape, arch=ARCH, n_devices=ULYSSES_P,
            top_k=OVERLAP_AUTOTUNE["top_k"], steps=OVERLAP_AUTOTUNE["steps"],
            warmup=OVERLAP_AUTOTUNE["warmup"], overlap_frac=measured_frac,
            comm_chunk_grid=OVERLAP_AUTOTUNE["comm_chunk_grid"],
            out_dir=tmp, device=dev)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        search = read_counts(counts)
        per_run = OVERLAP_AUTOTUNE["warmup"] + OVERLAP_AUTOTUNE["steps"]
        want = launches_of()
        for e in tuned["measured"]:
            for kk, vv in _schemes_launches(e["plan"].scheme, e["plan"],
                                            cfg.num_layers).items():
                want[kk] += vv * per_run
        check(search == want, f"overlap autotune launches {search}: want "
              f"{want}")
        # the analytical best and worst, each ring at both chunk counts
        ranked = [e["arrangement"] for e in tuned["analytical"]]
        pairs = sorted((a.key, n) for a in {ranked[0], ranked[-1]}
                       for n in OVERLAP_AUTOTUNE["comm_chunk_grid"]
                       if n == 1 or a.scheme != "ulysses")
        got_pairs = sorted((e["arrangement"].key, e["comm_chunks"])
                           for e in tuned["measured"])
        check(got_pairs == pairs, f"overlap autotune measured {got_pairs}: "
              f"want {pairs}")
        winner = ExecutionPlan.load(tuned["path"])
        filed = json.loads(pathlib.Path(tuned["path"]).read_text())
        check(winner == tuned["plan"]
              and filed["overlap_frac"] == measured_frac,
              f"plan file {tuned['path']} reloads as {winner}, not "
              f"{tuned['plan']}, or records overlap "
              f"{filed.get('overlap_frac')} for {measured_frac}")
        free_device()
        counts = reset_counts()
        t0 = time.perf_counter()
        with _registry_depth(SCHEMES_LAYERS):
            out = launch_train.main(["--plan", str(tuned["path"]),
                                     "--steps", "1", "--device", dev.type])
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        trained = read_counts(counts)
    want = _schemes_launches(winner.scheme, winner, SCHEMES_LAYERS)
    check(out["step"] == 1 and math.isfinite(out["loss"])
          and trained == want,
          f"overlap launch.train --plan: step {out['step']} loss "
          f"{out['loss']}, launches {trained}: want one finite step and "
          f"{want}")
    emit("overlap", model=ARCH, P=ULYSSES_P,
         shape={"seq_len": n, "batch": 1, "heads": [full.num_heads,
                                                    full.num_kv_heads],
                "head_dim": full.head_dim_, "dtype": "bfloat16"},
         grid=grid, grid_s=grid_s, launches=launches,
         train={"layers": TRAIN_SP_LAYERS, "C": plan.c, "R": plan.r,
                "loss": {"pipelined": loss[True],
                         "unpipelined": loss[False]},
                "leaves": len(names), "bit_equal": True,
                "launches_per_order": {
                    "pipelined": train_launches[True],
                    "unpipelined": train_launches[False]},
                "seconds": train_s},
         autotune={"overlap_frac": measured_frac,
                   "from": f"C={default.c} {default.placement} pipelined "
                           f"comm_chunks 1", **OVERLAP_AUTOTUNE,
                   "measured": [{"arrangement": e["arrangement"].key,
                                 "comm_chunks": e["comm_chunks"],
                                 "measured_s_per_step": e["measured_s"],
                                 "analytical_s_per_layer": e[
                                     "analytical_s"]}
                                for e in tuned["measured"]],
                   "winner": winner.to_dict(), "search_s": search_s,
                   "launches": search,
                   "plan_step": {"loss": out["loss"], "wall_s": plan_s,
                                 "launches": trained}},
         card=smi, seconds=time.perf_counter() - t_phase)
    return {"overlap": launches, "overlap_train": train_launches[True],
            "overlap_autotune": search, "overlap_autotune_plan": trained}


# ---------------------------------------------------------------------------
# phase 4a: the kernel layer's entries with per-row (B, S) positions
# ---------------------------------------------------------------------------

def phase_ragged_bwd(dev):
    """``dispatch.block_fwd`` (B5) and ``dispatch.block_bwd`` (B7) with
    (B, S) positions at the full width's heads. delta is taken from the f32
    o, so the backward is the exact gradient of attention in f32 at the
    bf16 inputs: autograd through the plain version of the same function
    differs only in the order of the sums (BWD_TOL)."""
    import torch

    from repro_torch.kernels import dispatch, ref

    b, sq, _, hq, hkv, window, offs, _ = ragged_bwd_cases()["path_4x1024"]
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, sq, hq, 80), generator=g, device=dev).bfloat16()
    k = torch.randn((b, sq, hkv, 80), generator=g, device=dev).bfloat16()
    v = torch.randn((b, sq, hkv, 80), generator=g, device=dev).bfloat16()
    do = torch.randn((b, sq, hq, 80), generator=g, device=dev).bfloat16()
    pos = (torch.tensor(offs, dtype=torch.int32, device=dev)[:, None]
           + torch.arange(sq, dtype=torch.int32, device=dev)[None])
    kw = dict(causal=True, window=window, impl="cuda")
    counts = reset_counts()
    t0 = time.perf_counter()
    o, lse = dispatch.block_fwd(q, k, v, pos, pos, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o).contiguous()
    got = dispatch.block_bwd(q, k, v, do, lse, delta, pos, pos, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(counts)
    check(launches == launches_of(B5=1, B7=1),
          f"ragged_bwd launches {launches}: want B5 1 and B7 1")
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o_ref, _ = ref.block_attention(*leaves, pos, pos, causal=True,
                                   window=window)
    want = torch.autograd.grad(o_ref, leaves, do.float())
    del o_ref, leaves
    err, ok, _ = grad_err(got, want, lse, BWD_TOL)
    check(ok and all(bool(torch.isfinite(t).all()) for t in got),
          f"ragged_bwd: gradients max err {err} against autograd of the "
          f"plain version (tol {BWD_TOL})")
    emit("ragged_bwd", rows=b, seq=sq, offsets=offs, heads=[hq, hkv],
         head_dim=80, window=window, dtype="bfloat16", max_abs_err=err,
         tol=BWD_TOL, launches=launches, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# phase 5: the engine at full width
# ---------------------------------------------------------------------------

def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ragged_bwd as rb
    from repro_torch.kernels import ragged_prefill as rp

    mods = (fa, pd, rp, pp, rb)
    for m in mods:
        m.reset_launches()
    return tuple(m.LAUNCHES for m in mods)


def read_counts(counts):
    out = {}
    for c in counts:
        out.update(c)
    return dict(out)


def launches_of(**counts):
    """The launch counts of a path that runs only the kernels named."""
    return {n: counts.get(n, 0) for n in KERNELS}


def _cached_launches(engine, cold):
    """A run's launches when ``cold`` prompts prefill whole (B2) and every
    other prefill is a suffix prefill (B6 and B1) over its cached pages."""
    L, m = engine.cfg.num_layers, engine.metrics
    return launches_of(B1=L * (m.prefill_chunks - cold), B2=L * cold,
                       B4=L * m.decode_steps,
                       B6=L * (m.prefill_chunks - cold))


def p1_launches(engine):
    """One card: C = R = 1, so each layer's StarTrail forward is one ring
    step through B2 (merging into the empty accumulator), and each decode
    step runs B4 once a layer."""
    L, m = engine.cfg.num_layers, engine.metrics
    return launches_of(B2=L * m.prefills, B4=L * m.decode_steps)


def drive_engine(engine, smi, reqs, want, what, profile_steps=0,
                 later=()):
    """Serve ``reqs`` (then ``later``, each queued once every earlier
    request's prefill has completed) step by step, with every count set to
    0 just before and read just after; profile the first ``profile_steps``
    steps that decode with no prefill queued or in flight. Each request
    must stream its ``max_new_tokens`` in-vocab tokens, and the launches
    must equal ``want(engine)``. Returns the streams, the first-token
    hidden states, the launch counts and the run's record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid,
                                                          h.float().clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pending = list(later)
    decode_ms, window = [], None
    in_window = {"wall_s": 0.0, "decode_steps": 0, "decode_wall_s": 0.0,
                 "tokens": 0}
    counts = reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    while not engine.idle() or pending:
        if pending and engine.metrics.prefills == len(reqs) + len(later) \
                - len(pending):
            r = pending.pop(0)
            check(engine.add_request(r) is None, f"{r.uid} rejected")
        active = engine.scheduler.active()
        # a step that only decodes: nothing queued, every prefill done
        pure = not engine.scheduler.queue and bool(active) \
            and all(st.cache_len > 0 for st in active)
        profiled = pure and window is None and profile_steps > 0
        t1 = time.perf_counter()
        if profiled:
            m = engine.metrics
            before = (m.decode_steps, m.decode_wall_s, m.tokens_out)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(profile_steps):
                    engine.step()
                torch.cuda.synchronize()
            window = _profile_window(prof, profile_steps,
                                     time.perf_counter() - t1)
            del prof
            # the window's steps and the reading of its trace
            in_window = {"wall_s": time.perf_counter() - t1,
                         "decode_steps": m.decode_steps - before[0],
                         "decode_wall_s": m.decode_wall_s - before[1],
                         "tokens": m.tokens_out - before[2]}
            emitted = [True]
        else:
            emitted = engine.step()
            if pure:
                decode_ms.append(1e3 * (time.perf_counter() - t1))
        check(bool(emitted) or bool(engine.scheduler.active()),
              "engine stalled")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    engine.on_prefill = None
    out = engine.collect()
    vocab = engine.cfg.vocab_size
    for r in (*reqs, *later):
        toks = out.get(r.uid, [])
        check(len(toks) == r.max_new_tokens
              and all(0 <= t < vocab for t in toks),
              f"{what} {r.uid}: {len(toks)} tokens, want "
              f"{r.max_new_tokens} in-vocab")
    m = engine.metrics
    expected = want(engine)
    check(launches == expected,
          f"{what} launches {launches}: want {expected} ({m.prefills} "
          f"prefills, {m.prefill_chunks} chunks, {m.decode_steps} decode "
          f"steps)")
    rec = {"P_sp": engine.sp, "C": engine.plan.c, "R": engine.plan.r,
           "scheme": engine.plan.scheme,
           "comm_chunks": engine.plan.comm_chunks, "wall_s": wall,
           "prefills": m.prefills, "prefill_chunks": m.prefill_chunks,
           "decode_steps": m.decode_steps, "prefill_s": m.prefill_wall_s,
           "ttft_s": dict(engine.ttft_s),
           "decode_step_wall_ms_median": (statistics.median(decode_ms)
                                          if decode_ms else None),
           "decode_step_profile": window, "profiled": in_window,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "card": smi}
    return out, hidden, launches, rec


def phase_engine(dev, smi):
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = registry.get(ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng_cfg = EngineConfig(pages_per_shard=512)
    plan_kw = dict(arch=cfg.name, c=1, decode_batch=4, page_size=16,
                   max_len=2048)
    engine = Engine(model, make_serve_plan(cfg, **plan_kw), eng_cfg)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator), then a clean run
    engine.add_request(Request("warm", rng.integers(0, cfg.vocab_size,
                                                    64).tolist(), 4))
    engine.run()
    engine.reset()
    plens = [64, 200, 336, 472, 608, 744, 880, 1024]
    reqs = [Request(f"req{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                    32) for i, n in enumerate(plens)]
    # the process's first profiler start takes seconds: keep it out of
    # the profiled decode window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    out, _, launches, rec = drive_engine(engine, smi, reqs, p1_launches,
                                         "engine", profile_steps=4)
    m, prof = engine.metrics, rec["profiled"]
    # the mean step and the rate leave out the profiled window and the
    # reading of its trace, so they compare with runs that profiled
    # nothing; wall_s is the whole run
    emit("engine", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s, requests=len(reqs),
         prompt_lens=plens, new_tokens=32, launches=launches,
         prefills=m.prefills, decode_steps=m.decode_steps,
         ttft_s=rec["ttft_s"],
         mean_decode_step_ms=1e3 * (m.decode_wall_s - prof["decode_wall_s"])
         / max(m.decode_steps - prof["decode_steps"], 1),
         decode_step_wall_ms_median=rec["decode_step_wall_ms_median"],
         decode_step_profile=rec["decode_step_profile"],
         prefill_s=m.prefill_wall_s, wall_s=rec["wall_s"],
         profiled_wall_s=prof["wall_s"],
         tokens_per_s=(m.tokens_out - prof["tokens"])
         / (rec["wall_s"] - prof["wall_s"]),
         max_memory_allocated=rec["max_memory_allocated"], card=smi)
    return engine, reqs, out, launches, rec


SAMPLE_MIX = {"temperature": 0.9, "top_k": (0, 16, 32),
              "top_p": (1.0, 0.9, 0.8), "seed": 100}
# the 0.999 quantile of chi-square with 7 degrees of freedom: 8 categories
CHI2_999_DF7 = 24.3
SAMPLE_DRAWS = {"vocab": 32000, "rows": 4, "draws": 4096, "top_k": 8,
                "top_p": 0.4}


def sampled_mix(reqs):
    """``check_engine_mixed``'s sampling settings on ``reqs``: even
    requests greedy, odd ones at temperature 0.9 with top-k 0/16/32 and
    top-p 1.0/0.9/0.8 in turn, seeds 100 + i."""
    import dataclasses

    mix = SAMPLE_MIX
    return [dataclasses.replace(
        r, temperature=0.0 if i % 2 == 0 else mix["temperature"],
        top_k=mix["top_k"][i % 3], top_p=mix["top_p"][i % 3],
        seed=mix["seed"] + i) for i, r in enumerate(reqs)]


def solo_streams(engine, reqs, before_step=None):
    """Each request served alone on ``engine``, ``before_step(engine)``
    called before every step. Returns uid -> stream and uid -> [(step,
    wall ms)] of the steps that only decode."""
    out, walls = {}, {}
    for r in reqs:
        engine.reset()
        check(engine.add_request(r) is None, f"{r.uid} rejected")
        walls[r.uid] = []
        while not engine.idle():
            if before_step is not None:
                before_step(engine)
            pure = bool(engine.scheduler.active()) \
                and not engine.scheduler.queue
            step = engine.metrics.steps
            t0 = time.perf_counter()
            engine.step()
            if pure:
                walls[r.uid].append((step, 1e3 * (time.perf_counter() - t0)))
        out[r.uid] = engine.collect()[r.uid]
    return out, walls


def _median_ms(walls, keep):
    """Median of ``solo_streams``' step walls for which ``keep(uid, step)``."""
    ms = [w for uid, ws in walls.items() for step, w in ws if keep(uid, step)]
    return statistics.median(ms) if ms else None


def _sample_draws(dev):
    """``engine.sampling.sample`` on CUDA tensors at V = 32000, 4 rows:
    4096 draws at temperature 1 with top-k 8 (every draw in the top 8, and
    the chi-square of the counts against the softmax over those 8 below
    its 0.999 quantile) and with top-p 0.4 (every draw in the nucleus);
    each draw keyed by (row, draw) through ``fold_in``."""
    import types

    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.startrail import StarTrailConfig
    from repro_torch.dist.comm import SingleComm
    from repro_torch.engine import sampling
    from repro_torch.models.runtime import Runtime

    d = SAMPLE_DRAWS
    V, B = d["vocab"], d["rows"]
    logits = 3.0 * np.random.default_rng(3).normal(size=V).astype(np.float32)
    cfg = ModelConfig(name="draws", family="dense", num_layers=1,
                      d_model=1, num_heads=1, num_kv_heads=1, d_ff=1,
                      vocab_size=V)
    rt = Runtime(comm=SingleComm(), st_cfg=StarTrailConfig(
        seq_len=8, seq_scheme="contiguous"), device=dev)
    head = types.SimpleNamespace(
        table=torch.from_numpy(logits[:, None]).to(dev))
    x = torch.ones(B, 1, 1, device=dev)

    def rows(v, dt):
        return torch.full((B,), v, dtype=dt, device=dev)

    def draw(top_k, top_p):
        toks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(d["draws"] // B):
            keys = [sampling.fold_in(sampling.seed_key(b), i)
                    for b in range(B)]
            toks.append(sampling.sample(
                rt, head, x, cfg, temperature=rows(1.0, torch.float32),
                top_k=rows(top_k, torch.int32),
                top_p=rows(top_p, torch.float32), keys=keys)[:, 0])
        toks = torch.cat(toks).cpu().numpy()
        ms = 1e3 * (time.perf_counter() - t0) / (d["draws"] // B)
        return toks, ms

    top = np.argsort(-logits)[:d["top_k"]]
    k_toks, k_ms = draw(d["top_k"], 1.0)
    check(np.isin(k_toks, top).all(), f"sample: top-k {d['top_k']} drew "
          f"{sorted(set(k_toks) - set(top))[:5]} outside the top {d['top_k']}")
    p = np.exp(logits[top].astype(np.float64) - logits[top].max())
    p /= p.sum()
    counts = np.array([(k_toks == t).sum() for t in top])
    chi2 = float(((counts - len(k_toks) * p) ** 2
                  / (len(k_toks) * p)).sum())
    check(chi2 < CHI2_999_DF7, f"sample: chi-square {chi2:.2f} of the top-k "
          f"draws against the softmax, bound {CHI2_999_DF7}")
    probs = np.exp(logits.astype(np.float64) - logits.max())
    probs /= probs.sum()
    order = np.argsort(-probs)
    nucleus = order[:int(np.searchsorted(np.cumsum(probs[order]),
                                         d["top_p"]) + 1)]
    p_toks, p_ms = draw(0, d["top_p"])
    check(np.isin(p_toks, nucleus).all(),
          f"sample: top-p {d['top_p']} drew outside its {len(nucleus)}-token "
          "nucleus")
    return {**d, "chi2_top_k": chi2, "chi2_bound": CHI2_999_DF7,
            "top_k_counts": counts.tolist(), "top_k_expected":
            (len(k_toks) * p).tolist(), "nucleus_size": len(nucleus),
            "distinct_top_p_draws": int(len(set(p_toks.tolist()))),
            "ms_per_call": {"top_k": k_ms, "top_p": p_ms}}


def _launch_serve_flags(dev):
    """``launch.serve`` in-process on the card at smoke width with the
    sampling and observability flags; ``--kernel ref``, as the smoke
    model's head size 16 is not one the kernels take."""
    import tempfile

    from repro_torch import obs
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as tmp:
        prom, trace = (os.path.join(tmp, n) for n in ("m.prom", "t.json"))
        out = serve.main(["--arch", ARCH, "--smoke", "--device", dev.type,
                          "--kernel", "ref", "--requests", "4",
                          "--temperature", "0.8", "--top-k", "40",
                          "--top-p", "0.9", "--metrics-dump", prom,
                          "--trace-out", trace])
        parsed = obs.parse_prometheus(open(prom).read())
        events = json.load(open(trace))["traceEvents"]
    n_tok = sum(len(v) for v in out.values())
    check(parsed[("engine_tokens_out_total", ())] == n_tok
          and sum(e["ph"] == "b" for e in events) == len(out)
          == sum(e["ph"] == "e" for e in events),
          f"launch.serve: {parsed.get(('engine_tokens_out_total', ()))} "
          f"tokens counted, {n_tok} streamed; request spans unmatched")
    return {"requests": len(out), "tokens": n_tok,
            "trace_events": len(events)}


def phase_sample(engine, smi, reqs, greedy_out, greedy_rec):
    """Sampled decoding on the engine phase's model and plan (P = 1):
    the engine phase's 8 prompts and budgets with ``sampled_mix``'s
    settings, through an engine with an ``obs.Registry`` and an enabled
    ``Tracer``. The greedy requests' streams must equal the engine phase's
    (another batch: that is their batch invariance), every sampled
    request's must equal serving it alone; the registry's and the trace's
    counts must match the run. Beside: the decode-step wall and device ms
    of this mixed window against the engine phase's all-greedy window (the
    same steps: the same prompts and budgets), the tracer on against
    ``NULL_TRACER`` on alternate steps of the solo runs, ``sample``
    on CUDA tensors (``_sample_draws``), and ``launch.serve`` with the
    flags. Returns the mixed run's launch counts."""
    import tempfile

    from repro_torch import obs
    from repro_torch.engine import Engine

    reg, tracer = obs.Registry(), obs.Tracer(enabled=True)
    eng = Engine(engine.model, engine.plan, engine.eng, registry=reg,
                 tracer=tracer)
    sreqs = sampled_mix(reqs)
    out, _, launches, rec = drive_engine(eng, smi, sreqs, p1_launches,
                                         "sample", profile_steps=4)
    for i, r in enumerate(sreqs):
        if i % 2 == 0:
            check(out[r.uid] == greedy_out[r.uid], f"sample: greedy "
                  f"{r.uid}'s stream differs from the engine phase's")
    check(any(out[r.uid] != greedy_out[r.uid] for r in sreqs[1::2]),
          "sample: every sampled stream equals its greedy stream")
    m = eng.metrics
    with tempfile.TemporaryDirectory() as tmp:
        reg.dump(os.path.join(tmp, "m.prom"))
        reg.dump(os.path.join(tmp, "m.json"), fmt="json")
        tracer.dump(os.path.join(tmp, "trace.json"))
        parsed = obs.parse_prometheus(open(os.path.join(tmp, "m.prom"))
                                      .read())
        events = json.load(open(os.path.join(tmp, "trace.json"))
                           )["traceEvents"]
    n_tok = sum(len(v) for v in out.values())
    got = {k: parsed[(k, ())] for k in (
        "engine_tokens_out_total", "serve_ttft_seconds_count",
        "serve_intertoken_seconds_count")}
    check(got == {"engine_tokens_out_total": n_tok,
                  "serve_ttft_seconds_count": m.prefills,
                  "serve_intertoken_seconds_count": n_tok - m.prefills},
          f"sample: dumped metrics {got}: {n_tok} tokens streamed, "
          f"{m.prefills} prefills")
    begins = sorted(e["args"]["uid"] for e in events if e["ph"] == "b")
    ends = [e for e in events if e["ph"] == "e"]
    steps = sum(e["name"] == "engine/step" for e in events)
    check(begins == sorted(r.uid for r in sreqs) and len(ends) == len(sreqs)
          and {e["id"] for e in ends} == {e["id"] for e in events
                                          if e["ph"] == "b"}
          and steps == m.steps,
          f"sample: trace has {len(begins)} request begins, {len(ends)} "
          f"ends, {steps} engine/step spans for {m.steps} steps")
    spans_per_step = len(events) / m.steps
    quantiles = m.latency_quantiles()

    # each sampled request alone, the tracer on for even steps and off for
    # odd
    tracer.clear()

    def toggle(e):
        e.tracer = tracer if e.metrics.steps % 2 == 0 else obs.NULL_TRACER

    sampled = [r for r in sreqs if r.temperature > 0]
    solo, walls = solo_streams(eng, sampled, toggle)
    eng.tracer = tracer
    for r in sampled:
        check(solo[r.uid] == out[r.uid], f"sample: {r.uid} alone gives "
              f"{solo[r.uid][:8]}..., in the mix {out[r.uid][:8]}...")
    draws = _sample_draws(eng.device)
    flags = _launch_serve_flags(eng.device)
    emit("sample", model=eng.cfg.name, requests=len(sreqs),
         settings=[{"uid": r.uid, "temperature": r.temperature,
                    "top_k": r.top_k, "top_p": r.top_p, "seed": r.seed}
                   for r in sreqs], launches=launches,
         greedy_equal_engine_phase=True, sampled_solo_equal_mixed=True,
         decode_step_wall_ms_median={
             "all_greedy": greedy_rec["decode_step_wall_ms_median"],
             "mixed": rec["decode_step_wall_ms_median"]},
         decode_window={"all_greedy": greedy_rec["decode_step_profile"],
                        "mixed": rec["decode_step_profile"]},
         tracer={"solo_decode_step_wall_ms_median": {
             "on": _median_ms(walls, lambda u, s: s % 2 == 0),
             "off": _median_ms(walls, lambda u, s: s % 2 == 1)},
             "steps_each": sum(len(w) for w in walls.values()) / 2,
             "events_per_step": spans_per_step},
         metrics=got, latency_quantiles=quantiles, draws=draws,
         launch_serve=flags, wall_s=rec["wall_s"], card=smi)
    del eng
    return launches


def next_token(engine, prompt, rt=None):
    """(hidden state, logits) of ``prompt``'s next token, both f32."""
    last, _ = engine.prefill_hidden(prompt, rt=rt)
    return last.float(), _logits(engine, last)


def _logits(engine, hidden):
    """The (1, V) f32 logits of a (1, 1, D) next-token hidden state."""
    import torch

    from repro_torch.engine import sampling

    with torch.no_grad():
        logits, _ = sampling.shard_logits(engine.rt, engine.model.head,
                                          hidden, engine.cfg)
    return logits


def compare(got, want, what, tol=None, strict=True,
            names=("hidden", "logits")):
    """Relative L2 error and largest error over the largest magnitude of
    each pair (the hidden state and the logits), checked against ``tol``
    (default ``ENGINE_TOL``) unless ``strict`` is off (then reported, with
    ``within_tol``)."""
    import torch

    tol = tol or ENGINE_TOL
    errs = {}
    for i, name in enumerate(names):
        a, b = got[i], want[i]
        errs[name] = {"rel_l2": float((a - b).norm() / b.norm()),
                      "max_abs_over_max": float((a - b).abs().max()
                                                / b.abs().max())}
        ok = bool(torch.isfinite(a).all()) and all(
            errs[name][k] <= tol[k] for k in tol)
        if strict:
            check(ok, f"{what} {name}: {errs[name]} beyond {tol}")
        else:
            errs[name]["within_tol"] = ok
    return errs


# bf16 keeps 8 significant bits (2^-8 ~ 4e-3 relative per rounding). Two
# routes round each layer's attention output from f32 sums taken in another
# order; a rounding that flips travels down the 24 layers' residual stream.
# Allow 2e-2 relative in the L2 norm (about five roundings' worth) and 5e-2
# of the largest magnitude for the single worst element. These checks catch
# a wrong kernel on the engine's path; the kernels' own precision is held to
# 1e-4 in phase 3.
ENGINE_TOL = {"rel_l2": 2e-2, "max_abs_over_max": 5e-2}


def phase_engine_check(engine, prompt, phase="engine_check", strict=True):
    """The CUDA kernels against the plain versions, same weights and card
    (reported, not checked, when ``strict`` is off)."""
    import dataclasses

    from repro_torch.engine import Engine

    ref_engine = Engine(engine.model, dataclasses.replace(
        engine.plan, kernel_impl="ref", block_impl="ref"), engine.eng)
    got = next_token(engine, prompt)
    want = next_token(ref_engine, prompt)
    errs = compare(got, want, f"{phase} cuda vs ref", strict=strict)
    emit(phase, prompt_len=len(prompt), err=errs, tol=ENGINE_TOL,
         strict=strict,
         argmax_equal=bool(got[1].argmax() == want[1].argmax()))
    return got


def phase_local(engine, prompt, startrail_route):
    """The local-mode prefill (B1 per layer) against the engine's StarTrail
    prefill (B2 per layer) of the same prompt."""
    import dataclasses

    import torch

    rt = dataclasses.replace(engine.rt, attention_impl="local")
    counts = reset_counts()
    got = next_token(engine, prompt, rt=rt)
    torch.cuda.synchronize()
    launches = read_counts(counts)
    L = engine.cfg.num_layers
    check(launches == launches_of(B1=L),
          f"local prefill launches {launches}: want B1 {L} and nothing else")
    errs = compare(got, startrail_route, "local vs StarTrail prefill")
    emit("local", prompt_len=len(prompt), launches=launches, err=errs,
         tol=ENGINE_TOL,
         argmax_equal=bool(got[1].argmax() == startrail_route[1].argmax()))
    return launches


def _device_events(prof):
    """(name, ms) of every device event (kernel, copy, memset) of a
    finished ``torch.profiler`` window, read from the profiler's raw
    events: a window of ~10^5 launches parses in about a second, not the
    tens of seconds ``prof.events()`` takes to build its event tree."""
    import torch

    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            yield evt.name(), evt.duration_ns() / 1e6


def _profile_window(prof, steps, wall_s, top=12):
    import collections

    per_name = collections.defaultdict(lambda: [0.0, 0])
    for name, ms in _device_events(prof):
        rec = per_name[name]
        rec[0] += ms
        rec[1] += 1
    check(bool(per_name), "torch.profiler recorded no device activity")
    device_ms = sum(v[0] for v in per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "steps": steps,
        "wall_ms_per_step": 1e3 * wall_s / steps,
        "device_ms_per_step": device_ms / steps,
        "idle_share": 1.0 - device_ms / (1e3 * wall_s),
        "kernel_launches_per_step": sum(v[1] for v in per_name.values())
        / steps,
        "top_kernels": [{"name": n[:90], "ms_per_step": v[0] / steps,
                         "calls_per_step": v[1] / steps}
                        for n, v in ranked],
    }


def phase_profile(engine, smi, prompt_len=1024, decode_steps=8):
    """Where the engine's time goes: ``torch.profiler`` over the last
    admission's prefill plus one decode step with the other slots busy,
    then over ``decode_steps`` decode steps with every slot active."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Request

    engine.reset()
    rng = np.random.default_rng(2)
    slots = engine.eng.max_slots

    def request(uid):
        return Request(uid, rng.integers(0, engine.cfg.vocab_size,
                                         prompt_len).tolist(),
                       decode_steps + 4)

    for i in range(slots - 1):
        engine.add_request(request(f"p{i}"))
    engine.step()                           # admits all but the last slot
    engine.add_request(request("last"))
    act = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    windows = (("prefill_and_decode_step", 1), ("decode", decode_steps))
    for name, steps in windows:
        with profile(activities=act) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit("profile", window=name, prompt_len=prompt_len, slots=slots,
             card=smi, **_profile_window(prof, steps, wall))
    engine.run()


PREFIX_LEN, PREFIX_CHUNK = 1024, 256
PREFIX_SUFFIXES = [64, 128, 192, 256, 320, 384, 448, 512]


def _prefix_engine(model, prefix_cache):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=ARCH, c=1, decode_batch=4,
                           page_size=16, max_len=2048,
                           prefix_cache=prefix_cache)
    return Engine(model, plan, EngineConfig(pages_per_shard=512,
                                            prefill_chunk=PREFIX_CHUNK))


def _alone_ttft(engine, prompts):
    """TTFT of each prompt served alone (one new token) in ``engine``."""
    from repro_torch.engine import Request

    out = []
    for prompt in prompts:
        uid = f"alone{len(engine.ttft_s)}"
        check(engine.add_request(Request(uid, prompt, 1)) is None,
              f"{uid} rejected")
        engine.run()
        out.append(engine.ttft_s[uid])
    return out


def phase_prefix(model, smi, reps=3):
    """The engine with the prefix cache and chunked prefill at full width:
    8 greedy requests sharing a 1024-token prefix, each with its own suffix.
    Requests that arrive once the prefix is registered prefill only their
    suffix (B6 for the cached pages, B1 for the suffix itself); every
    request's first token and next-token hidden state are held against a
    monolithic prefill of its prompt. Then TTFT of one request alone, with
    the prefix cached and without the cache (no claim)."""
    import numpy as np
    import torch

    from repro_torch.engine import Request

    cfg = model.cfg
    engine = _prefix_engine(model, prefix_cache=True)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    reqs = [Request(f"pre{i}", shared
                    + rng.integers(0, cfg.vocab_size, n).tolist(), 32)
            for i, n in enumerate(PREFIX_SUFFIXES)]
    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid,
                                                          h.float().clone())
    counts = reset_counts()
    t0 = time.perf_counter()
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    engine.on_prefill = None
    m = engine.metrics
    stats = m.to_dict()
    ttft_run = {r.uid: engine.ttft_s[r.uid] for r in reqs}
    cached = {r.uid: engine.scheduler.finished[r.uid].cached_len
              for r in reqs}
    for r in reqs:
        toks = out.get(r.uid, [])
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"{r.uid}: {len(toks)} tokens, want 32 in-vocab")
    check(m.prefill_tokens_cached > 0 and launches["B6"] > 0,
          f"prefix: {m.prefill_tokens_cached} cached tokens, B6 launched "
          f"{launches['B6']} times")
    cold = sum(1 for c in cached.values() if c == 0)
    want = _cached_launches(engine, cold)
    check(launches == want, f"prefix launches {launches}: want {want} "
          f"({cold} leading chunks of {m.prefill_chunks}, "
          f"{m.decode_steps} decode steps)")
    errs = {}
    for r in reqs:
        want_h = next_token(engine, r.tokens)
        got = (hidden[r.uid], _logits(engine, hidden[r.uid]))
        errs[r.uid] = compare(got, want_h, f"prefix {r.uid} vs monolithic")
        check(out[r.uid][0] == int(want_h[1].argmax()),
              f"prefix {r.uid}: first token {out[r.uid][0]} is not the "
              f"monolithic prefill's argmax {int(want_h[1].argmax())}")
    ttft = {}
    for name, pc in (("cached", True), ("uncached", False)):
        eng = engine if pc else _prefix_engine(model, prefix_cache=False)
        ttft[name] = {}
        for n in (64, 256, 512):
            prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
                       for _ in range(reps)]
            ttft[name][n] = statistics.median(_alone_ttft(eng, prompts))
        del eng
    emit("prefix", model=cfg.name, prefix_len=PREFIX_LEN,
         prefill_chunk=PREFIX_CHUNK, suffix_lens=PREFIX_SUFFIXES,
         new_tokens=32, launches=launches, cached_len=cached,
         **{k: stats[k] for k in (
             "prefill_tokens_cached", "prefill_tokens_computed",
             "prefill_chunks", "prefills", "decode_steps",
             "prefix_hit_rate", "prefill_wall_s", "decode_wall_s")},
         ttft_s=ttft_run,
         alone_ttft_median_s={"suffix_tokens": [64, 256, 512], **ttft},
         err_vs_monolithic=errs, tol=ENGINE_TOL, wall_s=wall, card=smi)
    return launches


LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN = 4, 1024, 32


def phase_legacy(engine, smi):
    """The static-batch path (``launch.serve.legacy_generate``) at full
    width: 4 prompts of 1024 tokens, 32 greedy tokens, B5 once per layer
    and decode step. Its first decode step's hidden state and token are
    held against the engine's prefill of the prompt and first token."""
    import numpy as np
    import torch

    from repro_torch.engine import Request
    from repro_torch.launch.serve import legacy_generate, legacy_start

    model, cfg = engine.model, engine.cfg
    dev = model.device
    B, S, G = LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, S))).to(dev)
    plan = engine.plan
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = legacy_generate(model, plan, tokens, G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    check(tuple(out.shape) == (B, G)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"legacy tokens {tuple(out.shape)}: want ({B}, {G}) in-vocab")
    L = cfg.num_layers
    want = launches_of(B2=L, B5=L * (G - 1))
    check(launches == want, f"legacy launches {launches}: want {want} (one "
          f"batched prefill, B5 once per layer in each of {G - 1} decode "
          f"steps)")
    # the first decode step's hidden state, by the same steps
    tok0, caches, decode = legacy_start(model, plan, tokens, G)
    h1 = decode(caches, tok0.long(), torch.full((B,), S, dtype=torch.int32,
                                               device=dev),
                return_hidden=True)
    # host ms of 8 further decode steps, each ending in its tokens on the
    # host (the legacy loop keeps them on the card until the end)
    tok = tok0.long()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(8):
        tok = decode(caches, tok, torch.full((B,), S + 1 + i,
                                             dtype=torch.int32,
                                             device=dev)).long()
        tok.cpu()
    step_ms = 1e3 * (time.perf_counter() - t1) / 8
    del caches
    # the engine: the same prompts, two tokens each
    engine.reset()
    for b in range(B):
        engine.add_request(Request(f"leg{b}", tokens[b].tolist(), 2))
    eng_out = engine.run()
    errs, same = {}, True
    for b in range(B):
        uid = f"leg{b}"
        check(eng_out[uid][0] == int(out[b, 0]),
              f"legacy row {b}: prefill token {int(out[b, 0])} != the "
              f"engine's {eng_out[uid][0]}")
        want_h = next_token(engine, tokens[b].tolist() + [eng_out[uid][0]])
        got = (h1[b:b + 1].float(), _logits(engine, h1[b:b + 1]))
        errs[uid] = compare(got, want_h, f"legacy row {b} decode step")
        same &= int(got[1].argmax()) == int(want_h[1].argmax()) \
            == eng_out[uid][1] == int(out[b, 1])
    check(same, "legacy first decode tokens differ from the engine's")
    emit("legacy", model=cfg.name, batch=B, prompt_len=S, new_tokens=G,
         launches=launches, wall_s=wall, tokens_per_s=B * G / wall,
         decode_step_ms=step_ms, err_vs_engine=errs, tol=ENGINE_TOL,
         card=smi)
    return launches


# ---------------------------------------------------------------------------
# phase 8c: the pinned-host KV tier, the handoff and preemption
# ---------------------------------------------------------------------------

# The pressure sequence at full width: a family prompt (a 1024-token prefix
# and its own 16-token tail), two 1536-token evictors (deeper chains, so the
# cost-aware eviction unwinds the family's first), the family again with a
# new tail. The tight pool (100 pages of 16) cannot hold the family beside
# an evictor, the roomy one (512) never evicts.
HOST_TIER = {"prefix": 1024, "tail": 16, "evictor": 1536, "new": 8,
             "tight_pages": 100, "roomy_pages": 512,
             "tier_bytes": 256 << 20, "reps": 3}
HANDOFF_PLENS = [512, 640, 896, 1024]          # 16 new tokens each
HANDOFF_NEW = 16
PREEMPT = {"plens": [320, 448, 576, 704], "new": 16, "at": 6,
           "temperature": 0.8, "top_k": 40, "top_p": 0.9}


def _serve_engine(model, pages, prefix_cache=False, tier_bytes=0,
                  tracer=None):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=ARCH, c=1, decode_batch=4,
                           page_size=16, max_len=2048,
                           prefix_cache=prefix_cache,
                           host_tier_bytes=tier_bytes)
    return Engine(model, plan, EngineConfig(pages_per_shard=pages),
                  tracer=tracer)


def _pressure_requests(vocab, rep):
    import numpy as np

    from repro_torch.engine import Request

    h = HOST_TIER
    rng = np.random.default_rng(11 + rep)
    fam = rng.integers(0, vocab, h["prefix"]).tolist()
    return [Request(f"h0.{rep}", fam + rng.integers(0, vocab, h["tail"])
                    .tolist(), h["new"]),
            *[Request(f"e{i}.{rep}", rng.integers(0, vocab, h["evictor"])
                      .tolist(), h["new"]) for i in range(2)],
            Request(f"h1.{rep}", fam + rng.integers(0, vocab, h["tail"])
                    .tolist(), h["new"])]


def _serve_pressure(engine, rep):
    """The pressure sequence on a fresh ``engine``, each request served to
    the end before the next arrives; every count set to 0 just before and
    read just after. Returns the streams, the re-arrival's first-token
    hidden state, TTFT and where it went (from the engine's spans: the
    admission, its evictions' spills included, is the TTFT less the
    ``engine/prefill`` span, which holds ``engine/host_reload``), cached
    and host-hit tokens, and the launches."""
    import torch

    reqs = _pressure_requests(engine.cfg.vocab_size, rep)
    again = reqs[-1]
    engine.tracer.clear()
    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid,
                                                          h.float().clone())
    torch.cuda.synchronize()
    counts = reset_counts()
    out = {}
    for r in reqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
        out.update(engine.run())
    torch.cuda.synchronize()
    launches = read_counts(counts)
    engine.on_prefill = None
    st = engine.scheduler.finished[again.uid]
    cold = sum(1 for r in reqs
               if engine.scheduler.finished[r.uid].cached_len == 0)
    want = _cached_launches(engine, cold)
    check(launches == want, f"host_tier rep {rep} launches {launches}: "
          f"want {want}")
    for r in reqs:
        check(len(out[r.uid]) == r.max_new_tokens,
              f"{r.uid}: {len(out[r.uid])} tokens")
    span = {e["name"]: e["dur"] / 1e3 for e in engine.tracer.events()
            if e.get("ph") == "X" and e.get("args", {}).get("uid")
            == again.uid}
    ttft_ms = 1e3 * engine.ttft_s[again.uid]
    reload_ms = span.get("engine/host_reload", 0.0)
    parts = {"admission_ms": ttft_ms - span["engine/prefill"],
             "reload_ms": reload_ms,
             "prefill_ms": span["engine/prefill"] - reload_ms}
    return {"out": out, "hidden": hidden[again.uid],
            "ttft": engine.ttft_s[again.uid], "ttft_parts": parts,
            "cached_len": st.cached_len,
            "host_len": st.host_len, "launches": launches,
            "uids": [r.uid for r in reqs]}


def _link_rates(conn):
    """Per op: pages, bytes, summed seconds of ``kv_transfer_seconds`` and
    bytes over them, against ``hw.HOST_LINK_BW``. Spills time dispatch to
    commit (the next step's flush), so only the synchronous ops give a
    link rate: export (d2h), reload and inject (h2d)."""
    from repro_torch.roofline import hw

    reg = conn.registry
    lat = reg.get("kv_transfer_seconds")
    out = {}
    for op in ("spill", "reload", "handoff_out", "handoff_in"):
        n = int(reg.get("kv_transfer_pages_total").value(op=op))
        if not n:
            continue
        nbytes = int(reg.get("kv_transfer_bytes_total").value(op=op))
        s, count = lat.value(op=op), lat.count(op=op)
        out[op] = {"pages": n, "bytes": nbytes, "seconds": s,
                   "transfers": count}
        if op == "spill":
            out[op]["mean_dispatch_to_commit_s"] = s / count
        else:
            out[op].update(GB_per_s=nbytes / s / 1e9,
                           of_host_link=nbytes / s / hw.HOST_LINK_BW)
    return out


def _token_share(got, want):
    pairs = [(a, b) for u in want for a, b in zip(got[u], want[u])]
    return sum(a == b for a, b in pairs) / len(pairs)


def phase_host_tier(model, smi):
    """The host KV tier at full width (module doc, phase 8c): the pressure
    sequence through a roomy pool, the tight pool with a 256 MiB tier and
    the tight pool without it; the prefill -> decode handoff between two
    engines against a unified one; preemption of a greedy and a sampled
    request mid-decode, each resumed. Returns the launches of each run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.engine import Request

    t_phase = time.perf_counter()
    cfg, h = model.cfg, HOST_TIER
    L = cfg.num_layers
    by_path = {}
    # --- 1. the tier under pressure
    engines = {name: _serve_engine(model, pages, True, tier,
                                   obs.Tracer(enabled=True))
               for name, pages, tier in (
                   ("roomy", h["roomy_pages"], 0),
                   ("tier", h["tight_pages"], h["tier_bytes"]),
                   ("off", h["tight_pages"], 0))}
    runs = {}
    for name, engine in engines.items():
        reps = [_serve_pressure(engine, 0)]
        runs[name] = {"reps": reps, "stats": engine.connector.stats(),
                      "rates": _link_rates(engine.connector),
                      "metrics": engine.metrics.to_dict()}
        by_path["host_tier" if name == "tier" else f"host_tier_{name}"] = \
            reps[0]["launches"]
        for rep in range(1, h["reps"] if name != "roomy" else 1):
            engine.reset()
            reps.append(_serve_pressure(engine, rep))
    # d2h over the link, synchronously: the last re-arrival's registered
    # blocks exported from the tier engine
    tier_eng = engines["tier"]
    last = _pressure_requests(cfg.vocab_size, h["reps"] - 1)[-1]
    tier_eng.connector.export(tier_eng.prefix_cache.match(
        tier_eng.prefix_cache.hashes(last.tokens)))
    runs["tier"]["rates"]["handoff_out"] = \
        _link_rates(tier_eng.connector)["handoff_out"]
    roomy, tier, off = (runs[n]["reps"][0] for n in ("roomy", "tier", "off"))
    check(tier["out"] == roomy["out"],
          "host tier streams differ from the roomy pool's")
    ts, os_ = runs["tier"]["stats"], runs["off"]["stats"]
    fam_blocks = h["prefix"] // 16
    check(ts["spill_pages"] >= fam_blocks and ts["reload_pages"]
          >= fam_blocks and ts["hit_tokens"] >= h["prefix"],
          f"host tier stats {ts}: want the family's {fam_blocks} blocks "
          f"spilled and reloaded")
    check(os_["hit_tokens"] == 0, f"tier-off host hits {os_}")
    check(tier["host_len"] == tier["cached_len"] == h["prefix"]
          and tier["launches"]["B6"] >= L,
          f"the re-arrival's cached {tier['cached_len']} / host "
          f"{tier['host_len']} tokens, B6 {tier['launches']['B6']}: B6 must "
          f"run on the {h['prefix']} reloaded tokens")
    off_err = None
    if off["out"] != roomy["out"]:
        # the tier-off engine prefills the family again, cold, at another
        # length: cuBLAS may pick other GEMM algorithms
        ref = engines["roomy"]
        off_err = compare((off["hidden"], _logits(ref, off["hidden"])),
                          (roomy["hidden"], _logits(ref, roomy["hidden"])),
                          "tier-off re-arrival vs the roomy pool")
    page_bytes = tier_eng.connector.page_bytes
    del engines, tier_eng
    free_device()
    ttft = {n: statistics.median(r["ttft"] for r in runs[n]["reps"])
            for n in ("tier", "off")}
    # --- 2. the prefill -> decode handoff
    rng = np.random.default_rng(13)
    hreqs = [Request(f"p{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                     HANDOFF_NEW) for i, n in enumerate(HANDOFF_PLENS)]
    hreqs.append(Request("p_one", rng.integers(0, cfg.vocab_size, 300)
                         .tolist(), 1))
    pre = _serve_engine(model, 512)
    for r in hreqs:
        check(pre.add_request(r) is None, f"{r.uid} rejected")
    unified = pre.run()
    pre.reset()
    dec = _serve_engine(model, 512)
    torch.cuda.synchronize()
    counts = reset_counts()
    t0 = time.perf_counter()
    first = {}
    for r in hreqs:
        check(pre.add_request(dataclasses.replace(
            r, max_new_tokens=1, handoff=True)) is None, f"{r.uid} rejected")
    by_uid = {r.uid: r for r in hreqs}
    while not (pre.idle() and dec.idle()):
        for eng in (pre, dec):
            if not eng.idle():
                eng.step()
        for st in pre.take_handoffs():
            orig = by_uid[st.req.uid]
            first[orig.uid] = st.out[0]
            if orig.max_new_tokens > 1:
                blocks = pre.export_kv(st)
                pre.release_handoff(st)
                dec.add_prefilled(orig, st.out[0], blocks)
            else:
                pre.release_handoff(st)
    torch.cuda.synchronize()
    handoff_wall = time.perf_counter() - t0
    launches = read_counts(counts)
    got = dec.collect()
    streams = {u: got.get(u, [first[u]]) for u in by_uid}
    check(streams == unified, "handoff streams differ from the unified "
          "engine's")
    ps, ds = pre.connector.stats(), dec.connector.stats()
    check(dec.metrics.prefills == 0 and ps["handoff_out_pages"]
          == ds["handoff_in_pages"] > 0,
          f"handoff: decode engine prefills {dec.metrics.prefills}, pages "
          f"out {ps['handoff_out_pages']} in {ds['handoff_in_pages']}")
    want = launches_of(B2=L * pre.metrics.prefills,
                       B4=L * dec.metrics.decode_steps)
    check(launches == want, f"handoff launches {launches}: want {want}")
    by_path["handoff"] = launches
    handoff = {"requests": len(hreqs), "prompt_lens": HANDOFF_PLENS + [300],
               "new_tokens": HANDOFF_NEW, "wall_s": handoff_wall,
               "handoff_out_pages": ps["handoff_out_pages"],
               "handoff_in_pages": ds["handoff_in_pages"],
               "decode_prefills": dec.metrics.prefills,
               "handoffs_out": pre.metrics.handoffs_out,
               "handoffs_in": dec.metrics.handoffs_in,
               "rates": {**_link_rates(pre.connector),
                         **_link_rates(dec.connector)},
               "launches": launches}
    del pre, dec
    free_device()
    # --- 3. preemption mid-decode, greedy and sampled
    p = PREEMPT
    rng = np.random.default_rng(17)
    preqs = [Request(f"g{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                     p["new"]) if i % 2 == 0 else
             Request(f"s{i}", rng.integers(0, cfg.vocab_size, n).tolist(),
                     p["new"], temperature=p["temperature"], top_k=p["top_k"],
                     top_p=p["top_p"], seed=40 + i)
             for i, n in enumerate(p["plens"])]
    engine = _serve_engine(model, 512, prefix_cache=True)
    for r in preqs:
        check(engine.add_request(r) is None, f"{r.uid} rejected")
    whole = engine.run()
    engine.reset()
    hidden = {}
    engine.on_prefill = lambda uid, hs: hidden.__setitem__(
        uid, hs.float().clone())
    torch.cuda.synchronize()
    counts = reset_counts()
    for r in preqs:
        engine.add_request(r)
    for _ in range(p["at"]):
        engine.step()
    victims = ("g0", "s1")
    before, resumes = {}, {}
    for uid in victims:
        st = next(s for s in engine.scheduler.active() if s.req.uid == uid)
        check(st.cache_len > 0 and not st.done, f"{uid} is not mid-decode")
        before[uid] = list(st.out)
        resumes[uid] = engine.preempt(uid)
    cached_before = engine.metrics.prefill_tokens_cached
    for uid in victims:
        check(engine.add_request(resumes[uid]) is None, f"{uid} rejected")
    out = engine.run()
    torch.cuda.synchronize()
    launches = read_counts(counts)
    engine.on_prefill = None
    resumed = {r.uid: before.get(r.uid, []) + out[r.uid] for r in preqs}
    m = engine.metrics
    check(m.prefill_tokens_cached > cached_before and m.preemptions == 2,
          f"preempt: cached {cached_before} -> {m.prefill_tokens_cached}, "
          f"{m.preemptions} preemptions")
    cold = sum(1 for r in preqs if r.uid not in victims) + len(victims)
    want = _cached_launches(engine, cold)
    check(launches == want, f"preempt launches {launches}: want {want}")
    by_path["preempt"] = launches
    for r in preqs:
        if r.uid not in victims:
            check(resumed[r.uid] == whole[r.uid],
                  f"{r.uid} (not preempted) changed")
    resume_err = {}
    for uid in victims:
        if resumed[uid] != whole[uid]:
            # the tail block is recomputed by a prefill where the
            # uninterrupted run wrote it with decode steps: hold the
            # resume's first hidden state against a monolithic prefill
            want_h = next_token(engine, resumes[uid].tokens)
            resume_err[uid] = compare(
                (hidden[uid], _logits(engine, hidden[uid])), want_h,
                f"preempt resume {uid} vs monolithic")
    preempt = {"prompt_lens": p["plens"], "new_tokens": p["new"],
               "preempted_at_step": p["at"], "victims": list(victims),
               "resume_lens": {u: len(resumes[u].tokens) for u in victims},
               "equal_streams": {u: resumed[u] == whole[u] for u in victims},
               "token_share": _token_share(resumed, whole),
               "resume_err_vs_monolithic": resume_err,
               "prefill_tokens_cached": m.prefill_tokens_cached,
               "launches": launches}
    del engine
    free_device()
    emit("host_tier", model=cfg.name, page_bytes=page_bytes, **h,
         streams_equal_roomy=True,
         off_streams_equal=off["out"] == roomy["out"],
         off_token_share=_token_share(off["out"], roomy["out"]),
         off_err_vs_roomy=off_err, tol=ENGINE_TOL,
         rearrival={"cached_len": tier["cached_len"],
                    "host_len": tier["host_len"]},
         rearrival_ttft_s={n: [r["ttft"] for r in runs[n]["reps"]]
                           for n in ("tier", "off")},
         rearrival_ttft_median_s=ttft,
         rearrival_ttft_parts_ms={n: [r["ttft_parts"]
                                      for r in runs[n]["reps"]]
                                  for n in ("tier", "off")},
         tier_stats=ts, off_stats=os_, rates=runs["tier"]["rates"],
         tier_metrics={k: runs["tier"]["metrics"][k] for k in (
             "prefill_tokens_host", "prefill_tokens_cached",
             "prefill_tokens_computed", "prefix_evictions")},
         launches={n: runs[n]["reps"][0]["launches"] for n in runs},
         handoff=handoff, preempt=preempt,
         seconds=time.perf_counter() - t_phase, card=smi)
    return by_path


# ---------------------------------------------------------------------------
# phase 18: the gateway and the process-separated front end
# ---------------------------------------------------------------------------

GATEWAY = {"system": 1024, "tails": [64, 128, 192, 256], "new": 32,
           "slots": 4, "page": 16, "pages": 512, "max_len": 2048}
FRONTEND = {"plens": [64, 256, 448, 640, 832, 1024], "new": 16,
            "sampled": (1, 4), "temperature": 0.8, "top_k": 40,
            "top_p": 0.9, "kill_after": 2, "timeout_s": 300}
PRIORITY = {"batch_plens": [256, 320, 384, 448], "batch_new": 24,
            "interactive_plen": 128, "interactive_new": 8, "at": 4,
            "slo_ms": 1.0, "slo_plen": 1024}
HTTP_SMOKE_TIMEOUT_S = 240


def _gw_plan(cfg, **kw):
    from repro_torch.plan import make_serve_plan

    g = GATEWAY
    return make_serve_plan(cfg, arch=ARCH, c=1, decode_batch=g["slots"],
                           page_size=g["page"], max_len=g["max_len"], **kw)


def _gw_eng():
    from repro_torch.engine import EngineConfig

    return EngineConfig(pages_per_shard=GATEWAY["pages"])


def _gateway_launches(engines, cold):
    """The launches of engines whose ``cold`` prompts prefill whole (B2)
    and whose every other prefill is a suffix prefill over cached pages
    (B6 and B1), each decode step B4 (``_cached_launches`` summed)."""
    L = engines[0].cfg.num_layers
    chunks = sum(e.metrics.prefill_chunks for e in engines)
    return launches_of(B1=L * (chunks - cold), B2=L * cold,
                       B4=L * sum(e.metrics.decode_steps for e in engines),
                       B6=L * (chunks - cold))


def _pure_decode(engines):
    """Every engine only decodes this step: nothing queued, handed in or
    mid-prefill, and some slot decoding."""
    busy = False
    for e in engines:
        s = e.scheduler
        if s.queue or s.prefilled or e._prefilling:
            return False
        busy = busy or bool(s.active())
    return busy


def _step_walls(step, engines, idle):
    """Drive ``step`` until ``idle()``; the wall ms of each step that only
    decodes (``_pure_decode`` before it)."""
    import torch

    walls = []
    while not idle():
        pure = _pure_decode(engines)
        t0 = time.perf_counter()
        emitted = step()
        torch.cuda.synchronize()
        if pure:
            walls.append(1e3 * (time.perf_counter() - t0))
        check(bool(emitted) or any(e.scheduler.active() or
                                   e.scheduler.prefilled for e in engines),
              "stalled")
    return walls


def replay(orch, replicas, **orch_kw):
    """Serve ``orch``'s admitted traffic again on ``replicas`` (in-process
    ``LocalReplica``s of the same seed's model): each request is submitted
    before the tick it was submitted at (``_Stream.submitted_step``) with
    its class, sampling and session, and each replica that died is killed
    before the tick its death was noticed at (``Orchestrator.deaths``), so
    the router, the admissions and the failovers follow the recorded run
    and every replica runs the same batches. Returns {rid -> stream}. A
    death noticed inside a submission is not replayed exactly."""
    from repro_torch.frontend.orchestrator import Orchestrator

    reqs = [dict(step=s.submitted_step, prompt=list(s.req.tokens),
                 max_new_tokens=s.req.max_new_tokens, cls=s.cls.name,
                 temperature=s.req.temperature, top_k=s.req.top_k,
                 top_p=s.req.top_p, seed=s.req.seed, session=s.session)
            for _, s in sorted(orch.streams.items())]
    deaths = list(orch.deaths)
    again = Orchestrator(replicas, **orch_kw)
    while reqs or not again.idle():
        for tick, i in deaths:
            if tick == again.steps and again.replicas[i].alive:
                again.replicas[i].kill()
        while reqs and reqs[0]["step"] == again.steps:
            kw = reqs.pop(0)
            kw.pop("step")
            rid = again.submit(kw.pop("prompt"), kw.pop("max_new_tokens"),
                               **kw)
            if not isinstance(rid, int):
                raise RuntimeError(f"replay: submission rejected: {rid}")
        again.step()
        if again.steps > again.max_steps:
            raise RuntimeError("replay did not drain")
    out = {rid: list(s.tokens) for rid, s in again.streams.items()}
    again.shutdown(drain=False)
    return out


def _priority_engine(model, reqs, at, victim=None, preempt_at=None):
    """Phase d's traffic straight on one ``Engine``, no orchestrator: the
    batch requests (all of ``reqs`` but the last) at tick 0, the
    interactive one after ``at`` ticks and, given ``victim``, that uid
    preempted right after it, with ``preempt_at`` tokens out, and its
    resume queued behind it, as the orchestrator's preemption tick does
    (the resume prefill recomputes the same last block). Returns the
    streams by uid and, for each of the victim's tokens, the (V,)
    ``sampling.scores`` row it was the argmax of and the logits row those
    scores came from."""
    from repro_torch.engine import Engine, sampling

    eng = Engine(model, _gw_plan(model.cfg, prefix_cache=True), _gw_eng())
    slots = eng.eng.max_slots
    calls, rows, hooked = [], [], [0]
    orig_sample, orig_greedy = sampling.sample, sampling.greedy

    def sample(rt, head, x, cfg, **kw):
        calls.append((sampling.scores(rt, head, x, cfg, **kw)[0],
                      sampling.shard_logits(rt, head, x, cfg)[0]))
        return orig_sample(rt, head, x, cfg, **kw)

    def greedy(rt, head, x, cfg):
        logits = sampling.shard_logits(rt, head, x, cfg)[0]
        calls.append((logits, logits))
        return orig_greedy(rt, head, x, cfg)

    def on_prefill(uid, _):
        # the prefill's own (B = 1) draw is the latest call
        if uid == victim:
            rows.append(tuple(t[0] for t in calls[-1]))
            hooked[0] += 1

    eng.on_prefill = on_prefill
    pre = []
    sampling.sample, sampling.greedy = sample, greedy
    try:
        for r in reqs[:-1]:
            check(eng.add_request(r) is None, f"{r.uid} rejected")
        tick = 0
        while tick <= at or not eng.idle():
            if tick == at:
                check(eng.add_request(reqs[-1]) is None, "interactive")
                if preempt_at is not None:
                    resume = eng.preempt(victim)
                    prompt = next(r for r in reqs if r.uid == victim).tokens
                    pre = resume.tokens[len(prompt):]
                    check(len(pre) == preempt_at,
                          f"{victim} had {len(pre)} tokens at tick {at}, "
                          f"the orchestrator preempted it at {preempt_at}")
                    check(eng.add_request(resume) is None, "resume")
            calls.clear()
            hooked[0] = 0
            emitted = eng.step()
            n_dec = sum(u == victim for u, _ in emitted) - hooked[0]
            if n_dec:
                dec = [c for c in calls if c[0].shape[0] == slots]
                st = next(s for s in list(eng.scheduler.active())
                          + list(eng.scheduler.finished.values())
                          if s.req.uid == victim)
                check(n_dec == 1 and len(dec) == 1, "one decode draw a step")
                rows.append(tuple(t[st.slot] for t in dec[0]))
            tick += 1
    finally:
        sampling.sample, sampling.greedy = orig_sample, orig_greedy
    out = eng.collect()
    if victim is not None:
        out[victim] = pre + out[victim]
        check([int(r[0].argmax()) for r in rows] == out[victim],
              f"{victim}'s recorded scores do not give its tokens")
    return out, rows


def _first_difference(req, off, on, rows_off, rows_on, resumed):
    """Where the preempted stream ``on`` first differs from its run without
    preemption ``off``: the two runs' sampler inputs (logits / T, T = 1
    for a greedy row) must agree within ``ENGINE_TOL``'s
    ``max_abs_over_max`` (the error the engine's logits are held to
    elsewhere), and the different tokens must be a near-tie at that
    error d: a token kept by top-k in one run and cut in the other lies
    within 2 d of each run's k-th score, and where the argmax over the
    tokens kept in both runs differs, each run's top-2 margin over them
    is at most 2 d (the gumbel noise is the same in both runs, keyed by
    seed and position). A wrong position, page or key is none of these.
    Returns the readings, each run's top-2 margin of its scores among
    them."""
    import torch

    from repro_torch.engine import sampling

    check(req.top_p >= 1.0, "the near-tie test covers top-k, not top-p")
    j = next(i for i, (a, b) in enumerate(zip(off, on)) if a != b)
    check(j >= resumed, f"differs at token {j}, before the resume at "
          f"{resumed}")
    (so, lo), (sn, ln) = ([t.float() for t in rows_off[j]],
                          [t.float() for t in rows_on[j]])
    temp = req.temperature if req.temperature > 0 else 1.0
    real = lo > sampling.NEG / 2
    zo, zn = lo[real] / temp, ln[real] / temp
    d = float((zo - zn).abs().max())
    tol = ENGINE_TOL["max_abs_over_max"] * float(
        torch.maximum(zo.abs().max(), zn.abs().max()))
    keep_o, keep_n = so > sampling.NEG / 2, sn > sampling.NEG / 2
    top_o, top_n = so.topk(2), sn.topk(2)
    rec = {"token": j, "resumed_at": resumed, "tokens": [off[j], on[j]],
           "margin_off": float(top_o.values[0] - top_o.values[1]),
           "margin_on": float(top_n.values[0] - top_n.values[1]),
           "top2_off": top_o.indices.tolist(),
           "top2_on": top_n.indices.tolist(),
           "max_abs_input_diff": d, "input_tol": tol}
    ok = d <= tol
    thr = []
    for t in sorted({off[j], on[j]}):
        if bool(keep_o[t]) == bool(keep_n[t]):
            continue
        # kept in one run only: a top-k boundary tie
        k = req.top_k
        ok = ok and 0 < k < zo.numel()
        if ok:
            gaps = [abs(float(z[t] - z.topk(k).values[-1]))
                    for z in (lo / temp, ln / temp)]
            thr.append({"token": t, "gap_to_kth_off": gaps[0],
                        "gap_to_kth_on": gaps[1]})
            ok = ok and max(gaps) <= 2 * d
    both = keep_o & keep_n
    ids = both.nonzero().flatten()
    c_o, c_n = int(ids[so[both].argmax()]), int(ids[sn[both].argmax()])
    rec["argmax_kept_in_both"] = [c_o, c_n]
    if c_o != c_n:
        m_o, m_n = float(so[c_o] - so[c_n]), float(sn[c_n] - sn[c_o])
        rec["margins_kept_in_both"] = [m_o, m_n]
        ok = ok and m_o <= 2 * d and m_n <= 2 * d
    rec["topk_boundary"] = thr
    check(ok and (thr or c_o != c_n),
          f"the preempted stream's first difference is no near-tie: {rec}")
    return rec


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(srv):
    """``srv`` (a ``FrontendServer`` on port 0) on an event loop in a
    thread of its own; returns (loop, thread) once it listens."""
    import asyncio
    import threading

    loop = asyncio.new_event_loop()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        loop.run_forever()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    for _ in range(400):
        if srv.port:
            return loop, t
        time.sleep(0.025)
    raise CheckFailed("front-end server did not come up")


def _stop_server(srv, loop, t, drain=True):
    srv.shutdown(drain=drain)
    loop.call_soon_threadsafe(loop.stop)
    t.join(30)


# phase e's launchers: the smoke model through the plain versions (its
# head size 16 is not one the kernels take), as the JAX CI's http-smoke
# runs it, and the full width through the CUDA kernels (README's command)
HTTP_LAUNCHERS = {
    "smoke": (["--smoke", "--kernel", "ref"], 4),
    "full": (["--max-slots", "4", "--page-size", "16", "--max-len", "2048"],
             4),
}


def _http_launcher(flags, port, log):
    """``launch.serve --http --workers 2`` with ``flags`` as a subprocess
    on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         *flags, "--http", "--workers", "2", "--port", str(port)], cwd=ROOT,
        env=env, stdout=log, stderr=subprocess.STDOUT, text=True)


def _http_smoke(proc, port, log_path, n_requests):
    """The launcher's front end driven by ``frontend.client --verify``
    (``n_requests`` streams against an in-process rebuild of the served
    engine), then SIGTERM: it must drain and exit 0."""
    import signal

    from repro_torch.frontend import client

    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, "launch.serve --http exited early: "
              + open(log_path).read()[-2000:])
        try:
            if client.get_json("127.0.0.1", port, "/healthz")["ok"]:
                break
        except OSError:
            pass
        check(time.perf_counter() - t0 < HTTP_SMOKE_TIMEOUT_S,
              "launch.serve --http did not come up")
        time.sleep(0.2)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.frontend.client", "--port",
         str(port), "--requests", str(n_requests), "--verify"], cwd=ROOT,
        env=env, capture_output=True, text=True,
        timeout=HTTP_SMOKE_TIMEOUT_S)
    client_s = time.perf_counter() - t1
    check(res.returncode == 0 and "bit-identical" in res.stdout,
          f"frontend.client --verify: rc {res.returncode}\n"
          f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    t2 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    drain_s = time.perf_counter() - t2
    log = open(log_path).read()
    check(rc == 0 and "drained; workers joined" in log,
          f"launch.serve --http after SIGTERM: rc {rc}\n{log[-2000:]}")
    starts = [ln for ln in log.splitlines() if "ready in" in ln]
    return {"client_lines": res.stdout.strip().splitlines(),
            "client_s": client_s, "sigterm_to_exit_s": drain_s, "rc": rc,
            "worker_lines": starts}


def phase_gateway(model, smi):
    """The gateway and the front end at full width (module doc, phase 18):
    a. two unified replicas on the card sharing ``model``, b. a
    prefill/decode pair, c. two spawned ``ProcReplica`` workers behind a
    ``FrontendServer`` with a worker killed mid-decode, d. priority
    preemption and the SLO gate in process, e. ``launch.serve --http
    --workers 2`` driven by ``frontend.client --verify`` and stopped by
    SIGTERM. The launches of the in-process runs (a, b, c's replayed
    reference, d) are counted; the worker processes' launches cannot be
    counted from this process, so c holds their streams to the replay
    instead. Returns the launches of each counted run."""
    import dataclasses
    import http.client
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from repro_torch.engine import Engine, Request
    from repro_torch.frontend import client
    from repro_torch.frontend.orchestrator import Orchestrator
    from repro_torch.frontend.protocol import make_worker_spec
    from repro_torch.frontend.server import FrontendServer
    from repro_torch.frontend.slo import (PriorityClass, SLOAdmission,
                                          parse_classes)
    from repro_torch.frontend.worker import (LocalReplica, ProcReplica,
                                             weights_digest)
    from repro_torch.gateway import Gateway
    from repro_torch.plan import make_role_plans

    t_phase = time.perf_counter()
    cfg, g = model.cfg, GATEWAY
    L = cfg.num_layers
    by_path, rec = {}, {}
    tmp = tempfile.TemporaryDirectory()
    launchers, procs = {}, []
    try:
        # --- a. two unified replicas sharing the model, prefix cache on
        rng = np.random.default_rng(23)
        system = [rng.integers(0, cfg.vocab_size, g["system"]).tolist()
                  for _ in range(2)]
        reqs = [Request(f"f{i % 2}.{i // 2}", system[i % 2] + rng.integers(
                    0, cfg.vocab_size, g["tails"][i // 2]).tolist(), g["new"])
                for i in range(8)]
        plan = _gw_plan(cfg, replicas=2, prefix_cache=True)
        gw = Gateway(model, plan, _gw_eng())
        check(all(e.model is model for e in gw.engines), "replica models")
        torch.cuda.synchronize()
        counts = reset_counts()
        t0 = time.perf_counter()
        owners = [gw.add_request(r, session=f"fam{i % 2}")
                  for i, r in enumerate(reqs)]
        gw_walls = _step_walls(gw.step, gw.engines, gw.idle)
        gw_wall = time.perf_counter() - t0
        launches = read_counts(counts)
        out = gw.collect()
        m = gw.metrics_dict()
        check(owners == [0, 1] * 4 and m["routed"] == [4, 4]
              and m["affinity_hits"] == 6,
              f"gateway routing: owners {owners}, routed {m['routed']}, "
              f"affinity hits {m['affinity_hits']}")
        check(all(p["prefill_tokens_cached"] > 0 for p in m["per_replica"]),
              f"gateway prefix hits: {m['per_replica']}")
        cold = sum(1 for e in gw.engines
                   for st in e.scheduler.finished.values()
                   if st.cached_len == 0)
        want = _gateway_launches(gw.engines, cold)
        check(launches == want, f"gateway launches {launches}: want {want}")
        by_path["gateway"] = launches
        # the reference: one engine per replica fed that replica's
        # requests at the same steps (so the same batches and cache hits)
        ref_walls, ref_out = [], {}
        for i in range(2):
            solo = Engine(model, dataclasses.replace(plan, replicas=1),
                          _gw_eng())
            for r in reqs:
                if gw._owner[r.uid] == i:
                    check(solo.add_request(r) is None, f"{r.uid} rejected")
            ref_walls.append(_step_walls(solo.step, [solo], solo.idle))
            ref_out.update(solo.collect())
            del solo
        check(out == ref_out, "gateway streams differ from one engine's "
              "per replica")
        check(all(len(out[r.uid]) == g["new"] for r in reqs),
              "gateway budgets")
        rec["replicas"] = {
            "requests": len(reqs), "system_prompt": g["system"],
            "tails": g["tails"], "new_tokens": g["new"], "routed": m["routed"],
            "affinity_hits": m["affinity_hits"],
            "prefill_tokens_cached": m["prefill_tokens_cached"],
            "prefix_hit_rate": m["prefix_hit_rate"], "wall_s": gw_wall,
            "tokens_per_s": m["tokens_out"] / gw_wall,
            "gateway_decode_step_ms_median": statistics.median(gw_walls),
            "gateway_decode_steps": len(gw_walls),
            "single_engine_decode_step_ms_median": [
                statistics.median(w) for w in ref_walls],
            "latency": gw.latency_quantiles(), "launches": launches}
        del gw
        free_device()
        # --- b. prefill/decode roles, one family
        fam = reqs[0::2]
        plans = make_role_plans(cfg, roles=["prefill", "decode"], arch=ARCH,
                                n_devices=1, c=1, decode_batch=g["slots"],
                                page_size=g["page"], max_len=g["max_len"],
                                prefix_cache=True)
        dis = Gateway(model, None, _gw_eng(), plans=plans)
        torch.cuda.synchronize()
        counts = reset_counts()
        t0 = time.perf_counter()
        owners = [dis.add_request(r) for r in fam]
        dis_out = dis.run()
        torch.cuda.synchronize()
        dis_wall = time.perf_counter() - t0
        launches = read_counts(counts)
        tier = dis.stats()["host_tier"]
        pre, dec = dis.engines
        check(owners == [0] * 4 and dis.handoffs == 4
              and tier["handoff_out_pages"] == tier["handoff_in_pages"] > 0
              and dec.metrics.prefills == 0,
              f"disaggregated: owners {owners}, {dis.handoffs} handoffs, "
              f"pages out {tier['handoff_out_pages']} in "
              f"{tier['handoff_in_pages']}, decode prefills "
              f"{dec.metrics.prefills}")
        cold = sum(1 for st in pre.scheduler.finished.values()
                   if st.cached_len == 0)
        want = _gateway_launches([pre, dec], cold)
        check(launches == want, f"disagg launches {launches}: want {want}")
        by_path["gateway_disagg"] = launches
        uni = Engine(model, _gw_plan(cfg, prefix_cache=True), _gw_eng())
        for r in fam:
            uni.add_request(r)
        check(dis_out == uni.run(), "disaggregated streams differ from a "
              "unified engine's")
        rec["disagg"] = {"requests": len(fam), "handoffs": dis.handoffs,
                         "handoff_out_pages": tier["handoff_out_pages"],
                         "handoff_in_pages": tier["handoff_in_pages"],
                         "decode_prefills": dec.metrics.prefills,
                         "wall_s": dis_wall, "launches": launches}
        del dis, pre, dec, uni
        free_device()
        # --- c. two worker processes behind the HTTP/SSE server
        f = FRONTEND
        spec = make_worker_spec(plan=_gw_plan(cfg), eng=_gw_eng(),
                                init_seed=0, smoke=False)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            procs = list(ex.map(lambda i: ProcReplica(
                i, spec, start_timeout_s=f["timeout_s"]), range(2)))
        start_s = [p.start_s for p in procs]
        start_wall = time.perf_counter() - t0
        digest = weights_digest(model)
        digests = [p.digest() for p in procs]
        check(digests == [digest] * 2,
              f"worker weights differ from the seed's: {digests} vs "
              f"{digest}")
        orch = Orchestrator(procs)
        srv = FrontendServer(orch, port=0, worker_spec=spec, workers=2)
        loop, thread = _start_server(srv)
        rng = np.random.default_rng(29)
        kws = [dict(prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=f["new"], seed=50 + i,
                    **(dict(temperature=f["temperature"], top_k=f["top_k"],
                            top_p=f["top_p"]) if i in f["sampled"] else {}))
                for i, n in enumerate(f["plens"])]
        t0 = time.perf_counter()
        first = client.generate_many("127.0.0.1", srv.port, kws,
                                     concurrency=len(kws))
        http_wall = time.perf_counter() - t0
        bad = [r for r in first if isinstance(r, Exception)]
        check(not bad, f"HTTP round 1 failed: {bad}")
        metrics = client.get_text("127.0.0.1", srv.port, "/metrics")
        check('worker="0"' in metrics and 'worker="1"' in metrics,
              "merged /metrics lacks a worker's series")
        check(not orch.deaths, f"a worker died unasked: {orch.deaths}")
        ttft = {q: orch.ttft_quantile(q) for q in (0.5, 0.95)}
        # round 2: the same requests, one worker killed mid-decode
        box = {}
        t2 = threading.Thread(target=lambda: box.update(
            res=client.generate_many("127.0.0.1", srv.port, kws,
                                     concurrency=len(kws))))
        t2.start()
        victim, orphans, t0 = None, [], time.perf_counter()
        while victim is None:
            check(time.perf_counter() - t0 < f["timeout_s"],
                  "no stream of round 2 reached mid-decode")
            with orch._lock:
                # every request of round 2 admitted (a kill inside an
                # admission would answer that request 503)
                round2 = [s for s in orch.streams.values()
                          if s.rid >= len(kws)]
                live = [s for s in round2
                        if not s.done and len(s.tokens) >= f["kill_after"]]
                if live and len(round2) == len(kws):
                    victim = live[0].replica
                    orphans = [s.rid for s in orch.streams.values()
                               if s.replica == victim and not s.done]
                    orch.replicas[victim].kill()
            time.sleep(0.002)
        t2.join(f["timeout_s"])
        second = box.get("res")
        check(second is not None and not any(
            isinstance(r, Exception) for r in second),
            "HTTP round 2 failed: " + str(second and [
                r for r in second if isinstance(r, Exception)]))
        fails = orch.registry.get("frontend_failovers_total").value()
        check(len(orch.deaths) == 1 and orch.deaths[0][1] == victim
              and fails == len(orphans) > 0
              and orch.registry.value("frontend_live_replicas") == 1,
              f"deaths {orch.deaths} (1 kill of worker {victim}), "
              f"failovers {fails} for {len(orphans)} orphaned streams")
        _stop_server(srv, loop, thread, drain=True)
        check(all(not p.proc.is_alive() for p in procs),
              "a worker did not join")
        # the reference: the recorded run replayed on two in-process
        # replicas of the same seed's model, the kill at the same tick
        locals_ = [LocalReplica(i, dict(spec, device=str(model.device)),
                                model=model) for i in range(2)]
        torch.cuda.synchronize()
        counts = reset_counts()
        want_out = replay(orch, locals_)
        torch.cuda.synchronize()
        launches = read_counts(counts)
        engines = [r.host.engine for r in locals_]
        want = launches_of(
            B2=L * sum(e.metrics.prefills for e in engines),
            B4=L * sum(e.metrics.decode_steps for e in engines))
        check(launches == want, f"front-end reference launches {launches}: "
              f"want {want}")
        by_path["frontend_ref"] = launches
        got = {r["rid"]: r["tokens"] for r in first + second}
        check(got == want_out, "HTTP streams differ from the replayed "
              "in-process run")
        n_tok = sum(len(r["tokens"]) for r in first)
        rec["frontend"] = {
            "requests_per_round": len(kws), "prompt_lens": f["plens"],
            "new_tokens": f["new"], "sampled": list(f["sampled"]),
            "worker_start_s": start_s, "workers_start_wall_s": start_wall,
            "http_round1_wall_s": http_wall,
            "http_tokens_per_s": n_tok / http_wall,
            "ttft_p50_s": ttft[0.5], "ttft_p95_s": ttft[0.95],
            "deaths": orch.deaths, "orphans": len(orphans),
            "failovers": fails, "steps": orch.steps,
            "weights_digest": digest, "reference_launches": launches}
        del locals_, engines, orch, srv
        free_device()
        # --- d. priority preemption and the SLO gate, in process
        p = PRIORITY
        dspec = make_worker_spec(plan=_gw_plan(cfg, prefix_cache=True),
                                 eng=_gw_eng(), init_seed=0, smoke=False,
                                 device=str(model.device), trace=True)
        classes = {"interactive": PriorityClass("interactive", 0),
                   "batch": PriorityClass("batch", 1, preemptible=True)}
        rng = np.random.default_rng(31)
        batch = [rng.integers(0, cfg.vocab_size, n).tolist()
                 for n in p["batch_plens"]]
        inter = rng.integers(0, cfg.vocab_size,
                             p["interactive_plen"]).tolist()

        def run(preempt):
            rep = LocalReplica(0, dspec, model=model)
            orch = Orchestrator([rep], classes=classes, preempt=preempt)
            rids = [orch.submit(b, p["batch_new"], cls="batch",
                                temperature=0.8 if i % 2 else 0.0,
                                top_k=40 if i % 2 else 0, seed=60 + i)
                    for i, b in enumerate(batch)]
            for _ in range(p["at"]):
                orch.step()
            rids.append(orch.submit(inter, p["interactive_new"],
                                    cls="interactive", seed=70))
            out = orch.run()
            return rep, orch, [out[r] for r in rids]

        _, _, off = run(False)
        free_device()
        torch.cuda.synchronize()
        counts = reset_counts()
        rep, porch, on = run(True)
        torch.cuda.synchronize()
        launches = read_counts(counts)
        n_pre = porch.registry.get("frontend_preemptions_total").value(
            cls="batch")
        eng = rep.host.engine
        victims = [s for s in porch.streams.values() if s.preemptions]
        vic_rids = {s.rid for s in victims}
        check(n_pre >= 1 and len(victims) == 1
              and victims[0].preemptions == 1,
              f"{n_pre} preemptions of {sorted(vic_rids)}: the references "
              "below re-create exactly one")
        for i, (a, b) in enumerate(zip(on, off)):
            check(a == b or i in vic_rids, f"stream {i}, not preempted, "
                  "differs from the run without preemption")
        # the references: the same traffic straight on an engine, with and
        # without the victim's preemption at the same tick, each equal to
        # its orchestrated run bit for bit (the resumed tokens included);
        # where the victim's stream differs, the first difference must be
        # a near-tie of the scores both references drew it from
        vs = victims[0]
        vuid = vs.req.uid
        reqs = [porch.streams[r].req for r in sorted(porch.streams)]
        ref_on, rows_on = _priority_engine(model, reqs, p["at"], vuid,
                                           vs.resumed)
        ref_off, rows_off = _priority_engine(model, reqs, p["at"], vuid)
        check([ref_on[r.uid] for r in reqs] == on, "the orchestrated "
              "preemption differs from an engine preempted at that tick")
        check([ref_off[r.uid] for r in reqs] == off, "the orchestrated run "
              "without preemption differs from the engine's")
        flip = None
        if on[vs.rid] != off[vs.rid]:
            flip = _first_difference(vs.req, off[vs.rid], on[vs.rid],
                                     rows_off, rows_on, vs.resumed)
        cold = sum(1 for e in rep.host.tracer.events()
                   if e.get("name") == "engine/prefill"
                   and e["args"]["cached_len"] == 0)
        want = _gateway_launches([eng], cold)
        check(launches == want, f"priority launches {launches}: want {want}")
        by_path["priority"] = launches
        # the SLO gate: a 1 ms TTFT target the priced prefill cannot meet
        slo = SLOAdmission(cfg, sp=1, page_size=g["page"],
                           decode_batch=g["slots"], kernel="cuda")
        sorch = Orchestrator([LocalReplica(0, dspec, model=model)],
                             classes=parse_classes(
            "interactive,batch", slo_ttft_ms=p["slo_ms"]), slo=slo)
        srv = FrontendServer(sorch, port=0, worker_spec=dspec, workers=0)
        loop, thread = _start_server(srv)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/generate", json.dumps(
            {"prompt": rng.integers(0, cfg.vocab_size,
                                    p["slo_plen"]).tolist(),
             "max_new_tokens": 4}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        text = resp.read().decode()
        body = json.loads(text) if resp.status != 200 else {"sse": text}
        retry_after = resp.getheader("Retry-After")
        conn.close()
        _stop_server(srv, loop, thread, drain=False)
        priced = slo.price(prompt_len=p["slo_plen"], queued_tokens=0)
        check(resp.status == 429 and body["error"] == "slo_ttft_unattainable"
              and retry_after is not None and int(retry_after) >= 1,
              f"SLO gate: {resp.status} {body} Retry-After {retry_after}")
        rec["priority"] = {"batch_prompt_lens": p["batch_plens"],
                           "preempted_at_step": p["at"],
                           "preemptions": n_pre,
                           "victims": sorted(vic_rids),
                           "equal_streams": [a == b for a, b in zip(on, off)],
                           "token_share": sum(
                               x == y for a, b in zip(on, off)
                               for x, y in zip(a, b)) / sum(map(len, off)),
                           "victim_resumed_at": vs.resumed,
                           "first_difference": flip,
                           "launches": launches,
                           "slo": {"status": resp.status, "body": body,
                                   "retry_after": retry_after,
                                   "priced_s": priced}}
        del rep, porch, sorch, eng, rows_on, rows_off
        free_device()
        # --- e. the launcher's front end, driven by its client; both
        # launchers start together (after a-d, whose timings they would
        # share the card with) and are driven one after the other
        for name, (flags, _) in HTTP_LAUNCHERS.items():
            port = _free_port()
            log_path = os.path.join(tmp.name, f"serve_{name}.log")
            log = open(log_path, "w")
            launchers[name] = (_http_launcher(flags, port, log), port,
                               log_path, log)
        for name, (proc, port, log_path, _) in launchers.items():
            rec[f"http_{name}"] = _http_smoke(proc, port, log_path,
                                              HTTP_LAUNCHERS[name][1])
    finally:
        for proc, _, _, log in launchers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
            log.close()
        tmp.cleanup()
        for proc in procs:
            if proc.proc.is_alive():
                proc.proc.kill()
                proc.proc.join(10)
    emit("gateway", model=cfg.name, page_size=g["page"], slots=g["slots"],
         **rec, seconds=time.perf_counter() - t_phase, card=smi)
    return by_path


def serving_phases(dev, smi):
    """The serving phases on one model; returns the launch counts of the
    engine, the sample phase, the local prefill, the prefix phase and the
    legacy phase, and the host_tier and gateway phases' by run (the
    engines and the model are freed after)."""
    engine, reqs, out, engine_launches, rec = phase_engine(dev, smi)
    sample_launches = phase_sample(engine, smi, reqs, out, rec)
    free_device()
    prompt = reqs[5].tokens
    startrail_route = phase_engine_check(engine, prompt)
    local_launches = phase_local(engine, prompt, startrail_route)
    phase_profile(engine, smi)
    prefix_launches = phase_prefix(engine.model, smi)
    legacy_launches = phase_legacy(engine, smi)
    model = engine.model
    del engine
    free_device()
    host_tier = phase_host_tier(model, smi)
    free_device()
    gateway = phase_gateway(model, smi)
    return (engine_launches, sample_launches, local_launches,
            prefix_launches, legacy_launches, host_tier, gateway)


# ---------------------------------------------------------------------------
# phases 9-11: training at the full width
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 4096, 4, 4
# bf16 params and grads, f32 grad accumulators and moments, the recomputed
# activations of one microbatch
TRAIN_RECKONED_BYTES = 32e9


class RepeatBatch:
    """A data source that serves one batch at every step: a loss that falls
    over a few steps shows the model learns (memorises) it."""

    def __init__(self, source):
        self.batch = source.get_batch(0)

    def get_batch(self, step):
        return self.batch


def _train_shape(seq, batch=1):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig(f"train_{seq // 1024}k_b{batch}", seq, batch, "train")


def phase_train(dev, smi):
    import math
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import trainer

    cfg = registry.get(ARCH)
    shape = _train_shape(TRAIN_SEQ, TRAIN_MICRO)
    plan = make_plan(cfg, shape, arch=ARCH, c=1, microbatches=TRAIN_MICRO)
    check(plan.remat == "attn_out", f"plan remat {plan.remat!r}: the "
          f"default is 'attn_out', as in the JAX plan")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_metrics.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=TRAIN_STEPS, log_every=TRAIN_STEPS, metrics_path=path),
            data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    check(len(recs) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}: want {TRAIN_STEPS} finite")
    check(losses[-1] < losses[0],
          f"train loss did not fall over one repeated batch: {losses}")
    L, M = cfg.num_layers, plan.microbatches
    want = launches_of(B2=2 * L * M * TRAIN_STEPS, B3=L * M * TRAIN_STEPS)
    check(launches == want, f"train launches {launches}: want {want} (per "
          f"layer and microbatch, the ring step forward twice under "
          f"recompute and backward once)")
    step_ms = [1e3 * r["step_s"] for r in recs]
    # step_s of step i is its dispatch plus the wait on step i-1; from the
    # third step on it is the steady device step
    steady = statistics.median(step_ms[2:])
    emit("train", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "C": plan.c, "R": plan.r,
               "seq_scheme": plan.seq_scheme, "block_impl": plan.block_impl,
               "remat": plan.remat, "microbatches": plan.microbatches},
         adamw={"lr": adam.learning_rate, "warmup": adam.warmup_steps,
                "state_dtype": adam.state_dtype},
         losses=losses, grad_norm=[r["grad_norm"] for r in recs],
         step_ms=step_ms, steady_step_ms=steady,
         tokens_per_s=shape.seq_len * shape.global_batch / (steady / 1e3),
         wall_s=wall, max_memory_allocated=peak,
         reckoned_bytes=TRAIN_RECKONED_BYTES, launches=launches, card=smi)
    return model, launches


def _state_bytes(tensors):
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def phase_dryrun(dev, smi):
    """Phase 31 (module doc): the production cell traced on the host, then
    the phase-9 train step predicted by its trace and measured on the
    card. Returns the measured steps' launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.roofline import hw
    from repro_torch.roofline import model as roofline

    t0 = time.perf_counter()
    rec = dryrun.lower_cell(ARCH, "decode_32k")
    trace_s = time.perf_counter() - t0
    roof = roofline.from_record(dict(rec, status="ok"))
    peak = rec["memory"]["peak_bytes_per_device"]
    emit("dryrun_cell", cell=f"{ARCH} decode_32k single pod C=2",
         devices=rec["devices"], mesh=rec["mesh"],
         kernel_impl=rec["plan"]["kernel_impl"], trace_s=trace_s,
         full_depth_trace_s=rec["compile_s"], peak_gib=peak / 2**30,
         hbm_gib=hw.HBM_BYTES / 2**30, fits=dryrun.fits(rec),
         memory=rec["memory"], flops_per_device=rec["flops_per_device"],
         bytes_accessed_per_device=rec["bytes_accessed_per_device"],
         collective_bytes=rec["collectives"]["total_bytes"],
         compute_s=roof.compute_s, memory_s=roof.memory_s,
         collective_s=roof.collective_s, dominant=roof.dominant,
         bound_s=roof.bound_s, card=smi)
    check(dryrun.fits(rec), f"dry run: {ARCH} decode_32k peak {peak} B "
          f"does not fit {hw.HBM_BYTES} B")

    cfg = registry.get(ARCH)
    shape = _train_shape(TRAIN_SEQ, TRAIN_MICRO)
    plan = make_plan(cfg, shape, arch=ARCH, c=1, microbatches=TRAIN_MICRO,
                     kernel_impl="cuda", block_impl="cuda")
    t0 = time.perf_counter()
    costs, mem = dryrun.trace_step(cfg, plan)
    step_trace_s = time.perf_counter() - t0
    bound_s = max(costs["flops"] / hw.PEAK_FLOPS_BF16,
                  costs["bytes"] / hw.HBM_BW,
                  costs["coll_total"] / hw.NVLINK_BW)
    predicted = mem["alias_bytes"] - 4         # parameters + state - step
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    step, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    measured = _state_bytes(list(model.parameters()) + opt["mu"]
                            + opt["nu"])
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {n: torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                                  shape.seq_len),
                              device=dev, generator=gen, dtype=torch.int32)
             for n in ("tokens", "labels")}
    counts = reset_counts()
    step(opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, metrics = step(opt, batch)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts(counts)
    device_ms = start.elapsed_time(end)
    max_alloc = torch.cuda.max_memory_allocated()
    ratio = mem["peak_bytes_per_device"] / max_alloc
    L, M = cfg.num_layers, plan.microbatches
    want = launches_of(B2=2 * 2 * L * M, B3=2 * L * M)
    emit("dryrun_step", shape={"seq_len": shape.seq_len,
                               "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "remat": plan.remat,
               "microbatches": M, "kernel_impl": plan.kernel_impl},
         trace_s=step_trace_s,
         predicted_param_state_bytes=predicted,
         measured_param_state_bytes=measured,
         predicted_memory=mem, max_memory_allocated=max_alloc,
         peak_ratio=ratio, traced_flops=costs["flops"],
         traced_bytes=costs["bytes"], bound_s=bound_s,
         bound_ms=bound_s * 1e3, device_ms=device_ms,
         bound_over_device=bound_s * 1e3 / device_ms,
         loss=float(metrics["loss"]), launches=launches, card=smi)
    check(predicted == measured, f"dry run: parameters and AdamW state "
          f"predicted {predicted} B, the live storages hold {measured} B")
    check(0.5 <= ratio <= 2.0, f"dry run: predicted peak "
          f"{mem['peak_bytes_per_device']} B against max_memory_allocated "
          f"{max_alloc} B (ratio {ratio:.3f}, want 0.5-2)")
    check(launches == want, f"dry run's step launches {launches}: want "
          f"{want}")
    del model, opt, sh, step, batch, metrics
    return launches


# The CUDA kernels against the plain versions through a whole model at seq
# 1024: bf16 activations round differently once the attention sums are
# taken in another order, and a flip travels down the 24 layers, so each
# gradient leaf is held to 5e-2 relative in the L2 norm and the loss to
# 2e-3 relative. These catch a wrong kernel on the training path; the
# kernels' own precision is held to 3e-4 in phase 3.
TRAIN_CHECK_TOL = {"loss_rel": 2e-3, "grad_rel_l2": 5e-2}


def phase_train_check(model, dev, phase="train_check", strict=True):
    import math

    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import step as train_step

    shape = _train_shape(1024)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, shape, seed=1).get_batch(0), dev)
    out = {}
    for impl in ("cuda", "ref"):
        vg_fn, _ = train_step.build_value_and_grad_fn(
            model, RunConfig(block_impl=impl), shape)
        out[impl] = vg_fn(batch)
    (loss_c, g_c), (loss_r, g_r) = out["cuda"], out["ref"]
    loss_rel = abs(float(loss_c) - float(loss_r)) / abs(float(loss_r))
    names = [n for n, _ in model.named_parameters()]
    rel = {n: float((a.float() - b.float()).norm() / b.float().norm())
           for n, a, b in zip(names, g_c, g_r)}
    worst = max(rel, key=rel.get)
    ok = (all(math.isfinite(x) for x in rel.values())
          and loss_rel <= TRAIN_CHECK_TOL["loss_rel"]
          and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2"])
    if strict:
        check(ok, f"{phase}: loss rel {loss_rel}, worst grad leaf {worst} "
              f"rel L2 {rel[worst]}, beyond {TRAIN_CHECK_TOL}")
    emit(phase, seq_len=shape.seq_len, batch=1, strict=strict,
         within_tol=ok,
         loss={"cuda": float(loss_c), "ref": float(loss_r)},
         loss_rel=loss_rel, loss_rel_tol=TRAIN_CHECK_TOL["loss_rel"],
         grad_rel_l2_worst={"leaf": worst, "value": rel[worst]},
         grad_rel_l2_median=statistics.median(rel.values()),
         grad_rel_l2_tol=TRAIN_CHECK_TOL["grad_rel_l2"], leaves=len(rel))


def phase_train_profile(model, dev, smi):
    """Where a train step's time goes: ``torch.profiler`` over one
    full-width step of one sequence without recompute and one with
    ``remat='attn_out'``, each after one unprofiled step; the peak memory
    of each profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    shape = _train_shape(TRAIN_SEQ)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0)
    batch = train_step.to_device(
        SyntheticLM(model.cfg, shape, seed=0).get_batch(0), dev)
    for remat in ("none", "attn_out"):
        plan = make_plan(model.cfg, shape, arch=ARCH, c=1, remat=remat)
        step_fn, sh = plan.build_train_step(model, adam)
        opt = adamw.init_state(sh["params"], adam)
        step_fn(opt, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit("train_profile", remat=remat, seq_len=shape.seq_len, batch=1,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             card=smi, **_profile_window(prof, 1, wall, top=15))
        del step_fn, sh, opt, prof
        free_device()


# Steps 3-4 after a restart against the same steps run straight through:
# the restored state is the saved one to the bit and no kernel of the step
# uses atomics, so the losses are expected equal; 1e-5 relative allows for
# a library kernel that sums in another order.
RESUME_TOL = 1e-5


def phase_resume(dev, smi):
    """Checkpoint and restart at full width with the depth cut to 2
    layers (the checkpoint ~3 GB): 4 steps straight; 2 steps with
    ``ckpt_dir``; a model initialised otherwise resumed from that
    checkpoint to step 4. Bytes written, the in-loop ``ckpt_s``, and a
    restore and a blocking save of both trees timed alone."""
    import dataclasses
    import math
    import pathlib
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import checkpoint
    from repro_torch.models.factory import build_model, jax_tree
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import trainer

    cfg = dataclasses.replace(registry.get(ARCH), num_layers=2)
    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(cfg, shape, arch=ARCH, c=1)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = SyntheticLM(cfg, shape, seed=0, seq_scheme=plan.seq_scheme,
                       sp_size=plan.sp_size)

    def run(seed, steps, ckpt_dir, path):
        model = build_model(cfg, device=dev, seed=seed)
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=steps, ckpt_every=2, ckpt_dir=ckpt_dir,
            log_every=steps, metrics_path=path), data_source=data,
            device=dev)
        with open(path) as f:
            return model, [json.loads(line) for line in f]

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        ckpt = root / "ckpt"
        _, straight = run(0, 4, None, root / "straight.jsonl")
        t0 = time.perf_counter()
        _, first = run(0, 2, str(ckpt), root / "first.jsonl")
        first_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
        model, resumed = run(1, 4, str(ckpt), root / "resumed.jsonl")
        check([r["step"] for r in resumed] == [3, 4],
              f"resume: steps {[r['step'] for r in resumed]}, want [3, 4] "
              f"(restored from step 2)")
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(resumed, straight[2:])]
        check(all(math.isfinite(x) and x <= RESUME_TOL for x in rel),
              f"resume: losses at steps 3-4 {[r['loss'] for r in resumed]} "
              f"vs straight {[r['loss'] for r in straight[2:]]}: rel {rel} "
              f"beyond {RESUME_TOL}")
        names = [n for n, _ in model.named_parameters()]
        like = jax_tree(dict(model.named_parameters()), cfg, "meta")
        opt_like = trainer.opt_tree(
            adamw.init_state([p.to("meta") for p in model.parameters()],
                             adam), names, cfg)
        t0 = time.perf_counter()
        trees = [checkpoint.restore(ckpt, 2, like),
                 checkpoint.restore(ckpt / "opt", 2, opt_like)]
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save(root / "timing", 2, trees[0])
        checkpoint.save(root / "timing" / "opt", 2, trees[1])
        save_s = time.perf_counter() - t0
        del trees, model
    emit("resume", model=cfg.name, layers=cfg.num_layers,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         remat=plan.remat, losses_straight=[r["loss"] for r in straight],
         losses_resumed={r["step"]: r["loss"] for r in resumed},
         loss_rel_diff=rel, tol=RESUME_TOL, checkpoint_bytes=nbytes,
         ckpt_s_in_loop=[r["ckpt_s"] for r in first if r["ckpt_s"]],
         first_run_s=first_s, restore_s=restore_s, blocking_save_s=save_s,
         card=smi)


# ---------------------------------------------------------------------------
# phase 13: training at SP degree 8 on a ThreadMesh on the card
# ---------------------------------------------------------------------------

# 8 of h2o's 24 layers for the script's time (PERF.md §4)
TRAIN_SP_LAYERS, TRAIN_SP_STEPS = 4, 2
TRAIN_SP_C, TRAIN_SP_R = 2, 2                  # P = C * C * R = 8 ranks
# bf16 at P = 8 against P = 1 on the same weights and batch: the ranks sum
# their bf16 MLP and vocab partials in another order and the ring merges
# attention blocks in another order, so the first step's loss is held to
# 1e-2 absolute and its global gradient norm to 2% relative. In f32 (the
# CUDA-core kernels) the loss and every gradient leaf are held to 2e-3,
# the reference's ``check_spmd_model`` bound.
TRAIN_SP_TOL = {"loss_abs": 1e-2, "grad_norm_rel": 2e-2, "f32_abs": 2e-3}
TRAIN_SP_F32 = {"layers": 2, "seq_len": 1024}
# the f32 parity's meshes, (c, r, data): P = 8 at one data replica, and 2
# replicas of P = 4 (global batch 2), under each sharding rule set
TRAIN_SP_F32_MESHES = ((2, 2, 1), (2, 1, 2))
TRAIN_SP_TIMEOUT = 180                         # s, a mesh run's limit
# the phase's P = 8 step at 8 layers with every parameter stored whole on
# every rank (CHANGES and PERF.md, PR 18-19; NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's layers under the 'default' rules
TRAIN_SP_8_LAYERS_WHOLE = {
    "layers": 8, "max_memory_allocated_GB": [23.7, 24.1],
    "device_ms_per_step": [505.6, 540.4], "f32_add_device_ms": 186.7,
    "f32_add_calls": 8924, "step_s": [4.3, 5.9]}


def _train_sp_parity(dev):
    """f32, depth 2, full width, seq 1024: the loss and every gradient
    leaf, assembled whole from the ranks' unique shards, on
    ThreadMesh(c=2, r=2) and on ThreadMesh(c=2, r=1, data=2) under each
    sharding rule set, against P = 1 on the same weights and batch (also
    the first run of the mesh's backward on the card: a deadlock fails it
    within TRAIN_SP_TIMEOUT)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.dist.sharding import RULES
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    cfg = dataclasses.replace(registry.get(ARCH), param_dtype="float32",
                              num_layers=TRAIN_SP_F32["layers"])
    model = build_model(cfg, device=dev, seed=1)
    names = [n for n, _ in model.named_parameters()]
    runs = {}
    for c, r, data in TRAIN_SP_F32_MESHES:
        shape = _train_shape(TRAIN_SP_F32["seq_len"], batch=data)
        plan = make_plan(cfg, shape, arch=ARCH, c=1)
        vg1, _ = train_step.build_value_and_grad_fn(model, plan.run_config(),
                                                    shape)
        loss1, g1 = vg1(train_step.to_device(
            SyntheticLM(cfg, shape, seed=2).get_batch(0), dev))
        p = c * c * r
        batch = train_step.to_device(
            SyntheticLM(cfg, shape, seed=2, sp_size=p).get_batch(0), dev)
        for rules in sorted(RULES):
            run_cfg = dataclasses.replace(plan.run_config(),
                                          sharding_rules=rules)
            vg8 = train_step.build_mesh_value_and_grad_fn(
                model, run_cfg, shape, ThreadMesh(c, r, data),
                timeout=TRAIN_SP_TIMEOUT)
            loss8, g8 = vg8(batch)
            errs = {n: float((a - b).abs().max())
                    for n, a, b in zip(names, g8, g1)}
            worst = max(errs, key=errs.get)
            loss_err = abs(float(loss8) - float(loss1))
            key = f"{rules}_c{c}_r{r}_data{data}"
            check(all(torch.isfinite(g).all() for g in g8)
                  and loss_err <= TRAIN_SP_TOL["f32_abs"]
                  and errs[worst] <= TRAIN_SP_TOL["f32_abs"],
                  f"train_sp f32 {key}: loss {float(loss8)} vs "
                  f"{float(loss1)}, worst leaf {worst} max abs err "
                  f"{errs[worst]}, beyond {TRAIN_SP_TOL['f32_abs']}")
            runs[key] = dict(loss={"P8": float(loss8), "P1": float(loss1)},
                             loss_abs_err=loss_err, worst_leaf=worst,
                             worst_leaf_max_abs_err=errs[worst])
            del g8
        del g1
    return dict(layers=cfg.num_layers, seq_len=TRAIN_SP_F32["seq_len"],
                leaves=len(names), runs=runs)


def _f32_add_rows(prof, steps=1):
    """Device ms and calls per step of the f32 elementwise adds in a
    profile (the mesh's psums are f32 adds)."""
    ms, calls = 0.0, 0
    for name, evt_ms in _device_events(prof):
        if "add" in name.lower() and "<float>" in name:
            ms += evt_ms
            calls += 1
    return {"device_ms_per_step": ms / steps, "calls_per_step": calls / steps}


def phase_train_sp(dev, smi):
    """P = 8 ranks as ThreadMesh(c=2, r=2) threads on the one card train
    full-width, full-depth h2o-danube-1.8b under the 'default' sharding
    rules (each rank's gradients are its shards': the MLP and the vocab
    tables split over the 8 ranks): seq 4096, global batch 1, zigzag,
    ``remat='attn_out'``, bf16, through ``trainer.train`` on a plan with
    ``n_devices=8``; 3 AdamW steps on one repeated batch. The first step's
    loss and gradient norm against the same model at P = 1 on the same
    weights and batch; before it, the f32 parity of ``_train_sp_parity``;
    after it, ``torch.profiler`` over one more step, whose f32 adds are
    printed beside the 8-layer step that stored every parameter whole."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    t_phase = time.perf_counter()
    f32 = _train_sp_parity(dev)
    free_device()
    cfg = dataclasses.replace(registry.get(ARCH),
                              num_layers=TRAIN_SP_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p = TRAIN_SP_C * TRAIN_SP_C * TRAIN_SP_R
    # placement and chunks pinned, not the ranking's pick, so the numbers
    # compare with the phase's earlier runs
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=p, c=TRAIN_SP_C,
                     placement="team_inner", comm_chunks=1)
    check((plan.sp_size, plan.r, plan.remat, plan.seq_scheme)
          == (p, TRAIN_SP_R, "attn_out", "zigzag"),
          f"train_sp plan {plan}")
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    # the P = 1 reference: the same weights, the batch in natural order
    vg1, _ = train_step.build_value_and_grad_fn(model, plan.run_config(),
                                                shape)
    t0 = time.perf_counter()
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
    loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
    p1_vg_s = time.perf_counter() - t0
    del g1
    free_device()
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_sp_metrics.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=TRAIN_SP_STEPS, log_every=TRAIN_SP_STEPS,
            metrics_path=path), data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    gnorms = [r["grad_norm"] for r in recs]
    check(len(recs) == TRAIN_SP_STEPS
          and all(math.isfinite(x) for x in losses + gnorms),
          f"train_sp losses {losses}: want {TRAIN_SP_STEPS} finite")
    check(losses[-1] < losses[0],
          f"train_sp loss did not fall over one repeated batch: {losses}")
    loss_err = abs(losses[0] - loss1)
    gnorm_rel = abs(gnorms[0] - gnorm1) / gnorm1
    check(loss_err <= TRAIN_SP_TOL["loss_abs"]
          and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
          f"train_sp bf16 first step at P={p}: loss {losses[0]} vs P=1 "
          f"{loss1} (abs {loss_err}), grad norm {gnorms[0]} vs {gnorm1} "
          f"(rel {gnorm_rel}), beyond {TRAIN_SP_TOL}")
    L = cfg.num_layers
    per_step = launches_of(B2=p * plan.r * 2 * L, B3=p * plan.r * L)
    want = {k: v * TRAIN_SP_STEPS for k, v in per_step.items()}
    check(launches == want, f"train_sp launches {launches}: want {want} "
          f"(per step {per_step}: every rank's ring steps per layer, "
          f"forward twice under recompute and backward once)")
    step_ms = [1e3 * r["step_s"] for r in recs]
    # where the P = 8 step's time goes: one more step under the profiler
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = train_step.to_device(data.get_batch(0), dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    breakdown = _profile_window(prof, 1, prof_wall, top=10)
    f32_add = _f32_add_rows(prof)
    del step_fn, sh, opt, prof
    emit("train_sp", model=cfg.name, layers=L, params=model.param_count(),
         weights="seeded random bf16",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"n_devices": plan.n_devices, "P_sp": plan.sp_size,
               "C": plan.c, "R": plan.r, "data": plan.data,
               "seq_scheme": plan.seq_scheme, "remat": plan.remat,
               "block_impl": plan.block_impl},
         losses=losses, grad_norm=gnorms,
         p1_first_step={"loss": loss1, "grad_norm": gnorm1,
                        "value_and_grad_s": p1_vg_s},
         loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel,
         tol=TRAIN_SP_TOL, f32_parity=f32, step_ms=step_ms,
         wall_s=wall, max_memory_allocated=peak,
         launches_per_step=per_step, launches=launches,
         profile=breakdown, f32_add=f32_add,
         rules=plan.sharding_rules,
         whole_storage_8_layers=TRAIN_SP_8_LAYERS_WHOLE,
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    return launches


# ---------------------------------------------------------------------------
# phase 13a: the same training with each rank a process (gloo; NCCL where
# the machine has a card for every rank)
# ---------------------------------------------------------------------------

# (data, C, R) = (1, 2, 1): P = 4 rank processes on the one card
TRAIN_PROCS_C, TRAIN_PROCS_R = 2, 1
# a gradient leaf against the ThreadMesh's: ROADMAP's tolerance for a
# gradient, rel L2 (the loss: absolute)
TRAIN_PROCS_TOL = {"grad_rel_l2": 2e-3, "loss_abs": 1e-2}
TRAIN_PROCS_TIMEOUT = 300                      # s, a spawned run's limit


def _train_procs_plan(n_devices, c):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.plan import make_plan

    cfg = dataclasses.replace(registry.get(ARCH),
                              num_layers=TRAIN_SP_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(cfg, shape, arch=ARCH, n_devices=n_devices, c=c,
                     scheme="startrail" if c > 1 else "ring",
                     placement="team_inner", comm_chunks=1)
    return cfg, shape, plan


def _rank_batch(cfg, shape, plan, dev):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import step as train_step

    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    return data, train_step.to_device(data.get_batch(0), dev)


def _procs_first_step(comm, cfg, shape, plan, model, batch):
    """The fresh model's loss and its owned shards' reduced gradients (on
    the host), with the ledger of that value_and_grad."""
    from repro_torch.train import step as train_step

    vg_fn, rt = train_step.build_value_and_grad_fn(
        model, plan.run_config(), shape, comm)
    comm.reset_ledgers()
    loss, grads = vg_fn(train_step.shard_batch(batch, rt), owned_only=True)
    owned = {i: g.cpu() for i, g in enumerate(grads) if g is not None}
    return float(loss), owned, comm.ledger.snapshot()


def _train_procs_rank(comm, cfg, plan, ckpt_dir, metrics_path):
    """One rank process of train_procs (``phase_train_procs``): the whole
    model drawn on the host from seed 0, this rank's shards kept on the
    card; the fresh model's first value and gradients; the trainer's
    ``TRAIN_SP_STEPS`` steps, checkpointing the last (counted launches);
    then one more step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.factory import build_model, rank_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = plan.shape_config()
    model = rank_model(build_model(cfg, device="cpu", seed=0), comm,
                       plan.sharding_rules, dev)
    data, batch = _rank_batch(cfg, shape, plan, dev)
    setup_s = time.perf_counter() - t0
    loss, owned, ledger_vg = _procs_first_step(comm, cfg, shape, plan,
                                               model, batch)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    counts = reset_counts()
    t0 = time.perf_counter()
    trainer.train(model, plan, adam, trainer.TrainerConfig(
        num_steps=TRAIN_SP_STEPS, ckpt_every=TRAIN_SP_STEPS,
        ckpt_dir=ckpt_dir, log_every=TRAIN_SP_STEPS,
        metrics_path=metrics_path if comm.rank == 0 else None),
        data_source=data, device=dev, comm=comm)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts(counts)
    params = list(model.parameters())
    trained = {i: params[i].detach().cpu() for i in owned}
    # one more step, profiled: device ms, wall, the signature check's cost
    # and the step's ledger
    step_fn, sh = plan.build_train_step(model, adam, comm)
    opt = adamw.init_state(sh["params"], adam)
    comm.reset_ledgers()
    sig_s, sig_calls = comm.signature_s, comm.signature_calls
    torch.cuda.synchronize()
    comm.agree(0)                          # the ranks start the step together
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sig_s = comm.signature_s - sig_s
    sig_calls = comm.signature_calls - sig_calls
    # the signature exchange alone, the ranks in lockstep: as many world
    # all-gathers of one int64 as the step made signature checks
    comm.agree(0)
    t0 = time.perf_counter()
    for _ in range(sig_calls):
        comm.agree(0)
    lockstep_s = time.perf_counter() - t0
    return dict(
        rank=comm.rank, loss=loss, grads=owned, blocks=model.held["blocks"],
        ledger_vg=ledger_vg, ledger_step=comm.ledger.snapshot(),
        launches=launches, trained=trained, setup_s=setup_s,
        train_s=train_s, wall_s=wall, **_step_profile(prof),
        signature_s=sig_s, signature_calls=sig_calls,
        signature_lockstep_s=lockstep_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def _step_profile(prof):
    """A profiled step's device events as (start, end) ns intervals (one
    host clock for every process), its device ms, the host<->device
    copies' share of them, and the host ms in gloo's calls."""
    import numpy as np
    import torch

    spans, device_ms, copy_ms, gloo = [], 0.0, 0.0, {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            spans.append((evt.start_ns(), evt.end_ns()))
            device_ms += evt.duration_ns() / 1e6
            if evt.name().startswith("Memcpy"):
                copy_ms += evt.duration_ns() / 1e6
        elif evt.name().startswith("gloo:"):
            gloo[evt.name()] = (gloo.get(evt.name(), 0.0)
                                + evt.duration_ns() / 1e6)
    spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    return dict(device_spans=spans, device_ms=device_ms, copy_ms=copy_ms,
                gloo_host_ms=gloo)


def _busy_ms(spans):
    """The length of the union of (start, end) ns intervals, in ms: the
    card's busy time, however many processes' kernels it ran."""
    import numpy as np

    spans = np.concatenate(spans) if spans else np.zeros((0, 2), np.int64)
    busy, end = 0, None
    for a, b in spans[np.argsort(spans[:, 0])]:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def _assemble_owned(results, shapes):
    """Whole leaves (host) from every rank's owned shards."""
    import torch

    whole = [None] * len(shapes)
    for res in results:
        for i, g in res["grads"].items():
            if whole[i] is None:
                whole[i] = torch.empty(shapes[i], dtype=g.dtype)
            whole[i][res["blocks"][i]] = g
    check(all(w is not None for w in whole),
          "train_procs: some gradient leaf has no owner")
    return whole


def _leaf_rel_l2(names, got, want):
    """Each leaf's ||got - want|| / ||want|| in f64 (on the card)."""
    import torch

    out = {}
    for n, a, b in zip(names, got, want):
        b = b.double()
        a = a.to(b.device).double()
        out[n] = float(torch.linalg.vector_norm(a - b)
                       / torch.linalg.vector_norm(b).clamp_min(1e-30))
    return out


def _thread_first_step(model, plan, shape, batch, mesh):
    from repro_torch.train import step as train_step

    mesh.reset_ledgers()
    vg = train_step.build_mesh_value_and_grad_fn(
        model, plan.run_config(), shape, mesh, timeout=TRAIN_SP_TIMEOUT)
    loss, grads = vg(batch)
    return float(loss), grads, [led.snapshot() for led in mesh.ledgers]


def _procs_run(backend, cfg, plan, tmp):
    """``_train_procs_rank`` on every rank process over ``backend``:
    (each rank's result, rank 0's metrics records, the run's seconds,
    the checkpoint's directory)."""
    from repro_torch.dist.procs import ProcessMesh

    ckpt = os.path.join(tmp, f"ckpt_{backend}")
    metrics_path = os.path.join(tmp, f"metrics_{backend}.jsonl")
    t0 = time.perf_counter()
    got = ProcessMesh(plan.c, plan.r, plan.data, plan.placement,
                      backend=backend, timeout=TRAIN_SP_TIMEOUT).run(
        _train_procs_rank, cfg, plan, ckpt, metrics_path,
        timeout=TRAIN_PROCS_TIMEOUT)
    seconds = time.perf_counter() - t0
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    return got, recs, seconds, ckpt


def _threads_reference(cfg, shape, plan, dev, tmp):
    """The ThreadMesh at the same plan, seed and kernels: the first
    step's loss, gradients and ledgers; ``TRAIN_SP_STEPS`` trainer steps'
    records; one more step profiled, with its ledgers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.comm import ThreadMesh
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    model = build_model(cfg, device="cpu", seed=0).to(dev)
    data, batch = _rank_batch(cfg, shape, plan, dev)
    out = {"names": [n for n, _ in model.named_parameters()],
           "shapes": [tuple(q.shape) for q in model.parameters()]}
    out["loss"], out["grads"], out["ledgers_vg"] = _thread_first_step(
        model, plan, shape, batch, ThreadMesh(plan.c, plan.r, plan.data))
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    path = os.path.join(tmp, "metrics_threads.jsonl")
    t0 = time.perf_counter()
    trainer.train(model, plan, adam, trainer.TrainerConfig(
        num_steps=TRAIN_SP_STEPS, log_every=TRAIN_SP_STEPS,
        metrics_path=path), data_source=data, device=dev)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    with open(path) as f:
        out["recs"] = [json.loads(line) for line in f]
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    sh["comm"].reset_ledgers()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
    out["profile"] = _step_profile(prof)
    out["ledgers_step"] = [led.snapshot() for led in sh["comm"].ledgers]
    return out


def _procs_checks(backend, cfg, plan, run, ref, smi, t_phase):
    """Hold one backend's rank processes against the ThreadMesh and emit
    their line; returns the launches summed over the ranks."""
    import math

    import torch

    from repro_torch.models.factory import Model
    from repro_torch.models.spec import DTYPES
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    got, recs, procs_s, ckpt = run
    name = "train_procs" if backend == "gloo" else "train_procs_nccl"
    rel = _leaf_rel_l2(ref["names"], _assemble_owned(got, ref["shapes"]),
                       ref["grads"])
    worst = max(rel, key=rel.get)
    loss_err = abs(got[0]["loss"] - ref["loss"])
    check(rel[worst] <= TRAIN_PROCS_TOL["grad_rel_l2"]
          and loss_err <= TRAIN_PROCS_TOL["loss_abs"],
          f"{name} first step: loss {got[0]['loss']} vs threads "
          f"{ref['loss']}, worst leaf {worst} rel L2 {rel[worst]}, beyond "
          f"{TRAIN_PROCS_TOL}")
    check([g["ledger_vg"] for g in got] == ref["ledgers_vg"]
          and [g["ledger_step"] for g in got] == ref["ledgers_step"],
          f"{name}: the ledgers of the first value and gradients or of a "
          f"train step differ from the ThreadMesh's")
    losses = [rec["loss"] for rec in recs]
    check(len(losses) == TRAIN_SP_STEPS
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0],
          f"{name} losses {losses}: want {TRAIN_SP_STEPS} finite, falling "
          f"over one repeated batch")
    # the processes' checkpoint, restored on the ThreadMesh's storage
    t0 = time.perf_counter()
    whole = Model(cfg, lambda sp: torch.empty(
        sp.shape, dtype=DTYPES[sp.dtype or cfg.param_dtype]))
    params = list(whole.parameters())
    step = trainer.restore_latest(ckpt, whole, ref["names"], adamw.init_state(
        params, adamw.AdamWConfig(state_dtype=cfg.opt_dtype)))
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(g["trained"][i], params[i][g["blocks"][i]])
               for g in got for i in g["trained"])
    check(step == TRAIN_SP_STEPS and same,
          f"{name} checkpoint: step {step}, the restored leaves equal the "
          f"ranks' trained shards: {same}")
    launches = {k: sum(g["launches"][k] for g in got) for k in KERNELS}
    p, L = plan.sp_size * plan.data, cfg.num_layers
    per_step = launches_of(B2=p * plan.r * 2 * L, B3=p * plan.r * L)
    want = {k: v * TRAIN_SP_STEPS for k, v in per_step.items()}
    check(launches == want, f"{name} launches {launches}: want {want}")
    wall = max(g["wall_s"] for g in got)
    busy = _busy_ms([g["device_spans"] for g in got])
    t_busy = _busy_ms([ref["profile"]["device_spans"]])
    emit(name, run=True, model=cfg.name, layers=L,
         shape={"seq_len": plan.seq_len, "batch": plan.global_batch},
         plan={"data": plan.data, "C": plan.c, "R": plan.r,
               "P_sp": plan.sp_size, "remat": plan.remat,
               "rules": plan.sharding_rules},
         backend=backend, ranks=p, cards=torch.cuda.device_count(),
         first_step={"loss_procs": got[0]["loss"],
                     "loss_threads": ref["loss"], "loss_abs_err": loss_err,
                     "worst_leaf": worst, "worst_rel_l2": rel[worst],
                     "bit_equal": all(v == 0.0 for v in rel.values()),
                     "tol": TRAIN_PROCS_TOL},
         losses={"procs": losses,
                 "threads": [x["loss"] for x in ref["recs"]]},
         step_s={"procs": [x["step_s"] for x in recs],
                 "threads": [x["step_s"] for x in ref["recs"]]},
         profiled_step={
             "procs": {"wall_s": wall, "device_busy_ms": busy,
                       "idle_share": 1 - busy / (1e3 * wall),
                       "device_ms_by_rank": [g["device_ms"] for g in got],
                       "copy_ms_by_rank": [g["copy_ms"] for g in got],
                       "gloo_host_ms_rank0": got[0]["gloo_host_ms"]},
             "threads": {"wall_s": ref["wall_s"], "device_busy_ms": t_busy,
                         "idle_share": 1 - t_busy / (1e3 * ref["wall_s"]),
                         "copy_ms": ref["profile"]["copy_ms"]}},
         signature_check={
             "calls_per_step": got[0]["signature_calls"],
             "host_s_per_step_by_rank": [g["signature_s"] for g in got],
             "lockstep_s_for_as_many_by_rank": [g["signature_lockstep_s"]
                                                for g in got]},
         ledger_bytes_equal=True, ledger_step_rank0=got[0]["ledger_step"],
         checkpoint={"bit_equal": True, "restore_s": restore_s},
         launches_per_step=per_step, launches=launches,
         seconds_split={"procs_run": procs_s,
                        "rank_setup": max(g["setup_s"] for g in got),
                        "rank_train": max(g["train_s"] for g in got),
                        "threads_train": ref["train_s"]},
         max_memory_allocated_by_rank=[g["max_memory_allocated"]
                                       for g in got],
         phase_s=time.perf_counter() - t_phase, card=smi)
    return launches


def phase_train_procs(dev, smi):
    """Phase 13a (module doc): train_sp's model and shape at (data, C, R) =
    (1, 2, 1) as four rank processes, over gloo on the one card (and over
    NCCL where the machine has a card for each rank), against the
    ThreadMesh at the same plan, seed and kernels. Returns each backend's
    launches."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    c, r = TRAIN_PROCS_C, TRAIN_PROCS_R
    p = c * c * r
    cfg, shape, plan = _train_procs_plan(p, c)
    check((plan.sp_size, plan.data, plan.r, plan.remat)
          == (p, 1, r, "attn_out"), f"train_procs plan {plan}")
    cards = torch.cuda.device_count()
    backends = ("gloo", "nccl") if cards >= p else ("gloo",)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {b: _procs_run(b, cfg, plan, tmp) for b in backends}
        ref = _threads_reference(cfg, shape, plan, dev, tmp)
        free_device()
        for b in backends:
            out[b] = _procs_checks(b, cfg, plan, runs[b], ref, smi, t_phase)
            runs[b] = None
    if "nccl" not in backends:
        emit("train_procs_nccl", run=False, cards=cards,
             reason=f"NCCL across rank processes was not run: this machine "
                    f"has {cards} card(s), and NCCL takes one card for each "
                    f"of the plan's {p} ranks (a stated gap, not a caught "
                    f"failure)", card=smi)
    return out


# ---------------------------------------------------------------------------
# phase 13b: serving with ranks as processes
# ---------------------------------------------------------------------------

# the workload of serve_procs (module doc), at full width; "layers" None is
# the full depth. 12 of 24 for the script's time (PERF.md §4): the phase
# took 93 s at 24 layers on one H100 80GB HBM3 at 700 W
SERVE_PROCS = {"layers": 12, "c": 2, "r": 1, "slots": 4, "page": 16,
               "max_len": 2048, "pages_per_shard": 128, "new": 8,
               # greedy prompts; the last joins once the rest have
               # prefilled
               "greedy": [256, 512, 768, 1024],
               "sampled": {"prompt": 384, "temperature": 0.8, "top_k": 32,
                           "top_p": 0.9, "seed": 7},
               "prefix": 512, "tails": [256, 128], "chunk": 256,
               "legacy": {"batch": 2, "prompt": 512}}
SERVE_PROCS_TIMEOUT = 300                      # s, a spawned run's limit
SERVE_PROCS_KERNELS = ("B1", "B2", "B4", "B5", "B6")


def _serve_procs_cfg():
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get(ARCH)
    layers = SERVE_PROCS["layers"]
    return (cfg if layers is None
            else dataclasses.replace(cfg, num_layers=layers))


def _serve_procs_plan(cfg, prefix_cache=False):
    from repro_torch.plan import make_serve_plan

    c, r = SERVE_PROCS["c"], SERVE_PROCS["r"]
    return make_serve_plan(cfg, arch=ARCH, n_devices=c * c * r, c=c,
                           decode_batch=SERVE_PROCS["slots"],
                           page_size=SERVE_PROCS["page"],
                           max_len=SERVE_PROCS["max_len"],
                           prefix_cache=prefix_cache)


def _serve_procs_requests(vocab):
    """(first, later) of the engine run and of the prefix run, and the
    legacy batch's prompts (numpy), all drawn from one seed."""
    import numpy as np

    from repro_torch.engine import Request

    sp = SERVE_PROCS
    rng = np.random.default_rng(31)
    greedy = [Request(f"g{i}", rng.integers(0, vocab, n).tolist(), sp["new"])
              for i, n in enumerate(sp["greedy"])]
    s = sp["sampled"]
    sampled = Request("s0", rng.integers(0, vocab, s["prompt"]).tolist(),
                      sp["new"], temperature=s["temperature"],
                      top_k=s["top_k"], top_p=s["top_p"], seed=s["seed"])
    shared = rng.integers(0, vocab, sp["prefix"]).tolist()
    prefix = [Request(f"px{i}", shared + rng.integers(0, vocab, n).tolist(),
                      sp["new"]) for i, n in enumerate(sp["tails"])]
    lg = sp["legacy"]
    legacy = rng.integers(0, vocab, (lg["batch"], lg["prompt"]))
    return ((greedy[:2] + [sampled] + greedy[2:3], greedy[3:]),
            (prefix[:1], prefix[1:]), legacy)


def _serve_procs_drive(engine, first, later):
    """Serve ``first``, then ``later`` once every earlier prefill has
    completed, step by step: the streams, the first-token hidden states
    (on the host, as the engine gives them), the run's wall, the median
    wall of a step that only decodes, and the engine's counts and host
    seconds a prefill chunk and a decode step."""
    import torch

    hidden = {}
    engine.on_prefill = lambda uid, h: hidden.__setitem__(uid, h.cpu())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in first:
        if engine.add_request(r) is not None:
            raise RuntimeError(f"serve_procs: {r.uid} rejected")
    pending, decode_ms = list(later), []
    while not engine.idle() or pending:
        if pending and engine.metrics.prefills >= len(first):
            for r in pending:
                if engine.add_request(r) is not None:
                    raise RuntimeError(f"serve_procs: {r.uid} rejected")
            pending = []
        active = engine.scheduler.active()
        pure = not engine.scheduler.queue and bool(active) \
            and all(st.cache_len > 0 for st in active)
        t1 = time.perf_counter()
        engine.step()
        if pure:
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.on_prefill = None
    m = engine.metrics
    return dict(streams=engine.collect(), hidden=hidden, wall_s=wall,
                decode_step_wall_ms_median=(statistics.median(decode_ms)
                                            if decode_ms else None),
                prefills=m.prefills, prefill_chunks=m.prefill_chunks,
                decode_steps=m.decode_steps,
                prefill_cached_tokens=m.prefill_tokens_cached,
                prefill_s_per_chunk=m.prefill_wall_s / max(
                    m.prefill_chunks, 1),
                decode_s_per_step=m.decode_wall_s / max(m.decode_steps, 1))


def _serve_procs_work(model, comm=None):
    """The serve_procs workload on ``model``: the ThreadMesh engine's
    (``comm`` None, the whole model) or this rank process's (its
    ``ProcessComm`` and ``rank_model``). Each run's counts are set to 0
    just before it and read just after; the engine run's ledgers (every
    thread's, or this rank's) and, on a process, its signature checks'
    calls and host seconds."""
    import torch

    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.launch import serve as launch_serve

    cfg, sp = model.cfg, SERVE_PROCS
    (first, later), (pfirst, plater), legacy = _serve_procs_requests(
        cfg.vocab_size)
    plan = _serve_procs_plan(cfg)
    eng_cfg = EngineConfig(pages_per_shard=sp["pages_per_shard"])
    out = {}
    engine = Engine(model, plan, eng_cfg, comm=comm)
    # warm-up (cuBLAS handles, the allocator, gloo's first exchanges)
    engine.add_request(Request("warm", first[0].tokens[:64], 2))
    engine.run()
    engine.reset()
    ledgers = (engine.mesh.ledgers if comm is None else [comm.ledger])
    for led in ledgers:
        led.reset()
    sig = (comm.signature_calls, comm.signature_s) if comm else (0, 0.0)
    counts = reset_counts()
    run = _serve_procs_drive(engine, first, later)
    run["launches"] = read_counts(counts)
    run["ledgers"] = [led.snapshot() for led in ledgers]
    if comm is not None:
        run["signature_calls"] = comm.signature_calls - sig[0]
        run["signature_s"] = comm.signature_s - sig[1]
    out["engine"] = run
    del engine
    engine = Engine(model, _serve_procs_plan(cfg, prefix_cache=True),
                    EngineConfig(pages_per_shard=sp["pages_per_shard"],
                                 prefill_chunk=sp["chunk"]), comm=comm)
    counts = reset_counts()
    run = _serve_procs_drive(engine, pfirst, plater)
    run["launches"] = read_counts(counts)
    out["prefix"] = run
    del engine
    tokens = torch.from_numpy(legacy).to(model.device)
    torch.cuda.synchronize()
    counts = reset_counts()
    t0 = time.perf_counter()
    toks = launch_serve.legacy_generate(model, plan, tokens, sp["new"],
                                        comm=comm)
    torch.cuda.synchronize()
    out["legacy"] = {"streams": toks.cpu().tolist(),
                     "wall_s": time.perf_counter() - t0,
                     "launches": read_counts(counts)}
    return out


def _serve_procs_rank(comm, cfg):
    """One rank process of serve_procs: the whole model drawn on its card
    from seed 0 (the ThreadMesh's weights), its shards kept and the whole
    freed (``factory.build_rank_model``), then ``_serve_procs_work``."""
    import torch

    from repro_torch.models.factory import build_rank_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_rank_model(cfg, comm, _serve_procs_plan(cfg).sharding_rules,
                             dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = sum(p.numel() for p in model.parameters())
    comm.agree(0)                          # the ranks start together
    out = _serve_procs_work(model, comm)
    out.update(rank=comm.rank, setup_s=setup_s, params_held=held,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return out


def _serve_procs_checks(backend, cfg, got, ref, procs_s, smi, t_phase):
    """Hold one backend's rank processes against the ThreadMesh engine and
    emit their line; returns their launches summed over the ranks and the
    runs."""
    import torch

    name = "serve_procs" if backend == "gloo" else "serve_procs_nccl"
    runs = ("engine", "prefix", "legacy")
    for run in runs:
        for g in got:
            check(g[run]["streams"] == ref[run]["streams"],
                  f"{name} {run}: rank {g['rank']}'s streams "
                  f"{g[run]['streams']} differ from the ThreadMesh's "
                  f"{ref[run]['streams']}")
    hidden, bit_equal = {}, True
    for run in ("engine", "prefix"):
        for uid, want in ref[run]["hidden"].items():
            for g in got:
                h = g[run]["hidden"][uid]
                same = h.dtype == want.dtype and torch.equal(h, want)
                bit_equal = bit_equal and same
                if not same:
                    # reported within ENGINE_TOL, and explained (PERF.md)
                    hidden[f"{run}/{uid}/rank{g['rank']}"] = compare(
                        (h.float(),), (want.float(),),
                        f"{name} {run} {uid} hidden vs threads",
                        names=("hidden",))["hidden"]
    check([g["engine"]["ledgers"][0] for g in got]
          == ref["engine"]["ledgers"],
          f"{name}: the ranks' ledgers differ from the ThreadMesh's")
    launches = {run: {k: sum(g[run]["launches"][k] for g in got)
                      for k in KERNELS} for run in runs}
    for run in runs:
        check(launches[run] == ref[run]["launches"],
              f"{name} {run} launches {launches[run]} (summed over the "
              f"ranks): the ThreadMesh's {ref[run]['launches']}")
    total = {k: sum(launches[run][k] for run in runs) for k in KERNELS}
    check(all(total[k] > 0 for k in SERVE_PROCS_KERNELS),
          f"{name} launches {total}: want every one of "
          f"{SERVE_PROCS_KERNELS} launched")

    def timing(src):
        return {run: {k: src[run][k] for k in (
            "wall_s", "decode_step_wall_ms_median", "prefill_s_per_chunk",
            "decode_s_per_step") if k in src[run]} for run in runs}

    e = ref["engine"]
    emit(name, run=True, model=cfg.name, layers=cfg.num_layers,
         plan={"data": 1, "C": SERVE_PROCS["c"], "R": SERVE_PROCS["r"],
               "P_sp": SERVE_PROCS["c"] ** 2 * SERVE_PROCS["r"]},
         backend=backend, ranks=len(got), cards=torch.cuda.device_count(),
         workload={k: SERVE_PROCS[k] for k in (
             "greedy", "sampled", "prefix", "tails", "chunk", "legacy",
             "new", "slots", "page")},
         streams_equal=True, hidden_bit_equal=bit_equal,
         hidden_err_vs_threads=hidden, tol=ENGINE_TOL,
         ledgers_equal=True, ledger_rank0=got[0]["engine"]["ledgers"][0],
         counts={"prefills": e["prefills"], "decode_steps": e["decode_steps"],
                 "prefix_chunks": ref["prefix"]["prefill_chunks"],
                 "prefix_cached_tokens": ref["prefix"]
                 ["prefill_cached_tokens"]},
         launches_by_run=launches, launches=total,
         timing={"procs_rank0": timing(got[0]), "threads": timing(ref)},
         signature_check={
             "calls_engine_run": got[0]["engine"]["signature_calls"],
             "host_s_engine_run_by_rank": [g["engine"]["signature_s"]
                                           for g in got]},
         setup_s_by_rank=[g["setup_s"] for g in got],
         params_held_by_rank=[g["params_held"] for g in got],
         max_memory_allocated_by_rank=[g["max_memory_allocated"]
                                       for g in got],
         procs_run_s=procs_s, phase_s=time.perf_counter() - t_phase,
         card=smi)
    return total


def phase_serve_procs(dev, smi):
    """Phase 13b (module doc): full-width h2o-danube-1.8b served at (data,
    C, R) = (1, 2, 1) by four rank processes over gloo on the one card
    (and over NCCL, one rank a card, where the machine has four), each an
    ``Engine`` of its own over its ``ProcessComm``, against the
    ThreadMesh engine at the same plan, seed and kernels. Returns each
    backend's launches."""
    import torch

    from repro_torch.dist.procs import ProcessMesh
    from repro_torch.models.factory import build_model

    t_phase = time.perf_counter()
    cfg = _serve_procs_cfg()
    c, r = SERVE_PROCS["c"], SERVE_PROCS["r"]
    p = c * c * r
    cards = torch.cuda.device_count()
    backends = ("gloo", "nccl") if cards >= p else ("gloo",)
    got = {}
    for b in backends:
        t0 = time.perf_counter()
        got[b] = ProcessMesh(c, r, 1, backend=b,
                             timeout=SERVE_PROCS_TIMEOUT).run(
            _serve_procs_rank, cfg, timeout=SERVE_PROCS_TIMEOUT)
        got[b] = (got[b], time.perf_counter() - t0)
    model = build_model(cfg, device=dev, seed=0)
    ref = _serve_procs_work(model)
    del model
    free_device()
    out = {b: _serve_procs_checks(b, cfg, g, ref, s, smi, t_phase)
           for b, (g, s) in got.items()}
    if "nccl" not in backends:
        emit("serve_procs_nccl", run=False, cards=cards,
             reason=f"NCCL across rank processes was not run: this machine "
                    f"has {cards} card(s), and NCCL takes one card for each "
                    f"of the plan's {p} ranks (a stated gap, not a caught "
                    f"failure)", card=smi)
    return out


# ---------------------------------------------------------------------------
# phase 14: the paper's baselines and StarTrail's chunked ring
# ---------------------------------------------------------------------------

# 2 layers for the script's time (PERF.md §4): a P = 8 step's wall is
# host-bound, ~1 s a layer on a slow host
SCHEMES_LAYERS, SCHEMES_STEPS = 2, 2
# (path name, scheme, C, comm_chunks); P = 8 ranks each
SCHEMES = (("ring", "ring", 1, 1), ("ulysses", "ulysses", 1, 1),
           ("startrail", "startrail", 2, 2))
# the profiled schemes (StarTrail at C = 2 is train_sp's profile)
SCHEMES_PROFILED = ("ring", "ulysses")


def _schemes_launches(name, plan, layers):
    """The plan's launches per step: every rank's ring steps per layer,
    forward twice under recompute and backward once; Ulysses one block per
    rank and layer, likewise."""
    p = plan.sp_size
    if name == "ulysses":
        return launches_of(B1=p * 2 * layers, B3=p * layers)
    return launches_of(B2=p * plan.r * 2 * layers, B3=p * plan.r * layers)


def phase_schemes(dev, smi):
    """The paper's comparison at full width: ``trainer.train`` on
    ``make_plan`` plans of P = 8 ThreadMesh ranks on the one card for the
    ring (C = 1, R = 8), DeepSpeed-Ulysses (all-to-all, B1 forward and B3
    backward over the whole sequence) and StarTrail (C = 2, R = 2, each ring
    transfer in 2 sub-chunks): h2o-danube-1.8b cut to ``SCHEMES_LAYERS``
    layers, seq 4096, batch 1, zigzag, ``remat='attn_out'``, bf16, 2
    AdamW steps each from the same weights on one repeated batch, with the
    obs registry and tracer on. Each first step's loss and gradient norm
    against P = 1 on the same weights and batch; exact launch counts from
    the plan; the forward island's ``comm_report`` per scheme (one layer at
    full width, seq 4096, bf16) must read 1.0 on every live kind. Printed
    beside them: the ledger's bytes per step against ``CommLog.per_step``,
    step ms, peak memory, and a profiled step of the ring and Ulysses."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.factory import build_model
    from repro_torch.obs import commlog
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    full = registry.get(ARCH)
    cfg = dataclasses.replace(full, num_layers=SCHEMES_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p, L = ULYSSES_P, cfg.num_layers
    # the forward island of one attention layer per scheme
    reports = {}
    for name, scheme, c, chunks in SCHEMES:
        plan = make_plan(full, shape, arch=ARCH, n_devices=p, c=c,
                         scheme=scheme, placement="team_inner",
                         comm_chunks=chunks)
        rep = commlog.comm_report(full, plan, device=dev)
        rows = rep["per_collective"]
        live = {k: row for k, row in rows.items() if row["analytical_bytes"]}
        # a kind the scheme should not run at all must move no byte
        check(live and rep["ranks_agree"] and rep["within_tolerance"]
              and all(row["ratio"] == 1.0 for row in live.values())
              and all(row["measured_bytes"] == 0 for k, row in rows.items()
                      if k not in live),
              f"schemes {name}: comm_report {rows} (ranks agree: "
              f"{rep['ranks_agree']}): every live kind must read 1.0 and "
              f"every other kind 0 bytes")
        reports[name] = {
            "per_collective": {k: {"measured_bytes": row["measured_bytes"],
                                   "analytical_bytes":
                                       row["analytical_bytes"],
                                   "eqs_bytes": row["eqs_bytes"],
                                   "ratio": row["ratio"]}
                               for k, row in rows.items()
                               if k in live or row["eqs_bytes"]},
            "unmodelled_allreduce_bytes": rep["unmodelled_allreduce_bytes"],
            "collective_counts": rep["collective_counts"]}
    free_device()

    model = build_model(cfg, device=dev, seed=0)
    init = [t.detach().clone() for t in model.parameters()]
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    # the P = 1 reference: the same weights, the batch in natural order
    plan1 = make_plan(cfg, shape, arch=ARCH, c=1)
    vg1, _ = train_step.build_value_and_grad_fn(model, plan1.run_config(),
                                                shape)
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
    loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
    del g1, vg1
    free_device()
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0, seq_scheme="zigzag",
                                   sp_size=p))
    by_path, out = {}, {}
    for name, scheme, c, chunks in SCHEMES:
        with torch.no_grad():
            for t, t0 in zip(model.parameters(), init):
                t.copy_(t0)
        plan = make_plan(cfg, shape, arch=ARCH, n_devices=p, c=c,
                         scheme=scheme, placement="team_inner",
                         comm_chunks=chunks)
        check((plan.sp_size, plan.c, plan.comm_chunks, plan.remat,
               plan.seq_scheme) == (p, c, chunks, "attn_out", "zigzag"),
              f"schemes {name} plan {plan}")
        reg, tracer = obs.Registry(), obs.Tracer(enabled=True)
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "metrics.jsonl")
            counts = reset_counts()
            t0 = time.perf_counter()
            trainer.train(model, plan, adam, trainer.TrainerConfig(
                num_steps=SCHEMES_STEPS, log_every=SCHEMES_STEPS,
                metrics_path=path), data_source=data, device=dev,
                tracer=tracer, registry=reg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts(counts)
            with open(path) as f:
                recs = [json.loads(line) for line in f]
        peak = torch.cuda.max_memory_allocated()
        losses = [r["loss"] for r in recs]
        gnorms = [r["grad_norm"] for r in recs]
        check(len(recs) == SCHEMES_STEPS
              and all(math.isfinite(x) for x in losses + gnorms)
              and losses[-1] < losses[0],
              f"schemes {name}: losses {losses} must be finite and fall")
        loss_err = abs(losses[0] - loss1)
        gnorm_rel = abs(gnorms[0] - gnorm1) / gnorm1
        check(loss_err <= TRAIN_SP_TOL["loss_abs"]
              and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
              f"schemes {name} first step at P={p}: loss {losses[0]} vs "
              f"P=1 {loss1} (abs {loss_err}), grad norm {gnorms[0]} vs "
              f"{gnorm1} (rel {gnorm_rel}), beyond {TRAIN_SP_TOL}")
        per_step = _schemes_launches(name, plan, L)
        want = {k: v * SCHEMES_STEPS for k, v in per_step.items()}
        check(launches == want, f"schemes {name} launches {launches}: want "
              f"{want} (per step {per_step}, from the plan)")
        spans = [e["name"] for e in tracer.events()]
        check(spans.count("train/step") == SCHEMES_STEPS,
              f"schemes {name}: tracer spans {spans}")
        measured = {}
        for (fam, key), v in obs.parse_prometheus(
                reg.render_prometheus()).items():
            if fam == "comm_ledger_bytes_total":
                lab = dict(key)
                measured.setdefault(lab["pass"], {})[lab["collective"]] = \
                    v / SCHEMES_STEPS
        log = commlog.CommLog(obs.Registry(), cfg, plan)
        row = dict(plan={"scheme": plan.scheme, "C": plan.c, "R": plan.r,
                         "P_sp": plan.sp_size,
                         "comm_chunks": plan.comm_chunks},
                   losses=losses, grad_norm=gnorms,
                   loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel,
                   step_ms=[1e3 * r["step_s"] for r in recs], wall_s=wall,
                   max_memory_allocated=peak, launches_per_step=per_step,
                   launches=launches,
                   ledger_bytes_per_step=measured,
                   commlog_per_step=log.per_step,
                   island=reports[name])
        if name in SCHEMES_PROFILED:
            step_fn, sh = plan.build_train_step(model, adam)
            opt = adamw.init_state(sh["params"], adam)
            batch = train_step.to_device(data.get_batch(0), dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step_fn(opt, batch)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            row["profile"] = _profile_window(prof, 1, prof_wall, top=10)
            del step_fn, sh, opt, prof, batch
        out[name] = row
        by_path[f"schemes_{name}"] = launches
        free_device()
    emit("schemes", model=cfg.name, layers=L, params=model.param_count(),
         weights="seeded random bf16",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         remat="attn_out", steps=SCHEMES_STEPS,
         p1_first_step={"loss": loss1, "grad_norm": gnorm1},
         tol=TRAIN_SP_TOL,
         island_shape={"layers": 1, "seq_len": TRAIN_SEQ, "batch": 1,
                       "dtype": "bfloat16", "heads": [full.num_heads,
                                                      full.num_kv_heads],
                       "head_dim": full.head_dim_},
         schemes=out, card=smi)
    del model, init
    return by_path


# ---------------------------------------------------------------------------
# phase 15: the §3.4 topology scheduler, measured
# ---------------------------------------------------------------------------

AUTOTUNE = {"top_k": 3, "steps": 1, "warmup": 1}


@contextlib.contextmanager
def _registry_depth(layers):
    """``registry.get`` with the depth cut to ``layers`` (the launcher
    builds its model from the registry; P = 8 ranks' gradients of 24
    layers would crowd one card, as in train_sp)."""
    import dataclasses

    from repro_torch.configs import registry

    get = registry.get
    registry.get = lambda name: dataclasses.replace(get(name),
                                                    num_layers=layers)
    try:
        yield
    finally:
        registry.get = get


def phase_autotune(dev, smi):
    """The paper's §3.4 procedure end to end: the analytical ranking of
    every legal arrangement at P = 8 under the H100 table
    (``roofline.hw``), then ``plan.autotune.autotune`` (top 3 plus the
    analytical worst: at P = 8 all four arrangements) times each on
    ``trainer``'s step (warm-up 1, 1 timed step, P = 8 ThreadMesh ranks on
    the one card) at the schemes phase's size (h2o-danube-1.8b cut to 8
    layers, seq 4096, batch 1, bf16, ``attn_out``), every candidate from
    the same seeded weights. The winner's plan file must reload equal and
    hold the arrangement its own record timed fastest, ``launch.train
    --plan FILE --steps 1`` must train one finite step from it through B2
    and B3 (B1 and B3 if Ulysses won), and
    ``make_serve_plan(c=None)`` on the full model must give C = 1 at
    P = 1. One card's ranks exchange synchronously and the step is
    host-bound, so the measured order ranks host and kernel time, not
    wires; the analytical one is the prediction a multi-card cell tests."""
    import dataclasses
    import math
    import pathlib
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train as launch_train
    from repro_torch.plan import ExecutionPlan, autotune, cost
    from repro_torch.plan import make_serve_plan

    full = registry.get(ARCH)
    cfg = dataclasses.replace(full, num_layers=SCHEMES_LAYERS)
    shape = _train_shape(TRAIN_SEQ)
    p, L = ULYSSES_P, cfg.num_layers
    ranking = cost.rank_arrangements(cfg, shape, p)
    want_keys = ({e["arrangement"].key for e in ranking[:AUTOTUNE["top_k"]]}
                 | {ranking[-1]["arrangement"].key})
    with tempfile.TemporaryDirectory() as tmp:
        counts = reset_counts()
        t0 = time.perf_counter()
        tuned = autotune.autotune(
            cfg, shape, arch=ARCH, n_devices=p, top_k=AUTOTUNE["top_k"],
            steps=AUTOTUNE["steps"], warmup=AUTOTUNE["warmup"],
            out_dir=tmp, device=dev)
        torch.cuda.synchronize()
        search_s = time.perf_counter() - t0
        search = read_counts(counts)
        measured = tuned["measured"]
        keys = [e["arrangement"].key for e in measured]
        check(sorted(keys) == sorted(want_keys),
              f"autotune measured {keys}: want the analytical top "
              f"{AUTOTUNE['top_k']} and the worst, {sorted(want_keys)}")
        times = [e["measured_s"] for e in measured]
        check(all(math.isfinite(t) and t > 0 for t in times),
              f"autotune times {dict(zip(keys, times))}")
        per_run = AUTOTUNE["warmup"] + AUTOTUNE["steps"]
        want = launches_of()
        for e in measured:
            for k, v in _schemes_launches(e["plan"].scheme, e["plan"],
                                          L).items():
                want[k] += v * per_run
        check(search == want, f"autotune search launches {search}: want "
              f"{want} ({per_run} steps per candidate, from each plan)")
        winner = ExecutionPlan.load(tuned["path"])
        check(winner == tuned["plan"], f"plan file {tuned['path']} "
              f"reloads as {winner}, not {tuned['plan']}")
        # the file's own record: its plan is the arrangement it timed fastest
        filed = json.loads(pathlib.Path(tuned["path"]).read_text())
        fastest = min(filed["measured"], key=lambda m: m["measured_s"])
        won = cost.Arrangement(winner.scheme, winner.c, winner.r,
                               winner.placement).key
        check(fastest["arrangement"] == won,
              f"plan file holds {won}, but its fastest measured "
              f"arrangement is {fastest['arrangement']} of "
              f"{filed['measured']}")
        free_device()
        counts = reset_counts()
        t0 = time.perf_counter()
        with _registry_depth(SCHEMES_LAYERS):
            out = launch_train.main(["--plan", str(tuned["path"]),
                                     "--steps", "1", "--device", dev.type])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trained = read_counts(counts)
    want = _schemes_launches(winner.scheme, winner, L)
    check(out["step"] == 1 and math.isfinite(out["loss"])
          and trained == want,
          f"launch.train --plan: step {out['step']} loss {out['loss']}, "
          f"launches {trained}: want one finite step and {want}")
    serve = make_serve_plan(full, arch=ARCH)
    check((serve.sp_size, serve.c) == (1, 1),
          f"make_serve_plan(c=None) gave P={serve.sp_size} C={serve.c}")
    emit("autotune", model=cfg.name, layers=L,
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         P=p, hw=hw_table(), card=smi,
         analytical=[{"arrangement": e["arrangement"].key,
                      "us_per_layer": 1e6 * e["total_s"],
                      "model_s": e["model_s"], "volumes": e["volumes"]}
                     for e in ranking],
         measured=[{"arrangement": e["arrangement"].key,
                    "measured_s_per_step": e["measured_s"],
                    "analytical_s_per_layer": e["analytical_s"],
                    "analytical_model_s": e["analytical_s"] * L}
                   for e in measured],
         winner=winner.to_dict(), search_s=search_s, **AUTOTUNE,
         launches=search, plan_step={"loss": out["loss"], "wall_s": train_s,
                                     "launches": trained},
         serve_plan={"P_sp": serve.sp_size, "C": serve.c,
                     "scheme": serve.scheme})
    return {"autotune": search, "autotune_plan": trained}


# ---------------------------------------------------------------------------
# phases 16-17: the dense configs at head size 128
# ---------------------------------------------------------------------------

DENSE_ARCH = "minitron-8b"
DENSE_PLENS = [64, 200, 336, 472, 608, 744, 880, 1024]   # P = 1 prompts
DENSE_NEW = 32
# P = 8: 2 of the P = 1 prompts (336 and 1024 tokens), 2 new tokens each;
# then 2 prompts sharing a 512-token prefix through 256-token chunks (few
# prompts and tokens for the script's time: a P = 8 decode step takes
# 2.5-5.7 s of wall)
DENSE_P8 = {"n_devices": 8, "c": 2, "prompts": (2, 7),
            "new_tokens": 2, "prefix": 512, "chunk": 256,
            "suffixes": (128, 256)}
# P = 8 sampled: prompt 2 greedy and prompt 4 sampled, 2 new tokens each
DENSE_P8_SAMPLED = {"greedy": 2, "sampled": 4, "temperature": 0.8,
                    "top_k": 40, "top_p": 0.9, "seed": 7}
# P = 8 rounds in bf16 where P = 1 does not: the MLP's reduce-scatter sums
# 8 bf16 partial products, the embedding's psum 8 partial lookups, and the
# ring merges 2 blocks per team before the team's combine. Over 32 layers
# that is a few bf16 roundings per layer more than ENGINE_TOL's 24-layer
# budget covers, so P = 8 against P = 1 gets 5e-2 relative in the L2 norm
# and 1e-1 of the largest magnitude: a wrong merge or kernel is off by O(1).
DENSE_SP_TOL = {"rel_l2": 5e-2, "max_abs_over_max": 1e-1}


def _dense_engine(model, n_devices=1, c=1, prefix_cache=False, chunk=0):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=DENSE_ARCH, n_devices=n_devices,
                           c=c, decode_batch=4, page_size=16, max_len=2048,
                           prefix_cache=prefix_cache)
    # 4 slots of 2048 tokens in pages of 16, spread over the SP ranks
    return Engine(model, plan, EngineConfig(
        pages_per_shard=512 // plan.sp_size, prefill_chunk=chunk))


def phase_dense_serve(dev, smi):
    """The engine at the full width of minitron-8b (32 layers, d_model
    4096, 32q/8kv heads of 128, vocab 256000, ~9.9 B seeded bf16
    parameters): at P = 1, 8 greedy requests of 64-1024 prompt tokens and
    32 new tokens (B2 per layer and prefill, B4 per layer and decode step);
    then at P = 8 as ThreadMesh(c=2, r=2) threads on the one card from the
    same weights, cut to 2 of those prompts (336 and 1024 tokens) with 3
    new tokens each (B2 on every rank, ring step and layer of a prefill; B4 on
    every rank and layer of a decode step), and 2 prompts sharing a
    512-token prefix through the prefix cache and 256-token chunks (each
    suffix chunk runs B6 and B1 on every rank and layer, merged across the
    ranks). The P = 8 cut keeps the phase near 100 s: its 8 rank threads
    share the GIL, so a step takes seconds. Each request's first-token
    hidden state at P = 8 is held against P = 1's (``DENSE_SP_TOL``); the
    share of streamed tokens that agree with P = 1's is printed (a
    mismatch after a bf16 near tie is reported, not failed on)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.engine import Request
    from repro_torch.models.factory import build_model

    cfg = registry.get(DENSE_ARCH)
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_PLENS]
    e1 = _dense_engine(model)
    e1.add_request(Request("warm", prompts[0], 4))
    e1.run()
    e1.reset()
    reqs = [Request(f"d{i}", p, DENSE_NEW) for i, p in enumerate(prompts)]
    out1, hid1, l1, rec1 = drive_engine(e1, smi, reqs, p1_launches,
                                        "dense P=1", profile_steps=4)

    sp, c = DENSE_P8["n_devices"], DENSE_P8["c"]
    e8 = _dense_engine(model, sp, c)
    check(not e8.plan.block_skip, "dense P=8: ring-block skipping is on, "
          "the launch counts below assume every ring step runs")
    ring = e8.plan.r
    n8 = DENSE_P8["new_tokens"]
    reqs8 = [Request(f"d{i}", prompts[i], n8) for i in DENSE_P8["prompts"]]

    def p8_launches(e):
        # B2 on every rank, ring step and layer of a prefill; B4 on every
        # rank and layer of a decode step
        return launches_of(B2=sp * ring * L * e.metrics.prefills,
                           B4=sp * L * e.metrics.decode_steps)

    out8, hid8, l8, rec8 = drive_engine(e8, smi, reqs8, p8_launches,
                                        "dense P=8", profile_steps=1)
    errs, agree, total = {}, 0, 0
    for r in reqs8:
        toks = out8[r.uid]
        errs[r.uid] = compare(
            (hid8[r.uid], _logits(e1, hid8[r.uid])),
            (hid1[r.uid], _logits(e1, hid1[r.uid])),
            f"dense P=8 {r.uid} vs P=1", DENSE_SP_TOL)
        agree += sum(a == b for a, b in zip(toks, out1[r.uid][:n8]))
        total += n8

    # one sampled and one greedy request at P = 8: every rank samples (the
    # engine raises if their tokens differ), the sampled stream equals its
    # solo run, the greedy one its stream in the all-greedy run above (its
    # batch invariance)
    ps = DENSE_P8_SAMPLED
    greq = Request(f"d{ps['greedy']}", prompts[ps["greedy"]], n8)
    sreq = Request(f"d{ps['sampled']}s", prompts[ps["sampled"]], n8,
                   temperature=ps["temperature"], top_k=ps["top_k"],
                   top_p=ps["top_p"], seed=ps["seed"])
    e8.reset()
    outs, _, ls, recs = drive_engine(e8, smi, [greq, sreq], p8_launches,
                                     "dense P=8 sampled")
    check(outs[greq.uid] == out8[greq.uid], f"dense P=8 sampled: greedy "
          f"{greq.uid} {outs[greq.uid]} beside a sampled request, "
          f"{out8[greq.uid]} in the all-greedy run")
    solo, walls8 = solo_streams(e8, [sreq])
    check(solo[sreq.uid] == outs[sreq.uid], f"dense P=8 sampled: alone "
          f"{solo[sreq.uid]}, beside a greedy request {outs[sreq.uid]}")
    del e8
    free_device()

    # the prefix cache and chunked prefill at P = 8
    ep = _dense_engine(model, sp, c, prefix_cache=True,
                       chunk=DENSE_P8["chunk"])
    shared = rng.integers(0, cfg.vocab_size, DENSE_P8["prefix"]).tolist()
    reqp = [Request(f"px{i}", shared + rng.integers(
        0, cfg.vocab_size, n).tolist(), n8)
        for i, n in enumerate(DENSE_P8["suffixes"])]

    def prefix_launches(e):
        # a prompt with nothing cached runs its leading chunk through B2;
        # every later chunk, and a cache hit's suffix, runs B6 and B1 on
        # every rank and layer
        m = e.metrics
        leading = sum(1 for st in e.scheduler.finished.values()
                      if st.cached_len == 0)
        suffix = m.prefill_chunks - leading
        return launches_of(B2=sp * ring * L * leading, B1=sp * L * suffix,
                           B6=sp * L * suffix, B4=sp * L * m.decode_steps)

    outp, hidp, lp, recp = drive_engine(ep, smi, reqp[:1], prefix_launches,
                                        "dense P=8 prefix", later=reqp[1:])
    cached = {r.uid: ep.scheduler.finished[r.uid].cached_len for r in reqp}
    check(cached[reqp[1].uid] == DENSE_P8["prefix"],
          f"dense P=8 prefix: cached lengths {cached}, want the second "
          f"request's {DENSE_P8['prefix']}-token prefix cached")
    for r in reqp:
        toks = outp[r.uid]
        mono = next_token(e1, r.tokens)
        errs[r.uid] = compare((hidp[r.uid], _logits(e1, hidp[r.uid])), mono,
                              f"dense P=8 {r.uid} vs P=1 monolithic",
                              DENSE_SP_TOL)
        agree += int(toks[0] == int(mono[1].argmax()))
        total += 1
    worst = {k: max(e[name][k] for e in errs.values()
                    for name in ("hidden", "logits")) for k in DENSE_SP_TOL}
    emit("dense_serve", model=cfg.name, params=model.param_count(),
         weights="seeded random bf16", init_s=init_s,
         p1={"prompt_lens": DENSE_PLENS, "new_tokens": DENSE_NEW, **rec1},
         p8={"prompt_lens": [DENSE_PLENS[i] for i in DENSE_P8["prompts"]],
             "new_tokens": n8, **rec8},
         p8_sampled={**ps, "prompt_lens": [DENSE_PLENS[ps["greedy"]],
                                           DENSE_PLENS[ps["sampled"]]],
                     "new_tokens": n8, "streams": outs,
                     "sampled_solo_equal": True,
                     "sampled_solo_decode_step_wall_ms_median": _median_ms(
                         walls8, lambda u, s: True), **recs},
         p8_prefix={"prefix_len": DENSE_P8["prefix"],
                    "suffix_lens": list(DENSE_P8["suffixes"]),
                    "chunk": DENSE_P8["chunk"], "cached_len": cached,
                    **recp},
         err_p8_vs_p1=errs, worst_err=worst, tol=DENSE_SP_TOL,
         tokens_agreeing_with_p1=agree / total, tokens_compared=total)
    del e1, ep, model
    return {"dense_serve_p1": l1, "dense_serve_p8": l8,
            "dense_serve_p8_sampled": ls, "dense_serve_p8_prefix": lp}


DENSE_TRAIN = {"model": "gpt-7b", "layers": 8, "seq": 4096, "steps": 3}
# bytes a parameter holds while training: bf16 weights and gradients, f32
# AdamW moments (the activations aside)
TRAIN_BYTES_PER_PARAM = 2 + 2 + 8


def _spec_params(tree):
    """Parameters a spec tree declares, counted without allocating."""
    import math

    from repro_torch.models.spec import PSpec

    if isinstance(tree, PSpec):
        return math.prod(tree.shape)
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(_spec_params(t) for t in items)


def phase_dense_train(dev, smi):
    """``trainer.train`` on the paper's GPT-7B (MHA 32/32, head size 128,
    d_ff 16384, vocab 50304) at seq 4096, batch 1, ``remat='attn_out'``,
    bf16, 3 AdamW steps on one repeated batch, at P = 1. The depth is cut
    from 32 to 8 layers: the reckoned bytes of weights, gradients and
    moments are printed for both. B2 runs 2 x 8 and B3 8 times a step.
    Then the D = 128 backward's device time from a profiled step, and one
    loss and gradient at seq 1024 under the CUDA kernels against the plain
    versions (``TRAIN_CHECK_TOL``)."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    full = registry.paper_model(DENSE_TRAIN["model"])
    L = DENSE_TRAIN["layers"]
    cfg = dataclasses.replace(full, num_layers=L)
    reckoned = {n: _spec_params(transformer.lm_specs(dataclasses.replace(
        full, num_layers=n))) * TRAIN_BYTES_PER_PARAM
        for n in (full.num_layers, L)}
    shape = _train_shape(DENSE_TRAIN["seq"])
    plan = make_plan(cfg, shape, arch=full.name, c=1)
    check(plan.remat == "attn_out", f"plan remat {plan.remat!r}")
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    steps = DENSE_TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dense_train.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=steps, log_every=steps, metrics_path=path),
            data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    check(len(recs) == steps and all(math.isfinite(x) for x in losses),
          f"dense_train losses {losses}: want {steps} finite")
    check(losses[-1] < losses[0],
          f"dense_train loss did not fall over one repeated batch: {losses}")
    want = launches_of(B2=2 * L * steps, B3=L * steps)
    check(launches == want, f"dense_train launches {launches}: want {want}")
    free_device()
    # one profiled step after one warm step: the D = 128 backward kernels
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    batch = train_step.to_device(data.get_batch(0), dev)
    step_fn(opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
    bwd = {"dkv": [0.0, 0], "dq": [0.0, 0]}
    for name, ms in _device_events(prof):
        for key, tag in (("dkv", "flash_bwd_dkv_mma"),
                         ("dq", "flash_bwd_dq_mma")):
            if tag in name:
                bwd[key][0] += ms
                bwd[key][1] += 1
    check(bwd["dkv"][1] == L and bwd["dq"][1] == L,
          f"dense_train profile: B3's kernels ran {bwd}, want {L} each")
    window = _profile_window(prof, 1, step_wall, top=12)
    del step_fn, sh, opt, prof, batch
    free_device()
    emit("dense_train", model=full.name, layers=L,
         layers_published=full.num_layers, params=model.param_count(),
         weights="seeded random bf16",
         reckoned_bytes={f"{n}_layers": b for n, b in reckoned.items()},
         reckoned_bytes_note="bf16 weights and gradients, f32 AdamW "
                             "moments: 12 B a parameter, activations aside",
         shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
         plan={"P_sp": plan.sp_size, "C": plan.c, "scheme": plan.scheme,
               "remat": plan.remat, "block_impl": plan.block_impl},
         losses=losses, grad_norm=[r["grad_norm"] for r in recs],
         step_ms=[1e3 * r["step_s"] for r in recs], wall_s=wall,
         max_memory_allocated=peak, launches=launches,
         b3_d128_device_ms={k: {"ms_per_step": v[0], "calls": v[1],
                                "ms_per_call": v[0] / max(v[1], 1)}
                            for k, v in bwd.items()},
         profile=window, card=smi)
    phase_train_check(model, dev, phase="dense_train_check")
    del model
    return launches


# ---------------------------------------------------------------------------
# phase 19: the 'fsdp' and 'tp' sharding rules, and checkpoints across
# meshes, at full width
# ---------------------------------------------------------------------------

# 2 layers for the script's time (as the schemes phase; PERF.md §4)
RULES_PHASE = {"layers": 2, "batch": 2, "c": 2, "data": 2, "ckpt_steps": 2}


def _rules_steps(model, cfg, dev, adam):
    """One train step under 'fsdp' and one under 'tp' at (data 2, c 2,
    r 1), each from the same weights (restored after it) and global batch
    2, profiled; loss and gradient norm against P = 1."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    shape = _train_shape(TRAIN_SEQ, batch=RULES_PHASE["batch"])
    plan1 = make_plan(cfg, shape, arch=ARCH, c=1)
    vg1, _ = train_step.build_value_and_grad_fn(model, plan1.run_config(),
                                                shape)
    loss1, g1 = vg1(train_step.to_device(
        SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
    loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
    del g1
    free_device()
    init = [p.detach().clone() for p in model.parameters()]
    L = cfg.num_layers
    runs, by_path = {}, {}
    for rules in ("fsdp", "tp"):
        plan = make_plan(cfg, shape, arch=ARCH, n_devices=8,
                         data=RULES_PHASE["data"], c=RULES_PHASE["c"],
                         placement="team_inner", comm_chunks=1,
                         sharding_rules=rules)
        check((plan.sp_size, plan.r, plan.data, plan.sharding_rules)
              == (4, 1, 2, rules), f"rules plan {plan}")
        step_fn, sh = plan.build_train_step(model, adam)
        opt = adamw.init_state(sh["params"], adam)
        batch = train_step.to_device(SyntheticLM(
            cfg, shape, seed=0, sp_size=plan.sp_size).get_batch(0), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt, m = step_fn(opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(counts)
        peak = torch.cuda.max_memory_allocated()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        loss_err = abs(loss - loss1)
        gnorm_rel = abs(gnorm - gnorm1) / gnorm1
        check(loss_err <= TRAIN_SP_TOL["loss_abs"]
              and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
              f"rules {rules}: loss {loss} vs P=1 {loss1} (abs {loss_err}), "
              f"grad norm {gnorm} vs {gnorm1} (rel {gnorm_rel}), beyond "
              f"{TRAIN_SP_TOL}")
        want = launches_of(B2=plan.n_devices * plan.r * 2 * L,
                           B3=plan.n_devices * plan.r * L)
        check(launches == want, f"rules {rules} launches {launches}: want "
              f"{want} (every rank's ring steps per layer, forward twice "
              f"under recompute and backward once)")
        runs[rules] = dict(loss=loss, grad_norm=gnorm, loss_abs_err=loss_err,
                           grad_norm_rel_err=gnorm_rel, wall_s=wall,
                           max_memory_allocated=peak, launches=launches,
                           profile=_profile_window(prof, 1, wall, top=8),
                           f32_add=_f32_add_rows(prof))
        by_path[f"rules_{rules}"] = launches
        del step_fn, sh, opt, prof
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        free_device()
    del init
    return dict(p1={"loss": loss1, "grad_norm": gnorm1}, runs=runs), by_path


def _rules_checkpoint(model, cfg, dev, adam):
    """``trainer.train`` under 'default' at P = 8 (ThreadMesh(2, 2)) writes
    a checkpoint at step 2; a P = 1 state restored from it holds the
    trained parameters and the saved moments bit for bit; one more step
    from it at P = 1 and one more from it at P = 8 give the same loss and
    gradient norm."""
    import pathlib
    import tempfile

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import checkpoint
    from repro_torch.models.factory import build_model, from_jax_tree
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    shape = _train_shape(TRAIN_SEQ)
    steps = RULES_PHASE["ckpt_steps"]
    plan8 = make_plan(cfg, shape, arch=ARCH, n_devices=8, c=2,
                      placement="team_inner", comm_chunks=1)
    plan1 = make_plan(cfg, shape, arch=ARCH, c=1)
    check(plan8.sharding_rules == plan1.sharding_rules == "default",
          "checkpoint plans' rules")

    def tcfg(n, ckpt):
        return trainer.TrainerConfig(num_steps=n, ckpt_every=steps,
                                     ckpt_dir=ckpt, log_every=n, seed=0)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = pathlib.Path(tmp)
        t0 = time.perf_counter()
        trainer.train(model, plan8, adam, tcfg(steps, str(ckpt)),
                      device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
        # the P = 1 state restored from the P = 8 checkpoint
        t0 = time.perf_counter()
        model1 = build_model(cfg, device=dev, seed=1)
        step1, sh1 = plan1.build_train_step(model1, adam)
        opt1 = adamw.init_state(sh1["params"], adam)
        last = trainer.restore_latest(ckpt, model1, sh1["names"], opt1)
        restore_s = time.perf_counter() - t0
        check(last == steps and opt1["step"] == steps,
              f"restore at P = 1: step {last}, want {steps}")
        params_equal = all(torch.equal(a, b) for a, b in
                           zip(model.parameters(), model1.parameters()))
        saved = checkpoint.restore(ckpt / "opt", steps, trainer.opt_tree(
            opt1, sh1["names"], cfg, "meta"))
        moments_equal = all(
            torch.equal(rows[n].to(dev), t)
            for key in ("mu", "nu")
            for rows in [from_jax_tree(saved[key], sh1["names"], cfg)]
            for n, t in zip(sh1["names"], opt1[key]))
        del saved
        check(params_equal and moments_equal,
              f"restore at P = 1: parameters equal {params_equal}, moments "
              f"equal {moments_equal} (want both bit for bit)")
        # one more step from the restored state at P = 1 ...
        batch = SyntheticLM(cfg, shape, seed=0, seq_scheme=plan1.seq_scheme,
                            sp_size=1).get_batch(steps)
        opt1, m1 = step1(opt1, train_step.to_device(batch, dev))
        m1 = {k: float(m1[k]) for k in ("loss", "grad_norm")}
        del step1, sh1, opt1, model1
        free_device()
        # ... and at P = 8 (the trainer restores the same checkpoint)
        m8 = trainer.train(model, plan8, adam, tcfg(steps + 1, str(ckpt)),
                           device=dev)
    loss_err = abs(m8["loss"] - m1["loss"])
    gnorm_rel = abs(m8["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    check(m8["step"] == steps + 1 and loss_err <= TRAIN_SP_TOL["loss_abs"]
          and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
          f"step {steps + 1} from the checkpoint: P = 8 {m8} vs P = 1 {m1} "
          f"(loss abs {loss_err}, grad norm rel {gnorm_rel}), beyond "
          f"{TRAIN_SP_TOL}")
    return dict(checkpoint_bytes=nbytes, train_s=train_s,
                restore_s=restore_s, params_bit_equal=params_equal,
                moments_bit_equal=moments_equal,
                next_step={"P8": {k: m8[k] for k in ("loss", "grad_norm")},
                           "P1": m1},
                loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel)


def phase_rules(dev, smi):
    """The 'fsdp' and 'tp' sharding rules at full width, h2o-danube-1.8b
    cut to ``RULES_PHASE['layers']`` layers, seq 4096, bf16, ``remat='attn_out'``: a. one step
    under each at (data 2, c 2, r 1) against P = 1 (``_rules_steps``), b. a
    checkpoint written at P = 8 under 'default' restored at P = 1
    (``_rules_checkpoint``)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get(ARCH),
                              num_layers=RULES_PHASE["layers"])
    model = build_model(cfg, device=dev, seed=0)
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    steps, by_path = _rules_steps(model, cfg, dev, adam)
    ckpt = _rules_checkpoint(model, cfg, dev, adam)
    del model
    emit("rules", model=cfg.name, layers=cfg.num_layers,
         seq_len=TRAIN_SEQ, weights="seeded random bf16", remat="attn_out",
         steps=steps, checkpoint=ckpt, tol=TRAIN_SP_TOL,
         phase_s=time.perf_counter() - t_phase, card=smi)
    torch.cuda.synchronize()
    return by_path


# ---------------------------------------------------------------------------
# phase 20: the MoE family served at full width
# ---------------------------------------------------------------------------

MOE_PHI, MOE_LLAMA = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"
# phi3.5-moe's 32 layers are 83.8 GB of bf16: 16 layers (42.1 GB) serve on
# the card; llama4-maverick's period (a dense layer, then a 128-expert MoE
# layer, 37.1 GB) is its cut
MOE_SERVE = {"phi_layers": 16, "llama_layers": 2, "slots": 4, "page": 16,
             "pages": 512, "max_len": 2048,
             "phi_plens": [64, 200, 336, 472, 608, 744, 880, 1024],
             "phi_new": 32, "llama_plens": [64, 384, 704, 1024],
             "llama_new": 16}


def _moe_model(arch, layers, dev, dtype="bfloat16"):
    """The full-width ``arch`` cut to ``layers``, seeded weights on the
    card, and the seconds its init took."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    cfg = dataclasses.replace(registry.get(arch), num_layers=layers,
                              param_dtype=dtype)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _moe_engine(model, prefix_cache=False, chunk=0):
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(model.cfg, arch=model.cfg.name, c=1,
                           decode_batch=MOE_SERVE["slots"],
                           page_size=MOE_SERVE["page"],
                           max_len=MOE_SERVE["max_len"],
                           prefix_cache=prefix_cache)
    return Engine(model, plan, EngineConfig(
        pages_per_shard=MOE_SERVE["pages"], prefill_chunk=chunk))


def _decode_weight_bytes(model):
    """The weight bytes one decode step reads: every layer's leaves (the
    JAX layout runs each expert's GEMMs on its ``cap`` rows, empty or not,
    so every expert is read), the final norm and the head table; the
    embedding lookup reads a row per slot."""
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters()
               if not n.startswith("embed."))


def _moe_block_device_ms(model, rt, shapes, grad=False, calls=10):
    """Device ms of one MoE block (the first MoE layer's weights) at each
    of ``shapes`` {name: (B, S)}: the forward, and with ``grad`` the
    forward and backward (input and every leaf of the block)."""
    import torch

    from repro_torch.dist.comm import SingleComm
    from repro_torch.models import moe, transformer
    from repro_torch.models.factory import shard_params

    cfg, dev = model.cfg, model.device
    i = transformer.layer_kinds(cfg).index("moe")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {}
    for name, (b, s) in shapes.items():
        x = torch.randn(b, s, cfg.d_model, device=dev, generator=gen,
                        dtype=model.embed.table.dtype)
        if not grad:
            p = model.layers[i].mlp
            with torch.no_grad():
                out[name] = device_ms(lambda: moe.moe_block(rt, p, x, cfg),
                                      calls=calls, reps=3)
            continue
        tree = shard_params(model, SingleComm(), trainable=True)
        p = tree.layers[i].mlp
        leaves = [x.requires_grad_()] + [
            t for n, t in tree.named.items() if n.startswith(f"layers.{i}.")
            and ".mlp." in n]

        def fwd_bwd():
            y, aux = moe.moe_block(rt, p, x, cfg)
            torch.autograd.grad(y.float().sum() + aux["moe_lb"]
                                + aux["moe_z"], leaves)

        out[name] = device_ms(fwd_bwd, calls=calls, reps=3)
        del tree, leaves
    return out


def _moe_serve_run(model, smi, plens, new, what, seed, strict):
    """The engine phase's run on a MoE model: greedy requests of ``plens``
    tokens, ``new`` each, launches exact (``p1_launches``), 4 profiled pure
    decode steps; then ``reset()`` and a replay that must give the same
    streams; then the CUDA kernels against the plain versions on the
    longest prompt (``phase_engine_check``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Request

    cfg = model.cfg
    engine = _moe_engine(model)
    rng = np.random.default_rng(seed)
    engine.add_request(Request("warm", rng.integers(0, cfg.vocab_size,
                                                    64).tolist(), 4))
    engine.run()
    engine.reset()
    reqs = [Request(f"{what}{i}", rng.integers(0, cfg.vocab_size,
                                               n).tolist(), new)
            for i, n in enumerate(plens)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=model.device).add_(1)
        torch.cuda.synchronize()
    out, _, launches, rec = drive_engine(engine, smi, reqs, p1_launches,
                                         what, profile_steps=4)
    m = engine.metrics
    run = dict(prefills=m.prefills, decode_steps=m.decode_steps,
               prefill_s=m.prefill_wall_s, wall_s=rec["wall_s"],
               ttft_s=rec["ttft_s"],
               decode_step_wall_ms_median=rec["decode_step_wall_ms_median"],
               decode_step_profile=rec["decode_step_profile"],
               max_memory_allocated=rec["max_memory_allocated"],
               launches=launches)
    engine.reset()
    for r in reqs:
        engine.add_request(r)
    check(engine.run() == out, f"{what}: the replay after reset() gave "
          f"other streams")
    # the whole model's next token under the CUDA kernels against the
    # plain versions, reported: bf16 rounding flips routing choices, and a
    # flipped or dropped token's expert output (~1e3 at this init) moves
    # the residual stream; the check is each layer's attention branch on
    # one input (``_moe_layer_check``)
    check_out = phase_engine_check(engine, reqs[-1].tokens,
                                   phase=f"{what}_check", strict=strict)
    run["layer_check"] = _moe_layer_check(
        model, engine.rt, engine._padded(reqs[-1].tokens),
        f"{what}_layer_check")
    return engine, launches, run, check_out


def _attn_prefill_branch(r, p, xi, cfg):
    """``attention_block`` less its residual add, which at the seeded MoE
    models' residual magnitudes (~1e3) would round the branch to bf16 ulps
    of the stream."""
    from repro_torch.models import blocks

    h = blocks.rmsnorm(p.norm, xi, cfg.norm_eps)
    q, k, v = blocks.qkv(r, p, h)
    pos = r.positions(xi.shape[1])
    q = blocks.rope(q, pos, cfg.rope_theta)
    k = blocks.rope(k, pos, cfg.rope_theta)
    return blocks.attention_out(r, p, r.attention(
        q, k, v, causal=True, window=cfg.window))


def _moe_layer_check(model, rt, tokens, what, grad=False):
    """Each layer's attention branch through the CUDA kernels against the
    plain versions on one input, the layer's input in the CUDA run (the
    next layer's input is the CUDA branch's output through the MLP or MoE
    block): a routing flip upstream cannot reach the comparison, and a
    wrong kernel fails it. Without ``grad``: the branch's output (the
    attention block less its input) under ``ENGINE_TOL`` (B2); with it, also
    the gradients of the input and of the block's leaves under a seeded
    cotangent, each within ``TRAIN_CHECK_TOL``'s ``grad_rel_l2`` (B2's
    recompute-free forward and B3). Beside it, per MoE layer, the tokens
    whose experts differ between the two branches' outputs, and the MoE
    output's RMS over its input's."""
    import dataclasses

    import torch

    from repro_torch.dist.comm import SingleComm
    from repro_torch.models import blocks, moe, transformer
    from repro_torch.models.factory import shard_params

    cfg = model.cfg
    S = tokens.shape[1]
    rt_c = dataclasses.replace(rt, st_cfg=dataclasses.replace(
        rt.st_cfg, seq_len=S, block_impl="cuda"), kernel_impl="cuda")
    rt_r = dataclasses.replace(rt_c, st_cfg=dataclasses.replace(
        rt_c.st_cfg, block_impl="ref"), kernel_impl="ref")
    tree = shard_params(model, SingleComm(), trainable=grad)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(8)
    layers = []
    with torch.no_grad():
        x = blocks.embed(rt_c, model.embed, tokens, cfg)
    for i, kind in enumerate(transformer.layer_kinds(cfg)):
        p = tree.layers[i].mixer
        leaves = [p.wq, p.wk, p.wv, p.wo, p.norm.scale]
        g_out = torch.randn(x.shape, device=x.device, dtype=x.dtype,
                            generator=gen) if grad else None
        out = {}
        for name, r in (("cuda", rt_c), ("ref", rt_r)):
            xi = x.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                b = _attn_prefill_branch(r, p, xi, cfg)
                grads = (torch.autograd.grad(b, [xi] + leaves, g_out)
                         if grad else ())
            out[name] = (b.detach(), [g.float() for g in grads])
        (b_c, g_c), (b_r, g_r) = out["cuda"], out["ref"]
        rec = {"branch": compare([b_c.float()], [b_r.float()],
                                 f"{what} layer {i} attention branch",
                                 names=("branch",))["branch"]}
        a_c, a_r = x + b_c, x + b_r
        if grad:
            names = ["x", "wq", "wk", "wv", "wo", "norm"]
            rel = {n: float((a - b).norm() / b.norm())
                   for n, a, b in zip(names, g_c, g_r)}
            worst = max(rel, key=rel.get)
            check(all(v == v for v in rel.values())
                  and rel[worst] <= TRAIN_CHECK_TOL["grad_rel_l2"],
                  f"{what} layer {i}: gradient {worst} rel L2 {rel[worst]} "
                  f"beyond {TRAIN_CHECK_TOL['grad_rel_l2']}")
            rec["grad_rel_l2"] = rel
        with torch.no_grad():
            if kind == "moe":
                m = tree.layers[i].mlp
                sel = {}
                for name, a in (("cuda", a_c), ("ref", a_r)):
                    h = blocks.rmsnorm(m.norm, a, cfg.norm_eps)
                    probs = torch.softmax(h.reshape(-1, cfg.d_model).float()
                                          @ m.router.float(), -1)
                    sel[name] = moe.route(probs, cfg.moe.top_k)[1]
                rec["tokens_routed_otherwise"] = int(
                    (sel["cuda"] != sel["ref"]).any(-1).sum())
            y = transformer.mlp_sublayer(rt_c, tree.layers[i].mlp, a_c, cfg,
                                         kind)[0]
            rec["mlp_out_rms_over_in"] = float(
                (y - a_c).float().pow(2).mean().sqrt()
                / a_c.float().pow(2).mean().sqrt())
            x = y
        layers.append(rec)
    return layers


def _moe_decode_layer_check(model, plan, cache, tok, cache_len):
    """The first decode step of the static batch, each layer's attention
    (B5 against the contiguous ``cache``) through the CUDA kernels against
    the plain versions on one input, the layer's input in the CUDA run, as
    ``_moe_layer_check`` does for the prefill; ``ENGINE_TOL``."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import blocks, transformer
    from repro_torch.serve import kv_cache, step as serve_step

    cfg, dev = model.cfg, model.device
    B, capacity = tok.shape[0], kv_cache.kv_stacks(cache)[0].shape[2]
    rt = serve_step.StaticSteps(
        model, plan.run_config(), ShapeConfig("serve", capacity, B,
                                              "decode")).rt
    rt_c = dataclasses.replace(rt, kernel_impl="cuda", st_cfg=dataclasses.
                               replace(rt.st_cfg, block_impl="cuda"))
    rt_r = dataclasses.replace(rt_c, kernel_impl="ref", st_cfg=dataclasses.
                               replace(rt_c.st_cfg, block_impl="ref"))
    cl = torch.full((B,), cache_len, dtype=torch.int32, device=dev)
    out = []
    with torch.no_grad():
        x = blocks.embed(rt_c, model.embed, tok.long(), cfg,
                         tokens_replicated=True)
        for i, kind in enumerate(transformer.layer_kinds(cfg)):
            layer = model.layers[i]
            c_i = kv_cache.layer(cache, i)
            b_c, b_r = (serve_step.attn_decode_branch(
                r, layer.mixer, x, c_i, cfg, cl, None) for r in (rt_c, rt_r))
            out.append(compare([b_c.float()], [b_r.float()],
                               f"moe legacy layer {i} decode attention",
                               names=("branch",))["branch"])
            x = transformer.mlp_sublayer(rt_c, layer.mlp, x + b_c, cfg,
                                         kind)[0]
    return out

def _moe_refusals(model):
    """An engine with chunked prefill or a prefix-cache plan on a MoE
    model raises before any step, with JAX's wording."""
    out = {}
    for name, kw in (("prefill_chunk", {"chunk": 256}),
                     ("prefix_cache", {"prefix_cache": True})):
        try:
            _moe_engine(model, **kw)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    check(out["prefill_chunk"] is not None
          and "chunked prefill" in out["prefill_chunk"]
          and out["prefix_cache"] is not None and "MoE" in out["prefix_cache"],
          f"moe_serve refusals: {out}")
    return out


def _moe_legacy(engine, smi):
    """``--legacy`` on the MoE model: 4 x 1024 tokens, 32 greedy tokens,
    B2 once per layer for the batched prefill and B5 once per layer and
    decode step; the first decode step's hidden state and logits through
    the CUDA kernels against the plain versions on the same batch (the
    engine serves its rows one prefill at a time, and capacity couples a
    batch's rows, so the engine is no reference here)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.serve import legacy_generate, legacy_start

    model, cfg = engine.model, engine.cfg
    dev = model.device
    B, S, G = LEGACY_BATCH, LEGACY_PROMPT, LEGACY_GEN
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = legacy_generate(model, engine.plan, tokens, G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    check(tuple(out.shape) == (B, G)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"moe legacy tokens {tuple(out.shape)}: want ({B}, {G}) in-vocab")
    L = cfg.num_layers
    want = launches_of(B2=L, B5=L * (G - 1))
    check(launches == want, f"moe legacy launches {launches}: want {want}")
    hidden = {}
    for impl in ("cuda", "ref"):
        plan = dataclasses.replace(engine.plan, kernel_impl=impl,
                                   block_impl=impl)
        tok0, caches, decode = legacy_start(model, plan, tokens, G)
        h1 = decode(caches, tok0.long(), torch.full(
            (B,), S, dtype=torch.int32, device=dev), return_hidden=True)
        hidden[impl] = (tok0, h1)
        del caches
    # the whole model's first decode step, reported (see _moe_serve_run);
    # the check is each layer's decode attention (B5) on one input
    errs = {}
    for b in range(B):
        got = [hidden["cuda"][1][b:b + 1].float(),
               _logits(engine, hidden["cuda"][1][b:b + 1])]
        ref = [hidden["ref"][1][b:b + 1].float(),
               _logits(engine, hidden["ref"][1][b:b + 1])]
        errs[f"row{b}"] = compare(got, ref, f"moe legacy row {b} cuda vs "
                                  f"ref", strict=False)
    tok0, caches, _ = legacy_start(model, engine.plan, tokens, G)
    layer_check = _moe_decode_layer_check(model, engine.plan, caches[0], tok0,
                                          S)
    del caches
    emit("moe_legacy", model=cfg.name, layers=L, batch=B, prompt_len=S,
         new_tokens=G, launches=launches, wall_s=wall,
         tokens_per_s=B * G / wall, err_cuda_vs_ref=errs,
         layer_check=layer_check, tol=ENGINE_TOL,
         first_tokens_equal=bool(torch.equal(hidden["cuda"][0],
                                             hidden["ref"][0])),
         card=smi)
    return launches


def phase_moe_serve(dev, smi):
    """Phase 20: a. phi3.5-moe at full width, 16 of 32 layers, the engine
    at P = 1 (4 slots, pages of 16) on the engine phase's workload; b.
    ``--legacy`` on it; c. llama4-maverick at full width, one period (a
    dense layer, then the 128-expert MoE layer), 4 requests. Each run's
    launches are exact, its replay after ``reset()`` equal and its longest
    prompt's next token through the CUDA kernels within ``ENGINE_TOL`` of
    the plain versions."""
    import torch

    from repro_torch.roofline import hw

    t_phase = time.perf_counter()
    by_path, runs = {}, {}
    for arch, layers, plens, new, key in (
            (MOE_PHI, MOE_SERVE["phi_layers"], MOE_SERVE["phi_plens"],
             MOE_SERVE["phi_new"], "moe_serve_phi"),
            (MOE_LLAMA, MOE_SERVE["llama_layers"], MOE_SERVE["llama_plens"],
             MOE_SERVE["llama_new"], "moe_serve_llama")):
        t_run = time.perf_counter()
        model, init_s = _moe_model(arch, layers, dev)
        # the whole-model check holds for llama4's 2 layers; phi's 16
        # amplify bf16 rounding through the routing (_moe_serve_run)
        engine, launches, run, _ = _moe_serve_run(
            model, smi, plens, new, key, seed=0, strict=arch == MOE_LLAMA)
        by_path[key] = launches
        weights = _decode_weight_bytes(model)
        prof = run["decode_step_profile"] or {}
        run.update(
            model=arch, layers=layers, params=model.param_count(),
            init_s=init_s, prompt_lens=plens, new_tokens=new,
            decode_weight_bytes=weights,
            decode_weight_read_bound_ms=weights / hw.HBM_BW * 1e3,
            decode_step_device_ms=prof.get("device_ms_per_step"),
            decode_idle_share=prof.get("idle_share"),
            decode_launches_per_step=prof.get("kernel_launches_per_step"),
            moe_block_device_ms=_moe_block_device_ms(
                model, engine.rt, {"decode_4_slots": (4, 1),
                                   "prefill_1024": (1, 1024)}))
        if arch == MOE_PHI:
            by_path["moe_legacy"] = _moe_legacy(engine, smi)
        else:
            run["refusals"] = _moe_refusals(model)
        run["run_s"] = time.perf_counter() - t_run
        runs[key] = run
        del engine, model
        free_device()
    emit("moe_serve", weights="seeded random bf16", runs=runs,
         phase_s=time.perf_counter() - t_phase, card=smi)
    torch.cuda.synchronize()
    return by_path


# ---------------------------------------------------------------------------
# phase 21: the MoE family trained at full width
# ---------------------------------------------------------------------------

# phi3.5-moe cut to 2 layers: bf16 weights and gradients and f32 moments
# are 34.4 GB; seq 4096, batch 1, attn_out. b. runs P = 8 as
# ThreadMesh(c=2, r=1, data=2) (8 experts on each data shard), global
# batch 2, the capacity lifted to 8.0 as the reference's check_spmd_model
MOE_TRAIN = {"layers": 2, "steps": 3, "mesh": (2, 1, 2), "batch": 2,
             "lifted_capacity": 8.0}


def _ce_and_aux(model, batch):
    """(cross-entropy, aux) of ``batch`` at P = 1, no graph."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.models import blocks, transformer
    from repro_torch.train import step as train_step

    shape = _train_shape(batch["tokens"].shape[1], batch["tokens"].shape[0])
    rt = train_step.make_runtime(model, RunConfig(), shape)
    cfg = model.cfg
    with torch.no_grad():
        x = blocks.embed(rt, model.embed, batch["tokens"], cfg)
        x, aux = transformer.apply_stack(rt, model.layers, x, cfg)
        x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
        ce = blocks.lm_head_logits_and_loss(rt, model.head, x,
                                            batch["labels"], cfg)
    return float(ce), float(aux)


def _moe_train_parts_ms(model, plan, dev):
    """Device ms of the step's parts, each alone on the step's shapes: one
    MoE block's forward and backward at seq 4096, the loss head's forward
    and backward, and one AdamW update of every parameter (f32 moments)."""
    import torch

    from repro_torch.models import blocks
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step

    cfg = model.cfg
    rt = train_step.make_runtime(model, plan.run_config(),
                                 plan.shape_config())
    out = {"moe_block_fwd_bwd": _moe_block_device_ms(
        model, rt, {"seq_4096": (1, TRAIN_SEQ)}, grad=True, calls=5)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    x = torch.randn(1, TRAIN_SEQ, cfg.d_model, device=dev, generator=gen,
                    dtype=model.embed.table.dtype, requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device=dev,
                           generator=gen)
    table = model.head.table.detach().requires_grad_()
    head = types.SimpleNamespace(table=table)

    def loss_head():
        loss = blocks.lm_head_logits_and_loss(rt, head, x, labels, cfg)
        torch.autograd.grad(loss, [x, table])

    out["loss_head_fwd_bwd"] = device_ms(loss_head, calls=5, reps=3)
    del x, table, head
    params = [p for p in model.parameters()]
    adam = adamw.AdamWConfig(learning_rate=0.0, warmup_steps=0,
                             weight_decay=0.0, state_dtype=cfg.opt_dtype)
    state = adamw.init_state(params, adam)
    grads = [torch.zeros_like(p) for p in params]
    out["adamw"] = device_ms(lambda: adamw.apply(params, grads, state, adam),
                             calls=3, reps=3)
    del state, grads
    return out


def _moe_train_p1(model, dev, smi):
    """a. P = 1, batch 1, capacity 1.25: the fresh model's loss and every
    gradient leaf through the CUDA kernels against the plain versions
    (``TRAIN_CHECK_TOL``), 3 trainer steps on one repeated batch (the loss
    must fall; the aux term printed apart), a profiled step, the parts'
    device ms."""
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step
    from repro_torch.train import trainer

    from repro_torch.configs.base import RunConfig

    cfg = model.cfg
    # the whole model's loss and gradients, reported (see _moe_serve_run);
    # the check is each layer's attention forward and backward on one input
    phase_train_check(model, dev, phase="moe_train_check", strict=False)
    free_device()
    check_batch = train_step.to_device(SyntheticLM(
        cfg, _train_shape(1024), seed=1).get_batch(0), dev)
    layer_check = _moe_layer_check(
        model, train_step.make_runtime(model, RunConfig(),
                                       _train_shape(1024)),
        check_batch["tokens"], "moe_train_layer_check", grad=True)
    del check_batch
    free_device()
    shape = _train_shape(TRAIN_SEQ)
    plan = make_plan(cfg, shape, arch=cfg.name, c=1)
    check(plan.remat == "attn_out", f"moe plan remat {plan.remat!r}")
    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=cfg.opt_dtype)
    data = RepeatBatch(SyntheticLM(cfg, shape, seed=0,
                                   seq_scheme=plan.seq_scheme,
                                   sp_size=plan.sp_size))
    batch = train_step.to_device(data.batch, dev)
    before = _ce_and_aux(model, batch)
    torch.cuda.reset_peak_memory_stats()
    steps = MOE_TRAIN["steps"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_train_metrics.jsonl")
        counts = reset_counts()
        t0 = time.perf_counter()
        trainer.train(model, plan, adam, trainer.TrainerConfig(
            num_steps=steps, log_every=steps, metrics_path=path),
            data_source=data, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    check(len(recs) == steps and all(math.isfinite(x) for x in losses),
          f"moe_train losses {losses}: want {steps} finite")
    check(losses[-1] < losses[0],
          f"moe_train loss did not fall over one repeated batch: {losses}")
    L = cfg.num_layers
    want = launches_of(B2=2 * L * steps, B3=L * steps)
    check(launches == want, f"moe_train launches {launches}: want {want}")
    after = _ce_and_aux(model, batch)
    # a profiled step (the trainer's state is not kept: fresh moments)
    step_fn, sh = plan.build_train_step(model, adam)
    opt = adamw.init_state(sh["params"], adam)
    step_fn(opt, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step_fn(opt, batch)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t1
    window = _profile_window(prof, 1, step_wall, top=12)
    del step_fn, sh, opt, prof
    free_device()
    parts = _moe_train_parts_ms(model, plan, dev)
    free_device()
    return dict(
        layer_check=layer_check,
        plan={"P_sp": plan.sp_size, "remat": plan.remat,
              "seq_scheme": plan.seq_scheme},
        adamw={"lr": adam.learning_rate, "state_dtype": adam.state_dtype},
        losses=losses, grad_norm=[r["grad_norm"] for r in recs],
        ce_aux_before={"ce": before[0], "aux": before[1]},
        ce_aux_after={"ce": after[0], "aux": after[1]},
        step_ms=[1e3 * r["step_s"] for r in recs], wall_s=wall,
        max_memory_allocated=peak, launches=launches,
        profiled_step=window, parts_device_ms=parts)


def _moe_train_mesh(model, dev, smi):
    """b. P = 8 on ThreadMesh(c=2, r=1, data=2), global batch 2, capacity
    8.0: one profiled train step's loss and gradient norm against P = 1 on
    the same weights and batch (``TRAIN_SP_TOL``), launches exact, the
    ledger's all-to-all bytes beside the reckoning."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    cfg0 = model.cfg
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, capacity_factor=MOE_TRAIN["lifted_capacity"]))
    model.cfg = cfg                     # the same weights, capacity lifted
    try:
        c, r, data = MOE_TRAIN["mesh"]
        shape = _train_shape(TRAIN_SEQ, batch=MOE_TRAIN["batch"])
        plan1 = make_plan(cfg, shape, arch=cfg.name, c=1)
        vg1, _ = train_step.build_value_and_grad_fn(
            model, plan1.run_config(), shape)
        loss1, g1 = vg1(train_step.to_device(
            SyntheticLM(cfg, shape, seed=0).get_batch(0), dev))
        loss1, gnorm1 = float(loss1), float(adamw.global_norm(g1))
        del g1, vg1
        free_device()
        plan = make_plan(cfg, shape, arch=cfg.name, n_devices=8, data=data,
                         c=c, placement="team_inner", comm_chunks=1)
        check((plan.sp_size, plan.r, plan.data) == (4, r, data),
              f"moe mesh plan {plan}")
        adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                                 state_dtype=cfg.opt_dtype)
        step_fn, sh = plan.build_train_step(model, adam)
        opt = adamw.init_state(sh["params"], adam)
        batch = train_step.to_device(SyntheticLM(
            cfg, shape, seed=0, sp_size=plan.sp_size).get_batch(0), dev)
        sh["comm"].reset_ledgers()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt, m = step_fn(opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(counts)
        peak = torch.cuda.max_memory_allocated()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        loss_err = abs(loss - loss1)
        gnorm_rel = abs(gnorm - gnorm1) / gnorm1
        check(loss_err <= TRAIN_SP_TOL["loss_abs"]
              and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
              f"moe_train P=8: loss {loss} vs P=1 {loss1} (abs {loss_err}), "
              f"grad norm {gnorm} vs {gnorm1} (rel {gnorm_rel}), beyond "
              f"{TRAIN_SP_TOL}")
        L = cfg.num_layers
        want = launches_of(B2=plan.n_devices * plan.r * 2 * L,
                           B3=plan.n_devices * plan.r * L)
        check(launches == want, f"moe_train P=8 launches {launches}: want "
              f"{want}")
        ledger = sh["comm"].ledgers[0].snapshot()
        n_moe = transformer.layer_kinds(cfg).count("moe")
        tokens = shape.seq_len // plan.sp_size          # a rank's T
        cap = moe_lib._capacity(tokens, cfg.moe)
        # the dispatch and the return each move a rank's (E, cap, D) but
        # its own slice; under attn_out the forward runs twice
        reckoned = 2 * (cfg.moe.num_experts * cap * cfg.d_model
                        * model.embed.table.element_size()) \
            * (data - 1) / data
        a2a_fwd = ledger["forward"]["all-to-all"]
        per_layer = a2a_fwd / (2 * n_moe)
        check(per_layer == reckoned, f"moe_train P=8: ledger all-to-all "
              f"{per_layer} B per layer and forward, reckoned {reckoned}")
        run = dict(mesh={"c": c, "r": r, "data": data},
                   capacity_factor=cfg.moe.capacity_factor, cap=cap,
                   p1={"loss": loss1, "grad_norm": gnorm1},
                   p8={"loss": loss, "grad_norm": gnorm},
                   loss_abs_err=loss_err, grad_norm_rel_err=gnorm_rel,
                   wall_s=wall, max_memory_allocated=peak, launches=launches,
                   profile=_profile_window(prof, 1, wall, top=10),
                   all_to_all_bytes={
                       "ledger_forward_rank0": a2a_fwd,
                       "ledger_backward_rank0":
                           ledger["backward"]["all-to-all"],
                       "per_layer_forward": per_layer,
                       "reckoned_per_layer_forward": reckoned,
                       "note": "the forward counts each MoE layer twice "
                               "(attn_out recomputes it in the backward)"})
        del step_fn, sh, opt, prof
    finally:
        model.cfg = cfg0
    free_device()
    return run, launches


def _moe_f32_checks(dev):
    """phi3.5-moe at 2 layers in f32 (the CUDA-core kernels): the whole
    model's next token of a 1024-token prompt (``phase_engine_check``) and
    its loss and gradients (``phase_train_check``) through the CUDA kernels
    against the plain versions, both checked: f32 rounding moves no
    routing choice here, so the whole model holds the bounds its bf16
    twin's routing cannot."""
    import numpy as np

    model, _ = _moe_model(MOE_PHI, MOE_TRAIN["layers"], dev,
                          dtype="float32")
    engine = _moe_engine(model)
    prompt = np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, 1024).tolist()
    phase_engine_check(engine, prompt, phase="moe_f32_engine_check")
    del engine
    free_device()
    phase_train_check(model, dev, phase="moe_f32_train_check")
    del model
    free_device()


def phase_moe_train(dev, smi):
    """Phase 21: phi3.5-moe at full width, 2 layers, seq 4096, bf16,
    ``attn_out``: a. P = 1 (``_moe_train_p1``), b. P = 8 at (c 2, r 1,
    data 2) with the capacity lifted (``_moe_train_mesh``); first, the f32
    whole-model checks (``_moe_f32_checks``)."""
    import torch

    t_phase = time.perf_counter()
    _moe_f32_checks(dev)
    model, init_s = _moe_model(MOE_PHI, MOE_TRAIN["layers"], dev)
    p1 = _moe_train_p1(model, dev, smi)
    mesh, mesh_launches = _moe_train_mesh(model, dev, smi)
    emit("moe_train", model=MOE_PHI, layers=MOE_TRAIN["layers"],
         params=model.param_count(), init_s=init_s, seq_len=TRAIN_SEQ,
         weights="seeded random bf16", remat="attn_out", p1=p1, p8=mesh,
         tol={"check": TRAIN_CHECK_TOL, "mesh": TRAIN_SP_TOL},
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    torch.cuda.synchronize()
    return {"moe_train": p1["launches"], "moe_train_mesh": mesh_launches}


# ---------------------------------------------------------------------------
# phase 22: --legacy at SP degree 4
# ---------------------------------------------------------------------------

# full-width h2o-danube-1.8b on ThreadMesh(c=2, r=1), phase 8b's 4 prompts
# of 1024 tokens; 8 new tokens, as a P = 4 decode step takes ~1.4 s of
# wall (the 4 rank threads share one interpreter)
LEGACY_SP = {"n_devices": 4, "c": 2, "new": 8}


def _head_logits(model, hidden):
    """The (B, V) f32 logits of (B, 1, D) hidden states on one rank."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.engine import sampling
    from repro_torch.train import step as train_step

    rt = train_step.make_runtime(model, RunConfig(), _train_shape(1024))
    with torch.no_grad():
        logits, _ = sampling.shard_logits(rt, model.head, hidden, model.cfg)
    return logits


def _profile_call(fn, top=8):
    """``_profile_window`` of one call of ``fn`` under ``torch.profiler``,
    CUDA activity only (the xLSTM windows hold ~10^5 launches, and CPU
    activity would slow their host loops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _profile_window(prof, 1, wall, top=top)


def phase_legacy_sp(dev, smi):
    """Phase 22: ``legacy_generate`` at P = 4 on ThreadMesh(c=2, r=1) at
    the full width of h2o-danube-1.8b: phase 8b's 4 prompts of 1024
    tokens, ``LEGACY_SP['new']`` greedy tokens. The prefill runs B2 on
    every rank and unskipped ring step of each layer, each decode step B5
    on every rank and layer; the first decode step's hidden state and
    logits and the prefill's last-layer K/V through the CUDA kernels
    against the plain versions; the tokens' agreement with the same batch
    at P = 1, reported."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.serve import legacy_generate, legacy_start
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan
    from repro_torch.serve import kv_cache

    t_phase = time.perf_counter()
    cfg = registry.get(ARCH)
    model = build_model(cfg, dev, seed=0)
    B, S, G = LEGACY_BATCH, LEGACY_PROMPT, LEGACY_SP["new"]
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    t0 = time.perf_counter()
    out1 = legacy_generate(model, make_serve_plan(cfg, arch=ARCH, c=1),
                           tokens, G)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    plan = make_serve_plan(cfg, arch=ARCH, n_devices=LEGACY_SP["n_devices"],
                           c=LEGACY_SP["c"])
    check((plan.sp_size, plan.c, plan.r, plan.data) == (4, 2, 1, 1),
          f"legacy_sp plan {plan}")
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = legacy_generate(model, plan, tokens, G)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counts)
    peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (B, G)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"legacy_sp tokens {tuple(out.shape)}: want ({B}, {G}) in-vocab")
    L, sp = cfg.num_layers, plan.sp_size
    # contiguous layout at (c, r) = (2, 1): rank (g, t) runs one ring step,
    # query block g against key block t, fully masked (skipped) for g < t,
    # so 3 of the 4 ranks launch B2 a layer
    ring = 3
    want = launches_of(B2=L * ring, B5=L * sp * (G - 1))
    check(launches == want,
          f"legacy_sp launches {launches}: want {want} (B2 on {ring} rank "
          f"ring steps a layer, B5 on {sp} ranks a layer and step)")
    # the CUDA kernels against the plain versions on the same batch
    runs = {}
    for impl in ("cuda", "ref"):
        plan_i = dataclasses.replace(plan, kernel_impl=impl, block_impl=impl)
        tok0, caches, decode = legacy_start(model, plan_i, tokens, G)
        h1 = decode(caches, tok0.long(), torch.full(
            (B,), S, dtype=torch.int32, device=dev), return_hidden=True)
        # the prefill's last-layer K/V, the ranks' slices in SP order
        kv = [torch.cat([kv_cache.layer(caches[r], L - 1)[n] for r in
                         decode.steps.groups()[0]], dim=1)[:, :S].float()
              for n in ("k", "v")]
        runs[impl] = (tok0, h1, kv)
        del caches, decode
    errs = {}
    for b in range(B):
        got, ref = ([h[b:b + 1].float(), _head_logits(model, h[b:b + 1])]
                    for h in (runs["cuda"][1], runs["ref"][1]))
        errs[f"row{b}"] = compare(got, ref, f"legacy_sp row {b} cuda vs ref")
    errs["prefill_last_layer_kv"] = compare(
        runs["cuda"][2], runs["ref"][2], "legacy_sp prefill K/V cuda vs ref",
        names=("k", "v"))
    check(torch.equal(runs["cuda"][0], runs["ref"][0]),
          "legacy_sp first tokens differ between the CUDA kernels and the "
          "plain versions")
    emit("legacy_sp", model=cfg.name, layers=L, batch=B, prompt_len=S,
         new_tokens=G, mesh={"c": plan.c, "r": plan.r, "data": plan.data},
         capacity=-(-(S + G) // sp) * sp, launches=launches,
         ring_steps_per_layer=ring, wall_s=wall, tokens_per_s=B * G / wall,
         p1_wall_s=wall1,
         token_agreement_with_p1=float((out == out1).float().mean()),
         max_memory_allocated=peak, err_cuda_vs_ref=errs, tol=ENGINE_TOL,
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    free_device()
    return {"legacy_sp": launches}


# ---------------------------------------------------------------------------
# phases 23-24: the xLSTM family at full width
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-1.3b"
# all 48 layers; a prompt of 1024 tokens is 256 a rank at P = 4, a
# multiple of the mLSTM's chunk of 64. New tokens by SP degree: a P = 4
# decode step takes ~0.56 s of wall (4 rank threads, one interpreter)
XLSTM_SERVE = {"batch": 4, "prompt": 1024, "new": {1: 32, 4: 8}, "c": 2,
               "layer_seq": 1024, "gla_seq": 256}
# seq cut from 2048 to 512 and the P = 8 run's depth from 48 layers to one
# period of 8, for the script's time: the sLSTM loop's launches grow with
# seq, and a P = 8 step of all 48 layers at seq 512 took ~50-60 s (8 rank
# threads sharing one interpreter; PERF.md §6)
XLSTM_TRAIN = {"seq": 512, "batch": 1, "p1_steps": 2, "mesh": (2, 2, 1),
               "mesh_steps": 2, "mesh_layers": 8, "check_seq": 256}
XLSTM_F32_TOL = 2e-5       # f32 layer checks, of the largest magnitude
XLSTM_GRAD_TOL = 2e-3      # f32 layer gradients, card against the CPU


def _xlstm_model(dev):
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    t0 = time.perf_counter()
    model = build_model(registry.get(XLSTM_ARCH), dev, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _f32_tree(module, device=None, grad=False):
    """A module's parameters as a tree of f32 leaves (copies, on
    ``device``), the nesting the blocks read."""
    import torch

    out = {n: p.detach().to(device or p.device, torch.float32, copy=True)
           .requires_grad_(grad)
           for n, p in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        out[n] = _f32_tree(child, device, grad)
    return types.SimpleNamespace(**out)


def _tree_leaves(tree, prefix=""):
    for n, t in vars(tree).items():
        if isinstance(t, types.SimpleNamespace):
            yield from _tree_leaves(t, f"{prefix}{n}.")
        else:
            yield prefix + n, t


def _rel_max(got, want):
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _contig_rt(comm, seq, dev):
    from repro_torch.core.startrail import StarTrailConfig
    from repro_torch.models.runtime import Runtime

    return Runtime(comm=comm, st_cfg=StarTrailConfig(
        seq_len=seq, seq_scheme="contiguous"), device=dev)


def _xlstm_layer_checks(model, dev):
    """f32 on the card: layer 0's ``mlstm_block`` at P = 4 (ThreadMesh(2,
    1), the slices joined) against P = 1, output and returned state; one
    ``chunked_gla`` at the mLSTM's shape on the card against the f64
    recurrence on the CPU (the CPU's own f32 result reported beside)."""
    import numpy as np
    import torch

    from repro_torch.dist.comm import SingleComm, ThreadMesh
    from repro_torch.models import ssm

    cfg = model.cfg
    S = XLSTM_SERVE["layer_seq"]
    p = _f32_tree(model.layers[0].mixer)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((1, S, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        y1, st1 = ssm.mlstm_block(_contig_rt(SingleComm(), S, dev), p, x,
                                  cfg, return_state=True)
    mesh = ThreadMesh(2, 1)
    n = S // mesh.size

    def rank_fn(comm):
        rt = _contig_rt(comm, S, dev)
        r = rt.sp_rank()
        with torch.no_grad():
            y, st = ssm.mlstm_block(rt, p, x[:, r * n:(r + 1) * n], cfg,
                                    return_state=True)
        return r, y, st["state"]

    out = sorted(mesh.run(rank_fn), key=lambda t: t[0])
    report = {}
    errs = {"mlstm_p4_vs_p1_out": _rel_max(
        torch.cat([y for _, y, _ in out], dim=1), y1),
            "mlstm_p4_vs_p1_state": max(_rel_max(s, st1["state"])
                                        for _, _, s in out)}
    G = XLSTM_SERVE["gla_seq"]
    H, N = cfg.num_heads, cfg.d_model // cfg.num_heads
    rng = np.random.default_rng(12)
    q, k = (rng.normal(size=(1, G, H, N)).astype(np.float32) * N ** -0.25
            for _ in range(2))
    v = rng.normal(size=(1, G, H, N + 1)).astype(np.float32)
    ld = np.log(1.0 / (1.0 + np.exp(-rng.normal(size=(1, G, H)) - 3.0))
                ).astype(np.float32)
    arrs = [torch.from_numpy(a) for a in (q, k, v, ld)]
    got = ssm.chunked_gla(*(a.to(dev) for a in arrs), cfg.xlstm.chunk)
    cpu = ssm.chunked_gla(*arrs, cfg.xlstm.chunk)
    want = _gla_f64(*arrs)
    for name, a, b, c in zip(("y", "h_fin", "ld_tot", "la"), got, want,
                             cpu):
        errs[f"chunked_gla_card_vs_f64_{name}"] = _rel_max(a.cpu(), b)
        # reported: the host's own f32 sums are no reference at 2e-5
        report[f"chunked_gla_cpu_vs_f64_{name}"] = _rel_max(c, b)
    bad = {k_: v_ for k_, v_ in errs.items() if not v_ <= XLSTM_F32_TOL}
    check(not bad, f"xlstm f32 layer checks beyond {XLSTM_F32_TOL} of the "
          f"largest magnitude: {bad}")
    return {**errs, **report}


def _gla_f64(q, k, v, ld):
    """``chunked_gla``'s four outputs by the token-by-token recurrence in
    f64 on the CPU (the reference of ``test_ssm_and_roofline``)."""
    import torch

    q, k, v, ld = (a.double() for a in (q, k, v, ld))
    B, S, H, N = q.shape
    h = torch.zeros((B, H, N, v.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * ld[:, t].exp()[..., None, None] \
            + k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, t], h))
    return torch.stack(ys, 1), h, ld.sum(1), ld.cumsum(1)


def _xlstm_serve_run(model, plan, tokens, new):
    """``--legacy`` at ``plan``'s ranks: ``legacy_generate``'s steps
    (``legacy_start``, then ``new - 1`` decode steps) timed one by one;
    the tokens, the launches (none: the family runs no attention kernel),
    the prefill's wall (with the cache's expansion) and each decode
    step's, a profiled decode step and prefill, peak memory."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import legacy_start
    from repro_torch.serve import step as serve_step

    B, S = tokens.shape
    dev = model.device
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches, decode = legacy_start(model, plan, tokens, new)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    toks, walls = [tok], []
    for i in range(new - 1):
        cl = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        tok = decode(caches, tok.long(), cl)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    launches = read_counts(counts)
    out = torch.cat(toks, dim=1)
    check(launches == launches_of(), f"xlstm_serve P={plan.sp_size} "
          f"launched {launches}: the family runs no attention kernel")
    check(tuple(out.shape) == (B, new)
          and bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
          f"xlstm tokens {tuple(out.shape)}: want ({B}, {new}) in-vocab")
    cl = torch.full((B,), S + new - 1, dtype=torch.int32, device=dev)
    decode_prof = _profile_call(lambda: decode(caches, tok.long(), cl))
    peak = torch.cuda.max_memory_allocated()
    del caches, decode
    prefill = serve_step.build_prefill_step(
        model, plan.run_config(), ShapeConfig("serve", S, B, "prefill"),
        plan.build_mesh())
    prefill_prof = _profile_call(lambda: prefill(tokens))
    del prefill
    free_device()
    wall = prefill_wall + sum(walls)
    return out, dict(
        launches=launches, new_tokens=new, wall_s=wall,
        tokens_per_s=B * new / wall, prefill_wall_s=prefill_wall,
        decode_step_wall_ms=[1e3 * min(walls), 1e3 * statistics.median(
            walls), 1e3 * max(walls)],
        decode_step_profile=decode_prof, prefill_profile=prefill_prof,
        max_memory_allocated=peak)


def phase_xlstm_serve(dev, smi):
    """Phase 23: full-width xlstm-1.3b (48 layers: 42 mLSTM, 6 sLSTM;
    seeded bf16) served by ``--legacy`` at P = 1 and at P = 4 on
    ThreadMesh(c=2, r=1): 4 prompts of 1024 tokens, 32 greedy tokens at
    P = 1 and 8 at P = 4. Each run's prefill and decode steps: wall, a
    profiled window's device ms, idle share and kernel launches, peak
    memory; no attention kernel launches. f32 layer checks first
    (``_xlstm_layer_checks``); the bf16 tokens' agreement between P = 1
    and P = 4 reported (the sLSTM's shard-local prefill state differs by
    construction)."""
    import numpy as np
    import torch

    from repro_torch.plan import make_serve_plan
    from repro_torch.roofline import hw

    t_phase = time.perf_counter()
    model, init_s = _xlstm_model(dev)
    cfg = model.cfg
    t0 = time.perf_counter()
    layer_checks = _xlstm_layer_checks(model, dev)
    layer_checks_s = time.perf_counter() - t0
    free_device()
    B, S = XLSTM_SERVE["batch"], XLSTM_SERVE["prompt"]
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    runs, outs, by_path = {}, {}, {}
    for n, new in XLSTM_SERVE["new"].items():
        t0 = time.perf_counter()
        plan = make_serve_plan(cfg, arch=XLSTM_ARCH, n_devices=n,
                               c=XLSTM_SERVE["c"] if n > 1 else 1)
        check(plan.sp_size == n, f"xlstm plan {plan}")
        outs[n], runs[f"p{n}"] = _xlstm_serve_run(model, plan, tokens, new)
        runs[f"p{n}"]["run_s"] = time.perf_counter() - t0
        by_path[f"xlstm_serve_p{n}"] = runs[f"p{n}"]["launches"]
    n1, n4 = XLSTM_SERVE["new"]
    k = min(XLSTM_SERVE["new"].values())
    d = cfg.d_model // cfg.num_heads
    n_mlstm = sum(cfg.mixer_on_layer(i) == "mlstm"
                  for i in range(cfg.num_layers))
    state_bytes = n_mlstm * B * cfg.num_heads * d * (d + 1) * 4
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name != "embed.table")
    bound = (weight_bytes + 2 * state_bytes) / hw.HBM_BW * 1e3
    emit("xlstm_serve", model=cfg.name, layers=cfg.num_layers,
         params=model.param_count(), init_s=init_s,
         weights="seeded random bf16", batch=B, prompt_len=S,
         layer_checks=layer_checks, layer_checks_s=layer_checks_s,
         layer_tol=XLSTM_F32_TOL, runs=runs,
         token_agreement_p1_p4=float(
             (outs[n1][:, :k] == outs[n4][:, :k]).float().mean()),
         decode_bytes={"weights_less_embedding": weight_bytes,
                       "mlstm_states": state_bytes,
                       "p1_bound_ms": bound, "p4_bound_ms": n4 * bound},
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    free_device()
    return by_path


def _xlstm_grad_checks(model, dev):
    """f32: one mLSTM layer's and one sLSTM layer's gradients (every
    parameter and the input) of a fixed random projection of the block's
    output, on the card against the CPU, at ``check_seq`` tokens."""
    import torch

    from repro_torch.dist.comm import SingleComm
    from repro_torch.models import ssm

    cfg = model.cfg
    S = XLSTM_TRAIN["check_seq"]
    gen = torch.Generator().manual_seed(13)
    x0 = torch.randn((1, S, cfg.d_model), generator=gen)
    w = torch.randn((1, S, cfg.d_model), generator=gen)
    errs = {}
    for kind in ("mlstm", "slstm"):
        i = next(j for j in range(cfg.num_layers)
                 if cfg.mixer_on_layer(j) == kind)
        grads = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            p = _f32_tree(model.layers[i].mixer, where, grad=True)
            x = x0.to(where, copy=True).requires_grad_()
            y = ssm.MIXERS[kind][1](_contig_rt(SingleComm(), S, where), p,
                                    x, cfg)
            (y * w.to(where)).sum().backward()
            grads[label] = {"x": x.grad, **{n: t.grad for n, t in
                                            _tree_leaves(p)}}
        for n, g in grads["cpu"].items():
            errs[f"{kind}_layer{i}.{n}"] = _rel_max(grads["card"][n].cpu(), g)
    bad = {k: v for k, v in errs.items() if not v <= XLSTM_GRAD_TOL}
    check(not bad, f"xlstm f32 gradients, card vs CPU, beyond "
          f"{XLSTM_GRAD_TOL} of the largest magnitude: {bad}")
    return errs


def _repeated_steps(model, plan, batch, steps, state_dtype="float32"):
    """``steps`` AdamW steps of ``plan``'s train step on one repeated
    batch (moments in ``state_dtype``), the last profiled: losses, grad
    norms, step walls, the profile, peak memory, launches."""
    import torch

    from repro_torch.optim import adamw

    adam = adamw.AdamWConfig(learning_rate=1e-3, warmup_steps=0,
                             state_dtype=state_dtype)
    step_fn, sh = plan.build_train_step(model, adam)
    state = {"opt": adamw.init_state(sh["params"], adam)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    losses, norms, walls = [], [], []

    def step():
        t0 = time.perf_counter()
        state["opt"], m = step_fn(state["opt"], batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))

    for _ in range(steps - 1):
        step()
    window = _profile_call(step)
    launches = read_counts(counts)
    peak = torch.cuda.max_memory_allocated()
    del step_fn, sh, state
    free_device()
    return dict(losses=losses, grad_norm=norms, step_s=walls,
                profiled_step=window, max_memory_allocated=peak,
                launches=launches)


def _layers_cut(model, layers, dtype=None):
    """A model of ``model``'s first ``layers`` layers (an encoder-decoder's
    first ``layers`` encoder and decoder layers) and every other leaf, the
    weights copied (cast to ``dtype`` when given)."""
    import dataclasses

    import torch

    from repro_torch.models.factory import Model

    dtype = dtype or model.embed.table.dtype
    cfg = dataclasses.replace(model.cfg, num_layers=layers,
                              param_dtype=str(dtype).split(".")[-1])
    if cfg.encdec:
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    whole = dict(model.named_parameters())
    with torch.no_grad():
        cut = Model(cfg, lambda s: torch.empty(
            s.shape, dtype=dtype, device=model.device))
        for name, p in cut.named_parameters():
            p.copy_(whole[name])
    return cut


def phase_xlstm_train(dev, smi):
    """Phase 24: full-width xlstm-1.3b trained at seq
    ``XLSTM_TRAIN['seq']``, batch 1, bf16, ``attn_out`` (each layer
    recomputes its mixer in the backward), AdamW (f32 moments, lr 1e-3)
    on one repeated batch: 2 steps of all 48 layers at P = 1, then 2 at
    P = 8 on ThreadMesh(c=2, r=2) of its first period (8 layers: 7 mLSTM,
    1 sLSTM; the weights P = 1 left, fresh moments); the loss must be
    finite and fall, no attention kernel launches; the last step of each
    profiled. f32 gradient checks first (``_xlstm_grad_checks``)."""
    import math

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    t_phase = time.perf_counter()
    model, init_s = _xlstm_model(dev)
    t0 = time.perf_counter()
    grad_checks = _xlstm_grad_checks(model, dev)
    grad_checks_s = time.perf_counter() - t0
    free_device()
    shape = _train_shape(XLSTM_TRAIN["seq"], XLSTM_TRAIN["batch"])
    runs, by_path = {}, {}
    c, r, data = XLSTM_TRAIN["mesh"]
    for key, mesh, steps in (("p1", (1, 1, 1), XLSTM_TRAIN["p1_steps"]),
                             ("p8", (c, r, data), XLSTM_TRAIN["mesh_steps"])):
        t0 = time.perf_counter()
        if key == "p8":
            trained = model
            model = _layers_cut(trained, XLSTM_TRAIN["mesh_layers"])
            del trained
            free_device()
        cfg = model.cfg
        plan = make_plan(cfg, shape, arch=cfg.name,
                         n_devices=mesh[2] * mesh[0] ** 2 * mesh[1],
                         data=mesh[2], c=mesh[0])
        check((plan.c, plan.r, plan.data) == mesh and plan.remat ==
              "attn_out" and plan.seq_scheme == "contiguous",
              f"xlstm plan {plan}")
        batch = train_step.to_device(SyntheticLM(
            cfg, shape, seed=0, seq_scheme=plan.seq_scheme,
            sp_size=plan.sp_size).get_batch(0), dev)
        run = _repeated_steps(model, plan, batch, steps)
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"xlstm_train {key}: losses {losses} must be finite and fall")
        check(run["launches"] == launches_of(), f"xlstm_train {key} "
              f"launched {run['launches']}: the family runs no attention "
              "kernel")
        run.update(layers=cfg.num_layers, params=model.param_count(),
                   plan={"P_sp": plan.sp_size, "c": plan.c, "r": plan.r,
                         "data": plan.data, "remat": plan.remat},
                   run_s=time.perf_counter() - t0)
        runs[key] = run
        by_path[f"xlstm_train_{key}"] = run["launches"]
    emit("xlstm_train", model=cfg.name, init_s=init_s,
         seq_len=shape.seq_len, batch=shape.global_batch,
         weights="seeded random bf16", remat="attn_out",
         grad_checks=grad_checks, grad_checks_s=grad_checks_s,
         grad_tol=XLSTM_GRAD_TOL, runs=runs,
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    free_device()
    return by_path


# ---------------------------------------------------------------------------
# phases 25-26: the hybrid family (jamba) at full width
# ---------------------------------------------------------------------------

HYBRID_ARCH = "jamba-1.5-large-398b"
# jamba's 8-layer period is 90.3 GB of bf16; its first five layers (Mamba +
# MLP, Mamba + MoE, Mamba + MLP, Mamba + MoE, attention + MLP: every (mixer,
# MLP) kind of the stack) are 48.0 GB. The MoE capacity factor is lifted to
# experts / top_k = 8, the least at which no token can be dropped, so the
# prefill, the decode steps and the full forward route alike
# (tests/test_serving_consistency.py lifts it for the same reason). A
# prompt of 1024 tokens is 256 a rank at P = 4, a multiple of the chunk.
HYBRID_SERVE = {"layers": 5, "batch": 4, "prompt": 1024,
                "new": {1: 32, 4: 8}, "c": 2, "capacity_factor": 8.0,
                "layer_seq": 256}
# one layer (Mamba + MLP, 2.08 B parameters) is the depth that trains on
# the card; P = 8 on ThreadMesh(2, 2) runs the conv halo and the state
# correction between 8 slices of 512 tokens
HYBRID_TRAIN = {"layers": 1, "seq": 4096, "batch": 1, "steps": 3,
                "mesh": (2, 2, 1), "check_seq": 256}
HYBRID_F32_TOL = 2e-5      # f32 Mamba layer, card against the CPU
HYBRID_GRAD_TOL = 2e-3     # f32 Mamba layer gradients, card against the CPU
# The tokens against the full forward's argmax. In bf16 the seeded MoE
# routes chaotically (as phase 20's phi): a near tie between two experts
# that the decode step and the full forward round apart sends a token to
# another expert, and the Mamba states carry the change to every later
# position of the row; so the five-layer bf16 run's agreement is reported.
# The check runs in f32 on the largest cut whose f32 weights fit beside
# nothing else on the card: the first three layers (Mamba + MLP, Mamba +
# MoE, Mamba + MLP; 13.2 B parameters, 52.6 GB), 2 prompts of 256 tokens,
# 8 new. A token off the argmax must be a near tie there: its full-forward
# logit within ``HYBRID_TIE`` standard deviations of the logits below the
# largest (a wrong cache or state lands several below).
HYBRID_F32_SERVE = {"layers": 3, "batch": 2, "prompt": 256, "new": 8}
HYBRID_TIE = 0.1


def _hybrid_model(layers, dev, capacity_factor=None, dtype="bfloat16"):
    """Full-width jamba cut to its first ``layers`` layers (the port's
    depth cut below one period), seeded weights in ``dtype`` on the card,
    the MoE capacity factor lifted when given; and the seconds its init
    took."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    cfg = dataclasses.replace(registry.get(HYBRID_ARCH), num_layers=layers,
                              param_dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _hybrid_layer_checks(model, dev):
    """f32: layer 0's ``mamba_block`` (output, SSM state, conv state) on
    the card at P = 1 and at P = 4 (ThreadMesh(2, 1), the slices joined,
    the conv halo between them) against the CPU at P = 1, within
    ``HYBRID_F32_TOL`` of the largest magnitude."""
    import torch

    from repro_torch.dist.comm import SingleComm, ThreadMesh
    from repro_torch.models import ssm

    cfg = model.cfg
    S = HYBRID_SERVE["layer_seq"]
    cpu = torch.device("cpu")
    x = torch.randn((1, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(11))
    want = {}
    runs = {}
    for where in (cpu, dev):
        p = _f32_tree(model.layers[0].mixer, where)
        with torch.no_grad():
            y, st = ssm.mamba_block(_contig_rt(SingleComm(), S, where), p,
                                    x.to(where), cfg, return_state=True)
        runs[where.type] = {"out": y, **st}
    want = runs["cpu"]
    errs = {f"p1_{n}": _rel_max(t.cpu(), want[n])
            for n, t in runs[dev.type].items()}
    mesh = ThreadMesh(2, 1)
    n = S // mesh.size
    p = _f32_tree(model.layers[0].mixer, dev)
    xd = x.to(dev)

    def rank_fn(comm):
        rt = _contig_rt(comm, S, dev)
        r = rt.sp_rank()
        with torch.no_grad():
            y, st = ssm.mamba_block(rt, p, xd[:, r * n:(r + 1) * n], cfg,
                                    return_state=True)
        return r, y, st

    out = sorted(mesh.run(rank_fn), key=lambda t: t[0])
    errs["p4_out"] = _rel_max(torch.cat([y for _, y, _ in out], 1).cpu(),
                              want["out"])
    for name in ("state", "conv"):
        errs[f"p4_{name}"] = max(_rel_max(st[name].cpu(), want[name])
                                 for _, _, st in out)
    bad = {k: v for k, v in errs.items() if not v <= HYBRID_F32_TOL}
    check(not bad, f"hybrid f32 Mamba layer checks beyond {HYBRID_F32_TOL} "
          f"of the largest magnitude: {bad}")
    return errs


def _hybrid_serve_run(model, plan, tokens, new):
    """``--legacy`` at ``plan``'s ranks: ``legacy_start``, then ``new - 1``
    decode steps timed one by one; the tokens, the attention kernels'
    launches (B2 on the prefill's attention layer, B5 on every decode
    step), the prefill's wall and each decode step's, a profiled decode
    step and prefill, peak memory."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import legacy_start
    from repro_torch.serve import step as serve_step

    B, S = tokens.shape
    dev = model.device
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok, caches, decode = legacy_start(model, plan, tokens, new)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0
    toks, walls = [tok], []
    for i in range(new - 1):
        cl = torch.full((B,), S + i, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        tok = decode(caches, tok.long(), cl)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    launches = read_counts(counts)
    out = torch.cat(toks, dim=1)
    n_attn = sum(model.cfg.mixer_on_layer(i) == "attn"
                 for i in range(model.cfg.num_layers))
    sp = plan.sp_size
    # no window, so no ring step is skipped: every rank runs its R ring
    # steps of each attention layer (phase 22's h2o skips one of 4)
    check(not plan.block_skip, "hybrid_serve: ring-block skipping is on, "
          "the launch counts below assume every ring step runs")
    ring = sp * plan.r
    want = launches_of(B2=n_attn * ring, B5=n_attn * sp * (new - 1))
    check(launches == want, f"hybrid_serve P={sp} launches {launches}: "
          f"want {want} (B2 on {ring} rank ring steps of each attention "
          f"layer, B5 on {sp} ranks a decode step)")
    check(tuple(out.shape) == (B, new)
          and bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
          f"hybrid tokens {tuple(out.shape)}: want ({B}, {new}) in-vocab")
    cl = torch.full((B,), S + new - 1, dtype=torch.int32, device=dev)
    decode_prof = _profile_call(lambda: decode(caches, tok.long(), cl))
    peak = torch.cuda.max_memory_allocated()
    del caches, decode
    prefill = serve_step.build_prefill_step(
        model, plan.run_config(), ShapeConfig("serve", S, B, "prefill"),
        plan.build_mesh())
    prefill_prof = _profile_call(lambda: prefill(tokens))
    del prefill
    free_device()
    wall = prefill_wall + sum(walls)
    return out, dict(
        launches=launches, new_tokens=new, wall_s=wall,
        tokens_per_s=B * new / wall, prefill_wall_s=prefill_wall,
        decode_step_wall_ms=[1e3 * min(walls), 1e3 * statistics.median(
            walls), 1e3 * max(walls)],
        decode_step_profile=decode_prof, prefill_profile=prefill_prof,
        max_memory_allocated=peak)


def _hybrid_kernel_checks(model, plan, tokens):
    """B2 and B5 against their plain versions on this path, as phase 20's
    per-layer checks: the attention layer's branch (its block less the
    residual add: the seeded MoE layers grow the residual stream ~1e3
    times the branch, so the whole model's output would round a wrong
    branch away) through the CUDA kernels and the plain versions on one
    input, the layer's input from the CUDA run; in the prefill (B2) and in
    the first decode step against the prefilled cache (B5), on every rank
    of ``plan``; ``ENGINE_TOL``."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import legacy_start
    from repro_torch.models import blocks, ssm, transformer
    from repro_torch.serve import kv_cache, step as serve_step

    cfg = model.cfg
    B, S = tokens.shape
    kinds = transformer.layer_plan(cfg)

    def impls(rt):
        rt_c = dataclasses.replace(rt, kernel_impl="cuda", st_cfg=dataclasses.
                                   replace(rt.st_cfg, block_impl="cuda"))
        return rt_c, dataclasses.replace(
            rt_c, kernel_impl="ref",
            st_cfg=dataclasses.replace(rt_c.st_cfg, block_impl="ref"))

    def stack(rt_c, tree, x, attn, mix):
        """x through every layer, the CUDA run's; ``attn(layer, i, x)``
        gives the attention branch pair, ``mix`` runs the other mixers."""
        pairs = []
        for i, (layer, (mixer, kind)) in enumerate(zip(tree.layers, kinds)):
            if mixer == "attn":
                b_c, b_r = attn(layer, i, x)
                pairs.append((b_c.float(), b_r.float()))
                x = x + b_c
            else:
                x = mix(layer, i, x, mixer)
            x = transformer.mlp_sublayer(rt_c, layer.mlp, x, cfg, kind)[0]
        return pairs

    prefill = serve_step.build_prefill_step(
        model, plan.run_config(), ShapeConfig("serve", S, B, "prefill"),
        plan.build_mesh())

    def prefill_fn(rt, _, tree):
        rt_c, rt_r = impls(rt)
        s = S // rt.sp_size()
        own = prefill.steps.rows_of(rt, tokens)[
            :, rt.sp_rank() * s:(rt.sp_rank() + 1) * s]
        return stack(
            rt_c, tree, blocks.embed(rt_c, tree.embed, own, cfg),
            lambda layer, i, x: tuple(_attn_prefill_branch(
                r, layer.mixer, x, cfg) for r in (rt_c, rt_r)),
            lambda layer, i, x, mixer: ssm.MIXERS[mixer][1](
                rt_c, layer.mixer, x, cfg))

    pre = prefill.steps.run(prefill_fn)
    del prefill
    tok0, caches, decode = legacy_start(model, plan, tokens, 2)

    def decode_fn(rt, rank, tree):
        rt_c, rt_r = impls(rt)
        tok = decode.steps.rows_of(rt, tok0.long())
        cl = torch.full((tok.shape[0],), S, dtype=torch.int32,
                        device=tok.device)
        cache = caches[rank]
        return stack(
            rt_c, tree, blocks.embed(rt_c, tree.embed, tok, cfg,
                                     tokens_replicated=True),
            lambda layer, i, x: tuple(serve_step.attn_decode_branch(
                r, layer.mixer, x, kv_cache.layer(cache, i), cfg, cl, None)
                for r in (rt_c, rt_r)),
            lambda layer, i, x, mixer: serve_step._RECURRENT_DECODE[mixer](
                rt_c, layer.mixer, x, kv_cache.layer(cache, i), cfg))

    dec = decode.steps.run(decode_fn)
    del caches, decode
    free_device()
    errs = {}
    for what, ranks in (("prefill_b2", pre), ("decode_b5", dec)):
        for rank, pairs in enumerate(ranks):
            for j, (b_c, b_r) in enumerate(pairs):
                errs[f"{what}_rank{rank}_attn{j}"] = compare(
                    [b_c], [b_r], f"hybrid P={plan.sp_size} rank {rank} "
                    f"{what} attention branch", names=("branch",))["branch"]
    return errs


def _hybrid_full_forward_check(model, tokens, out, strict=True):
    """Teacher forcing: the full forward (the training path, P = 1) over
    the prompt and the generated tokens but the last, one row at a time;
    each generated token against its argmax. Returns the share that equal
    it and the largest gap, in standard deviations of the logits, between
    the argmax's logit and the generated token's; with ``strict`` each gap
    must be within ``HYBRID_TIE`` (a near tie), else it is reported
    (``_argmax_report``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import RunConfig
    from repro_torch.engine import sampling
    from repro_torch.models import blocks, transformer
    from repro_torch.train import step as train_step

    cfg = model.cfg
    B, S = tokens.shape
    new = out.shape[1]
    seq = torch.cat([tokens, out[:, :-1].to(tokens.dtype)], dim=1)
    seq = F.pad(seq, (0, -seq.shape[1] % cfg.mamba.chunk))
    rt = train_step.make_runtime(model, RunConfig(),
                                 _train_shape(seq.shape[1]))
    rows = []
    for b in range(B):
        with torch.no_grad():
            x = blocks.embed(rt, model.embed, seq[b:b + 1], cfg)
            x, _ = transformer.apply_stack(rt, model.layers, x, cfg,
                                           remat="none")
            x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
            logits, _ = sampling.shard_logits(
                rt, model.head, x[0, S - 1:S - 1 + new, None], cfg)
        rows.append(logits)
    return _argmax_report(cfg, rows, out, strict, "hybrid")


def _argmax_report(cfg, rows, out, strict, what):
    """Each row's generated tokens ``out[b]`` against the argmax of its
    full-forward logits ``rows[b]`` (new, V): the share that equal it and
    the largest gap, in standard deviations of the logits, between the
    argmax's logit and the generated token's; with ``strict`` each gap
    must be within ``HYBRID_TIE`` (a near tie), else it is reported."""
    import torch

    gaps, match = [], []
    for b, logits in enumerate(rows):
        valid = logits[:, :cfg.vocab_size]
        top = valid.max(-1).values
        picked = valid.gather(-1, out[b].long()[:, None])[:, 0]
        gaps.append((top - picked) / valid.std(-1))
        match.append(out[b].long() == valid.argmax(-1))
    gaps, match = torch.stack(gaps), torch.stack(match)
    worst = float(gaps.max())
    if strict:
        check(worst <= HYBRID_TIE,
              f"{what} {cfg.param_dtype} P=1 tokens off the full-forward "
              f"argmax by {worst} standard deviations of the logits (beyond "
              f"the near-tie bound {HYBRID_TIE}); {int((~match).sum())} of "
              f"{match.numel()} differ")
    free_device()
    return {"dtype": cfg.param_dtype, "layers": cfg.num_layers,
            "equal_share": float(match.float().mean()),
            "differ": [[int(b), int(i)] for b, i in (~match).nonzero()],
            "max_gap_in_std": worst, "tie_bound": HYBRID_TIE,
            "within_tie_bound": worst <= HYBRID_TIE}


def _hybrid_f32_tokens(dev):
    """``--legacy`` at P = 1 in f32 on the first ``HYBRID_F32_SERVE``
    layers (capacity lifted), its tokens held against the f32 full
    forward's argmax (``_hybrid_full_forward_check``, strict)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import legacy_generate
    from repro_torch.plan import make_serve_plan

    f = HYBRID_F32_SERVE
    t0 = time.perf_counter()
    model, _ = _hybrid_model(f["layers"], dev,
                             HYBRID_SERVE["capacity_factor"], "float32")
    cfg = model.cfg
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (f["batch"], f["prompt"]))).to(dev)
    out = legacy_generate(model, make_serve_plan(cfg, arch=HYBRID_ARCH, c=1),
                          tokens, f["new"])
    rec = _hybrid_full_forward_check(model, tokens, out)
    rec.update(params=model.param_count(), batch=f["batch"],
               prompt_len=f["prompt"], new_tokens=f["new"])
    del model
    free_device()
    return {**rec, "seconds": time.perf_counter() - t0}


def phase_hybrid_serve(dev, smi):
    """Phase 25: full-width jamba-1.5-large-398b cut to its first five
    layers (seeded bf16, MoE capacity lifted to no drops) served by
    ``--legacy`` at P = 1 and at P = 4 on ThreadMesh(c=2, r=1): 4 prompts
    of 1024 tokens, 32 greedy tokens at P = 1 and 8 at P = 4. Each run's
    prefill and decode steps: wall, a profiled window's device ms, idle
    share and launches, peak memory, B2 and B5 launches; B2 and B5 against
    their plain versions on this path; an f32 Mamba layer on the card
    against the CPU first; the P = 1 tokens against the full forward's
    argmax, reported in bf16 and checked in f32 on a three-layer cut
    (``_hybrid_f32_tokens``)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer
    from repro_torch.plan import make_serve_plan
    from repro_torch.roofline import hw

    t_phase = time.perf_counter()
    model, init_s = _hybrid_model(HYBRID_SERVE["layers"], dev,
                                  HYBRID_SERVE["capacity_factor"])
    cfg = model.cfg
    t0 = time.perf_counter()
    layer_checks = _hybrid_layer_checks(model, dev)
    layer_checks_s = time.perf_counter() - t0
    free_device()
    B, S = HYBRID_SERVE["batch"], HYBRID_SERVE["prompt"]
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    runs, outs, by_path, kernel_checks = {}, {}, {}, {}
    for n, new in HYBRID_SERVE["new"].items():
        t0 = time.perf_counter()
        plan = make_serve_plan(cfg, arch=HYBRID_ARCH, n_devices=n,
                               c=HYBRID_SERVE["c"] if n > 1 else 1)
        check(plan.sp_size == n and plan.seq_scheme == "contiguous",
              f"hybrid plan {plan}")
        outs[n], runs[f"p{n}"] = _hybrid_serve_run(model, plan, tokens, new)
        by_path[f"hybrid_serve_p{n}"] = runs[f"p{n}"]["launches"]
        kernel_checks[f"p{n}"] = _hybrid_kernel_checks(model, plan, tokens)
        runs[f"p{n}"]["run_s"] = time.perf_counter() - t0
    n1, n4 = HYBRID_SERVE["new"]
    t0 = time.perf_counter()
    full_forward = _hybrid_full_forward_check(model, tokens, outs[n1],
                                              strict=False)
    full_forward["seconds"] = time.perf_counter() - t0
    k = min(HYBRID_SERVE["new"].values())
    m = cfg.mamba
    di = m.expand * cfg.d_model
    n_mamba = sum(cfg.mixer_on_layer(i) == "mamba"
                  for i in range(cfg.num_layers))
    state_bytes = n_mamba * B * (di // m.head_dim) * m.d_state \
        * m.head_dim * 4
    conv_bytes = n_mamba * B * (m.d_conv - 1) * di * 2
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name != "embed.table")
    kv_bytes = 2 * B * (S + n1) * cfg.num_kv_heads * cfg.head_dim_ * 2
    # a decode step reads every weight but the embedding (every expert of
    # a MoE layer: the port runs each expert's rows, empty or not), reads
    # and writes the Mamba states and conv windows, reads the K/V cache
    bound = (weight_bytes + 2 * (state_bytes + conv_bytes) + kv_bytes) \
        / hw.HBM_BW * 1e3
    params, layer_plan = model.param_count(), transformer.layer_plan(cfg)
    del model
    free_device()
    full_forward_f32 = _hybrid_f32_tokens(dev)
    emit("hybrid_serve", model=cfg.name, layers=cfg.num_layers,
         layer_plan=[list(x) for x in layer_plan],
         params=params, init_s=init_s,
         weights="seeded random bf16",
         capacity_factor=cfg.moe.capacity_factor, batch=B, prompt_len=S,
         layer_checks=layer_checks, layer_checks_s=layer_checks_s,
         layer_tol=HYBRID_F32_TOL, runs=runs,
         kernel_checks=kernel_checks, tol=ENGINE_TOL,
         full_forward_p1=full_forward, full_forward_f32=full_forward_f32,
         token_agreement_p1_p4=float(
             (outs[n1][:, :k] == outs[n4][:, :k]).float().mean()),
         decode_bytes={"weights_less_embedding": weight_bytes,
                       "mamba_states": state_bytes, "conv": conv_bytes,
                       "kv_cache": kv_bytes, "p1_bound_ms": bound},
         phase_s=time.perf_counter() - t_phase, card=smi)
    return by_path


def _hybrid_grad_checks(model, dev):
    """f32: layer 0's ``mamba_block`` gradients (every parameter and the
    input) of a fixed random projection of its output, on the card at
    P = 1 and at P = 8 (ThreadMesh(2, 2): the halo's and the correction's
    backward; each rank's parameter gradients summed) against the CPU at
    P = 1, at ``check_seq`` tokens."""
    import torch

    from repro_torch.dist.comm import SingleComm, ThreadMesh
    from repro_torch.models import ssm

    cfg = model.cfg
    S = HYBRID_TRAIN["check_seq"]
    gen = torch.Generator().manual_seed(13)
    x0 = torch.randn((1, S, cfg.d_model), generator=gen)
    w = torch.randn((1, S, cfg.d_model), generator=gen)
    mixer = model.layers[0].mixer
    grads = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        p = _f32_tree(mixer, where, grad=True)
        x = x0.to(where, copy=True).requires_grad_()
        y = ssm.mamba_block(_contig_rt(SingleComm(), S, where), p, x, cfg)
        (y * w.to(where)).sum().backward()
        grads[label] = {"x": x.grad, **{n: t.grad for n, t in
                                        _tree_leaves(p)}}
    base = _f32_tree(mixer, dev)
    mesh = ThreadMesh(*HYBRID_TRAIN["mesh"])
    n = S // mesh.size
    xd, wd = x0.to(dev), w.to(dev)

    def leaf_tree(tree):
        return types.SimpleNamespace(**{
            k: leaf_tree(v) if isinstance(v, types.SimpleNamespace)
            else v.detach().requires_grad_() for k, v in vars(tree).items()})

    def rank_fn(comm):
        rt = _contig_rt(comm, S, dev)
        r = rt.sp_rank()
        p = leaf_tree(base)
        x = xd[:, r * n:(r + 1) * n].clone().requires_grad_()
        y = ssm.mamba_block(rt, p, x, cfg)
        (y * wd[:, r * n:(r + 1) * n]).sum().backward()
        return r, x.grad, {k: t.grad for k, t in _tree_leaves(p)}

    out = sorted(mesh.run(rank_fn), key=lambda t: t[0])
    mesh_grads = {"x": torch.cat([g for _, g, _ in out], dim=1)}
    for k in out[0][2]:
        mesh_grads[k] = sum(g[k] for _, _, g in out)
    errs = {}
    for name, g in grads["cpu"].items():
        errs[f"p1.{name}"] = _rel_max(grads["card"][name].cpu(), g)
        errs[f"p8.{name}"] = _rel_max(mesh_grads[name].cpu(), g)
    bad = {k: v for k, v in errs.items() if not v <= HYBRID_GRAD_TOL}
    check(not bad, f"hybrid f32 Mamba gradients, card vs CPU, beyond "
          f"{HYBRID_GRAD_TOL} of the largest magnitude: {bad}")
    return errs


def phase_hybrid_train(dev, smi):
    """Phase 26: full-width jamba-1.5-large-398b cut to one layer (Mamba +
    MLP) trained at seq ``HYBRID_TRAIN['seq']``, batch 1, bf16,
    ``attn_out`` recompute (the Mamba layer keeps only its input), AdamW
    (lr 1e-3, moments in the config's bf16) on one repeated batch: 3
    steps at P = 1, then 3 at P = 8 on ThreadMesh(c=2, r=2) (the conv halo
    and the cross-shard state correction at full width); the loss must be
    finite and fall; no attention
    kernel launches (the cut has no attention layer); the last step of
    each profiled. Each run starts from the same seeded weights (after
    P = 1's steps, a fresh Adam's first step at lr 1e-3 moves every weight
    by ~1e-3, ~10% of its scale, and the loss leaves the minimum P = 1
    reached), so P = 8's first loss and gradient norm are held against
    P = 1's (``TRAIN_SP_TOL``). f32 gradient checks first
    (``_hybrid_grad_checks``)."""
    import math

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.plan import make_plan
    from repro_torch.train import step as train_step

    t_phase = time.perf_counter()
    model, init_s = _hybrid_model(HYBRID_TRAIN["layers"], dev)
    cfg = model.cfg
    t0 = time.perf_counter()
    grad_checks = _hybrid_grad_checks(model, dev)
    grad_checks_s = time.perf_counter() - t0
    free_device()
    shape = _train_shape(HYBRID_TRAIN["seq"], HYBRID_TRAIN["batch"])
    runs, by_path = {}, {}
    for key, (c, r, data) in (("p1", (1, 1, 1)),
                              ("p8", HYBRID_TRAIN["mesh"])):
        t0 = time.perf_counter()
        if key == "p8":
            del model
            free_device()
            model, _ = _hybrid_model(HYBRID_TRAIN["layers"], dev)
        plan = make_plan(cfg, shape, arch=cfg.name,
                         n_devices=data * c * c * r, data=data, c=c)
        check((plan.c, plan.r, plan.data) == (c, r, data) and plan.remat ==
              "attn_out" and plan.seq_scheme == "contiguous",
              f"hybrid plan {plan}")
        batch = train_step.to_device(SyntheticLM(
            cfg, shape, seed=0, seq_scheme=plan.seq_scheme,
            sp_size=plan.sp_size).get_batch(0), dev)
        run = _repeated_steps(model, plan, batch, HYBRID_TRAIN["steps"],
                              state_dtype=cfg.opt_dtype)
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"hybrid_train {key}: losses {losses} must be finite and fall")
        check(run["launches"] == launches_of(), f"hybrid_train {key} "
              f"launched {run['launches']}: the one-layer cut has no "
              "attention layer")
        if key == "p8":
            p1 = runs["p1"]
            loss_err = abs(losses[0] - p1["losses"][0])
            gnorm_rel = abs(run["grad_norm"][0] - p1["grad_norm"][0]) \
                / p1["grad_norm"][0]
            run.update(first_loss_abs_err_vs_p1=loss_err,
                       first_grad_norm_rel_err_vs_p1=gnorm_rel)
            check(loss_err <= TRAIN_SP_TOL["loss_abs"]
                  and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
                  f"hybrid_train P=8 first step: loss {losses[0]} vs P=1 "
                  f"{p1['losses'][0]} (abs {loss_err}), grad norm "
                  f"{run['grad_norm'][0]} vs {p1['grad_norm'][0]} (rel "
                  f"{gnorm_rel}), beyond {TRAIN_SP_TOL}")
        run.update(plan={"P_sp": plan.sp_size, "c": plan.c, "r": plan.r,
                         "data": plan.data, "remat": plan.remat},
                   run_s=time.perf_counter() - t0)
        runs[key] = run
        by_path[f"hybrid_train_{key}"] = run["launches"]
    emit("hybrid_train", model=cfg.name, layers=cfg.num_layers,
         params=model.param_count(), init_s=init_s,
         seq_len=shape.seq_len, batch=shape.global_batch,
         weights="seeded random bf16", remat="attn_out",
         opt_dtype=cfg.opt_dtype,
         grad_checks=grad_checks, grad_checks_s=grad_checks_s,
         grad_tol=HYBRID_GRAD_TOL, runs=runs, tol=TRAIN_SP_TOL,
         phase_s=time.perf_counter() - t_phase, card=smi)
    del model
    free_device()
    return by_path


ENCDEC_ARCH = "seamless-m4t-large-v2"
# seamless-m4t-large-v2 whole (24 encoder + 24 decoder layers, 2.04 B
# parameters, 4.07 GB of bf16): the encoder prefill at 1 x 4096 frames, then
# ``--legacy`` (the encoder prefilled over ``prompt`` frames, the decoder's
# prompt fed one token a decode step, then ``new`` tokens) at P = 1 and at
# P = 4 on ThreadMesh(c=2, r=1), as (batch, prompt, new); the CUDA-vs-plain
# check teacher-forces the first ``check_positions`` tokens on both routes.
# Cut for the script's time: a P = 4 decode step takes 1.3-2.0 s of wall
# (four rank threads share one interpreter), so P = 4 serves 4 prompt
# tokens and 3 new, not 64 and 8 (71 steps and their check took 350 s on
# an H100), and P = 1 a prompt of 64 and 16 new, not 256 and 32 (the
# prompt's steps 25 s), checks over 24 and 3 positions (PERF.md §4)
ENCDEC_SERVE = {"enc_len": 4096, "c": 2,
                "legacy": {1: (2, 64, 16), 4: (2, 4, 3)},
                "check_positions": {1: 24, 4: 3}}
# the tokens against the full forward's argmax, strict in f32 at full depth
# (8.1 GB): a token off the argmax must be a near tie (``HYBRID_TIE``)
ENCDEC_F32_SERVE = {"batch": 2, "prompt": 32, "new": 8}
# all 48 layers train at P = 1; the P = 8 mesh (c 2, r 1, data 2) runs a
# 4 + 4-layer cut, against P = 1 at the same cut and batch
ENCDEC_TRAIN = {"seq": 4096, "batch": 1, "steps": 3, "cut": 4,
                "mesh": (2, 1, 2), "mesh_batch": 2, "mesh_steps": 2}
# the kernel regimes of the path (``_encdec_kernel_checks``), as (kernel,
# batch, Sq, Sk) at 16 heads of 64: B2 under no mask at the encoder's ring
# step (P = 1: 4096 queries and keys; a ring step of P = 8 at c = 2: 2048
# team queries against 1024 keys), B1 with one query row against the
# encoder output (the cross decode: 256 keys at P = 1, 16 on a rank at
# P = 4), B3 under no mask at P = 1 (the encoder's backward and the
# training cross-attention's), B1 and B3 with Sq != Sk under no mask (the
# training cross-attention of a rank at P = 4: 1024 queries against the
# 4096 gathered keys)
ENCDEC_KERNEL_CASES = {"b2_full_p1": ("B2", 1, 4096, 4096),
                       "b2_full_ring_step_p8": ("B2", 1, 2048, 1024),
                       "b1_one_row_p1": ("B1", 2, 1, 256),
                       "b1_one_row_p4_rank": ("B1", 2, 1, 16),
                       "b1_sq_ne_sk": ("B1", 1, 1024, 4096),
                       "b3_full_p1": ("B3", 1, 4096, 4096),
                       "b3_sq_ne_sk": ("B3", 1, 1024, 4096)}


def _encdec_model(dev, layers=None, dtype="bfloat16"):
    """Full-width seamless (cut to ``layers`` encoder and decoder layers
    when given), seeded weights in ``dtype`` on the card; and the seconds
    its init took."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    cfg = dataclasses.replace(registry.get(ENCDEC_ARCH), param_dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  num_encoder_layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _encdec_kernel_checks(dev):
    """The regimes the encoder-decoder runs the kernels in
    (``ENCDEC_KERNEL_CASES``), each against its plain version on the card
    at the path's shapes, bf16 and f32, to ``TOL`` (forward) and
    ``BWD_TOL`` (backward) as in phase 3; bf16 device ms against the plain
    version's, the bound and, for B1, SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    h, d = 16, 64
    out = {}
    for case, (name, b, sq, sk) in ENCDEC_KERNEL_CASES.items():
        rec = {"kernel": name, "shape": [b, sq, sk, h, d]}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            g = torch.Generator(device=dev).manual_seed(sq + sk)
            q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, sk, h, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, sk, h, d), generator=g, device=dev).to(dtype)
            pq = torch.arange(sq, dtype=torch.int32, device=dev)
            pk = torch.arange(sk, dtype=torch.int32, device=dev)
            acc = ()
            if name == "B2":
                acc = tuple(t.contiguous() for t in fa.flash_attention_fwd_plain(
                    q, k.flip(1), v.flip(1), pq, pk, causal=False))
            if name == "B3":
                do = torch.randn((b, sq, h, d), generator=g,
                                 device=dev).to(dtype)
                o, lse = fa.flash_attention_fwd_plain(q, k, v, pq, pk,
                                                      causal=False)
                delta = torch.einsum("bshd,bshd->bhs", do.float(),
                                     o.to(dtype).float()).contiguous()
                args = (q, k, v, do, lse, delta, pq, pk)
                got = fa.flash_attention_bwd(*args, causal=False)
                torch.cuda.synchronize()
                want = fa.flash_attention_bwd_plain(*args, causal=False)
                err, ok, _ = grad_err(got, want, lse, BWD_TOL)
                tol = BWD_TOL
                call = lambda: fa.flash_attention_bwd(*args, causal=False)
                plain = lambda: fa.flash_attention_bwd_plain(*args,
                                                             causal=False)
                nbytes, flops = bwd_work(q, k, pq, pk, sq * sk * b)
            else:
                o, lse = fa.flash_attention_fwd(q, k, v, pq, pk, *acc,
                                                causal=False)
                torch.cuda.synchronize()
                o_p, lse_p = fa.flash_attention_fwd_plain(
                    q, k, v, pq, pk, *acc, causal=False)
                err, ok, _ = partial_err(o, lse, o_p, lse_p, TOL[dname])
                tol = TOL[dname]
                call = lambda: fa.flash_attention_fwd(q, k, v, pq, pk, *acc,
                                                      causal=False)
                plain = lambda: fa.flash_attention_fwd_plain(
                    q, k, v, pq, pk, *acc, causal=False)
                io = 2 * (b * h * sq * d + b * h * sq) * 4
                nbytes = (q.numel() + 2 * k.numel()) * q.element_size() \
                    + (sq + sk) * 4 + io
                flops = 4 * d * h * sq * sk * b
            check(ok, f"encdec kernel check {case} {dname}: max err {err} "
                      f"(tol {tol}) or a dead row not exact")
            rec[dname] = {"max_abs_err": err, "tol": tol}
            if dtype == torch.bfloat16:
                t_b, by = bound(nbytes, flops, "bfloat16")
                rec.update(device_ms=device_ms(call, calls=10, reps=3),
                           plain_device_ms=device_ms(plain, calls=3, reps=3),
                           bound_ms=t_b, bound_by=by)
                if name == "B1":
                    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                    rec["sdpa_device_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        calls=10, reps=3)
        out[case] = rec
    free_device()
    return out


def _encdec_frames(dev, batch, length, d_model, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, length, d_model), generator=g, device=dev)


def _encdec_plan(cfg, n, impl="cuda"):
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(cfg, arch=ENCDEC_ARCH, n_devices=n,
                           c=ENCDEC_SERVE["c"] if n > 1 else 1,
                           kernel_impl=impl, block_impl=impl)
    check(plan.sp_size == n and plan.block_impl == impl
          and not plan.block_skip, f"encdec plan {plan}")
    return plan


def _encdec_prefill_run(model, n, frames):
    """The encoder prefill (``serve.step.build_prefill_step``) of
    ``frames`` at P = ``n`` on the CUDA kernels: wall, launches (B2 on
    every rank's ring step of each encoder layer: no mask, none
    skipped), a profiled call, peak memory; then the same on the plain
    versions, the two encoder outputs within ``ENGINE_TOL``."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import step as serve_step

    cfg = model.cfg
    shape = ShapeConfig("serve", frames.shape[1], frames.shape[0], "prefill")
    enc = {}
    rec = {}
    for impl in ("cuda", "ref"):
        plan = _encdec_plan(cfg, n, impl)
        prefill = serve_step.build_prefill_step(
            model, plan.run_config(), shape, plan.build_mesh())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = reset_counts()
        t0 = time.perf_counter()
        outs = prefill(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        enc[impl] = torch.cat([outs[r] for r in prefill.steps.groups()[0]],
                              dim=1)
        if impl == "cuda":
            want = launches_of(B2=cfg.num_encoder_layers * n * plan.r)
            check(launches == want, f"encdec prefill P={n} launches "
                  f"{launches}: want {want} (B2 on every rank's ring step "
                  f"of each encoder layer)")
            rec.update(launches=launches, wall_s=wall,
                       profile=_profile_call(lambda: prefill(frames)),
                       max_memory_allocated=torch.cuda.max_memory_allocated())
        else:
            rec["plain_wall_s"] = wall
        del prefill, outs
        free_device()
    rec["cuda_vs_plain"] = compare([enc["cuda"].float()], [enc["ref"].float()],
                                   f"encdec prefill P={n} enc_out",
                                   names=("enc_out",))["enc_out"]
    return enc["cuda"], rec


def _encdec_teacher_hidden(model, n, impl, tokens, frames):
    """The decoder's hidden state at every position of ``tokens`` (B, S)
    fed one a decode step after the encoder prefill of ``frames``
    (``launch.serve.encdec_caches``), at P = ``n`` on ``impl``'s kernels:
    (B, S, D) f32."""
    import torch

    from repro_torch.launch.serve import encdec_caches

    B, S = tokens.shape
    caches, decode = encdec_caches(model, _encdec_plan(model.cfg, n, impl),
                                   frames, -(-S // n) * n)
    hid = []
    for t in range(S):
        cl = torch.full((B,), t, dtype=torch.int32, device=model.device)
        hid.append(decode(caches, tokens[:, t:t + 1].long(), cl,
                          return_hidden=True).float())
    del caches, decode
    free_device()
    return torch.cat(hid, dim=1)


def _encdec_legacy_run(model, n, batch, prompt, new, seed):
    """``--legacy`` at P = ``n`` on the CUDA kernels (``legacy_start``,
    then ``new - 1`` decode steps timed one by one): tokens, launches (B2
    on the encoder prefill; on every decode step, each rank's B5 for the
    decoder's self-attention and B1 for its cross-attention in every
    layer), walls, a profiled decode step, peak memory; then the
    decoder's hidden states over the first ``check_positions`` of the
    same tokens (teacher forced) on the CUDA kernels and on the plain
    versions, within ``ENGINE_TOL``."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import legacy_start

    cfg = model.cfg
    dev = model.device
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt))).to(dev)
    frames = _encdec_frames(dev, batch, prompt, cfg.d_model, seed)
    plan = _encdec_plan(cfg, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    t0 = time.perf_counter()
    tok, caches, decode = legacy_start(model, plan, tokens, new, frames)
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - t0
    toks, walls = [tok], []
    for i in range(new - 1):
        cl = torch.full((batch,), prompt + i, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        tok = decode(caches, tok.long(), cl)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    launches = read_counts(counts)
    out = torch.cat(toks, dim=1)
    steps = prompt + new - 1
    L = cfg.num_layers
    want = launches_of(B2=cfg.num_encoder_layers * n * plan.r,
                       B1=L * n * steps, B5=L * n * steps)
    check(launches == want, f"encdec --legacy P={n} launches {launches}: "
          f"want {want} (B2 on the encoder's ring steps; B5 and B1 on {n} "
          f"ranks, {L} layers and {steps} decode steps)")
    check(tuple(out.shape) == (batch, new)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"encdec tokens {tuple(out.shape)}: want ({batch}, {new}) in-vocab")
    cl = torch.full((batch,), prompt + new - 1, dtype=torch.int32, device=dev)
    decode_prof = _profile_call(lambda: decode(caches, tok.long(), cl))
    peak = torch.cuda.max_memory_allocated()
    del caches, decode
    free_device()
    seq = torch.cat([tokens, out[:, :-1]], dim=1)[
        :, :ENCDEC_SERVE["check_positions"][n]]
    t0 = time.perf_counter()
    hid = {impl: _encdec_teacher_hidden(model, n, impl, seq, frames)
           for impl in ("cuda", "ref")}
    check_s = time.perf_counter() - t0
    errs = compare([hid["cuda"]], [hid["ref"]],
                   f"encdec --legacy P={n} decoder hidden states",
                   names=("hidden",))["hidden"]
    wall = start_wall + sum(walls)
    return out, tokens, frames, dict(
        batch=batch, prompt_len=prompt, new_tokens=new, launches=launches,
        tokens=out.tolist(), start_wall_s=start_wall,
        decode_step_wall_ms=[1e3 * min(walls), 1e3 * statistics.median(
            walls), 1e3 * max(walls)] if walls else None,
        prompt_steps_per_s=prompt / start_wall,
        tokens_per_s=batch * new / wall, decode_step_profile=decode_prof,
        max_memory_allocated=peak, hidden_cuda_vs_plain=errs,
        hidden_check_positions=seq.shape[1], hidden_check_s=check_s)


def _encdec_full_forward_check(model, tokens, frames, out, strict=True):
    """Teacher forcing: the full forward (the training path's encoder and
    decoder, P = 1) over the frames and the prompt and generated tokens
    but the last, one row at a time; each generated token against its
    argmax (``_argmax_report``)."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.engine import sampling
    from repro_torch.models import encdec
    from repro_torch.train import step as train_step

    cfg = model.cfg
    B, S = tokens.shape
    new = out.shape[1]
    seq = torch.cat([tokens, out[:, :-1].to(tokens.dtype)], dim=1)
    rt = train_step.make_runtime(model, RunConfig(seq_scheme="contiguous"),
                                 _train_shape(seq.shape[1]))
    rows = []
    for b in range(B):
        with torch.no_grad():
            enc = encdec.encode(rt, model, frames[b:b + 1], cfg)
            x = encdec.decode(rt, model, seq[b:b + 1], enc, cfg)
            logits, _ = sampling.shard_logits(
                rt, model.head, x[0, S - 1:S - 1 + new, None], cfg)
        rows.append(logits)
    return _argmax_report(cfg, rows, out, strict, "encdec")


def phase_encdec_serve(dev, smi):
    """Phase 27: full-width seamless-m4t-large-v2 whole (48 layers, seeded
    bf16). The path's kernel regimes against their plain versions first
    (``_encdec_kernel_checks``). The encoder prefill of 1 x 4096 frames at
    P = 1 and at P = 4 (ThreadMesh(c=2, r=1)), on the CUDA kernels and on
    the plain versions (``ENGINE_TOL``); ``--legacy`` at P = 1 (2 x 64,
    16 new) and at P = 4 (2 x 4, 3 new), the decoder's hidden states
    teacher forced on both routes (``ENGINE_TOL``); the P = 1 tokens
    against the full forward's argmax, reported in bf16 and checked in
    f32 at full depth on 2 x 32, 8 new."""
    t_phase = time.perf_counter()
    model, init_s = _encdec_model(dev)
    cfg = model.cfg
    t0 = time.perf_counter()
    kernel_checks = _encdec_kernel_checks(dev)
    kernel_checks_s = time.perf_counter() - t0
    frames = _encdec_frames(dev, 1, ENCDEC_SERVE["enc_len"], cfg.d_model, 5)
    prefill, enc, by_path = {}, {}, {}
    for n in (1, 4):
        t0 = time.perf_counter()
        enc[n], prefill[f"p{n}"] = _encdec_prefill_run(model, n, frames)
        prefill[f"p{n}"]["run_s"] = time.perf_counter() - t0
        by_path[f"encdec_prefill_p{n}"] = prefill[f"p{n}"]["launches"]
    prefill["p4_vs_p1"] = compare([enc[4].float()], [enc[1].float()],
                                  "encdec prefill P=4 against P=1",
                                  names=("enc_out",), strict=False)["enc_out"]
    del enc
    free_device()
    legacy, outs = {}, {}
    for n, (b, s, new) in ENCDEC_SERVE["legacy"].items():
        t0 = time.perf_counter()
        out, tokens, frames_l, rec = _encdec_legacy_run(model, n, b, s, new,
                                                        seed=7 + n)
        rec["run_s"] = time.perf_counter() - t0
        legacy[f"p{n}"] = rec
        by_path[f"encdec_legacy_p{n}"] = rec["launches"]
        outs[n] = (out, tokens, frames_l)
    t0 = time.perf_counter()
    full_forward = _encdec_full_forward_check(model, *outs[1][1:], outs[1][0],
                                              strict=False)
    full_forward["seconds"] = time.perf_counter() - t0
    from repro_torch.roofline import hw

    params = model.param_count()
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name not in ("embed.table", "frontend_proj")
                       and not name.startswith("encoder."))
    b1, s1, n1 = ENCDEC_SERVE["legacy"][1]
    kv = 2 * cfg.num_layers * b1 * (s1 + n1) * cfg.num_kv_heads \
        * cfg.head_dim_ * 2
    enc_bytes = b1 * s1 * cfg.d_model * 2
    del model, outs
    free_device()
    t0 = time.perf_counter()
    f = ENCDEC_F32_SERVE
    model32, _ = _encdec_model(dev, dtype="float32")
    out32, tokens32, frames32, rec32 = _encdec_legacy_run_f32(
        model32, f["batch"], f["prompt"], f["new"])
    full_forward_f32 = _encdec_full_forward_check(model32, tokens32,
                                                  frames32, out32)
    full_forward_f32.update(rec32, seconds=time.perf_counter() - t0)
    del model32
    free_device()
    emit("encdec_serve", model=cfg.name, params=params,
         encoder_layers=cfg.num_encoder_layers, decoder_layers=cfg.num_layers,
         init_s=init_s, weights="seeded random bf16",
         kernel_checks=kernel_checks, kernel_checks_s=kernel_checks_s,
         prefill_frames=ENCDEC_SERVE["enc_len"], prefill=prefill,
         legacy=legacy, tol=ENGINE_TOL, full_forward_p1=full_forward,
         full_forward_f32=full_forward_f32,
         decode_bytes={"decoder_weights_and_head": weight_bytes,
                       "kv_cache": kv, "enc_out": enc_bytes,
                       "p1_bound_ms": (weight_bytes + kv + enc_bytes)
                       / hw.HBM_BW * 1e3},
         phase_s=time.perf_counter() - t_phase, card=smi)
    return by_path


def _encdec_legacy_run_f32(model, batch, prompt, new):
    """``--legacy`` at P = 1 in f32 (``legacy_generate``): the tokens, the
    prompt and frames it read, and its wall."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import legacy_generate

    cfg = model.cfg
    dev = model.device
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (batch, prompt))).to(dev)
    frames = _encdec_frames(dev, batch, prompt, cfg.d_model, 8)
    t0 = time.perf_counter()
    out = legacy_generate(model, _encdec_plan(cfg, 1), tokens, new, frames)
    torch.cuda.synchronize()
    return out, tokens, frames, {"batch": batch, "prompt_len": prompt,
                                 "new_tokens": new, "tokens": out.tolist(),
                                 "legacy_wall_s": time.perf_counter() - t0}


def _encdec_train_launches(cfg, ranks, steps):
    """B2 and B3 on every self-attention ring step (R = 1 here), B1 and
    B3 on every cross-attention, forward twice under ``attn_out``."""
    self_attn = cfg.num_encoder_layers + cfg.num_layers
    return launches_of(B1=2 * cfg.num_layers * ranks * steps,
                       B2=2 * self_attn * ranks * steps,
                       B3=(self_attn + cfg.num_layers) * ranks * steps)


def _pipeline_batch(cfg, shape, plan, dev):
    """The pipeline's batch of step 0 in sequence order (``SyntheticLM`` at
    one rank), its tokens, labels and frontend embeddings (an
    encoder-decoder's frames, a VLM's patches) laid out in ``plan``'s SP
    shard order. (The pipeline draws the embeddings of a wider mesh in
    shard order directly, as the JAX one does, so at another SP degree the
    same seed puts other embeddings at each position.)"""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticLM, shard_permutation
    from repro_torch.train import step as train_step

    batch = SyntheticLM(cfg, shape, seed=0, seq_scheme="contiguous",
                        sp_size=1).get_batch(0)
    perm = shard_permutation(shape.seq_len, plan.sp_size,
                             plan.seq_scheme).reshape(-1)
    return train_step.to_device(
        {k: np.take(v, perm, axis=1) for k, v in batch.items()}, dev)


def _encdec_grad_check(model, batch, shape):
    """The first step's loss and gradients on the fresh model, CUDA
    kernels against the plain versions. In bf16 the encoder's deep query
    and key gradients are noise: their norm is ~1e-4 of the value
    gradients', and both routes land 1.5-3.7 times that norm from an f32
    model's on an H100 (PERF.md §6), so the bf16 comparison is reported,
    each route beside the f32 model's gradients, and the check
    (``TRAIN_CHECK_TOL``, as ``phase_train_check``) runs on an f32 copy of
    the model: the CUDA-core f32 kernels against the plain versions."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.models.factory import Model
    from repro_torch.train import step as train_step

    def grads(m):
        out = {}
        for impl in ("cuda", "ref"):
            vg_fn, _ = train_step.build_value_and_grad_fn(
                m, RunConfig(block_impl=impl), shape)
            out[impl] = vg_fn(batch)
            free_device()
        return out

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def summary(losses, rels, strict):
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        worst = max(rels, key=rels.get)
        ok = (all(math.isfinite(x) for x in rels.values())
              and loss_rel <= TRAIN_CHECK_TOL["loss_rel"]
              and rels[worst] <= TRAIN_CHECK_TOL["grad_rel_l2"])
        return {"loss": {"cuda": losses[0], "ref": losses[1]},
                "loss_rel": loss_rel, "strict": strict, "within_tol": ok,
                "grad_rel_l2_worst": {"leaf": worst, "value": rels[worst]},
                "grad_rel_l2_median": statistics.median(rels.values())}

    names = [n for n, _ in model.named_parameters()]
    bf = grads(model)
    rec = {"leaves": len(names), "tol": TRAIN_CHECK_TOL}
    rec["bf16"] = summary(
        [float(bf[i][0]) for i in ("cuda", "ref")],
        {n: rel(a, b) for n, a, b in zip(names, bf["cuda"][1],
                                         bf["ref"][1])}, False)
    with torch.no_grad():
        m32 = Model(dataclasses.replace(model.cfg, param_dtype="float32"),
                    lambda s: torch.empty(s.shape, device=model.device))
        for a, b in zip(m32.parameters(), model.parameters()):
            a.copy_(b)
    f32 = grads(m32)
    del m32
    rec["f32"] = summary(
        [float(f32[i][0]) for i in ("cuda", "ref")],
        {n: rel(a, b) for n, a, b in zip(names, f32["cuda"][1],
                                         f32["ref"][1])}, True)
    truth = f32["cuda"][1]
    for impl in ("cuda", "ref"):
        r = {n: rel(a, t) for n, a, t in zip(names, bf[impl][1], truth)}
        worst = max(r, key=r.get)
        rec[f"bf16_{impl}_vs_f32"] = {
            "worst": {"leaf": worst, "value": r[worst]},
            "median": statistics.median(r.values())}
    del bf, f32, truth
    free_device()
    f = rec["f32"]
    check(f["within_tol"], f"encdec_train first step in f32: loss rel "
          f"{f['loss_rel']}, worst grad leaf {f['grad_rel_l2_worst']}, "
          f"beyond {TRAIN_CHECK_TOL}")
    return rec


def phase_encdec_train(dev, smi):
    """Phase 28: full-width seamless-m4t-large-v2 whole (48 layers) trained
    at seq 4096, batch 1, bf16, ``attn_out`` recompute, AdamW (lr 1e-3,
    f32 moments) on one repeated batch of the pipeline's tokens and
    frames: the first step's gradients on the fresh model, CUDA kernels
    against the plain versions (``_encdec_grad_check``: checked in f32,
    reported in bf16), then 3 steps at
    P = 1 (loss finite and falling; B1, B2, B3 launched, the last step
    profiled). Then a 4 + 4-layer cut of the same weights at batch 2: 2
    steps at P = 1, and 2 at P = 8 on ThreadMesh(c=2, r=1, data=2) from
    the same weights and batch (``_pipeline_batch``), P = 8's first loss
    and gradient norm against P = 1's (``TRAIN_SP_TOL``)."""
    import math

    from repro_torch.plan import make_plan

    t_phase = time.perf_counter()
    model, init_s = _encdec_model(dev)
    cfg = model.cfg
    t = ENCDEC_TRAIN
    cuts = [_layers_cut(model, t["cut"]) for _ in range(2)]
    runs, by_path = {}, {}
    shape = _train_shape(t["seq"], t["batch"])
    plan = make_plan(cfg, shape, arch=cfg.name, n_devices=1, c=1)
    check(plan.remat == "attn_out", f"encdec plan {plan}")
    batch = _pipeline_batch(cfg, shape, plan, dev)
    t0 = time.perf_counter()
    grad_check = _encdec_grad_check(model, batch, shape)
    grad_check["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = _repeated_steps(model, plan, batch, t["steps"])
    losses = run["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"encdec_train p1: losses {losses} must be finite and fall")
    want = _encdec_train_launches(cfg, 1, t["steps"])
    check(run["launches"] == want, f"encdec_train p1 launches "
          f"{run['launches']}: want {want}")
    run.update(run_s=time.perf_counter() - t0, layers=2 * cfg.num_layers,
               seq_len=shape.seq_len, batch=shape.global_batch)
    runs["p1"], by_path["encdec_train_p1"] = run, run["launches"]
    params = model.param_count()
    del model
    free_device()
    cut_shape = _train_shape(t["seq"], t["mesh_batch"])
    for key, cut, (c, r, data) in (("cut_p1", cuts[0], (1, 1, 1)),
                                   ("cut_p8", cuts[1], t["mesh"])):
        t0 = time.perf_counter()
        plan = make_plan(cut.cfg, cut_shape, arch=cfg.name,
                         n_devices=data * c * c * r, data=data, c=c)
        check((plan.c, plan.r, plan.data) == (c, r, data)
              and plan.remat == "attn_out", f"encdec plan {plan}")
        batch = _pipeline_batch(cut.cfg, cut_shape, plan, dev)
        run = _repeated_steps(cut, plan, batch, t["mesh_steps"])
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"encdec_train {key}: losses {losses} must be finite and fall")
        want = _encdec_train_launches(cut.cfg, data * c * c * r,
                                      t["mesh_steps"])
        check(run["launches"] == want, f"encdec_train {key} launches "
              f"{run['launches']}: want {want}")
        if key == "cut_p8":
            p1 = runs["cut_p1"]
            loss_err = abs(losses[0] - p1["losses"][0])
            gnorm_rel = abs(run["grad_norm"][0] - p1["grad_norm"][0]) \
                / p1["grad_norm"][0]
            run.update(first_loss_abs_err_vs_p1=loss_err,
                       first_grad_norm_rel_err_vs_p1=gnorm_rel)
            check(loss_err <= TRAIN_SP_TOL["loss_abs"]
                  and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
                  f"encdec_train P=8 first step: loss {losses[0]} vs P=1 "
                  f"{p1['losses'][0]} (abs {loss_err}), grad norm "
                  f"{run['grad_norm'][0]} vs {p1['grad_norm'][0]} (rel "
                  f"{gnorm_rel}), beyond {TRAIN_SP_TOL}")
        run.update(plan={"P_sp": plan.sp_size, "c": plan.c, "r": plan.r,
                         "data": plan.data, "remat": plan.remat,
                         "seq_scheme": plan.seq_scheme},
                   layers=2 * t["cut"], seq_len=cut_shape.seq_len,
                   batch=cut_shape.global_batch,
                   run_s=time.perf_counter() - t0)
        runs[key] = run
        by_path[f"encdec_train_{key}"] = run["launches"]
    del cuts, cut
    free_device()
    emit("encdec_train", model=cfg.name, params=params,
         init_s=init_s, weights="seeded random bf16", remat="attn_out",
         opt_dtype=cfg.opt_dtype, grad_check=grad_check, runs=runs,
         tol=TRAIN_SP_TOL, phase_s=time.perf_counter() - t_phase, card=smi)
    return by_path


VLM_ARCH = "paligemma-3b"
# paligemma-3b whole (18 layers, 3.04 B parameters, 6.07 GB of bf16): the
# prefill of 1 x 4096 tokens (512 patches) at P = 1 through StarTrail (B2)
# and once through the local route (B1); ``--legacy`` at P = 1 and at P = 4
# on ThreadMesh(c=2, r=1), as (batch, prompt, new): the prompt's first
# eighth its image prefix (128 and 8 patches); the CUDA-vs-plain check
# teacher-forces the first ``check_positions`` generated tokens on both
# routes
VLM_SERVE = {"prefill": 4096, "c": 2,
             "legacy": {1: (2, 1024, 32), 4: (2, 64, 4)},
             "check_positions": {1: 32, 4: 3}}
# the tokens against the full forward's argmax, strict in f32 at a depth
# cut (its head alone is 2.1 B parameters, 8.4 GB of f32): the f32 kernels
# at head size 256 on the path (B2 f32 in the prefill, B5 f32 in decode)
VLM_F32_SERVE = {"layers": 4, "batch": 2, "prompt": 128, "new": 8}
# all 18 layers train at P = 1 (seq 4096, 512 patches); the gradient check
# in f32 on a ``check_cut``-layer copy; the P = 8 mesh (c 2, r 1, data 2)
# runs a ``cut``-layer copy against P = 1 at the same cut and batch
VLM_TRAIN = {"seq": 4096, "batch": 1, "steps": 3, "check_cut": 4,
             "cut": 2, "mesh": (2, 1, 2), "mesh_batch": 2, "mesh_steps": 2}


def _vlm_model(dev, layers=None, dtype="bfloat16"):
    """Full-width paligemma (cut to its first ``layers`` layers when
    given), seeded weights in ``dtype`` on the card; and the seconds its
    init took."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.factory import build_model

    cfg = dataclasses.replace(registry.get(VLM_ARCH), param_dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _vlm_plan(cfg, n, impl="cuda"):
    from repro_torch.plan import make_serve_plan

    plan = make_serve_plan(cfg, arch=VLM_ARCH, n_devices=n,
                           c=VLM_SERVE["c"] if n > 1 else 1,
                           kernel_impl=impl, block_impl=impl)
    check(plan.sp_size == n and plan.block_impl == impl
          and plan.scheme != "ulysses", f"vlm plan {plan}")
    return plan


def _vlm_inputs(dev, cfg, batch, length, seed):
    """Seeded prompt tokens (B, S) and patch embeddings (B, S, d_model):
    the prompt's first ``int(0.125 * S)`` positions take the patches."""
    import numpy as np
    import torch

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length))).to(dev)
    return tokens, _encdec_frames(dev, batch, length, cfg.d_model, seed)


def _vlm_prefill_run(model, tokens, patches):
    """The prefill with patches (``serve.step.lm_prefill`` at P = 1) on the
    CUDA kernels through StarTrail (B2 once a layer), then through the
    local route (B1 once a layer), then on the plain versions: walls,
    launches, a profiled call, peak memory; the next-token hidden state and
    every layer's K and V of each CUDA route against the plain versions'
    (``ENGINE_TOL``)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import step as serve_step
    from repro_torch.train import step as train_step

    cfg = model.cfg
    shape = ShapeConfig("serve", tokens.shape[1], tokens.shape[0], "prefill")
    L = cfg.num_layers
    out, rec = {}, {}
    for route in ("startrail", "local", "ref"):
        impl = "ref" if route == "ref" else "cuda"
        plan = _vlm_plan(cfg, 1, impl)
        rt = train_step.make_runtime(model, plan.run_config(), shape)
        rt = dataclasses.replace(rt, st_cfg=dataclasses.replace(
            rt.st_cfg, seq_scheme="contiguous"))
        if route == "local":
            rt = dataclasses.replace(rt, attention_impl="local")

        def run():
            with torch.no_grad():
                return serve_step.lm_prefill(rt, model, tokens, cfg,
                                             return_hidden=True,
                                             frontend_emb=patches)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = reset_counts()
        t0 = time.perf_counter()
        last, cache = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counts)
        out[route] = [last.float(), cache["k"].float(), cache["v"].float()]
        del cache
        if route == "ref":
            rec["plain_wall_s"] = wall
            continue
        want = launches_of(B2=L) if route == "startrail" \
            else launches_of(B1=L)
        check(launches == want, f"vlm prefill ({route}) launches "
              f"{launches}: want {want}")
        rec[route] = dict(launches=launches, wall_s=wall,
                          profile=_profile_call(run),
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        free_device()
    for route in ("startrail", "local"):
        rec[route]["cuda_vs_plain"] = compare(
            out[route], out["ref"], f"vlm prefill ({route}) against plain",
            names=("hidden", "k", "v"))
    rec["local_vs_startrail"] = compare(
        out["local"], out["startrail"], "vlm prefill local against "
        "StarTrail", names=("hidden", "k", "v"), strict=False)
    del out
    free_device()
    return rec


def _vlm_teacher_hidden(model, n, impl, tokens, patches, seq):
    """The hidden state after the prefill of ``tokens`` with ``patches``
    (``launch.serve.legacy_start``) at every decode step over ``seq`` (B,
    k), each at its own position, at P = ``n`` on ``impl``'s kernels: (B,
    k, D) f32."""
    import torch

    from repro_torch.launch.serve import legacy_start

    B, prompt = tokens.shape
    _, caches, decode = legacy_start(model, _vlm_plan(model.cfg, n, impl),
                                     tokens, seq.shape[1] + 1,
                                     patches=patches)
    hid = []
    for t in range(seq.shape[1]):
        cl = torch.full((B,), prompt + t, dtype=torch.int32,
                        device=model.device)
        hid.append(decode(caches, seq[:, t:t + 1].long(), cl,
                          return_hidden=True).float())
    del caches, decode
    free_device()
    return torch.cat(hid, dim=1)


def _vlm_legacy_run(model, n, batch, prompt, new, seed):
    """``--legacy`` at P = ``n`` on the CUDA kernels (``legacy_start``, then
    ``new - 1`` decode steps timed one by one): tokens, launches (B2 on the
    prefill's ring steps; B5 on every rank, layer and decode step), walls,
    a profiled decode step, peak memory; then the hidden states over the
    first ``check_positions`` generated tokens (teacher forced) on the CUDA
    kernels and on the plain versions, within ``ENGINE_TOL``."""
    import torch

    from repro_torch.launch.serve import legacy_start

    cfg = model.cfg
    dev = model.device
    tokens, patches = _vlm_inputs(dev, cfg, batch, prompt, seed)
    plan = _vlm_plan(cfg, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = reset_counts()
    t0 = time.perf_counter()
    tok, caches, decode = legacy_start(model, plan, tokens, new,
                                       patches=patches)
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - t0
    toks, walls = [tok], []
    for i in range(new - 1):
        cl = torch.full((batch,), prompt + i, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        tok = decode(caches, tok.long(), cl)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        toks.append(tok)
    launches = read_counts(counts)
    out = torch.cat(toks, dim=1)
    L = cfg.num_layers
    want = launches_of(B2=L * n * plan.r, B5=L * n * (new - 1))
    check(launches == want, f"vlm --legacy P={n} launches {launches}: want "
          f"{want} (B2 on the prefill's ring steps; B5 on {n} ranks, {L} "
          f"layers and {new - 1} decode steps)")
    check(tuple(out.shape) == (batch, new)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"vlm tokens {tuple(out.shape)}: want ({batch}, {new}) in-vocab")
    cl = torch.full((batch,), prompt + new - 1, dtype=torch.int32,
                    device=dev)
    decode_prof = _profile_call(lambda: decode(caches, tok.long(), cl))
    peak = torch.cuda.max_memory_allocated()
    del caches, decode
    free_device()
    seq = out[:, :VLM_SERVE["check_positions"][n]]
    t0 = time.perf_counter()
    hid = {impl: _vlm_teacher_hidden(model, n, impl, tokens, patches, seq)
           for impl in ("cuda", "ref")}
    check_s = time.perf_counter() - t0
    errs = compare([hid["cuda"]], [hid["ref"]],
                   f"vlm --legacy P={n} hidden states",
                   names=("hidden",))["hidden"]
    wall = start_wall + sum(walls)
    return out, tokens, patches, dict(
        batch=batch, prompt_len=prompt, patches=int(
            cfg.prefix_len_frac * prompt), new_tokens=new,
        launches=launches, tokens=out.tolist(), start_wall_s=start_wall,
        decode_step_wall_ms=[1e3 * min(walls), 1e3 * statistics.median(
            walls), 1e3 * max(walls)] if walls else None,
        tokens_per_s=batch * new / wall, decode_step_profile=decode_prof,
        max_memory_allocated=peak, hidden_cuda_vs_plain=errs,
        hidden_check_positions=seq.shape[1], hidden_check_s=check_s)


def _vlm_full_forward_check(model, tokens, patches, out, strict=True):
    """Teacher forcing: the full forward at P = 1 over the prompt and the
    generated tokens but the last, the patches at the *prompt's* prefix
    (``int(0.125 * prompt_len)`` positions; a forward that derived it from
    its own length would move it), one row at a time; each generated token
    against its argmax (``_argmax_report``)."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.engine import sampling
    from repro_torch.models import blocks, transformer
    from repro_torch.train import step as train_step

    cfg = model.cfg
    B, S = tokens.shape
    new = out.shape[1]
    seq = torch.cat([tokens, out[:, :-1].to(tokens.dtype)], dim=1)
    rt = train_step.make_runtime(model, RunConfig(seq_scheme="contiguous"),
                                 _train_shape(seq.shape[1]))
    prefix_len = int(cfg.prefix_len_frac * S)
    is_prefix = torch.arange(seq.shape[1], device=model.device) < prefix_len
    rows = []
    for b in range(B):
        with torch.no_grad():
            x = blocks.embed(rt, model.embed, seq[b:b + 1], cfg)
            emb = torch.zeros_like(x)
            emb[:, :S] = patches[b:b + 1].to(x.dtype)
            x = torch.where(is_prefix[None, :, None], emb, x)
            x, _ = transformer.apply_stack(rt, model.layers, x, cfg,
                                           prefix_len=prefix_len)
            x = blocks.rmsnorm(model.final_norm, x, cfg.norm_eps)
            logits, _ = sampling.shard_logits(
                rt, model.head, x[0, S - 1:S - 1 + new, None], cfg)
        rows.append(logits)
    return _argmax_report(cfg, rows, out, strict, "vlm")


def phase_vlm_serve(dev, smi):
    """Phase 29: full-width paligemma-3b whole (18 layers, head size 256,
    seeded bf16). The prefill of 1 x 4096 tokens with 512 patches at P = 1
    through StarTrail (B2) and through the local route (B1), each against
    the plain versions (``ENGINE_TOL``); ``--legacy`` at P = 1 (2 x 1024,
    128 patches, 32 new) and at P = 4 on ThreadMesh(c=2, r=1) (2 x 64, 8
    patches, 4 new), B2 on the prefill and B5 on every rank, layer and
    decode step, the hidden states teacher forced on both routes
    (``ENGINE_TOL``); the P = 1 tokens against the full forward's argmax
    at the prompt's prefix, reported in bf16 and checked in f32 at a
    4-layer cut (2 x 128, 8 new; near ties within ``HYBRID_TIE``)."""
    t_phase = time.perf_counter()
    model, init_s = _vlm_model(dev)
    cfg = model.cfg
    by_path = {}
    t0 = time.perf_counter()
    tokens, patches = _vlm_inputs(dev, cfg, 1, VLM_SERVE["prefill"], 5)
    prefill = _vlm_prefill_run(model, tokens, patches)
    prefill["run_s"] = time.perf_counter() - t0
    by_path["vlm_prefill_p1"] = prefill["startrail"]["launches"]
    by_path["vlm_prefill_local"] = prefill["local"]["launches"]
    del tokens, patches
    legacy, outs = {}, {}
    for n, (b, s, new) in VLM_SERVE["legacy"].items():
        t0 = time.perf_counter()
        out, tokens, patches, rec = _vlm_legacy_run(model, n, b, s, new,
                                                    seed=7 + n)
        rec["run_s"] = time.perf_counter() - t0
        legacy[f"p{n}"] = rec
        by_path[f"vlm_legacy_p{n}"] = rec["launches"]
        outs[n] = (out, tokens, patches)
    t0 = time.perf_counter()
    full_forward = _vlm_full_forward_check(model, *outs[1][1:], outs[1][0],
                                           strict=False)
    full_forward["seconds"] = time.perf_counter() - t0
    from repro_torch.roofline import hw

    params = model.param_count()
    weight_bytes = sum(p.numel() * p.element_size()
                       for name, p in model.named_parameters()
                       if name != "embed.table")
    b1, s1, n1 = VLM_SERVE["legacy"][1]
    kv = 2 * cfg.num_layers * b1 * (s1 + n1) * cfg.num_kv_heads \
        * cfg.head_dim_ * 2
    del model, outs
    free_device()
    t0 = time.perf_counter()
    f = VLM_F32_SERVE
    model32, _ = _vlm_model(dev, layers=f["layers"], dtype="float32")
    tokens32, patches32 = _vlm_inputs(dev, model32.cfg, f["batch"],
                                      f["prompt"], 8)
    from repro_torch.launch.serve import legacy_generate

    out32 = legacy_generate(model32, _vlm_plan(model32.cfg, 1), tokens32,
                            f["new"], patches=patches32)
    full_forward_f32 = _vlm_full_forward_check(model32, tokens32, patches32,
                                               out32)
    full_forward_f32.update(batch=f["batch"], prompt_len=f["prompt"],
                            new_tokens=f["new"], tokens=out32.tolist(),
                            params=model32.param_count(),
                            seconds=time.perf_counter() - t0)
    del model32
    free_device()
    emit("vlm_serve", model=cfg.name, params=params, layers=cfg.num_layers,
         head_dim=cfg.head_dim_, init_s=init_s, weights="seeded random bf16",
         patches="seeded random (the JAX launcher's zeros would keep the "
                 "prefix rows zero)",
         prefill_tokens=VLM_SERVE["prefill"], prefill=prefill,
         legacy=legacy, tol=ENGINE_TOL, full_forward_p1=full_forward,
         full_forward_f32=full_forward_f32,
         decode_bytes={"weights_and_head": weight_bytes, "kv_cache": kv,
                       "p1_bound_ms": (weight_bytes + kv) / hw.HBM_BW * 1e3},
         phase_s=time.perf_counter() - t_phase, card=smi)
    return by_path


def _vlm_train_launches(cfg, ranks, steps):
    """B2 on every ring step (R = 1 here), twice under ``attn_out``; B3
    once."""
    return launches_of(B2=2 * cfg.num_layers * ranks * steps,
                       B3=cfg.num_layers * ranks * steps)


def _vlm_grad_check(model, batch, shape):
    """The first step's loss and gradients on the fresh model, CUDA kernels
    against the plain versions: reported in bf16 at full depth, checked
    (``TRAIN_CHECK_TOL``, as ``phase_train_check``) on an f32 copy of the
    first ``check_cut`` layers, which runs the CUDA-core f32 kernels at
    head size 256 (PR 29 found the bf16 gradients of deep query and key
    projections to be noise against an f32 model's)."""
    import math

    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.train import step as train_step

    def grads(m):
        out = {}
        for impl in ("cuda", "ref"):
            vg_fn, _ = train_step.build_value_and_grad_fn(
                m, RunConfig(block_impl=impl), shape)
            out[impl] = vg_fn(batch)
            free_device()
        return out

    def summary(m, g, strict):
        names = [n for n, _ in m.named_parameters()]
        rels = {n: float((a.float() - b.float()).norm() / b.float().norm())
                for n, a, b in zip(names, g["cuda"][1], g["ref"][1])}
        losses = [float(g[i][0]) for i in ("cuda", "ref")]
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        worst = max(rels, key=rels.get)
        ok = (all(math.isfinite(x) for x in rels.values())
              and loss_rel <= TRAIN_CHECK_TOL["loss_rel"]
              and rels[worst] <= TRAIN_CHECK_TOL["grad_rel_l2"])
        return {"layers": m.cfg.num_layers, "dtype": m.cfg.param_dtype,
                "leaves": len(names),
                "loss": {"cuda": losses[0], "ref": losses[1]},
                "loss_rel": loss_rel, "strict": strict, "within_tol": ok,
                "grad_rel_l2_worst": {"leaf": worst, "value": rels[worst]},
                "grad_rel_l2_median": statistics.median(rels.values())}

    rec = {"tol": TRAIN_CHECK_TOL}
    rec["bf16"] = summary(model, grads(model), False)
    m32 = _layers_cut(model, VLM_TRAIN["check_cut"], torch.float32)
    rec["f32"] = summary(m32, grads(m32), True)
    del m32
    free_device()
    f = rec["f32"]
    check(f["within_tol"], f"vlm_train first step in f32: loss rel "
          f"{f['loss_rel']}, worst grad leaf {f['grad_rel_l2_worst']}, "
          f"beyond {TRAIN_CHECK_TOL}")
    return rec


def phase_vlm_train(dev, smi):
    """Phase 30: full-width paligemma-3b whole (18 layers) trained at seq
    4096 (512 patches), batch 1, bf16, ``attn_out`` recompute, AdamW (lr
    1e-3, f32 moments) on one repeated batch of the pipeline's tokens and
    patches: the first step's gradients on the fresh model, CUDA kernels
    against the plain versions (``_vlm_grad_check``: checked in f32 on a
    4-layer copy, reported in bf16 at full depth), then 3 steps at P = 1
    (loss finite and falling; B2 and B3 at head size 256 on every layer,
    the last step profiled, peak memory). Then a 2-layer cut of the same
    weights at batch 2: 2 steps at P = 1 and 2 at P = 8 on ThreadMesh(c=2,
    r=1, data=2) from the same weights and batch (``_pipeline_batch``: the
    pipeline's patches laid out in the shard order), P = 8's first loss
    and gradient norm against P = 1's (``TRAIN_SP_TOL``)."""
    import math

    from repro_torch.plan import make_plan

    t_phase = time.perf_counter()
    model, init_s = _vlm_model(dev)
    cfg = model.cfg
    t = VLM_TRAIN
    cuts = [_layers_cut(model, t["cut"]) for _ in range(2)]
    runs, by_path = {}, {}
    shape = _train_shape(t["seq"], t["batch"])
    plan = make_plan(cfg, shape, arch=cfg.name, n_devices=1, c=1)
    check(plan.remat == "attn_out", f"vlm plan {plan}")
    batch = _pipeline_batch(cfg, shape, plan, dev)
    check(tuple(batch["frontend_emb"].shape) == (1, t["seq"], cfg.d_model),
          f"vlm batch patches {tuple(batch['frontend_emb'].shape)}")
    t0 = time.perf_counter()
    grad_check = _vlm_grad_check(model, batch, shape)
    grad_check["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = _repeated_steps(model, plan, batch, t["steps"])
    losses = run["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"vlm_train p1: losses {losses} must be finite and fall")
    want = _vlm_train_launches(cfg, 1, t["steps"])
    check(run["launches"] == want, f"vlm_train p1 launches "
          f"{run['launches']}: want {want}")
    run.update(run_s=time.perf_counter() - t0, layers=cfg.num_layers,
               seq_len=shape.seq_len, batch=shape.global_batch,
               patches=int(cfg.prefix_len_frac * shape.seq_len))
    runs["p1"], by_path["vlm_train_p1"] = run, run["launches"]
    params = model.param_count()
    del model
    free_device()
    cut_shape = _train_shape(t["seq"], t["mesh_batch"])
    for key, cut, (c, r, data) in (("cut_p1", cuts[0], (1, 1, 1)),
                                   ("cut_p8", cuts[1], t["mesh"])):
        t0 = time.perf_counter()
        plan = make_plan(cut.cfg, cut_shape, arch=cfg.name,
                         n_devices=data * c * c * r, data=data, c=c)
        check((plan.c, plan.r, plan.data) == (c, r, data)
              and plan.remat == "attn_out", f"vlm plan {plan}")
        batch = _pipeline_batch(cut.cfg, cut_shape, plan, dev)
        run = _repeated_steps(cut, plan, batch, t["mesh_steps"])
        losses = run["losses"]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"vlm_train {key}: losses {losses} must be finite and fall")
        want = _vlm_train_launches(cut.cfg, data * c * c * r,
                                   t["mesh_steps"])
        check(run["launches"] == want, f"vlm_train {key} launches "
              f"{run['launches']}: want {want}")
        if key == "cut_p8":
            p1 = runs["cut_p1"]
            loss_err = abs(losses[0] - p1["losses"][0])
            gnorm_rel = abs(run["grad_norm"][0] - p1["grad_norm"][0]) \
                / p1["grad_norm"][0]
            run.update(first_loss_abs_err_vs_p1=loss_err,
                       first_grad_norm_rel_err_vs_p1=gnorm_rel)
            check(loss_err <= TRAIN_SP_TOL["loss_abs"]
                  and gnorm_rel <= TRAIN_SP_TOL["grad_norm_rel"],
                  f"vlm_train P=8 first step: loss {losses[0]} vs P=1 "
                  f"{p1['losses'][0]} (abs {loss_err}), grad norm "
                  f"{run['grad_norm'][0]} vs {p1['grad_norm'][0]} (rel "
                  f"{gnorm_rel}), beyond {TRAIN_SP_TOL}")
        run.update(plan={"P_sp": plan.sp_size, "c": plan.c, "r": plan.r,
                         "data": plan.data, "remat": plan.remat,
                         "seq_scheme": plan.seq_scheme},
                   layers=t["cut"], seq_len=cut_shape.seq_len,
                   batch=cut_shape.global_batch,
                   run_s=time.perf_counter() - t0)
        runs[key] = run
        by_path[f"vlm_train_{key}"] = run["launches"]
    del cuts, cut
    free_device()
    emit("vlm_train", model=cfg.name, params=params, head_dim=cfg.head_dim_,
         init_s=init_s, weights="seeded random bf16", remat="attn_out",
         opt_dtype=cfg.opt_dtype, grad_check=grad_check, runs=runs,
         tol=TRAIN_SP_TOL, phase_s=time.perf_counter() - t_phase, card=smi)
    return by_path



GPT3B_ARCH = "gpt-3b"
# The paper's GPT-3B at full width through the paged engine (pages of 16,
# 4 slots of 2080 tokens, the prefix cache on): four prompts with nothing
# cached, the first 1024 tokens of the last one shared by the two prompts
# queued once those prefills are done (1024-token prefix hits), 32 new
# tokens each. Then P = 4 on ThreadMesh(c=2, r=1) from the same weights:
# 2 of the prompts, 3 new tokens each
GPT3B_SERVE = {"cold": [64, 512, 2048], "prefix": 1024,
               "suffixes": [64, 256, 512], "new": 32, "page": 16,
               "max_len": 2080, "pages": 1024,
               "p4": {"n_devices": 4, "c": 2, "prompts": (1, 3), "new": 3}}
# launch.serve's engine mode at pages of 128 on the full-width h2o
SERVE_PAGE128 = ["--arch", ARCH, "--page-size", "128", "--pages-per-shard",
                 "32", "--max-len", "1024", "--prompt-len", "600", "--gen",
                 "8", "--requests", "4"]


@contextlib.contextmanager
def _decode_hiddens(engine, steps):
    """Append to ``steps``, for each greedy decode step of ``engine``
    (``serve.step.lm_decode_step``) while the block runs, its (B, 1, D)
    hidden state, cache lengths, input tokens and the uid of each slot's
    request (None for a free slot): the step is computed as before, its
    tokens from that state."""
    from repro_torch.engine import sampling as sampling_lib
    from repro_torch.serve import step as serve_step

    orig = serve_step.lm_decode_step

    def decode(rt, params, cache, tokens, cfg, cache_len, paged=None,
               return_hidden=False, sampling=None):
        check(sampling is None, "decode capture: greedy rows only")
        x = orig(rt, params, cache, tokens, cfg, cache_len, paged,
                 return_hidden=True)
        steps.append(dict(
            hidden=x.float().clone(), cache_len=cache_len.cpu().tolist(),
            tokens=tokens.flatten().cpu().tolist(),
            uids=[st.req.uid if st is not None else None
                  for st in engine.scheduler.slots]))
        return x if return_hidden else sampling_lib.greedy(
            rt, params.head, x, cfg)

    serve_step.lm_decode_step = decode
    try:
        yield steps
    finally:
        serve_step.lm_decode_step = orig


def _gpt3b_run(engine, smi, reqs, later, want, what, profile_steps=0):
    """``drive_engine`` with every decode step's hidden state kept."""
    steps = []
    with _decode_hiddens(engine, steps):
        out, hidden, launches, rec = drive_engine(
            engine, smi, reqs, want, what, profile_steps=profile_steps,
            later=later)
    return out, hidden, steps, launches, rec


def _same_context_rows(step, step_r, out, out_r, prompt_len):
    """The slots of one decode step that hold the same request at the same
    cache length in both runs, with every token fed so far equal: their
    inputs are the same, so their hidden states must agree."""
    rows = []
    for st, uid in enumerate(step["uids"]):
        n = step["cache_len"][st]
        if uid is None or uid != step_r["uids"][st] or n == 0 \
                or n != step_r["cache_len"][st]:
            continue
        fed = n - prompt_len[uid] + 1      # the first token, then each new
        if out[uid][:fed] == out_r[uid][:fed]:
            rows.append(st)
    return rows


def phase_gpt3b_serve(dev, smi):
    """Phase 32: the paper's GPT-3B (16 layers, d_model 4096, 12 heads of
    256, MHA, vocab 50304, ~4.4 B seeded bf16 parameters) served at full
    width by the paged engine with the prefix cache: ``GPT3B_SERVE``'s
    prompts (the cold ones prefill through B2 at head size 256 on every
    layer, the two prefix hits through B6 and B1, every decode step runs B4
    at head size 256 on every layer; 4 pure decode steps profiled). The
    same requests through the same engine on the plain versions: each
    prompt's next-token hidden state and logits, and each decode step's
    (the rows whose tokens fed so far agree; the first, the last and at
    least half of the steps must have one), within ``ENGINE_TOL``; the
    share of streamed tokens that agree printed. Then P = 4 on
    ThreadMesh(c=2, r=1): 2 prompts, 3 new tokens, first-token hidden
    states against P = 1's (``DENSE_SP_TOL``), B4 reading each rank's
    shard of the pages. Last, ``launch.serve`` in engine mode with
    ``--page-size 128`` on the full-width h2o-danube-1.8b
    (``SERVE_PAGE128``: B4 at pages of 128, two key tiles a page)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.engine import Engine, EngineConfig, Request
    from repro_torch.launch import serve
    from repro_torch.models.factory import build_model
    from repro_torch.plan import make_serve_plan

    cfg = registry.paper_model(GPT3B_ARCH)
    L, sv = cfg.num_layers, GPT3B_SERVE
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.param_count()

    def engine(n_devices=1, c=1, impl="cuda"):
        plan = make_serve_plan(cfg, arch=GPT3B_ARCH, n_devices=n_devices,
                               c=c, decode_batch=4, page_size=sv["page"],
                               max_len=sv["max_len"], prefix_cache=True)
        plan = dataclasses.replace(plan, kernel_impl=impl, block_impl=impl)
        return Engine(model, plan, EngineConfig(
            pages_per_shard=sv["pages"] // plan.sp_size))

    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in sv["cold"]]
    shared = rng.integers(0, cfg.vocab_size, sv["prefix"]).tolist()
    prompts += [shared + rng.integers(0, cfg.vocab_size, n).tolist()
                for n in sv["suffixes"]]
    cold = len(sv["cold"]) + 1
    reqs = [Request(f"g{i}", p, sv["new"]) for i, p in enumerate(prompts)]

    e1 = engine()
    e1.add_request(Request("warm", prompts[0], 4))
    e1.run()
    e1.reset()
    out, hid, steps, l1, rec = _gpt3b_run(
        e1, smi, reqs[:cold], reqs[cold:],
        lambda e: _cached_launches(e, cold), "gpt3b P=1", profile_steps=4)
    cached = {r.uid: e1.scheduler.finished[r.uid].cached_len for r in reqs}
    check(all(cached[r.uid] == sv["prefix"] for r in reqs[cold:]),
          f"gpt3b: cached lengths {cached}, want the {sv['prefix']}-token "
          f"prefix hit by the last {len(reqs) - cold} prompts")
    check(l1["B4"] > 0 and l1["B6"] > 0 and l1["B2"] > 0,
          f"gpt3b: launches {l1}")

    eref = engine(impl="ref")
    out_r, hid_r, steps_r, _, rec_r = _gpt3b_run(
        eref, smi, reqs[:cold], reqs[cold:], lambda e: launches_of(),
        "gpt3b P=1 plain")
    errs = {r.uid: compare((hid[r.uid], _logits(e1, hid[r.uid])),
                           (hid_r[r.uid], _logits(eref, hid_r[r.uid])),
                           f"gpt3b {r.uid} prefill cuda vs plain")
            for r in reqs}
    # every decode step (B4 at head size 256 on each layer), on the rows
    # whose context is the same in both runs
    firsts = {r.uid: (out[r.uid][0], out_r[r.uid][0]) for r in reqs}
    check(len(steps) == len(steps_r) and len(steps) > 1,
          f"gpt3b: {len(steps)} decode steps, plain {len(steps_r)}")
    plen = {r.uid: len(r.tokens) for r in reqs}
    worst = {"hidden": {}, "logits": {}}
    step_rows = []
    for k, (a, b) in enumerate(zip(steps, steps_r)):
        rows = _same_context_rows(a, b, out, out_r, plen)
        step_rows.append(len(rows))
        if not rows:
            continue
        h, hr = a["hidden"][rows], b["hidden"][rows]
        e = compare((h, _logits(e1, h)), (hr, _logits(eref, hr)),
                    f"gpt3b decode step {k} cuda vs plain")
        for name in worst:
            for key, x in e[name].items():
                worst[name][key] = max(worst[name].get(key, 0.0), x)
    held = sum(n > 0 for n in step_rows)
    check(step_rows[0] > 0 and step_rows[-1] > 0
          and 2 * held >= len(steps),
          f"gpt3b: rows of the same context per decode step {step_rows}")
    errs["decode_steps_worst"] = worst
    tokens = sum(len(out[r.uid]) for r in reqs)
    same = sum(a == b for r in reqs for a, b in zip(out[r.uid],
                                                     out_r[r.uid]))
    del eref
    free_device()

    p4 = sv["p4"]
    e4 = engine(p4["n_devices"], p4["c"])
    check(not e4.plan.block_skip, "gpt3b P=4: ring-block skipping is on, "
          "the launch counts below assume every ring step runs")
    sp, ring = e4.sp, e4.plan.r
    reqs4 = [Request(f"g{i}", prompts[i], p4["new"]) for i in p4["prompts"]]

    def p4_launches(e):
        # B2 on every rank, ring step and layer of a prefill; B4 on every
        # rank and layer of a decode step
        return launches_of(B2=sp * ring * L * e.metrics.prefills,
                           B4=sp * L * e.metrics.decode_steps)

    out4, hid4, l4, rec4 = drive_engine(e4, smi, reqs4, p4_launches,
                                        "gpt3b P=4")
    errs4 = {r.uid: compare((hid4[r.uid], _logits(e1, hid4[r.uid])),
                            (hid[r.uid], _logits(e1, hid[r.uid])),
                            f"gpt3b P=4 {r.uid} vs P=1", DENSE_SP_TOL)
             for r in reqs4}
    agree4 = sum(a == b for r in reqs4
                 for a, b in zip(out4[r.uid], out[r.uid]))
    del e4, e1, model
    free_device()

    counts = reset_counts()
    t1 = time.perf_counter()
    served = serve.main([*SERVE_PAGE128, "--device", dev.type])
    torch.cuda.synchronize()
    l128 = read_counts(counts)
    check(len(served) == 4 and all(0 < len(v) <= 8 for v in served.values())
          and l128["B4"] > 0 and l128["B2"] > 0,
          f"launch.serve --page-size 128: {len(served)} streams, launches "
          f"{l128}")
    page128 = {"flags": SERVE_PAGE128, "streams": len(served),
               "tokens": sum(len(v) for v in served.values()),
               "launches": l128, "wall_s": time.perf_counter() - t1}
    # B4 on bf16 with G <= 16: the paged, key-split forward
    b4_ms = sum(k["ms_per_step"]
                for k in rec["decode_step_profile"]["top_kernels"]
                if "flash_fwd_mma<256, false, true, true>" in k["name"])
    emit("gpt3b_serve", model=cfg.name, params=params,
         weights="seeded random bf16", init_s=init_s,
         prompt_lens=[len(p) for p in prompts], new_tokens=sv["new"],
         prefix_len=sv["prefix"], cached_len=cached, p1=rec,
         b4_device_ms_per_decode_step=b4_ms, plain=rec_r,
         first_tokens=firsts, decode_rows_held=step_rows, err=errs,
         tol=ENGINE_TOL, tokens_agreeing_with_plain=same / tokens,
         tokens_compared=tokens,
         p4={**p4, "P_sp": sp, "err_vs_p1": errs4, "tol": DENSE_SP_TOL,
             "tokens_agreeing_with_p1": agree4 / (len(reqs4) * p4["new"]),
             **rec4},
         launch_serve_page128=page128, card=smi)
    return {"gpt3b_serve_p1": l1, "gpt3b_serve_p4": l4,
            "serve_page128": l128}


# phases that ``python3 chip_smoke.py --only <name>`` runs alone after the
# build (development runs, and train_procs on a machine of several cards)
ALONE = {"train_procs": phase_train_procs, "serve_procs": phase_serve_procs}


def free_device():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main():
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script "
              f"(src/repro_torch): {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    try:
        smi = nvidia_smi()
        emit("device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=smi,
             total_memory=torch.cuda.get_device_properties(0).total_memory,
             torch=torch.__version__, cuda=torch.version.cuda)
        info = _build.build_info()
        emit("build", seconds=info["seconds"], built=info["built"],
             ptxas=info["ptxas"], hw=hw_table(), card=smi)
        if sys.argv[1:2] == ["--only"]:
            # a development run of one phase (not the contract's run)
            ALONE[sys.argv[2]](dev, smi)
            print(f"seconds {time.perf_counter() - t_start:.1f}")
            print(smi)
            return 0
        rows = phase_kernels(dev)
        free_device()
        phase_kernels_ulysses(dev, rows)
        free_device()
        phase_kernels_d128(dev, rows)
        free_device()
        phase_kernels_d256(dev, rows)
        free_device()
        by_path = {"ring": phase_ring(dev)}
        free_device()
        by_path.update(phase_overlap(dev, smi))
        free_device()
        by_path["ragged_bwd"] = phase_ragged_bwd(dev)
        free_device()
        (by_path["engine"], by_path["sample"], by_path["local"],
         by_path["prefix"], by_path["legacy"],
         host_tier, gateway) = serving_phases(dev, smi)
        by_path.update(host_tier)
        by_path.update(gateway)
        free_device()
        model, by_path["train"] = phase_train(dev, smi)
        free_device()
        phase_train_check(model, dev)
        free_device()
        phase_train_profile(model, dev, smi)
        del model
        free_device()
        phase_resume(dev, smi)
        free_device()
        by_path["dryrun"] = phase_dryrun(dev, smi)
        free_device()
        by_path["train_sp"] = phase_train_sp(dev, smi)
        free_device()
        procs = phase_train_procs(dev, smi)
        by_path["train_procs"] = procs["gloo"]
        if "nccl" in procs:
            by_path["train_procs_nccl"] = procs["nccl"]
        free_device()
        procs = phase_serve_procs(dev, smi)
        by_path["serve_procs"] = procs["gloo"]
        if "nccl" in procs:
            by_path["serve_procs_nccl"] = procs["nccl"]
        free_device()
        by_path.update(phase_schemes(dev, smi))
        free_device()
        by_path.update(phase_autotune(dev, smi))
        free_device()
        by_path.update(phase_dense_serve(dev, smi))
        free_device()
        by_path["dense_train"] = phase_dense_train(dev, smi)
        free_device()
        by_path.update(phase_rules(dev, smi))
        free_device()
        by_path.update(phase_moe_serve(dev, smi))
        free_device()
        by_path.update(phase_moe_train(dev, smi))
        free_device()
        by_path.update(phase_legacy_sp(dev, smi))
        free_device()
        by_path.update(phase_xlstm_serve(dev, smi))
        free_device()
        by_path.update(phase_xlstm_train(dev, smi))
        free_device()
        by_path.update(phase_hybrid_serve(dev, smi))
        free_device()
        by_path.update(phase_hybrid_train(dev, smi))
        free_device()
        by_path.update(phase_encdec_serve(dev, smi))
        free_device()
        by_path.update(phase_encdec_train(dev, smi))
        free_device()
        by_path.update(phase_vlm_serve(dev, smi))
        free_device()
        by_path.update(phase_vlm_train(dev, smi))
        free_device()
        by_path.update(phase_gpt3b_serve(dev, smi))
        paths = {"B1": "local", "B2": "engine", "B3": "train",
                 "B4": "engine", "B5": "legacy", "B6": "prefix",
                 "B7": "ragged_bwd"}
        for name, row in rows.items():
            row["launches"] = by_path[paths[name]][name]
            row["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            check(row["launches"] > 0, f"{name} never launched on its path")
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "tol", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms", "d128", "d256")
    print(f"seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
