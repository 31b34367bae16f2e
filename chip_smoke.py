"""Drive the PyTorch port's serving, speculative, beam, continuous-batching
server, feature-extraction, test-run and training paths, its command
line, its multi-device training, its inference over several devices, the
large GPT-2 family and the kernels' whole domain (Cerebras-GPT-2.7B's
width, GPT-J's heads) once on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build: compile the port's CUDA kernels from ``ergm_tpu_torch/csrc``;
   print the registers and spills of K1's and K4's Hopper kernels.
2. kernel: K1 (prefill attention) against its plain PyTorch version at
   the slice's shapes, causal [256, 128, 768] with and without a
   left-pad mask and cross q [256, 128, 768] over k/v [256, 32, 768]
   with a ragged caption mask, in bf16 (within 2e-2: output rounding
   plus summation order) and fp32 (within 2e-5, TF32 off); median
   times of both from CUDA events, and of one
   ``scaled_dot_product_attention`` call with each form's masks as a
   boolean mask, with each form's bound, on rows of their own, and the
   persistent grid the bf16 kernel launched with (CTAs, items, key
   tile: what its C entry point reports of the launch).
3. decode kernels: K3 (fused cross sublayer, B=256 over a 32-token int8
   caption cache with a ragged mask), K4 (fused LN2 + MLP, B=256,
   D=768, F=3072) and K2 (int8 decode attention, B=64, T=512, index
   400, left-pad mask) against their plain versions, fp32 with TF32 off
   (within 2e-4, 2e-5 and 3e-4) and bf16 (|kernel - plain| <= 2e-2 +
   1e-2 |plain|), K3 and K4 also at the beam path's 64 rows; median
   times of both from CUDA events; K3 and K4 in
   bf16 must repeat bit for bit and start at most 3 and 2 kernels a call;
   K4's bf16 grids as its C entry point reports the launches (each
   projection's grid and cluster size) must be the planner's plans, and
   go into its row; the device duration of each of their kernels by torch.profiler. K2 in
   bf16 must repeat bit for bit in one launch a call; its cluster size,
   device duration (torch.profiler) and time at every cluster size the
   row allows; then the same, with the plain version's time and the bound,
   at B=1, T=1024, index 1000 (a single request over a long cache) and
   B=256, T=256, index 200 (the headline decode's cache size, a reading
   only: K2 is not routed below T=512).
4. reference: a small fp32 model on the card against the same model on
   the CPU (plain versions), prefill and decode logits within 1e-3:
   once with the decode switches off, and once with all three on
   (``ERGM_CROSS_KERNEL=1``, ``ERGM_DECODE_KERNEL=1``,
   ``decode_fused_mlp``) over a 512-slot cache, where K2, K3 and K4
   must each launch on the card.
5. slice: gpt2 at full width and 2 of its 12 layers (the depth cut that
   keeps the script within half its time limit), random weights from seed
   0, int8 KV and cross caches, int8 lm_head, bf16: ``generate`` at B=256 (128-token
   prompt, 128 new tokens, 32-token caption, image and audio features,
   top-p 0.8) with the switches off and with ``ERGM_CROSS_KERNEL=1``
   and ``decode_fused_mlp`` on, timed in turns (off, on, on, off); then
   ``generate_batch`` over 64 ragged greedy requests. K1 must launch
   n_layer times per prefill in each form (self and cross), K3 and K4
   n_layer times per decode step with the switches on. Then the device
   time and kernel count of one B=256 decode step, switches off and K3 +
   K4 on, by torch.profiler over 8 steps, beside the host's wall time
   per step.
6. long history: gpt2 at full width, B=64, a 384-token prompt, 128 new
   tokens in a 512-slot cache, with ``ERGM_DECODE_KERNEL=1``, without,
   and without with the prompt prefill's self-attention on the plain math
   (``ERGM_ATTN_IMPL=xla``: the route taken before it followed JAX's rule),
   timed in turns; K2 must launch n_layer times per decode step, and K5
   n_layer times per prefill under ``auto``. Then the device time and
   device operations of one B=64 decode step over the 512-slot cache with
   K2 on and off, by torch.profiler over 8 steps, beside the host's wall
   time per step.
7. speculative decoding: bench.py:207-240's B=1 request (gpt2 at full
   width, random weights from seed 0, int8 weights, bf16 caches, a
   128-token prompt with token types, a 32-token caption, image and
   audio features, 32 new tokens, greedy) through ``generate_batch`` on
   three routes: plain (``spec_mode="none"``), ``auto`` (which must take
   prompt-lookup drafting) and a 3-layer self-draft with gamma 4. In
   fp32 the three token lists must be equal; in bf16 each speculative
   route must equal plain wherever plain's top-2 logit margin exceeds
   1e-3. K5 must launch n_layer times in the prefill (n_layer + 3 with
   the draft's own). Then one first call a route (startup) and 5 timed
   requests a route in turns: the median wall time, macro steps and
   accepted proposals.
8. beam search over the long history (2 of gpt2's 12 layers, as the
   slice phase): the serving configuration, 16
   ragged prompts bucketed to 384 tokens, 4 beams, 128 new tokens in 512
   slots, ``beam_search_batch`` with the decode kernels off and with K2,
   K3 and K4 on, in fp32 and in bf16. K5 must launch n_layer times in
   the prefill and K2-K4 n_layer times a step with the kernels on. The
   margin rule (each row's expansions pick the same candidates in both
   runs up to its first expansion decided by a gap of at most 1e-3) is
   asserted in fp32 and reported in bf16; in bf16 a third run with the
   kernels on holds every launch of K2, K3 and K4 against its plain
   version on the same inputs (2e-2 + 1e-2 |plain|). Then the device time of one
   bf16 beam step each way (torch.profiler over 8 steps) and the time of
   the step's cache reorder at 16, 64 and 127 generated slots, and of
   the whole cache.
9. server: the continuous-batching server (``infer/server.py``) at gpt2
   full width, 1 of its 12 layers (cut so that the script keeps within
   half its time limit; both server phases), bf16, int8 lm_head, random
   weights from seed 0: 256
   requests submitted at once (``scripts/server_bench.py``'s defaults:
   prompts of 16-128 tokens, 16-128 new tokens, greedy, a 32-token caption
   on 3 of 4, image and audio features) through 64 slots, blocks of 32
   steps, a capacity ladder of 32 slots up to 512. After one warm-up run,
   five arms in turns: the bf16 cache, the same with ``decode_fused_mlp``
   (K4), the int8 staged cache, sorted admission, and tiers (8 long slots,
   ``kv_cache_dtype="auto"``, every 8th prompt 384 tokens, 1024 slots).
   Every request must return its budget; K1 must launch n_layer times for
   each admission group at a prompt bucket <= 128 (the cross form for each
   carrying a caption), K5 for each at 384, K4 n_layer times a decode
   step; every block dispatch runs under
   ``torch.cuda.set_sync_debug_mode("error")``. Each arm's utt/s, tok/s,
   slot utilisation, block lengths, grows, shrinks, phase times, and one
   block's device time (torch.profiler) beside its host wall time; every
   K1, K5 and K4 launch of the K4 and tier arms against its plain version
   (2e-2 + 1e-2 |plain|, real rows); 16 requests (32 new tokens each) through the
   server and one at a time through ``generate``, fp32 with TF32 off, on
   the compute-dtype and the int8 staged cache: tokens equal up to each
   row's first step where generate's top-2 margin is 1e-3 or less (bf16:
   printed); and, as a reading, ``generate_batch`` over arrival-order
   batches of 64.
9b. the server's extension paths (``server_ext_phase``), the same model
   with ``decode_fused_mlp``: 64 three-turn conversations (turn 1 of
   48-96 tokens, each next turn the last prompt, its reply and 16-48 new
   tokens, budgets 16-48, submitted as each result arrives) through 48
   slots, with ``session_id`` (deltas through the extension program;
   parked sessions evicted LRU) and re-prefilled whole (``max_prompt``
   384, buckets over 128 through K5): utt/s, prefill tokens fed,
   extension programs, fallbacks, evictions, phase times. 16 prompts of
   448 tokens arriving one a step among 64 short requests (1,024 slots),
   whole (``max_prompt`` 512, K5) and in 128-token chunks (``prefill_
   chunk``): a step's wall time while they are admitted (median and
   longest) and utt/s. 128 requests through speculative blocks (gamma 4,
   n-gram 3) and plain blocks: proposed and accepted counts, macro steps,
   utt/s, tok/s, one speculative block's device time and operations. K1
   must launch n_layer times for each admission group at a bucket <= 128
   (and for each carrying a caption), K5 for each over 128, K4 n_layer
   times a decode step, and nothing launch inside an extension program or
   a verify window; every dispatch and extension program runs under
   ``set_sync_debug_mode("error")``; every K1 and K4 launch of the chunked
   and speculative arms is held against its plain version (real rows).
   Then fp32 at full width (TF32 off): 8 conversations' second turns
   against a fresh server's full prefill, 8 prompts of 200-448 tokens in
   64-token chunks against ``generate``, 16 requests through speculative
   and plain blocks, and ``ServerFrontend`` on 127.0.0.1 (16 concurrent
   ``POST /generate``, 8 of them streamed, a two-turn session, ``GET
   /health``, a streamed client that disconnects and must be cancelled)
   against the same requests submitted directly: each n of n equal, a row
   that parts passing only where ``generate``'s top-2 margin is 1e-3 or
   less.
10. training kernels: K5 (block attention) forward and backward at the
   training slice's [48, 12, 512, 64], causal, bf16, dropout 0 and 0.1
   on one seed (output within 2e-2 + 1e-2 |plain|; gradients: against
   the plain version run in f32, at most twice the plain bf16 version's
   error, see ``bf16_grad_ratio``; dK without its last 64 keys must fail
   that bar), and fp32 with TF32 off at [4, 12, 512, 64] (2e-5 and
   5e-5); K6 (fused cross-entropy) forward and backward (dh and dW over
   8192-column vocab chunks) at N=24,576, V=50,271, D=768 in bf16 with
   logits of std 3 (NLL within 1e-4 + 1e-4 |plain|, gradients as K5's,
   and the gold term alone must fail that bar; two backward runs bitwise
   equal) and fp32 at N=2,048 (NLL 1e-5, gradients rtol 1e-4 / atol
   1e-5). Median CUDA-event times of kernel and plain in turns, and of
   ``scaled_dot_product_attention`` as K5's yardstick; K6's backward
   also with 4096- and 16384-column chunks, and one cuBLAS ``h @ w.t()``
   at its shapes as context.
   K7 (JAX's library flash kernel, ``flash_attention.flash_mha``): [8, 12,
   2048, 64] bf16 (the one-pass kernels), causal, left-pad key and query
   masks, no dropout, forward and backward against the plain version of
   what the card runs (``flash_attention.kernel_reference``: in bf16
   ``flash_mha_reference``, JAX's library flash arithmetic; output and
   gradient bars as K5's, on real rows; the bf16 run twice bit for bit),
   fp32 at [1, 2, 2048, 64] (2e-5 and 5e-5); times of kernel, plain and
   ``scaled_dot_product_attention`` (``is_causal``, no mask) as the
   yardstick.
11. training reference: a small fp32 model takes 3 AdamW steps on the
   card (K5 and K6) and on the CPU (plain versions); losses within 1e-4.
   Then the long-context path: one ``make_train_step`` step of gpt2 at
   full width with ``n_positions=2048``, two layers, B=2, L=2048 and no
   attention dropout, where the ``auto`` route takes K7 inside JAX's
   flash gate: it must launch twice forward and twice backward, K5 never.
12. training slice: the ``scripts/train_bench.py`` configuration (gpt2
   at full width, B=48, L=512, bf16, dropout 0.1, remat "mlp", random
   weights from seed 0): ``make_train_step`` once, then 8 timed steps
   (two chains of 4); K5 must launch 12 forward and 12 backward times
   per step and K6's forward and backward once each; the LM loss on the
   repeated batch must fall. One more step reads the device memory in use
   and at its peak before, during and after K6's backward, to show where
   the step's peak is set. Then ``Trainer(cfg).train()`` for one epoch on a
   synthetic dataset (B=48, batches padded to 512): validation, a
   best-PPL checkpoint, and a resume that restores it.

13. feature extraction and test runs (``pipeline_phase``), run between
   the server phases and training: the wav2vec2-base encoder (7 convs,
   768 wide, 12 layers, random weights from seed 0) over clips of 41,040,
   82,000, 48,000, 327,760 and 368,720 samples at 16 kHz (128, 256, 149,
   1,024 and 1,152 frames) and one of 1.5 s at 22.05 kHz, at B=1 in fp32
   and bf16, entered with cuDNN's TF32 on: K5 must launch 12 times for each
   clip whose frame count is a multiple of 128 up to 1,024, K7 for 1,152
   (JAX's flash gate), neither for the others, every launch within its bar
   (fp32 F32_TOL, bf16 the bf16 bar) of its plain version
   (``KernelShadow``), the fp32 features of three clips within 1e-3 of the
   CPU's; ms a clip (host wall), one clip's device busy time and host wall
   read in the same profiled passes, and each convolution of a 128-frame
   clip timed alone. ``extract_features.main`` over the same directory (PNG
   keyframes where PIL imports): K5 and K7 as above, its audio features equal to
   the direct run's. The BLIP ViT-B/16 encoder at 384 px (577 tokens, no
   K5) in fp32 and bf16: ms an image. ``extract_text_features`` at gpt2
   full width in bf16 over 256 utterances of 8-250 tokens: K5 12 times
   for each batch bucketed to 128 or 256 tokens, none for 64 or 192.
   ``run_test`` at gpt2 full width (bf16, random weights from seed 0) over
   a synthetic split of 5 batches of 64 (words across the whole
   vocabulary, captions on every other dialogue), 32 new tokens at top-p
   0.8 (full sort), then ``Evaluator.evaluate_all`` (BERTScore skipped: no
   local model): K5 12 times and K6 once an eval step, K1 12 times (self)
   and 12 more (cross) a generate prefill; a second run holds every K1, K5
   and K6 launch against its plain version; utt/s and the eval step's ms.
   fp32 ``run_test`` on a 2-layer model of gpt2 width, greedy, card
   against CPU: hypotheses by the margin rule, losses within 1e-4
   relative. ``train_bpe`` with the native merge loop (built from
   ``cpp/bpe_core.cpp`` into ``ergm_tpu_torch/_build/``), ``text2ids.main``,
   and three turns of ``run_repl`` at gpt2 width.

14. the command line (``cli_phase``), after training: gpt2-medium at full
   width and 12 of its 24 layers (1024 wide, 16 heads, bf16, random
   weights from seed 0; the depth cut that keeps the script near 850 s
   beside phase 17, which drives the same command line at gpt2-large's
   and gpt2-xl's full depth) through ``ergm_tpu_torch.cli``. ``load_data
   --source=synthetic``, then a train split over GPT-2's vocabulary (24
   dialogues of 16 turns, utterances of 8-40 tokens, captions; batches up
   to 512 tokens) and a valid split (32 dialogues of 4 turns of 3-8
   tokens; 16 dialogues, 32 steps an epoch: cut from 24 so that the script
   keeps within half its time limit). ``--mode=train`` with
   train_torch.sh's flags (B=8,
   ``--max_len=1024``, lr 1e-5, no warmup, remat "mlp"), then with the
   JAX help's gpt2-medium recipe (``--adam_mu_dtype=bfloat16
   --grad_accum_steps=2 --num_workers=2``): the Trainer's epoch line (tok/s,
   step p50, MFU), the peak memory, K5's and K6's launches exactly as their
   gates give them at the epoch's batch shapes; a third, shorter run holds
   every K5 and K6 forward launch against its plain version. One train
   step under remat none, mlp, full and dots from the same weights, batch
   and seed: losses equal bit for bit, gradients within the bf16 bar of no
   remat's, K5 twice a layer forward under full and dots, each policy's
   step time, peak memory and device busy time. ``--mode=infer`` over 128
   valid utterances at B=64 (top-p 0.8, a 128-token cap): K1 (self and
   cross), K5 and K6 as the gates give them, the results and generations
   files, utt/s, and a second ``run_test`` of the same weights under
   ``KernelShadow``. ``--mode=serve`` over 64 requests (half sampled,
   captions on a third): every response, req/s.
   ``convert_ckpt --reverse`` of the trained checkpoint and back: the
   parameters and the fp32 logits equal bit for bit.

15. multi-device training (``parallel_phase``), last: (a) ``cli.main
   --mode=train`` at gpt2-medium's full width and depth over the first 4
   train dialogues (8 steps of B=8, batches up to 512 tokens) in a world
   of one rank over NCCL (torchrun's variables), default mesh and
   ``--shard_opt_state``, fp32 then bf16:
   the fp32 losses equal the plain Trainer's (no world) bit for bit, K5
   and K6 launch as their gates give, every K6 launch through
   ``fused_lm_loss_sharded``, the backend NCCL; a shorter bf16 run (2
   dialogues, as ``cli_phase``) holds every K5 and K6 launch, forward and
   backward, against its plain version. With two cards or more the CLI
   also starts a world of 2 itself, fp32, dropout 0: its epoch loss equals
   a world of one's. (b) Two processes share card 0 over a gloo group: the
   collectives the port issues probed on CUDA tensors (all_reduce,
   broadcast, all_gather), then gpt2 at full width (fp32, B=16, L=128,
   captions) for 4 steps as data=2 with the sharded K6 loss and ZeRO-1
   (dropout 0) and as model=2 (K5 on 6 heads a rank, dropout 0.1), each
   against one process's steps in the same process: loss within 1e-5,
   every gradient (this rank's part) within 1e-4; step times are readings
   of gloo through the host on one shared card, not the port's speed.
   (c) ``utils.profiling``: ``capture`` around one bf16 train step of
   gpt2 (B=8, L=128) writes a trace holding the ``annotate`` region and
   K5's and K6's kernels; ``StepTimer`` over 6 steps; ``start_server``'s
   endpoint, asked from another thread, records a trace holding K5's and
   K6's kernels while this thread launches steps.

16. inference over several devices (``mesh_infer_phase``), last: (a) four
   processes sharing card 0 over gloo as data=2 x model=2, gpt2 at full
   width and depth (6 heads a model rank; the serving slice: int8 KV and
   cross caches, int8 lm_head, ``decode_fused_mlp``, ``ERGM_CROSS_KERNEL``):
   ``generate_batch`` over 64 prompts of 128 tokens (captions on 3 of 4,
   image and audio features) and 32 new greedy tokens in fp32 (TF32 off),
   whose gathered tokens must equal the parent's one-process run up to each
   row's first decision with a top-2 margin of 1e-3 or less and whose
   emotion logits must be within 1e-4; then in bf16 with every K1 (self
   and cross), K2 and tensor-parallel K3 and K4 launch of every rank held
   against its plain version (``KernelShadow``), the K2 arm (a 512-token
   bucket, 544 slots, ``ERGM_DECODE_KERNEL``), ``beam_search_batch`` over
   8 prompts x 4 beams, and the slot-axis server (64 requests with budgets
   up to 16 through 16 slots, 8 a data rank; plain blocks shadowed, then
   speculative blocks). Each rank's launches must be K1 12 (self) and 12
   (cross) a prefill and K3's and K4's partial forms 12 a decode step (K2
   12 a step, K5 and K1 cross 12 a prefill in the K2 arm); each rank
   prints them with its decode step's wall time over gloo (a reading).
   (b) gpt2-xl's head geometry at 2 layers over model=2 (ranks 0 and 1:
   13 and 12 heads), fp32, against one process by the margin rule. (c)
   ``cli.main --mode=infer`` and ``--mode=serve`` at gpt2's full width in
   a world of one rank over NCCL: generations and responses equal to the
   runs without a world, before (a), so that no reading of the ranks
   overlaps it. (d) ``dryrun_multichip(4)`` on the card. K3's and
   K4's partial forms are also timed alone at a data rank's 32 rows against
   their plain versions (the ``_tp`` rows of the JSON line).

17. the large GPT-2 family (``large_phase``), last: (a) K6 at gpt2-large's
   training shape (N=6,144, V=50,271, D=1,280) and gpt2-xl's (N=2,048,
   D=1,600) in bf16 (NLL 1e-4 + 1e-4 |plain|, gradients by
   ``bf16_grad_ratio``) and fp32 with TF32 off (NLL 1e-5, gradients rtol
   1e-4 / atol 1e-5), times in turns with the plain version's and the
   bound; K1 (self with left pads, cross over a ragged caption), K3 and
   K4 at gpt2-large's width and the serving arm's shapes (B=64, 128
   tokens, a 32-token caption; F=5,120), bf16 and fp32, with times and
   bounds. (b, c) gpt2-large (B=12) and gpt2-xl (B=4), each at 12 of its
   36 and 48 layers (the depth cut that keeps the script within its time
   limit beside phase 19), through ``cli.main --mode=train`` with
   ergm_tpu's recipe (batches
   of 512 tokens, ``--remat_policy=full --adam_mu_dtype=bfloat16``,
   attention dropout 0.1, ``lm_loss_impl="auto"``), 8 steps each: K5 and
   K6 launches as their gates give (K5 twice a layer forward under full
   remat, and for the caption's cross-attention where its bucket passes
   K5's gate), the epoch line (tok/s, step p50, MFU; blocks of 2 steps,
   the first left out), finite losses and the peak memory; then the same
   run with every K5 and K6 launch, forward and backward, held against
   its plain version. (d) Both models at full width and depth in the
   serving configuration (bf16, int8 KV and caption caches, int8
   lm_head): ``generate_batch`` over 64 prompts of 128 tokens (captions
   on 3 of 4, image and audio features), 32 new greedy tokens, with the
   decode switches off and then with ``ERGM_CROSS_KERNEL`` and
   ``decode_fused_mlp`` under ``KernelShadow``: K1 self and cross n_layer
   times a prefill and K3 and K4 n_layer times a step at gpt2-large, none
   of them at gpt2-xl (JAX's D % 128 gates); the long-history arm
   (``generate``, 16 prompts of 384 tokens, 32 new, 512 slots) without
   and with ``ERGM_DECODE_KERNEL``: K5 n_layer times a prefill, K2 n_layer
   times a step; kernels-on tokens equal kernels-off ones wherever the
   latter's top-2 margin exceeds 1e-3; utt/s of each arm. (e) The
   agreement with ``ergm_tpu`` at gpt2-large's width: the seeded weights
   and inputs of ``ergm_tpu_torch/models/seeded.py`` (4 of 36 layers) on
   the card in fp32 against ``tests/fixtures/large_agreement.json``
   (``scripts/large_agreement.py``): greedy tokens by the margin rule,
   emotion logits within 1e-3, two AdamW steps' LM losses within 1e-5 and
   2e-3, relative (K5's and K6's fp32 routes).

18. K5 and K6 over the whole domain of their JAX kernels (``domain_phase``),
   last: (a) K5 at [48, 768 / Dh, 512, Dh] for Dh = 24 (padded to the
   32-wide kernel), 32, 96 and 128, causal and not, dropout 0 and 0.1, bf16
   (fp32 at B=4), forward and backward against the plain version at the
   bars of phase 10, with the times of kernel, plain and
   ``scaled_dot_product_attention`` at the training configuration and the
   bound; K7 at the widest head, [2, 6, 2048, 128], causal, left pads,
   the same way. (b) K6 at gpt2's training shape (N=24,576, GPT-2's
   50,257-row vocabulary) for D = 32, 96, 100 and 776 (padded to 64, 128,
   128 and 832, whole stages of the kernels' products), bf16
   and fp32 (N=2,048), with times and bounds and, at D = 100, the bf16
   backward twice bit for bit. (c) Nine 2-layer models (n_embd x n_head:
   768 x 6, 768 x 24, 96 x 4, 768 x 8, 32 x 4, 100 x 4, 776 x 8, 1088 x 8,
   2112 x 33; bf16, dropout 0.1) through ``Trainer`` for 2 steps of 8 x
   512 tokens and validation, every K5 and K6 launch held against its plain
   version (``KernelShadow``, forward and backward): K5 launches in training
   exactly at head widths in JAX's block gate (not at 25, 97 or 136, where
   the explicit ``block`` route raises), K7 forward in validation at 25 and
   97 (JAX's flash gate, no dropout), neither at 136; K6 at every width,
   2,112 too; one long-context step at 6 heads of 128 (K7). (d)
   gpt2 at its full width and 12 layers in fp32 against
   ``tests/fixtures/gpt2_agreement.json`` (``GPT2_AGREEMENT``): tokens by
   the margin rule, emotion logits within 1e-4, losses within 1e-5 and
   2e-3, relative.

19. K6 and K7 over the rest of their JAX kernels' domain and
   Cerebras-GPT-2.7B's width (``wide_phase``), last: (a) K6 at N=2,048
   over GPT-2's 50,257-row vocabulary for D = 2,560 (Cerebras-GPT-2.7B),
   4,096 (GPT-J-6B, Cerebras-6.7B) and 5,120 (Cerebras-13B), bf16 and fp32
   (N=1,024; the f32 backward in column groups of 2,048), at the bars of
   phase 17, with the bf16 backward twice bit for bit at 2,560. (b) K7 at
   [2, 16, 2048, Dh], causal, left pads, no dropout, for Dh = 100 (bf16:
   padded to the one-pass kernels' 128; fp32: K5's 128-wide template), 256
   and 384 (in bf16 the one-pass kernels, held to ``flash_mha_reference``,
   JAX's library flash arithmetic; the ptxas registers and spills of every
   one-pass kernel, 64 and 128 too, printed), fp32 and bf16, forward
   and backward against the plain version at the bars of phase 10, with
   SDPA's times and the bound; at Dh = 200 ``auto`` takes the plain math
   and ``flash`` raises. (c) Cerebras-GPT-2.7B's published widths
   (``models/seeded.py::CEREBRAS_2P7B``: 2,560 wide, 32 heads of 80,
   n_inner 10,240, through ``ModelConfig``'s constructor) at 8 of its 32
   layers: K3 and K4 at its width and the serving shapes, then ``Trainer``
   (bf16, full remat, attention dropout 0.1, 2 steps of 4 x 1,024 and
   validation; K6 at 2,560, K5 at Dh 80 on the 96-wide template) with every
   K5 and K6 launch held against its plain version, and ``generate_batch``
   over 64 prompts of 128 tokens and 32 new ones (captions, image and
   audio features; int8 caches and lm_head) with K3 and K4 off and on as
   in phase 17. (d) Three 2-layer models through ``Trainer`` at B=2 x
   2,048 tokens without attention dropout, so that JAX's flash gate routes
   every self-attention call: GPT-J-6B's attention (4,096 wide, 16 heads
   of 256, K6 at 4,096), 16 heads of 100 at 1,600 wide, and Cerebras-13B's
   width (5,120 wide, 40 heads of 128, K6 at 5,120), K7 and K6 shadowed. (e)
   Cerebras-GPT-2.7B's width at 2 layers in fp32 against
   ``tests/fixtures/cerebras_2p7b_agreement.json``
   (``CEREBRAS_2P7B_AGREEMENT``): tokens by the margin rule, emotion
   logits within 1e-3, both losses within 1e-5, relative.

Prints the card's name and power limit, a JSON line with each kernel's
numbers (time, launches on its path, the bound computed from this run's
shapes, the plain version's and a library call's time), and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero without a GPU.
Times are medians of CUDA events around single calls queued while the
device is kept busy, so they read device time and not the host's launch
overhead.
``--profile=PATH`` also writes a torch.profiler table of two train steps
to PATH, and ones of the B=256 and long-history decode steps and of two
steps of the command line's gpt2-medium recipe beside it (``_decode`` and
``_medium`` before the extension).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from ergm_tpu_torch.core.config import ModelConfig, TrainConfig
from ergm_tpu_torch.data.synthetic import write_synthetic_dataset
from ergm_tpu_torch.infer import beam, speculative
from ergm_tpu_torch.infer.generate import generate, generate_batch, pack_ragged_batch
from ergm_tpu_torch.infer.http_server import ServerFrontend
from ergm_tpu_torch.infer.server import ContinuousServer, Request, request_from_json
from ergm_tpu_torch.models import gpt2
from ergm_tpu_torch.ops import (_build, block_attention, cross_decode, decode_attention,
                                flash_attention, fused_ce, fused_decode, prefill_attention)
from ergm_tpu_torch.ops.attention import dropout_keep
from ergm_tpu_torch.train import checkpoint as ckpt_lib
from ergm_tpu_torch.train.steps import AdamW, create_train_state, make_train_step
from ergm_tpu_torch.train.trainer import Trainer
from ergm_tpu_torch.utils.flops import model_flops_per_token

DEVICE = "cuda"
B, PROMPT, NEW, CAPTION, D, H = 256, 128, 128, 32, 768, 12
EOS, SP2 = 50256, 50258
# the headline serving configuration of bench.py:101-104
SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
             kv_cache_dtype="int8", weight_dtype="int8_lm_head", cross_kv_dtype="int8")
BF16_TOL, F32_TOL = 2e-2, 2e-5
# the decode kernels' fp32 bars (JAX's own tests of K2, K3 and K4)
K2_TOL, K3_TOL, K4_TOL = 3e-4, 2e-4, 2e-5
# K2's readings (B, H, T, index): the long-history path's shape (its JSON
# row), a single request over a long cache, and the headline decode's cache
# size (a reading only: K2 is not routed below T = 512)
K2_SHAPES = {"long history": (64, 12, 512, 400), "single request": (1, 12, 1024, 1000),
             "headline cache": (256, 12, 256, 200)}
# the long-history phase: gpt2 at full width over a 512-slot cache
LONG_B, LONG_PROMPT, LONG_MAX = 64, 384, 512
# the slice and beam phases' depth: 2 of gpt2's 12 layers (cut so that the
# script keeps within half its time limit with the mesh phase; their
# readings from then on are not those of 12 layers)
SLICE_LAYERS = 2
SWITCHES = ("ERGM_CROSS_KERNEL", "ERGM_DECODE_KERNEL", "ERGM_ATTN_IMPL")
# the B=1 request of bench.py:207-240: int8 weights, bf16 self and cross
# caches, a 128-token prompt and 32 new tokens; SPEC_REQS timed requests a route
SPEC_SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
                  weight_dtype="int8")
SPEC_PROMPT, SPEC_NEW, SPEC_REQS = 128, 32, 5
# beam search over the long history: 16 ragged prompts bucketed to 384
# tokens, 4 beams, 128 new tokens in LONG_MAX slots
BEAM_B, BEAM_PROMPT, BEAM_W = 16, 384, 4
# the continuous server (scripts/server_bench.py:37-43's defaults): gpt2 at
# full width, 1 of its 12 layers (the depth cut that keeps the script within
# half its time limit; the server's phases are bound by the host, a layer at
# a time), bf16, int8 lm_head, full-precision MLP weights; SRV_REQS
# requests through SRV_SLOTS slots, prompts of 16-SRV_PROMPT tokens and
# 16-SRV_NEW new tokens, blocks of SRV_SYNC steps, a capacity ladder of
# SRV_GROW slots up to SRV_CACHE; the tiered arm adds SRV_LONG_SLOTS long
# slots, SRV_LONG_PROMPT-token prompts and SRV_LONG_CACHE slots
SRV_SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
                 weight_dtype="int8_lm_head", n_layer=1)
SRV_REQS, SRV_SLOTS, SRV_PROMPT, SRV_NEW, SRV_SYNC, SRV_GROW, SRV_CACHE = (
    256, 64, 128, 128, 32, 32, 512)
SRV_LONG_SLOTS, SRV_LONG_PROMPT, SRV_LONG_CACHE = 8, 384, 1024
# the fp32 identity with generate: the first SRV_IDENTITY requests, their
# budgets cut to SRV_IDENTITY_NEW less 3 per place in a group of
# SRV_IDENTITY_SLOTS (so rows finish in different blocks of
# SRV_IDENTITY_SYNC steps), through SRV_IDENTITY_SLOTS slots: the later
# requests join freed slots while other rows decode
SRV_IDENTITY, SRV_IDENTITY_NEW, SRV_IDENTITY_SLOTS, SRV_IDENTITY_SYNC = 16, 32, 8, 8
# the server's extension paths (server_ext_phase): SRV_CONVS conversations
# of SRV_TURNS turns through SRV_CONV_SLOTS slots, re-prefilled up to
# SRV_REPREFILL_MAX tokens; SRV_LONG_N prompts of SRV_CHUNK_PROMPT tokens
# among SRV_CHUNK_SHORT short requests, whole or in SRV_CHUNK-token chunks,
# in SRV_CHUNK_CACHE slots; SRV_SPEC_REQS requests through speculative
# blocks (gamma SRV_GAMMA, n-gram SRV_NGRAM); the HTTP front end over
# SRV_HTTP_SLOTS slots
SRV_CONVS, SRV_TURNS, SRV_CONV_SLOTS, SRV_REPREFILL_MAX = 64, 3, 48, 384
SRV_CHUNK_SHORT, SRV_LONG_N, SRV_CHUNK_PROMPT, SRV_CHUNK, SRV_CHUNK_CACHE = 64, 16, 448, 128, 1024
SRV_SPEC_REQS, SRV_GAMMA, SRV_NGRAM, SRV_HTTP_SLOTS = 128, 4, 3, 16
# the training configuration of scripts/train_bench.py:27-89
TRAIN_SLICE = dict(model_type="gpt2", vocab_size=50271, dtype="bfloat16", modality_dim=768,
                   attn_pdrop=0.1, resid_pdrop=0.1, embd_pdrop=0.1, remat=True,
                   remat_policy="mlp", lm_loss_impl="auto")
TRAIN_B, TRAIN_L, SEED = 48, 512, 1234
# K7's shapes: L past JAX's block gate (1024), inside its flash gate
LONG_L, FLASH_B = 2048, 8
# H100 SXM data sheet: HBM bytes/s and dense peaks (bf16 tensor cores, f32 CUDA cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


@contextlib.contextmanager
def switches(*names: str):
    """Sets JAX's decode-kernel switches ``names`` to 1 and the others off
    for the duration; "ERGM_ATTN_IMPL=xla" among the names sets that
    override (the plain math for every ``multihead_attention`` call)."""
    saved = {n: os.environ.pop(n, None) for n in SWITCHES}
    os.environ.update(dict(n.split("=") if "=" in n else (n, "1") for n in names))
    try:
        yield
    finally:
        for n, v in saved.items():
            os.environ.pop(n, None)
            if v is not None:
                os.environ[n] = v


class StepCounter:
    """Counts the single-token decode steps that ``gpt2.forward`` runs."""

    def __enter__(self):
        self.real, self.steps = gpt2.forward, 0

        def forward(params, config, input_ids, *args, **kwargs):
            if kwargs.get("cache") is not None and input_ids.shape[1] == 1:
                self.steps += 1
            return self.real(params, config, input_ids, *args, **kwargs)
        gpt2.forward = forward
        return self

    def __exit__(self, *exc):
        gpt2.forward = self.real


def reset_launches() -> None:
    for mod in (prefill_attention, cross_decode, fused_decode, decode_attention,
                block_attention, flash_attention, fused_ce):
        mod.LAUNCHES = 0
    prefill_attention.CROSS_LAUNCHES = 0
    cross_decode.TP_LAUNCHES = 0
    fused_decode.TP_LAUNCHES = 0
    block_attention.BWD_LAUNCHES = 0
    flash_attention.BWD_LAUNCHES = 0
    fused_ce.BWD_LAUNCHES = 0


def _train_counts() -> dict:
    return {"block_mha": block_attention.LAUNCHES,
            "block_mha_bwd": block_attention.BWD_LAUNCHES,
            "fused_softmax_xent": fused_ce.LAUNCHES,
            "fused_softmax_xent_bwd": fused_ce.BWD_LAUNCHES}


def _k7_counts() -> dict:
    """K7's launches (``flash_attention.flash_mha``), forward and backward."""
    return {"flash_mha": flash_attention.LAUNCHES, "flash_mha_bwd": flash_attention.BWD_LAUNCHES}


def bound(nbytes: float, flops: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(tb, tf), "bound_by": "bytes" if tb >= tf else "operations"}


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _bf16_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """One bf16 output rounding plus the summation order."""
    return bool(((got.float() - want.float()).abs()
                 <= BF16_TOL + 1e-2 * want.float().abs()).all())


def _ptxas(source: str, pattern: str) -> dict:
    """Registers and spills of the kernels of ``source`` whose names match
    ``pattern``, from this run's build log."""
    return _build.ptxas_report(_build.build_log(), source, pattern)


def _k1_grid(b: int, h: int, length: int) -> dict:
    """The persistent grid K1's last bf16 launch ran with, as the C side
    reports it (its CTAs, the (batch row, head, query block) items they
    walk, its key tile), checked against one CTA an SM over the items at
    this shape, and the kernel's registers and spills."""
    ctas, items, key_tile = list(prefill_attention.LAST_GRID)
    want = -(-length // 128) * b * h
    if items != want or ctas != min(want, _build.sm_count(torch.device(DEVICE))):
        raise AssertionError(f"K1 at {b} x {h} x {length} launched {ctas} CTAs over {items} "
                             f"items; want {want} items, one CTA an SM")
    return {"grid": {"ctas": ctas, "items": items, "key_tile": key_tile},
            "ptxas": _ptxas("prefill_attention.cu", "hop")}


def _k4_grid(m: int, d: int, f: int) -> dict:
    """The grids K4's last bf16 call launched (up and down projection), as
    the C side reports them: CTAs along x and y and the cluster's size,
    checked against the planner's plans at this shape (columns a CTA, K
    split, a cluster's column tiles), and the kernels' registers and
    spills."""
    cap = fused_decode.capacity(torch.device(DEVICE))
    plans = (fused_decode.plan(m, d, f, True, cap), fused_decode.plan(m, f, d, False, cap))
    started, *dims = list(fused_decode.LAST_GRID)
    grid, mt = {}, -(-m // fused_decode.TILE_ROWS)
    for i, (side, p, n) in enumerate((("up", plans[0], f), ("down", plans[1], d))):
        x, y, cluster = dims[3 * i:3 * i + 3]
        if started != 2 or (x, y, cluster) != (n // p.nt * p.splits, mt, p.splits * p.cn):
            raise AssertionError(f"K4 at {m} x {d} x {f}: the {side} projection launched "
                                 f"{started} kernels, grid ({x}, {y}), clusters of {cluster}; "
                                 f"the planner says {p}")
        grid[side] = {**p._asdict(), "grid": [x, y], "cluster": cluster, "ctas": x * y}
    return {"grid": grid, "ptxas": _ptxas("fused_decode.cu", r"wg")}


def _timed_pair(name: str, run, plain, reps: int = 20) -> tuple:
    """Median CUDA-event times of kernel and plain, in turns (plain,
    kernel, kernel, plain); returns (kernel ms, plain ms)."""
    p1, k1, k2, p2 = (_median_ms(f, reps) for f in (plain, run, run, plain))
    print(f"{name} bf16: kernel {min(k1, k2):.4f} ms, plain {min(p1, p2):.4f} ms "
          f"(medians of {reps}; runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f})")
    return min(k1, k2), min(p1, p2)


def _median_ms(fn, reps: int = 20) -> float:
    for _ in range(min(3, reps)):
        fn()
    torch.cuda.synchronize()
    # ~50 ms of device work ahead of the timed calls, so that the host has
    # queued them before the first one starts: the events then bracket
    # device time, not the launch overhead of the Python wrappers
    torch.cuda._sleep(100_000_000)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _kernel_durations(name: str, run, per_call: int, calls: int = 5, attempts: int = 3) -> list:
    """Prints the device duration of each of the ``per_call`` kernels of
    one call (medians over ``calls`` calls, torch.profiler) and the gaps
    between them; returns the durations in us. The profiler may miss the
    first kernels after it starts, so one call runs inside it before the
    ``calls`` that are read, and the trace's last ``per_call * calls``
    kernels are read when they repeat with the call's period (a kernel
    lost among them would break it); a trace that fails that is taken
    again, at most ``attempts`` times."""
    run()
    torch.cuda.synchronize()
    per = per_call
    for _ in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()  # not read: the profiler may miss it
            torch.cuda.synchronize()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        held = len(evs)
        evs = evs[-per * calls:]
        if (per * calls <= held <= per * (calls + 1)
                and all(e.name == evs[i % per].name for i, e in enumerate(evs))):
            break
        print(f"{name}: the trace holds {held} device operations over {calls} + 1 calls; "
              f"taking it again")
    else:
        raise AssertionError(f"{name}: {held} device operations over {calls} + 1 calls")
    calls_ev = [evs[i * per:(i + 1) * per] for i in range(calls)]
    dur = np.median([[e.time_range.elapsed_us() for e in c] for c in calls_ev], axis=0)
    gaps = np.median([[c[i + 1].time_range.start - c[i].time_range.end for i in range(per - 1)]
                      for c in calls_ev], axis=0) if per > 1 else []
    print(f"{name} bf16 kernels (torch.profiler, medians of {calls} calls): "
          + ", ".join(f"{e.name[:40]} {d:.2f} us" for e, d in zip(calls_ev[0], dur))
          + "; gaps " + ", ".join(f"{x:.2f} us" for x in gaps))
    return [float(d) for d in dur]


def kernel_phase(gen: torch.Generator) -> dict:
    """K1 vs plain at the slice's shapes. Returns the numbers of its two
    JSON rows, the self form ("prefill_mha") and the cross form
    ("prefill_mha_cross")."""
    res = {name: {"max_abs_err": 0.0, "max_abs_err_f32": 0.0}
           for name in ("prefill_mha", "prefill_mha_cross")}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        # the model hands K1 column slices of the fused projections
        qkv = torch.randn((B, PROMPT, 3 * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        ckv = torch.randn((B, CAPTION, 2 * D), generator=gen, device=DEVICE).to(dtype)
        ck, cv = ckv.split(D, dim=-1)
        lens = torch.randint(PROMPT // 2, PROMPT + 1, (B,), generator=gen, device=DEVICE)
        leftpad = (torch.arange(PROMPT, device=DEVICE)[None] >= PROMPT - lens[:, None]).float()
        clens = torch.randint(1, CAPTION + 1, (B,), generator=gen, device=DEVICE)
        ragged = (torch.arange(CAPTION, device=DEVICE)[None] < clens[:, None]).float()
        cases = {"self": (q, k, v, None, True, 1.0),
                 "self_leftpad": (q, k, v, leftpad, True, leftpad[:, :, None]),
                 "cross": (q.contiguous(), ck, cv, ragged, False, 1.0)}
        for name, (qq, kk, vv, m, causal, rows) in cases.items():
            run = lambda: prefill_attention.prefill_mha(  # noqa: E731
                qq, kk, vv, m, n_head=H, scale=0.125, causal=causal)
            plain = lambda: prefill_attention.prefill_mha_reference(  # noqa: E731
                qq, kk, vv, m, n_head=H, scale=0.125, causal=causal)
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = ((got.float() - want.float()) * rows).abs().max().item()
            print(f"K1 {name} {dtype}: max |kernel - plain| = {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"K1 {name} {dtype} disagrees with its plain version: {err}")
            r = res["prefill_mha_cross" if name == "cross" else "prefill_mha"]
            key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
            r[key] = max(r[key], err)
            if dtype == torch.bfloat16 and name != "self":
                r.update(_k1_grid(B, H, PROMPT))
                print(f"K1 {name} bf16: grid {json.dumps(r['grid'])}")
                r["ms"], r["plain_ms"] = _timed_pair(f"K1 {name}", run, plain)
                # the yardstick: one SDPA call over the same head views, with
                # the form's masks as one boolean mask; the bound counts the
                # (query, key) pairs the form computes
                heads = [x.view(B, -1, H, D // H).transpose(1, 2) for x in (qq, kk, vv)]
                allowed = m[:, None, None, :] > 0
                if causal:
                    allowed = allowed & torch.ones(PROMPT, PROMPT, dtype=torch.bool,
                                                   device=DEVICE).tril()
                r["library_ms"] = _median_ms(lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=allowed, scale=0.125))
                lk = kk.shape[1]
                pairs = B * H * (PROMPT * (PROMPT + 1) // 2 if causal else PROMPT * lk)
                r.update(bound(2 * _nbytes(qq) + 2 * B * lk * D * qq.element_size(),
                               2 * 2 * pairs * (D // H)))
                print(f"K1 {name} bf16: SDPA {r['library_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def _random_block(cfg: ModelConfig, gen: torch.Generator) -> gpt2.Block:
    """A decoder block at the config's width and dtype: N(0, 0.02)
    weights, N(0, 0.02) biases and N(1, 0.1) LayerNorm scales."""
    blk = gpt2.Block(cfg, device=DEVICE)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            x = torch.randn(p.shape, generator=gen, device=DEVICE)
            p.copy_(1.0 + 0.1 * x if name.endswith("scale") else 0.02 * x)
    return blk.to(cfg.compute_dtype).requires_grad_(False)


def _k2_case(gen: torch.Generator, b: int, h: int, t: int, index: int, dtype) -> tuple:
    """K2's arguments at one shape: layer 1 of a stacked int8 cache [2, b,
    h, t, 64] with bf16 scales, read in place; q a head view of a fused qkv
    projection; a left-pad mask of up to 199 slots. Returns (args, the
    bytes and the operations its function needs at these inputs)."""
    dh = 64
    kq, vq = (torch.randint(-127, 128, (2, b, h, t, dh), generator=gen, device=DEVICE,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = ((0.001 + 0.02 * torch.rand((2, b, h, t, 1), generator=gen,
                                         device=DEVICE)).bfloat16() for _ in range(2))
    qkv = torch.randn((b, 1, 3 * h * dh), generator=gen, device=DEVICE).to(dtype)
    q = qkv[..., :h * dh].view(b, 1, h, dh).transpose(1, 2)
    pads = torch.randint(0, 200, (b,), generator=gen, device=DEVICE)
    kmask = (torch.arange(t, device=DEVICE)[None] >= pads[:, None]).float()
    args = (q, kq[1], vq[1], ks[1], vs[1], index, 0.125, kmask)
    nbytes = (_nbytes(q, kmask) + b * h * dh * q.element_size()  # the slots up to the cursor
              + (index + 1) * _nbytes(kq[1], vq[1], ks[1], vs[1]) // t)
    return args, nbytes, 2 * 2 * b * h * (index + 1) * dh


def _k2_reading(label: str, args: tuple, h: int) -> dict:
    """K2 in bf16: a repeat is bitwise equal, a call is one launch, the
    cluster size it takes, its device duration (torch.profiler), and its
    time at every cluster size the row allows (CUDA events), each within
    the bar of the planned one's output."""
    run = lambda: decode_attention.decode_mha_int8(*args, n_head=h)  # noqa: E731
    decode_attention.LAUNCHES = 0
    first, again = run(), run()
    torch.cuda.synchronize()
    r = {"repeat_bitwise": bool(torch.equal(first, again)),
         "launches_per_call": decode_attention.LAUNCHES / 2,
         "cluster": decode_attention.LAST_CLUSTER}
    print(f"decode_mha_int8 {label}: a repeat is bitwise equal: {r['repeat_bitwise']}; "
          f"{r['launches_per_call']:g} launch a call; cluster of {r['cluster']} CTAs")
    if not r["repeat_bitwise"] or r["launches_per_call"] != 1:
        raise AssertionError(f"decode_mha_int8 {label}: repeat or launch count fails")
    r["device_us"] = _kernel_durations(f"decode_mha_int8 {label}", run, 1)[0]
    t, index = args[1].shape[2], args[5]
    r["cluster_ms"] = {}
    for c in range(1, decode_attention.MAX_CLUSTER + 1):
        if decode_attention.slice_keys(t, index, c) > decode_attention.MAX_KEYS:
            continue
        at = lambda: decode_attention.decode_mha_int8(*args, n_head=h, cluster=c)  # noqa: E731
        if not _bf16_ok(at(), first):
            raise AssertionError(f"decode_mha_int8 {label}: a cluster of {c} disagrees")
        r["cluster_ms"][c] = _median_ms(at)
    print(f"decode_mha_int8 {label} bf16 by cluster size (medians of 20): "
          + ", ".join(f"{c}: {ms:.4f} ms" for c, ms in r["cluster_ms"].items()))
    return r


def k2_shapes_phase(gen: torch.Generator) -> dict:
    """K2 in bf16 at its two further shapes (``K2_SHAPES``) against its
    plain version: the bar, a bitwise repeat, one launch a call, the
    cluster size, the device duration, CUDA-event times of kernel and plain
    in turns and the bound from the run's inputs. Also the floor of such a
    time: the same events around one empty launch."""
    res = {"launch_floor_ms": _median_ms(lambda: torch.cuda._sleep(0))}
    print(f"an empty launch reads {res['launch_floor_ms']:.4f} ms between CUDA events")
    for label, (b, h, t, index) in K2_SHAPES.items():
        if label == "long history":  # decode_kernel_phase's row
            continue
        args, nbytes, flops = _k2_case(gen, b, h, t, index, torch.bfloat16)
        run = lambda: decode_attention.decode_mha_int8(*args, n_head=h)  # noqa: E731
        plain = lambda: decode_attention.decode_mha_int8_reference(*args, n_head=h)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"decode_mha_int8 {label} B={b} T={t} index {index} bf16: max |kernel - plain| "
              f"= {err:.3e} (bar 2e-2 + 1e-2 |plain|)")
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or not _bf16_ok(got, want):
            raise AssertionError(f"decode_mha_int8 {label} disagrees with its plain version")
        r = {"shape": [b, h, t, index], "max_abs_err": err, **_k2_reading(label, args, h)}
        r["ms"], r["plain_ms"] = _timed_pair(f"decode_mha_int8 {label}", run, plain)
        r.update(bound(nbytes, flops))
        print(f"decode_mha_int8 {label}: {r['ms']:.4f} ms against a bound of "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.0%} of it")
        res[label] = r
    return res


def decode_kernel_phase(gen: torch.Generator) -> dict:
    """K2, K3 and K4 against their plain versions at the slice's shapes.
    Returns each kernel's numbers for the JSON line."""
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = ModelConfig.from_model_type(**{**SLICE, "dtype": "bfloat16" if dtype == torch.bfloat16
                                              else "float32"})
        blk = _random_block(cfg, gen)
        L, D = 2, cfg.n_embd
        h = torch.randn((B, 1, D), generator=gen, device=DEVICE).to(dtype)

        # K3: layer 1 of a two-layer stacked int8 caption cache, ragged mask
        codes = [torch.randint(-127, 128, (L, B, CAPTION, D), generator=gen, device=DEVICE,
                               dtype=torch.int8) for _ in range(2)]
        scales = [0.001 + 0.02 * torch.rand((L, B, CAPTION, H), generator=gen, device=DEVICE)
                  for _ in range(2)]
        clens = torch.randint(1, CAPTION + 1, (B,), generator=gen, device=DEVICE)
        cmask = (torch.arange(CAPTION, device=DEVICE)[None] < clens[:, None]).float()
        cmask[5] = 0.0  # a caption-less row
        stacks = (*codes, *scales)
        k3 = (lambda: cross_decode.fused_cross_decode(h, blk, 1, 0.125, stacks, cmask, cfg),
              lambda: cross_decode.fused_cross_decode_reference(h, blk, 1, 0.125, stacks,
                                                                cmask, cfg), K3_TOL)

        # K4: the LN2 + MLP tail at D=768, F=3072
        k4 = (lambda: fused_decode.fused_ln_mlp(h, blk.ln_2, blk.mlp, cfg),
              lambda: fused_decode.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, cfg), K4_TOL)

        # K2 at the long-history shape
        k2_args, k2_bytes, k2_flops = _k2_case(gen, *K2_SHAPES["long history"], dtype)
        k2 = (lambda: decode_attention.decode_mha_int8(*k2_args, n_head=H),
              lambda: decode_attention.decode_mha_int8_reference(*k2_args, n_head=H), K2_TOL)

        # bytes and operations each kernel's function needs at these inputs
        F_ = cfg.inner_dim
        bounds = {
            "cross_decode": bound(
                2 * _nbytes(h) + _nbytes(codes[0][1], codes[1][1], scales[0][1], scales[1][1],
                                         cmask, *blk.ln_cross.parameters(),
                                         *blk.cross_attn.q_attn.parameters(),
                                         *blk.cross_attn.c_proj.parameters()),
                2 * 2 * B * D * D + 2 * 2 * B * CAPTION * D),
            "fused_ln_mlp": bound(
                2 * _nbytes(h) + _nbytes(*blk.ln_2.parameters(), *blk.mlp.parameters()),
                2 * 2 * B * D * F_),
            "decode_mha_int8": bound(k2_bytes, k2_flops),
        }
        for name, (run, plain, tol) in (("cross_decode", k3), ("fused_ln_mlp", k4),
                                        ("decode_mha_int8", k2)):
            r = res.setdefault(name, {"max_abs_err": 0.0, "max_abs_err_f32": 0.0,
                                      "library_ms": None})
            got, want = run(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {dtype}: shape {tuple(got.shape)} or non-finite")
            err = (got.float() - want.float()).abs().max().item()
            ok = _bf16_ok(got, want) if dtype == torch.bfloat16 else err <= tol
            bar = "2e-2 + 1e-2 |plain|" if dtype == torch.bfloat16 else f"{tol:g}"
            print(f"{name} {dtype}: max |kernel - plain| = {err:.3e} (bar {bar})")
            if not ok:
                raise AssertionError(f"{name} {dtype} disagrees with its plain version: {err}")
            if dtype == torch.bfloat16:
                r["max_abs_err"] = err
                mod = {"cross_decode": cross_decode, "fused_ln_mlp": fused_decode}.get(name)
                if mod is not None:  # the redesigned K3 and K4: repeats and kernels a call
                    again = run()
                    torch.cuda.synchronize()
                    r["repeat_bitwise"] = bool(torch.equal(got, again))
                    r["kernels_per_call"] = mod.KERNELS_PER_CALL
                    if name == "fused_ln_mlp":
                        r.update(_k4_grid(B, D, F_))
                        print(f"fused_ln_mlp bf16: grid {json.dumps(r['grid'])}")
                    most = 3 if name == "cross_decode" else 2
                    print(f"{name} bf16: a repeat is bitwise equal: {r['repeat_bitwise']}; "
                          f"{r['kernels_per_call']} kernels a call (at most {most})")
                    if not r["repeat_bitwise"] or not 1 <= r["kernels_per_call"] <= most:
                        raise AssertionError(f"{name}: repeat or kernel count fails")
                elif name == "decode_mha_int8":
                    r.update(_k2_reading("long history", k2_args, H))
                r["ms"], r["plain_ms"] = _timed_pair(name, run, plain)
                r.update(bounds[name])
                if mod is not None:
                    _kernel_durations(name, run, mod.KERNELS_PER_CALL)
            else:
                r["max_abs_err_f32"] = err

        # K3 and K4 at the beam path's shape: B*W = 64 rows over the same
        # 32-token caption cache (the cache as the path holds it, contiguous)
        n = BEAM_B * BEAM_W
        stacks_n = tuple(x[:, :n].contiguous() for x in stacks)
        for name, run, plain, tol in (
                ("cross_decode",
                 lambda: cross_decode.fused_cross_decode(h[:n], blk, 1, 0.125, stacks_n,
                                                         cmask[:n], cfg),
                 lambda: cross_decode.fused_cross_decode_reference(h[:n], blk, 1, 0.125,
                                                                   stacks_n, cmask[:n], cfg),
                 K3_TOL),
                ("fused_ln_mlp", lambda: fused_decode.fused_ln_mlp(h[:n], blk.ln_2, blk.mlp, cfg),
                 lambda: fused_decode.fused_ln_mlp_reference(h[:n], blk.ln_2, blk.mlp, cfg),
                 K4_TOL)):
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
                  and (_bf16_ok(got, want) if dtype == torch.bfloat16 else err <= tol))
            bar = "2e-2 + 1e-2 |plain|" if dtype == torch.bfloat16 else f"{tol:g}"
            print(f"{name} {dtype} at the beam path's {n} rows: max |kernel - plain| = "
                  f"{err:.3e} (bar {bar})")
            if not ok:
                raise AssertionError(f"{name} {dtype} at {n} rows disagrees with its plain "
                                     f"version: {err}")
            key = "max_abs_err_beam_rows" + ("" if dtype == torch.bfloat16 else "_f32")
            res[name][key] = err
            if name == "fused_ln_mlp" and dtype == torch.bfloat16:
                res[name]["grid_beam_rows"] = _k4_grid(n, D, F_)["grid"]
    return res


def reference_phase() -> None:
    """A small fp32 model: the card's path against the CPU's plain path,
    prefill and three decode steps, within the CPU tests' 1e-3 bar for
    int8 caches. First with the decode switches off (the card through
    K1); then with all three on over a 512-slot cache (the card through
    K1, K2, K3 and K4)."""
    base = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=64,
                       modality_dim=768, dtype="float32", kv_cache_dtype="int8",
                       cross_kv_dtype="int8", weight_dtype="int8_lm_head")
    cpu = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator().manual_seed(1), base, device="cpu"), base)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(1)
    b, L, lc, steps = 64, 16, 8, 3
    x = dict(input_ids=rng.integers(0, 256, (b, L)), token_type_ids=rng.integers(0, 256, (b, L)),
             imgs=rng.standard_normal((b, 768)).astype(np.float32),
             auds=rng.standard_normal((b, 768)).astype(np.float32),
             caption_ids=rng.integers(0, 256, (b, lc)))
    toks = rng.integers(0, 256, (steps, b, 1))
    for on, T in ((False, L + steps), (True, LONG_MAX)):
        cfg = base.replace(decode_fused_mlp=on)
        logits = {}
        with switches(*(SWITCHES if on else ())):
            for dev, params in (("cpu", cpu), (DEVICE, card)):
                t = {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
                mask = torch.zeros((b, T), device=dev)
                mask[:, :L] = 1.0
                reset_launches()
                with torch.inference_mode():
                    cache = gpt2.init_kv_cache(cfg, b, T, caption_len=lc, device=dev)
                    o = gpt2.forward(params, cfg, attention_mask=mask, cache=cache,
                                     prefix_prefill=True, compute_logits="last", **t)
                    out = [o.logits[:, -1]]
                    for s in range(steps):
                        mask[:, L + s] = 1.0
                        o = gpt2.forward(params, cfg, torch.as_tensor(toks[s], device=dev),
                                         position_ids=torch.full((b, 1), L + s, device=dev),
                                         attention_mask=mask, cache=o.cache)
                        out.append(o.logits[:, -1])
                if dev == DEVICE:
                    counts = _launch_counts()
                    want = {"prefill_mha": cfg.n_layer, "prefill_mha_cross": cfg.n_layer,
                            "block_mha": 0,
                            **{k: (cfg.n_layer * steps if on else 0) for k in (
                                "fused_cross_decode", "fused_ln_mlp", "decode_mha_int8")}}
                    if counts != want:
                        raise AssertionError(f"small model launches {counts}, want {want}")
                logits[dev] = torch.stack(out).cpu()
        err = (logits[DEVICE] - logits["cpu"]).abs().max().item()
        arm = "switches on, K1-K4, T=512" if on else "switches off, K1"
        print(f"reference ({arm}): small fp32 model, card vs CPU, max |logit diff| = "
              f"{err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"the card's forward disagrees with the CPU's ({arm}): {err}")


def _launch_counts() -> dict:
    cross = prefill_attention.CROSS_LAUNCHES
    return {"prefill_mha": prefill_attention.LAUNCHES - cross, "prefill_mha_cross": cross,
            "fused_cross_decode": cross_decode.LAUNCHES,
            "fused_ln_mlp": fused_decode.LAUNCHES,
            "decode_mha_int8": decode_attention.LAUNCHES,
            "block_mha": block_attention.LAUNCHES}


def _check_generate(out, cfg, ids, prompt: int, max_len: int) -> int:
    """The repo's own checks of a generate call; returns its new tokens."""
    b = ids.shape[0]
    tok, lengths, emo = out.tokens, out.lengths, out.emotion_logits
    if tok.shape != (b, max_len) or not torch.equal(tok[:, :prompt], ids):
        raise AssertionError(f"bad token buffer {tuple(tok.shape)}")
    if int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError("token out of the vocabulary")
    if int(lengths.min()) <= prompt or int(lengths.max()) > max_len:
        raise AssertionError(f"lengths out of range: {int(lengths.min())}..{int(lengths.max())}")
    if emo.shape != (b, cfg.num_emotions) or not bool(torch.isfinite(emo).all()):
        raise AssertionError(f"emotion logits are not finite [{b}, 7]")
    return int(lengths.sum()) - b * prompt


def _generate_arms(label: str, params, arms: dict, inputs: dict, prompt: int, max_len: int,
                   card: str) -> dict:
    """Runs ``generate`` under each arm ({name: (config, switch names)}):
    one untimed first call each, then timed calls in turns (a, b, b, a).
    Each timed call starts from zeroed launch counts; K2-K4 must launch
    n_layer times per decode step where their switch is on, and never
    where it is off. Returns {arm: counts of its last timed call}."""
    ids = inputs["input_ids"]

    def run(cfg, names, seed):
        with switches(*names), StepCounter() as steps:
            reset_launches()
            t0 = time.time()
            out = generate(params, cfg, ids, prompt, max_len=max_len, eos_id=EOS, sp2_id=SP2,
                           top_p=0.8, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                           token_type_ids=inputs["token_type_ids"], imgs=inputs["imgs"],
                           auds=inputs["auds"], caption_ids=inputs["caption_ids"])
            torch.cuda.synchronize()
            wall = time.time() - t0
        return out, wall, steps.steps, _launch_counts()

    for name, (cfg, names) in arms.items():
        t0 = time.time()
        run(cfg, names, 0)
        print(f"{label} [{name}]: first call {time.time() - t0:.3f} s")
    order = list(arms)
    counts, walls = {}, {name: [] for name in order}
    for name in order + order[::-1]:
        cfg, names = arms[name]
        out, wall, steps, got = run(cfg, names, 1)
        new_tokens = _check_generate(out, cfg, ids, prompt, max_len)
        n = cfg.n_layer * steps
        want = {"fused_cross_decode": n if "ERGM_CROSS_KERNEL" in names else 0,
                "fused_ln_mlp": n if cfg.decode_fused_mlp else 0,
                "decode_mha_int8": n if "ERGM_DECODE_KERNEL" in names else 0}
        if {k: got[k] for k in want} != want or steps < 1:
            raise AssertionError(f"{label} [{name}]: launches {got} over {steps} decode steps, "
                                 f"want {want}")
        walls[name].append(wall)
        counts[name] = got
        b = ids.shape[0]
        print(f"{label} [{name}] B={b}: {wall:.3f} s, {b / wall:.2f} utt/s, "
              f"{new_tokens / wall:.0f} new tok/s ({new_tokens} tokens, {steps} decode steps), "
              f"launches {got} on {card}")
    runs = {k: "/".join(f"{w:.3f}" for w in v) for k, v in walls.items()}
    print(f"{label}: wall s " + ", ".join(f"{k} {min(walls[k]):.3f} (runs {runs[k]})"
                                          for k in walls))
    return counts


def _gpt2_inputs(rng, b: int, prompt: int) -> dict:
    return {"input_ids": torch.as_tensor(rng.integers(0, 50000, (b, prompt)), device=DEVICE),
            "token_type_ids": torch.as_tensor(rng.integers(0, 50000, (b, prompt)),
                                              device=DEVICE),
            "imgs": torch.as_tensor(rng.standard_normal((b, 768)), device=DEVICE).bfloat16(),
            "auds": torch.as_tensor(rng.standard_normal((b, 768)), device=DEVICE).bfloat16(),
            "caption_ids": torch.as_tensor(rng.integers(0, 50000, (b, CAPTION)), device=DEVICE)}


def slice_phase(card: str) -> tuple:
    """Full-width gpt2: generate at B=256 with the decode switches off and
    with K3 and K4 on, 64 ragged generate_batch requests, and the
    long-history generate with K2 on and off, at SLICE_LAYERS layers.
    Returns the slice's kernels-on launch counts and the long-history K2
    arm's."""
    cfg = ModelConfig.from_model_type(**{**SLICE, "n_layer": SLICE_LAYERS})
    t0 = time.time()
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
    torch.cuda.synchronize()
    print(f"slice: gpt2 init + int8 lm_head in {time.time() - t0:.2f} s")
    arms = {"kernels off": (cfg, ()),
            "K3+K4 on": (cfg.replace(decode_fused_mlp=True), ("ERGM_CROSS_KERNEL",))}
    counts = _generate_arms("slice generate", params, arms,
                            _gpt2_inputs(np.random.default_rng(0), B, PROMPT), PROMPT,
                            PROMPT + NEW, card)
    for name, got in counts.items():
        if (got["prefill_mha"], got["prefill_mha_cross"], got["block_mha"]) != (
                cfg.n_layer, cfg.n_layer, 0):
            raise AssertionError(f"[{name}] K1 launched {got['prefill_mha']} (self) and "
                                 f"{got['prefill_mha_cross']} (cross) times and K5 "
                                 f"{got['block_mha']} times in one prefill, want "
                                 f"{cfg.n_layer}, {cfg.n_layer} and 0")
    step_tables = decode_step_phase(params, arms, card)

    brng = np.random.default_rng(1)
    n = 64
    prompts = [brng.integers(0, 50000, int(m)).tolist()
               for m in [PROMPT] + list(brng.integers(8, PROMPT + 1, n - 1))]
    captions = [None if i % 4 == 3 else brng.integers(0, 50000, int(brng.integers(4, 33))).tolist()
                for i in range(n)]
    prefill_attention.LAUNCHES = 0
    t0 = time.time()
    results, bemo = generate_batch(
        params, cfg, prompts, max_len=PROMPT + NEW, eos_id=EOS, sp2_id=SP2,
        imgs=brng.standard_normal((n, 768)).astype(np.float32),
        auds=brng.standard_normal((n, 768)).astype(np.float32), captions=captions,
        greedy=True, max_new_tokens=32)
    bwall = time.time() - t0
    if prefill_attention.LAUNCHES != 2 * cfg.n_layer:
        raise AssertionError(f"generate_batch: K1 launched {prefill_attention.LAUNCHES} times")
    if len(results) != n or any(not 1 <= len(r) <= 32 for r in results):
        raise AssertionError("generate_batch: wrong continuation lengths")
    if any(t < 0 or t >= cfg.vocab_size for r in results for t in r):
        raise AssertionError("generate_batch: token out of the vocabulary")
    if bemo.shape != (n, cfg.num_emotions) or not np.isfinite(bemo).all():
        raise AssertionError("generate_batch: emotion logits are not finite [64, 7]")
    print(f"slice generate_batch: {n} ragged greedy requests ({n // 4} without a caption) "
          f"in {bwall:.3f} s on {card}")

    # "prefill as before": the prompt's self-attention on the plain math,
    # the route taken before the prefill followed JAX's rule (the T=512
    # decode steps do not call multihead_attention)
    long_arms = {"K2 on": (cfg, ("ERGM_DECODE_KERNEL",)), "kernels off": (cfg, ()),
                 "prefill as before": (cfg, ("ERGM_ATTN_IMPL=xla",))}
    long_counts = _generate_arms("long history", params, long_arms,
                                 _gpt2_inputs(np.random.default_rng(2), LONG_B, LONG_PROMPT),
                                 LONG_PROMPT, LONG_MAX, card)
    for name, got in long_counts.items():
        want = 0 if name == "prefill as before" else cfg.n_layer
        if got["block_mha"] != want:
            raise AssertionError(f"long history [{name}]: K5 launched {got['block_mha']} times "
                                 f"in one prefill, want {want}")
    print(f"long history: K5 launched {long_counts['kernels off']['block_mha']} times in the "
          f"prefill ({cfg.n_layer} layers) under auto")
    long_steps = decode_step_phase(params, {k: long_arms[k] for k in ("K2 on", "kernels off")},
                                   card, b=LONG_B, prompt=LONG_PROMPT, slots=LONG_MAX)
    step_tables.update({f"long history {k}": v for k, v in long_steps.items()})
    return counts["K3+K4 on"], long_counts["K2 on"], step_tables


def decode_step_phase(params, arms: dict, card: str, steps: int = 8, b: int = B,
                      prompt: int = PROMPT, slots: int = 0) -> dict:
    """Device time and kernel count of one decode step at batch ``b`` under
    each arm ({name: (config, switch names)}), by torch.profiler over
    ``steps`` steps after a ``prompt``-token prefill and two warm-up steps,
    and the host's wall time per step over as many unprofiled steps; the
    cache holds ``slots`` slots (0: just enough). K2-K4 must launch n_layer
    times a step where their switch is on, and never where it is off.
    Returns {arm: profiler table}."""
    inputs = _gpt2_inputs(np.random.default_rng(4), b, prompt)
    tok = torch.as_tensor(np.random.default_rng(5).integers(0, 50000, (b, 1)), device=DEVICE)
    T = slots or prompt + 2 + 2 * steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tables = {}
    for name, (cfg, names) in arms.items():
        with switches(*names), torch.inference_mode():
            mask = torch.zeros((b, T), device=DEVICE)
            mask[:, :prompt] = 1.0
            cache = gpt2.init_kv_cache(cfg, b, T, caption_len=CAPTION, device=DEVICE)
            o = gpt2.forward(params, cfg, attention_mask=mask, cache=cache, prefix_prefill=True,
                             compute_logits="last", **inputs)
            pos = prompt

            def step():
                nonlocal o, pos
                mask[:, pos] = 1.0
                o = gpt2.forward(params, cfg, tok, position_ids=torch.full((b, 1), pos,
                                                                           device=DEVICE),
                                 attention_mask=mask, cache=o.cache)
                pos += 1

            step()
            step()
            torch.cuda.synchronize()
            reset_launches()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(steps):
                    step()
                torch.cuda.synchronize()
            counts = _launch_counts()
            t0 = time.time()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.time() - t0) / steps
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
        kernels = sum(e.count for e in device) / steps
        n = cfg.n_layer * steps
        want = (n if "ERGM_CROSS_KERNEL" in names else 0, n if cfg.decode_fused_mlp else 0,
                n if "ERGM_DECODE_KERNEL" in names and T >= 512 else 0)
        if (counts["fused_cross_decode"], counts["fused_ln_mlp"],
                counts["decode_mha_int8"]) != want or ms <= 0:
            raise AssertionError(f"decode step [{name}]: launches {counts}, device {ms} ms")
        print(f"decode step [{name}] B={b}, {T} slots: device time {ms:.3f} ms, {kernels:.0f} "
              f"device operations, host wall {1e3 * wall:.3f} ms a step (torch.profiler over "
              f"{steps} steps; wall unprofiled) on {card}")
        tables[name] = (f"{card}: decode step [{name}] B={b}, {T} slots, device time {ms:.3f} ms, "
                        f"{kernels:.0f} device operations a step\n"
                        + prof.key_averages().table(sort_by="device_time_total", row_limit=30,
                                                    max_name_column_width=70))
    return tables


class LogitRecorder:
    """Records the full-depth model's logits by the logical position of
    the token they predict, the last call winning: a verify window's rows
    past its accepted prefix are overwritten by the next window, so what
    stays is what predicted the emitted tokens."""

    def __init__(self, n_layer: int):
        self.n_layer, self.at = n_layer, {}

    def __enter__(self):
        self.real = gpt2.forward

        def forward(params, config, input_ids, *args, **kwargs):
            out = self.real(params, config, input_ids, *args, **kwargs)
            pos = kwargs.get("position_ids")
            if out.logits is not None and config.n_layer == self.n_layer and pos is not None:
                pos = pos[0, -out.logits.shape[1]:].tolist()
                for i, q in enumerate(pos):
                    self.at[q + 1] = out.logits[0, i].float()
            return out
        gpt2.forward = forward
        return self

    def __exit__(self, *exc):
        gpt2.forward = self.real


def _top2_margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _first_difference(want: list, got: list, plain: dict, other: dict, start: int) -> dict:
    """Where ``got`` first leaves ``want`` (``index``, None when they
    agree), the plain route's top-2 logit margin there and the largest
    |logit difference| of the two routes there (their prefixes are equal
    up to it); and, over the positions up to it, the largest logit
    difference as a share of the bf16 bar 2e-2 + 1e-2 |plain|."""
    res = {"index": None, "margin": None, "delta": None, "bar_share": 0.0}
    for j, (a, b) in enumerate(zip(want, got)):
        p, o = plain[start + j], other[start + j]
        err = (p - o).abs()
        res["bar_share"] = max(res["bar_share"], float((err / (BF16_TOL + 1e-2 * p.abs())).max()))
        if a != b:
            res.update(index=j, margin=_top2_margin(p), delta=float(err.max()))
            return res
    if len(want) != len(got):
        res["index"] = min(len(want), len(got))
    return res


class SpecSpy:
    """Wraps ``speculative.speculative_generate`` to keep each call's mode
    and (accepted, macro steps, proposed) from ``speculative_stats``."""

    def __enter__(self):
        self.real, self.calls = speculative.speculative_generate, []

        def spy(*args, **kwargs):
            out, stats = speculative.speculative_stats(*args, **kwargs)
            self.calls.append((kwargs["mode"], stats))
            return out
        speculative.speculative_generate = spy
        return self

    def __exit__(self, *exc):
        speculative.speculative_generate = self.real


def _b1_request(rng) -> dict:
    """bench.py:207-240's request: a 128-token prompt with token types, a
    32-token caption, image and audio features."""
    return dict(prompts=[rng.integers(0, 50000, SPEC_PROMPT).tolist()],
                token_types=[rng.integers(0, 50000, SPEC_PROMPT).tolist()],
                imgs=rng.standard_normal((1, 768)).astype(np.float32),
                auds=rng.standard_normal((1, 768)).astype(np.float32),
                captions=[rng.integers(0, 50000, CAPTION).tolist()])


def spec_phase(card: str) -> dict:
    """One B=1 request through ``generate_batch`` on three routes: plain
    (``spec_mode="none"``), ``auto`` (which must take n-gram drafting)
    and a 3-layer self-draft with gamma 4. fp32 tokens must be equal
    across the routes; in bf16 each route is compared with the plain one
    by the margin rule. K5 must launch n_layer times in the target's
    prefill (and draft_layers more for the draft's). Returns the launch
    counts of the last timed request of each route."""
    routes = {"plain": dict(spec_mode="none"), "auto": {},
              "draft": dict(draft_layers=3, spec_gamma=4)}
    req = _b1_request(np.random.default_rng(1))
    kw = dict(max_len=SPEC_PROMPT + SPEC_NEW, eos_id=EOS, sp2_id=SP2, greedy=True,
              max_new_tokens=SPEC_NEW, **req)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig.from_model_type(**{**SPEC_SLICE, "dtype": dtype})
        params = gpt2.params_for_inference(
            gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
        tokens, logits = {}, {}
        for name, route in routes.items():
            with switches(), SpecSpy() as spy, LogitRecorder(cfg.n_layer) as rec:
                block_attention.LAUNCHES = 0
                tokens[name] = generate_batch(params, cfg, **kw, **route)[0][0]
                k5 = block_attention.LAUNCHES
            logits[name] = rec.at
            want_mode = {"plain": None, "auto": "ngram", "draft": "draft"}[name]
            modes = [m for m, _ in spy.calls]
            if modes != ([want_mode] if want_mode else []):
                raise AssertionError(f"B=1 [{name}]: routed to {modes}, want {want_mode}")
            want_k5 = cfg.n_layer + (3 if name == "draft" else 0)
            if k5 != want_k5 or len(tokens[name]) != SPEC_NEW:
                raise AssertionError(f"B=1 [{name}] {dtype}: K5 launched {k5} times (want "
                                     f"{want_k5}), {len(tokens[name])} tokens")
        for name in ("auto", "draft"):
            d = _first_difference(tokens["plain"], tokens[name], logits["plain"], logits[name],
                                  SPEC_PROMPT)
            print(f"B=1 {dtype} [{name}]: first leaves plain greedy at new token {d['index']} "
                  f"(None: all {SPEC_NEW} equal); plain's top-2 margin there {d['margin']}, the "
                  f"routes' logits there differ by {d['delta']}; before it the logits differ by "
                  f"at most {d['bar_share']:.3f} of the bf16 bar")
            # fp32: token for token; bf16: the margin rule (equal wherever
            # plain's top-2 margin exceeds 1e-3)
            if d["index"] is not None and (dtype == "float32" or d["margin"] > 1e-3):
                raise AssertionError(f"B=1 {dtype} [{name}] leaves plain greedy: {d}")
        if dtype == "float32":
            del params
            torch.cuda.empty_cache()
            continue

        # times: a warm call (startup), then SPEC_REQS requests a route in turns
        walls, stats = {name: [] for name in routes}, {}
        for name, route in routes.items():
            t0 = time.time()
            generate_batch(params, cfg, **kw, **route)
            print(f"B=1 [{name}]: first call {1e3 * (time.time() - t0):.1f} ms (startup)")
        order = list(routes)
        for i in range(SPEC_REQS):
            for name in (order if i % 2 == 0 else order[::-1]):
                with switches(), SpecSpy() as spy:
                    reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    generate_batch(params, cfg, **kw, **routes[name])
                    torch.cuda.synchronize()
                    walls[name].append(time.time() - t0)
                    out[name] = _launch_counts()
                    stats[name] = spy.calls
        for name in routes:
            calls = stats[name]
            acc, steps, prop = calls[0][1] if calls else (0, SPEC_NEW, 0)
            ms = 1e3 * float(np.median(walls[name]))
            print(f"B=1 [{name}] bf16: median {ms:.2f} ms a request over {SPEC_REQS} "
                  f"(runs " + "/".join(f"{1e3 * w:.1f}" for w in walls[name]) + f" ms), "
                  f"{steps} {'macro ' if calls else ''}steps, {acc} of {prop} proposals "
                  f"accepted, {ms / steps:.2f} ms a step on {card}")
    return out


def _k1_rows(args, kwargs):
    """The rows of a K1 output that are compared: real queries of the self
    form (left-pad mask), rows with a caption of the cross form."""
    m = args[3] if len(args) > 3 else kwargs.get("kv_mask")
    if m is None:
        return None
    return m[:, :, None] if kwargs.get("causal", True) else (m.sum(-1) > 0)[:, None, None]


def _k5_rows(args, kwargs):
    """Real query rows of a K5 output (K5 gives zeros on padded queries,
    the plain version junk)."""
    m = kwargs.get("q_mask")
    return None if m is None else m[:, None, :, None]


def _k5_key_mask(kbits: torch.Tensor, lk: int) -> torch.Tensor:
    """K5's key mask [B, Lk] from the forward's bits (bit c of word w is key
    32w + c)."""
    bits = (kbits[:, :, None] >> torch.arange(32, device=kbits.device)) & 1
    return bits.reshape(kbits.shape[0], lk)


def _k5_bwd_args(args) -> tuple:
    """``block_attention.launch_bwd``'s arguments with the head stride
    (default: the launch's head count)."""
    return tuple(args) + ((args[0].shape[1],) if len(args) == 13 else ())


def _attn_bwd_plain(plain, args, dtype, **kw) -> list:
    """(dQ, dK, dV) of the plain attention ``plain`` in ``dtype`` on the
    inputs of a K5 or K7 backward launch (its first eleven; ``kw``:
    ``plain``'s further arguments), by autograd."""
    q, k, v, _, _, qm, kbits, _, do, scale, causal = args[:11]
    xs = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        o = plain(*xs, causal=causal, scale=scale, q_mask=qm,
                  kv_mask=_k5_key_mask(kbits, k.shape[2]), **kw)
        return list(torch.autograd.grad(o, xs, do.to(dtype)))


def _k5_bwd_plain(args, dtype) -> list:
    """``_attn_bwd_plain`` of K5's plain version with the launch's dropout."""
    rate, seed, stride = _k5_bwd_args(args)[11:]
    return _attn_bwd_plain(block_attention.block_mha_reference, args, dtype,
                           dropout_rate=rate, dropout_seed=seed, dropout_head_stride=stride)


def _k7_bwd_plain(args, dtype) -> list:
    """``_attn_bwd_plain`` of the plain version of what a K7 launch runs
    (``flash_attention.kernel_reference``; no dropout)."""
    return _attn_bwd_plain(flash_attention.kernel_reference, args, dtype)


def _k5_bwd_jax(args) -> list:
    """``_attn_bwd_jax`` on a K5 backward launch's arguments, with its dropout."""
    return _attn_bwd_jax(args[:11], False, *_k5_bwd_args(args)[11:])


def _k7_bwd_jax(args) -> list:
    """``_attn_bwd_jax`` on a K7 backward launch's arguments (no dropout):
    JAX's library flash backward where the launch runs the one-pass kernels
    (``flash_attention.flash_route``), K5's backward arithmetic elsewhere
    (``wide::``)."""
    q = args[0]
    return _attn_bwd_jax(args, flash_attention.flash_route(q.shape[-1], q.dtype))


def _attn_bwd_jax(args, flash: bool, rate: float = 0.0, seed: int = 0,
                  stride: int | None = None) -> list:
    """(dQ, dK, dV) by the arithmetic of JAX's K5 backward
    (``ergm_tpu/ops/block_attention.py::_bwd_kernel``), in plain PyTorch:
    scores, pn and dpn in f32 from the bf16 operands, delta = rowsum(pn *
    dpn), ds = pn * (dpn - delta) and the dropped pn rounded to the
    operands' dtype, f32 products, the results rounded. ds is 0 where a key
    is masked (the where's derivative), as in K5 and the autograd twin.
    With ``flash`` (a K7 launch on the one-pass kernels), JAX's library
    flash backward instead (``flash_attention.py::_flash_attention_bwd``
    and its kernels): delta = rowsum(o * dO) in f32 from the forward's
    output, ds = pn * (dpn - delta) * scale rounded. ``args``: the launch's
    first eleven; ``rate``, ``seed``, ``stride``: K5's dropout."""
    q, k, v, o, _, qm, kbits, _, do, scale, causal = args
    B, H, L, _ = q.shape
    lk = k.shape[2]
    mask = _k5_key_mask(kbits, lk)[:, None, None, :].bool()
    if causal:
        mask = mask & (torch.arange(lk, device=q.device)[None, :]
                       <= torch.arange(L, device=q.device)[:, None])
    f = [x.float() for x in (q, k, v, do)]
    s = torch.where(mask, f[0] @ f[1].transpose(-1, -2) * scale, -1e30)
    pn = torch.where(qm[:, None, :, None].bool(), torch.softmax(s, -1), 0.0)
    dpn = f[3] @ f[2].transpose(-1, -2)
    pv = pn
    if rate > 0.0:
        keep = dropout_keep(seed, B, H, L, lk, rate, device=q.device, head_stride=stride)
        dpn = torch.where(keep, dpn / (1.0 - rate), 0.0)
        pv = torch.where(keep, pn / (1.0 - rate), 0.0)
    if flash:
        delta = (o.float() * f[3]).sum(-1, keepdim=True)
        ds = torch.where(mask, pn * (dpn - delta) * scale, 0.0).to(q.dtype).float()
        scale = 1.0
    else:
        delta = (pn * dpn).sum(-1, keepdim=True)
        ds = torch.where(mask, pn * (dpn - delta), 0.0).to(q.dtype).float()
    return [(ds @ f[1] * scale).to(q.dtype), (ds.transpose(-1, -2) @ f[0] * scale).to(q.dtype),
            (pv.to(q.dtype).float().transpose(-1, -2) @ f[3]).to(q.dtype)]


def _k6_bwd_plain(args, dtype) -> list:
    """(dh, dW) of K6's plain version in ``dtype`` on the inputs of
    ``fused_ce.launch_bwd`` (the per-token cotangent g)."""
    hidden, wte, labels, _, g = args[:5]
    hh, ww = (x.detach().to(dtype).requires_grad_(True) for x in (hidden, wte))
    with torch.enable_grad():
        nll = fused_ce.fused_softmax_xent_reference(hh, ww, labels)
        return list(torch.autograd.grad((nll * g).sum(), (hh, ww)))


def _k6_f64(hidden, wte, labels, g) -> list:
    """K6's plain math in float64: (NLL, dh, dW) for the per-token
    cotangent ``g``, the fp32 route's oracle: at D = 5,120 the kernels
    read 1.294 of the fp32 gradient bar against the f32 plain version and
    under 0.1 against this, the rest being the f32 version's rounding."""
    logits = hidden.double() @ wte.double().t()
    ok = labels >= 0
    gold = logits.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    nll = torch.logsumexp(logits, -1) - torch.where(ok, gold, 0.0)
    gg = torch.where(ok, g.double(), 0.0)
    p = torch.softmax(logits, -1) * gg[:, None]
    p[ok, labels[ok]] -= gg[ok]
    return [nll, p @ wte.double(), p.t() @ hidden.double()]


def _k6_bwd_jax(args) -> list:
    """(dh, dW) by the arithmetic of JAX's K6 backward
    (``ergm_tpu/ops/fused_ce.py::_vjp_bwd`` and its ``_padj``), in plain
    PyTorch on the inputs of ``fused_ce.launch_bwd``: the f32 logits of the
    operands, padj = exp(s - logZ) g - [v = label] g with the forward's logZ
    (0 for an ignored label), rounded to the operands' dtype before both
    products, f32 products, the results rounded. The kernel rounds where
    this does; the autograd of the plain forward rounds only its results."""
    hidden, wte, labels, logz, g = args[:5]
    h, w = hidden.float(), wte.float()
    ok = labels >= 0
    gw = torch.where(ok, g, 0.0)
    p = torch.exp(h @ w.t() - logz[:, None]) * gw[:, None]
    rows = torch.nonzero(ok)[:, 0]
    p[rows, labels[rows].long()] -= gw[rows]
    p = p.to(hidden.dtype).float()
    return [(p @ w).to(hidden.dtype), (p.t() @ h).to(wte.dtype)]


class KernelShadow:
    """Holds every launch of the given kernels in a run against its plain
    version on the same inputs: each wrapper is wrapped to call the plain
    version after it and keep, on the device, the largest |kernel - plain|
    as a share of its bar, over the output rows that ``rows(args, kwargs)``
    marks (all when it gives None): F32_TOL where the first input is fp32,
    else the bf16 bar 2e-2 + 1e-2 |plain|. ``backward`` entries wrap a
    module's ``launch_bwd`` likewise: each launch's bf16 gradients are
    held by ``bf16_grad_ratio`` against ``plain(args)`` and ``exact(args)``
    (the same math in f32), over the rows that ``rows(args)`` marks per
    gradient; where ``also(args)`` is given (a second plain version), the
    kernel's and the plain version's ratios against it are kept too
    (``readings``), unchecked. The plain versions add to no count; the
    kernels' own launches in such a run are not the path's. ``kernels``:
    (module, wrapper name, rows or None[, plain version: by default the
    module's ``<name>_reference``]); K2, K3 and K4 by default.
    ``backward``: (module, count name, plain, exact, rows, also or None)."""

    KERNELS = ((decode_attention, "decode_mha_int8", None),
               (cross_decode, "fused_cross_decode", None), (fused_decode, "fused_ln_mlp", None))
    # the server's path: K1 (both forms), K5 and K4
    SERVER = ((prefill_attention, "prefill_mha", _k1_rows),
              (block_attention, "block_mha", _k5_rows),
              (fused_decode, "fused_ln_mlp", None))
    # the training path's backward launches, each against JAX's backward
    # arithmetic (the TPU kernel's) and read against the autograd of its
    # forward's plain version: K5 and K7 with dQ on the rows of real queries; K6
    # (whose padj JAX rounds before both products: at gpt2-xl's width a
    # training step's launch read 1.15 of the bar against the autograd,
    # which rounds only the results)
    BACKWARD = ((block_attention, "block_mha_bwd", _k5_bwd_jax,
                 lambda a: _k5_bwd_plain(a, torch.float32),
                 lambda a: (a[5][:, None, :, None], None, None),
                 lambda a: _k5_bwd_plain(a, torch.bfloat16)),
                (fused_ce, "fused_softmax_xent_bwd", _k6_bwd_jax,
                 lambda a: _k6_bwd_plain(a, torch.float32), lambda a: (None, None),
                 lambda a: _k6_bwd_plain(a, torch.bfloat16)))
    # the same and K7's (runs with shapes past JAX's block gate)
    K7_BACKWARD = BACKWARD + ((flash_attention, "flash_mha_bwd", _k7_bwd_jax,
                               lambda a: _k7_bwd_plain(a, torch.float32),
                               lambda a: (a[5][:, None, :, None], None, None),
                               lambda a: _k7_bwd_plain(a, torch.bfloat16)),)

    def __init__(self, kernels=KERNELS, backward=()):
        self.kernels, self.backward = kernels, backward

    def __enter__(self):
        self.real, self.calls, self.bwd_share = {}, {}, {}
        self.share = {name: torch.zeros((), device=DEVICE) for _, name, *_ in self.kernels}
        for mod, name, rows, *own in self.kernels:
            real = getattr(mod, name)
            plain = own[0] if own else getattr(mod, f"{name}_reference")
            self.real[name], self.calls[name] = real, 0

            def shadow(*args, _real=real, _plain=plain, _name=name, _rows=rows, **kwargs):
                got = _real(*args, **kwargs)
                with torch.no_grad():  # a training forward's plain twin builds no graph
                    want = _plain(*args, **kwargs).float()
                    f32 = next(a for a in args
                               if isinstance(a, torch.Tensor)).dtype == torch.float32
                    err = (got.detach().float() - want).abs() / (
                        F32_TOL if f32 else BF16_TOL + 1e-2 * want.abs())
                    keep = None if _rows is None else _rows(args, kwargs)
                    if keep is not None:
                        err = torch.where(keep > 0, err, 0.0)
                    torch.maximum(self.share[_name], err.max(), out=self.share[_name])
                self.calls[_name] += 1
                return got
            setattr(mod, name, shadow)
        self.readings = {}
        for mod, name, plain, exact, rows, also in self.backward:
            real = mod.launch_bwd
            self.real[name], self.calls[name], self.bwd_share[name] = real, 0, 0.0

            def shadow_bwd(*args, _real=real, _plain=plain, _exact=exact, _name=name, _rows=rows,
                           _also=also, **kwargs):
                got = _real(*args, **kwargs)
                if got[0].dtype != torch.bfloat16:
                    raise TypeError(f"{_name}: the backward shadow holds bf16 gradients, got "
                                    f"{got[0].dtype}")
                with torch.no_grad():
                    want, x32 = _plain(args), _exact(args)
                    other = _also(args) if _also is not None else None
                    for i, keep in enumerate(_rows(args)):
                        g, p, x = got[i], want[i], x32[i]
                        o = None if other is None else other[i]
                        if keep is not None:
                            g, p, x, o = (None if t is None else torch.where(keep > 0, t.float(), 0.0)
                                          for t in (g, p, x, o))
                        self.bwd_share[_name] = max(self.bwd_share[_name], bf16_grad_ratio(g, p, x))
                        if o is not None:
                            r = self.readings.setdefault(_name, [0.0, 0.0])
                            r[0] = max(r[0], bf16_grad_ratio(g, o, x))
                            r[1] = max(r[1], bf16_grad_ratio(p, o, x))
                self.calls[_name] += 1
                return got
            mod.launch_bwd = shadow_bwd
        return self

    def __exit__(self, *exc):
        for mod, name, *_ in self.kernels:
            setattr(mod, name, self.real[name])
        for mod, name, *_ in self.backward:
            mod.launch_bwd = self.real[name]

    def shares(self) -> dict:
        return {**{name: float(x) for name, x in self.share.items()}, **self.bwd_share}


def _beam_arms(params, cfg, prompts: list, kw: dict, card: str) -> tuple:
    """``beam_search_batch`` with the decode kernels off, then with K2, K3
    and K4 on, each from launch counts of 0: K5 must launch n_layer times
    in the prefill, and K2-K4 n_layer times a step in the second run
    only. Returns the arms, {arm: best hypotheses}, {arm: (each
    expansion's picks [S, B, W], the smallest gap between adjacent ones
    of its W+1 best candidate scores [S, B])} and the second run's
    launch counts."""
    arms = {"kernels off": (cfg, ()),
            "K2+K3+K4 on": (cfg.replace(decode_fused_mlp=True),
                            ("ERGM_DECODE_KERNEL", "ERGM_CROSS_KERNEL"))}
    results, decisions = {}, {}
    real_top_k = beam._top_k
    for name, (c, names) in arms.items():
        picks, gaps = [], []

        def top_k(x, k):  # beam._top_k, keeping what it picked and by what gap
            vals, idx = real_top_k(x, k)
            best = torch.topk(x, k + 1, dim=-1).values
            picks.append(idx)
            gaps.append((best[:, :k] - best[:, 1:]).min(dim=-1).values)
            return vals, idx

        beam._top_k = top_k
        try:
            with switches(*names), StepCounter() as steps:
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.time()
                res, emo = beam.beam_search_batch(params, c, prompts, **kw)
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = _launch_counts()
        finally:
            beam._top_k = real_top_k
        n = c.n_layer * steps.steps
        on = bool(names)
        want = {"block_mha": c.n_layer, "decode_mha_int8": n if on else 0,
                "fused_cross_decode": n if on else 0, "fused_ln_mlp": n if on else 0}
        if {k: got[k] for k in want} != want or steps.steps < 1:
            raise AssertionError(f"beam [{name}]: launches {got} over {steps.steps} steps, "
                                 f"want {want}")
        if (len(res) != BEAM_B or any(not 1 <= len(r) <= LONG_MAX - BEAM_PROMPT for r in res)
                or any(t < 0 or t >= c.vocab_size for r in res for t in r)
                or emo.shape != (BEAM_B, c.num_emotions) or not np.isfinite(emo).all()):
            raise AssertionError(f"beam [{name}]: bad output")
        results[name] = res
        decisions[name] = (torch.stack(picks).cpu().numpy(), torch.stack(gaps).cpu().numpy())
        print(f"beam [{name}] {c.dtype} B={BEAM_B}, W={BEAM_W}, {LONG_MAX} slots: {wall:.3f} s, "
              f"{steps.steps} steps, {sum(map(len, res))} best-hypothesis tokens, launches "
              f"{got} on {card}")
    return arms, results, decisions, got


def _beam_agreement(label: str, results: dict, decisions: dict) -> int:
    """The margin rule for beams: each row's expansions must pick the same
    candidates in both arms, in the same order, up to its first expansion
    whose kernels-off scores put two of its W+1 best candidates within
    1e-3. A row is followed only up to its first differing expansion:
    after it the arms hold different hypotheses. Prints how far the arms
    agree; returns the number of rows whose picks differ before any such
    close call."""
    off, on = results["kernels off"], results["K2+K3+K4 on"]
    (p_off, g_off), (p_on, _) = decisions["kernels off"], decisions["K2+K3+K4 on"]
    to_end, close, broken = 0, [], []
    for b in range(BEAM_B):
        for s in range(g_off.shape[0]):
            if g_off[s, b] <= 1e-3:
                close.append(s)
                break
            if not np.array_equal(p_off[s, b], p_on[s, b]):
                broken.append((b, s, float(g_off[s, b])))
                break
        else:
            to_end += 1
    same = sum(a == b for a, b in zip(off, on))
    lead = sum(next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
               for a, b in zip(off, on))
    print(f"beam {label}: best hypotheses equal in {same} of {BEAM_B} rows, tokens equal before "
          f"the first difference {lead} of {sum(map(len, off))}; of {BEAM_B} rows, {to_end} "
          f"pick alike in all {g_off.shape[0]} expansions, {len(close)} reach a close call "
          f"(gap <= 1e-3) first (at expansions {close}), and {len(broken)} part where every "
          f"gap so far exceeded 1e-3 (row, expansion, gap there: {broken})")
    return len(broken)


def beam_phase(card: str) -> dict:
    """Beam search over a long history (the serving configuration, int8
    KV and cross caches and int8 lm_head): 16 ragged prompts bucketed to
    384 tokens, 4 beams, 128 new tokens in 512 slots, with the decode
    kernels off and with K2, K3 and K4 on (``_beam_arms``), in fp32 and
    in bf16. The margin rule (``_beam_agreement``) is asserted in fp32;
    in bf16, where the kernels' rounding moves candidate scores by more
    than 1e-3, the agreement is printed, and a third run with the kernels
    on holds every launch of K2, K3 and K4 against its plain version
    within the bf16 bar (``KernelShadow``). Then the device time of one
    bf16 beam step each way (torch.profiler over 8 steps) and the time of
    its cache reorder. Returns the bf16 kernels-on launch counts."""
    rng = np.random.default_rng(3)
    lens = [BEAM_PROMPT] + rng.integers(200, BEAM_PROMPT + 1, BEAM_B - 1).tolist()
    prompts = [rng.integers(0, 50000, n).tolist() for n in lens]
    kw = dict(num_beams=BEAM_W, max_len=LONG_MAX, eos_id=EOS, sp2_id=SP2,
              token_types=[rng.integers(0, 50000, n).tolist() for n in lens],
              captions=[None if i % 4 == 3 else rng.integers(0, 50000, CAPTION).tolist()
                        for i in range(BEAM_B)],
              imgs=rng.standard_normal((BEAM_B, 768)).astype(np.float32),
              auds=rng.standard_normal((BEAM_B, 768)).astype(np.float32),
              max_new_tokens=LONG_MAX - BEAM_PROMPT, prompt_bucket=128)
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig.from_model_type(**{**SLICE, "dtype": dtype, "n_layer": SLICE_LAYERS})
        params = gpt2.params_for_inference(
            gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
        arms, results, decisions, counts = _beam_arms(params, cfg, prompts, kw, card)
        if _beam_agreement(dtype, results, decisions) and dtype == "float32":
            raise AssertionError("beam fp32: the arms pick differently where the margin rule "
                                 "says they must not")
        if dtype == "bfloat16":
            # once more with the kernels on, every launch of K2, K3 and K4
            # held against its plain version at the path's shapes and data
            c, names = arms["K2+K3+K4 on"]
            with switches(*names), KernelShadow() as shadow, StepCounter() as steps:
                beam.beam_search_batch(params, c, prompts, **kw)
            shares = shadow.shares()
            print(f"beam bf16 [K2+K3+K4 on]: every launch against its plain version on the same "
                  f"inputs ({shadow.calls} launches over {steps.steps} steps); the largest "
                  f"|kernel - plain| as a share of the bar 2e-2 + 1e-2 |plain|: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
            if (any(v > 1.0 or not math.isfinite(v) for v in shares.values())
                    or set(shadow.calls.values()) != {c.n_layer * steps.steps}):
                raise AssertionError(f"beam bf16: a kernel leaves its plain version's bar or "
                                     f"was not held on every step: {shares}, {shadow.calls}")
        if dtype == "float32":
            del params
            torch.cuda.empty_cache()
    beam_step_phase(params, arms, prompts, kw, card)
    return counts


def beam_step_phase(params, arms: dict, prompts: list, kw: dict, card: str,
                    steps: int = 8) -> None:
    """The device time of one beam step under each arm (torch.profiler
    over ``steps`` steps after two warm-up steps) beside the host's wall
    time a step, and the device time of the step's cache reorder (the
    generated slots of every self-attention field) by CUDA events, with
    the reorder of the whole cache as JAX does it beside it."""
    ids, mask, tts, cap_ids, cap_mask, buffer_len = pack_ragged_batch(
        prompts, eos_id=EOS, sp2_id=SP2,
        n_positions=1024, max_len=LONG_MAX, token_types=kw["token_types"],
        captions=kw["captions"], prompt_bucket=128, max_new_tokens=kw["max_new_tokens"])
    dev = lambda x: torch.as_tensor(x, device=DEVICE)  # noqa: E731
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, (cfg, names) in arms.items():
        with switches(*names):
            s, rows = beam.beam_start(
                params, cfg, dev(ids).long(), prompt_mask=dev(mask), num_beams=BEAM_W,
                max_len=buffer_len, eos_id=EOS, token_type_ids=dev(tts).long(),
                imgs=dev(kw["imgs"]), auds=dev(kw["auds"]), caption_ids=dev(cap_ids).long(),
                caption_mask=dev(cap_mask), logical_cap=LONG_MAX)
            for _ in range(2):
                s = beam.beam_step(params, cfg, s, rows, SP2)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(steps):
                    s = beam.beam_step(params, cfg, s, rows, SP2)
                torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(steps):
                s = beam.beam_step(params, cfg, s, rows, SP2)
            torch.cuda.synchronize()
            wall = (time.time() - t0) / steps
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
        kernels = sum(e.count for e in device) / steps
        if ms <= 0:
            raise AssertionError(f"beam step [{name}]: no device time in the trace")
        flat = torch.randperm(BEAM_B * BEAM_W, device=DEVICE)
        lo = rows.Lp
        with torch.inference_mode():
            # the reorder after 16, 64 and 127 generated slots (the first,
            # middle and last steps), and of the whole cache
            reorder = {n: _median_ms(lambda: beam._gather_beams(s.cache, flat, lo, lo + n))
                       for n in (16, 64, buffer_len - lo - 1)}
            whole_ms = _median_ms(lambda: [getattr(s.cache, f).index_select(1, flat)
                                           for f in beam._SELF_FIELDS])
        print(f"beam step [{name}] B*W={BEAM_B * BEAM_W}, {buffer_len} slots: device time "
              f"{ms:.3f} ms, {kernels:.0f} device operations, host wall {1e3 * wall:.3f} ms a "
              f"step (torch.profiler over {steps} steps; wall unprofiled); the reorder of "
              + ", ".join(f"{n} generated slots {t:.4f} ms ({100 * t / ms:.1f}% of the step)"
                          for n, t in reorder.items())
              + f", of the whole cache {whole_ms:.4f} ms; on {card}")
    del s
    torch.cuda.empty_cache()


def _server_traffic(rng, n: int = SRV_REQS, long_every: int = 0) -> list:
    """``scripts/server_bench.py``'s offline traffic: ``n`` greedy requests
    (Request keyword dicts), prompts of 16-128 tokens, budgets of 16-128
    new tokens, a 32-token caption on 3 of 4, image and audio features on
    each; with ``long_every``, every long_every-th prompt has 384 tokens."""
    out = []
    for i in range(n):
        plen = (SRV_LONG_PROMPT if long_every and i % long_every == long_every - 1
                else int(rng.integers(16, SRV_PROMPT + 1)))
        out.append(dict(prompt_ids=rng.integers(0, 50000, plen).tolist(),
                        max_new_tokens=int(rng.integers(16, SRV_NEW + 1)), greedy=True,
                        caption_ids=(None if i % 4 == 3
                                     else rng.integers(0, 50000, CAPTION).tolist()),
                        img=rng.standard_normal(768).astype(np.float32),
                        aud=rng.standard_normal(768).astype(np.float32)))
    return out


def _server(params, cfg, **kw) -> ContinuousServer:
    base = dict(slots=SRV_SLOTS, eos_id=EOS, sp2_id=SP2, max_prompt=SRV_PROMPT, prompt_bucket=64,
                cache_len=SRV_CACHE, caption_len=CAPTION, sync_every=SRV_SYNC,
                cache_grow_step=SRV_GROW)
    return ContinuousServer(params, cfg, **{**base, **kw})


class _Groups(list):
    """Admission groups as (prompt bucket, whether a request carries a
    caption); ``live``: groups that joined while another row decoded;
    ``fed``: prompt tokens through the groups, ``ext_fed``: delta tokens
    through extension programs; ``rids``: the requests admitted through
    groups; ``inner``: kernel launches inside extension programs and
    speculative blocks (verify windows)."""
    live = fed = ext_fed = 0


@contextlib.contextmanager
def _no_sync_in_dispatch(srv: ContinuousServer):
    """Runs every block dispatch and every extension program of ``srv``
    under ``torch.cuda.set_sync_debug_mode("error")`` (a host read of a
    device value there raises) and records its admissions in the
    ``_Groups`` it yields."""
    groups = _Groups()
    groups.rids, groups.inner = set(), {}
    real = {n: getattr(srv, n) for n in ("_dispatch_block", "_admit_group", "_admit_ext_group",
                                         "_extend", "_spec_decode")}

    def no_sync(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    def counted(fn):
        def run(*args, **kwargs):
            before = _launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                for k, n in _launch_counts().items():
                    groups.inner[k] = groups.inner.get(k, 0) + n - before[k]
        return run

    def recorded(entries, pb, g=0):
        groups.append((pb, any(e[2].caption_ids for e in entries)))
        groups.live += any(s.active for s in srv.slots)
        groups.fed += sum(len(e[2].prompt_ids) for e in entries)
        groups.rids.update(e[1] for e in entries)
        return real["_admit_group"](entries, pb, g)

    def ext_recorded(entries, pbd, g=0):
        groups.ext_fed += sum(len(e["ids"]) for e in entries)
        return real["_admit_ext_group"](entries, pbd, g)

    srv._dispatch_block, srv._admit_group = no_sync(real["_dispatch_block"]), recorded
    srv._admit_ext_group = ext_recorded
    srv._extend = no_sync(counted(real["_extend"]))
    srv._spec_decode = counted(real["_spec_decode"])
    try:
        yield groups
    finally:
        for n in real:
            delattr(srv, n)


def _serve(srv: ContinuousServer, traffic: list) -> dict:
    """All of ``traffic`` submitted at once, then drained, from a reset
    server and zeroed launch counts; checks that each request returns its
    budget of in-vocabulary tokens and finite emotion logits. Returns the
    run's readings."""
    srv.reset()
    with _no_sync_in_dispatch(srv) as groups, StepCounter() as steps:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        rids = [srv.submit(Request(**r)) for r in traffic]
        res = srv.run_until_drained(max_iters=100_000)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _launch_counts()
    V = srv.cfg.vocab_size
    for rid, r in zip(rids, traffic):
        got = res[rid]
        if (len(got.tokens) != r["max_new_tokens"] or any(t < 0 or t >= V for t in got.tokens)
                or not np.isfinite(got.emotion_logits).all()):
            raise AssertionError(f"server: request {rid} returned {len(got.tokens)} tokens for a "
                                 f"budget of {r['max_new_tokens']}, or bad values")
    tokens = sum(len(res[r].tokens) for r in rids)
    slot_steps = srv.S * sum(n * c for n, c in srv.block_len_hist.items())
    return dict(tokens=[res[r].tokens for r in rids], wall=wall, groups=groups,
                live_joins=groups.live,
                steps=steps.steps, counts=counts, new_tokens=tokens,
                slot_util=(tokens - len(rids)) / max(slot_steps, 1),
                hist=dict(sorted(srv.block_len_hist.items())), grows=srv.grows,
                shrinks=srv.shrinks, phases={k: round(v, 3) for k, v in
                                             sorted(srv.phase_seconds.items())},
                blocks=srv.server_step)


def _server_counts_ok(label: str, cfg, run: dict) -> None:
    """K1 self n_layer times for each admission group at a prompt bucket
    <= 128, K1 cross for each of those carrying a caption, K5 for each at
    384, K4 n_layer times a decode step with ``decode_fused_mlp``."""
    L, got = cfg.n_layer, run["counts"]
    short = [cap for pb, cap in run["groups"] if pb <= 128]
    want = {"prefill_mha": L * len(short), "prefill_mha_cross": L * sum(short),
            "block_mha": L * sum(pb == SRV_LONG_PROMPT for pb, _ in run["groups"]),
            "fused_ln_mlp": L * run["steps"] if cfg.decode_fused_mlp else 0}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"server [{label}]: launches {got} over {len(run['groups'])} "
                             f"admission groups and {run['steps']} decode steps, want {want}")


def _block_profile(srv: ContinuousServer, traffic: list) -> tuple:
    """One steady decode block (after one, the queue still full): the host
    wall time of its dispatch and harvest, then the device time and device
    operations of the next one by torch.profiler; admissions before each
    block are not counted."""
    srv.reset()
    for r in traffic:
        srv.submit(Request(**r))
    srv.step()
    # device activity only: a host trace of a block's ~40,000 operations
    # takes the profiler tens of seconds to process
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():  # the server's device state is inference tensors
        def block():
            n = srv._pick_block_len()
            srv._harvest(srv._dispatch_block())
            torch.cuda.synchronize()
            return n

        srv._admit()
        srv._fit_capacity()
        torch.cuda.synchronize()
        t0 = time.time()
        block()
        wall = time.time() - t0
        srv._admit()
        srv._fit_capacity()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            n = block()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(e.self_device_time_total for e in device) / 1e3
    ops = sum(e.count for e in device)
    if ms <= 0:
        raise AssertionError("server block: no device time in the trace")
    srv.reset()
    return n, wall, ms, ops


def _generate_request(params, cfg, r: dict) -> tuple:
    """One request (Request keywords) through ``generate`` alone, as the
    server sees it: sp2 token types, the caption padded to CAPTION with its
    mask. Returns its greedy tokens and the ``LogitRecorder`` of the run."""
    ids = torch.tensor([r["prompt_ids"]], device=DEVICE)
    Lp, n = ids.shape[1], r["max_new_tokens"]
    cap = cap_mask = None
    if r.get("caption_ids") is not None:
        cap = torch.full((1, CAPTION), EOS, device=DEVICE)
        cap[0, :len(r["caption_ids"])] = torch.tensor(r["caption_ids"])
        cap_mask = torch.zeros((1, CAPTION), device=DEVICE)
        cap_mask[0, :len(r["caption_ids"])] = 1.0
    feats = {k + "s": torch.as_tensor(r[k][None], device=DEVICE)
             for k in ("img", "aud") if r.get(k) is not None}
    with LogitRecorder(cfg.n_layer) as rec:
        out = generate(params, cfg, ids, Lp, max_len=Lp + n, eos_id=EOS, sp2_id=SP2, greedy=True,
                       token_type_ids=torch.full_like(ids, SP2), caption_ids=cap,
                       caption_mask=cap_mask, **feats)
    return out.tokens[0, Lp:int(out.lengths[0])].tolist(), rec


def _server_identity(card: str, bf16_params, bf16_cfg) -> None:
    """SRV_IDENTITY requests (budgets cut to SRV_IDENTITY_NEW and
    staggered) through SRV_IDENTITY_SLOTS slots of the server, where some
    must join freed slots while other rows decode, and, one at a time,
    through ``generate`` with the same inputs
    (sp2 token types, the caption padded to 32 with its mask), on the
    compute-dtype and the int8 staged cache in fp32 (TF32 off), where the
    tokens must be equal up to each row's first step where ``generate``'s
    top-2 logit margin is 1e-3 or less, and on the bf16 cache, where the
    agreement is printed."""
    traffic = [dict(r, max_new_tokens=min(r["max_new_tokens"],
                                          SRV_IDENTITY_NEW - 3 * (i % SRV_IDENTITY_SLOTS)))
               for i, r in enumerate(_server_traffic(np.random.default_rng(0), SRV_IDENTITY))]
    for dtype in ("float32", "bfloat16"):
        if dtype == "float32":
            cfg = ModelConfig.from_model_type(**{**SRV_SLICE, "dtype": dtype})
            params = gpt2.params_for_inference(
                gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
        else:
            cfg, params = bf16_cfg, bf16_params
        for kv in ("auto", "int8") if dtype == "float32" else ("auto",):
            c = cfg.replace(kv_cache_dtype=kv)
            run = _serve(_server(params, c, slots=SRV_IDENTITY_SLOTS,
                                 sync_every=SRV_IDENTITY_SYNC), traffic)
            served = run["tokens"]
            if run["live_joins"] < 1:
                raise AssertionError(f"server identity [{kv}]: no admission group joined while "
                                     f"other rows decoded ({len(run['groups'])} groups)")
            equal, broken, lead = 0, [], 0
            for i, r in enumerate(traffic):
                Lp = len(r["prompt_ids"])
                want, rec = _generate_request(params, c, r)
                got = served[i]
                close = next((j for j in range(len(want))
                              if _top2_margin(rec.at[Lp + j]) <= 1e-3), len(want))
                diff = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
                            None if len(want) == len(got) else min(len(want), len(got)))
                equal += diff is None
                lead += len(want) if diff is None else diff
                if diff is not None and diff < close:
                    broken.append((i, diff, _top2_margin(rec.at[Lp + diff])))
            print(f"server identity {dtype} [{kv} cache]: {len(run['groups'])} admission groups "
                  f"through {SRV_IDENTITY_SLOTS} slots, {run['live_joins']} joined while other "
                  f"rows decoded; {equal} of {len(traffic)} requests equal to generate's, {lead} of {sum(len(s) for s in served)} tokens before "
                  f"the first difference; {len(broken)} rows part before a close call "
                  f"(margin <= 1e-3): {broken} on {card}")
            if dtype == "float32" and broken:
                raise AssertionError(f"server fp32 [{kv}]: tokens leave generate's where the "
                                     f"margin rule says they must not: {broken}")
        if dtype == "float32":
            del params
            torch.cuda.empty_cache()


def server_phase(card: str) -> dict:
    """The continuous-batching server at gpt2 full width (bf16, int8
    lm_head): ``_server_traffic``'s 256 requests through 64 slots, after
    one warm-up run, on five arms in turns: the bf16 cache (fifo), the
    same with ``decode_fused_mlp`` (K4), the int8 staged cache, sorted
    admission, and tiers (8 long slots, ``kv_cache_dtype="auto"``: the
    long pool int8 staged; every 8th prompt 384 tokens, which takes K5);
    each with its launch counts checked (``_server_counts_ok``) and every
    block dispatched without a host sync. Then one block's device time
    on arms 1, 3 and 5, ``KernelShadow`` over arms 2 and 5, the fp32 identity with
    ``generate`` (``_server_identity``), and the static reading:
    ``generate_batch`` over arrival-order batches of 64. Returns
    {kernel: {arm: launches}}."""
    cfg = ModelConfig.from_model_type(**SRV_SLICE)
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
    k4 = cfg.replace(decode_fused_mlp=True)
    base = _server_traffic(np.random.default_rng(0))
    tiered = _server_traffic(np.random.default_rng(0), long_every=8)
    arms = {"bf16 fifo": (cfg, {}, base), "K4": (k4, {}, base),
            "int8 staged": (k4.replace(kv_cache_dtype="int8"), {}, base),
            "sorted": (k4, dict(admit_policy="sorted"), base),
            "tiers": (k4, dict(long_slots=SRV_LONG_SLOTS, max_prompt=SRV_LONG_PROMPT,
                               cache_len=SRV_LONG_CACHE), tiered)}
    servers = {name: _server(params, c, **kw) for name, (c, kw, _) in arms.items()}
    t0 = time.time()
    _serve(servers["bf16 fifo"], base[:SRV_SLOTS])
    print(f"server: warm-up run ({SRV_SLOTS} requests) {time.time() - t0:.2f} s")
    t_phase = time.time()
    runs = {}
    for name, (c, kw, traffic) in arms.items():
        run = runs[name] = _serve(servers[name], traffic)
        _server_counts_ok(name, c, run)
        n = len(traffic)
        print(f"server [{name}] {n} requests, {SRV_SLOTS} slots: {run['wall']:.3f} s, "
              f"{n / run['wall']:.2f} utt/s, {run['new_tokens'] / run['wall']:.0f} generated "
              f"tok/s ({run['new_tokens']} tokens, {run['blocks']} blocks, {run['steps']} "
              f"forward steps), slot utilisation {run['slot_util']:.3f}, block lengths "
              f"{run['hist']}, grows {run['grows']}, shrinks {run['shrinks']}, phases "
              f"{run['phases']}, launches {run['counts']}, {len(run['groups'])} admission "
              f"groups {run['groups']} on {card}")
    for a, b in (("int8 staged", "K4"), ("sorted", "K4"), ("K4", "bf16 fifo")):
        same = sum(x == y for x, y in zip(runs[a]["tokens"], runs[b]["tokens"]))
        print(f"server: [{a}] gives [{b}]'s tokens on {same} of {len(base)} requests")
    t_arms = time.time()
    # one block each of the arms whose decode step differs in its cache:
    # sorted runs K4's step (the decode phase reads K4's effect on a step)
    for name in ("bf16 fifo", "int8 staged", "tiers"):
        n, wall, ms, ops = _block_profile(servers[name], arms[name][2])
        print(f"server block [{name}]: {n} steps over {SRV_SLOTS} slots, device time {ms:.3f} "
              f"ms ({ms / n:.3f} ms a step), {ops} device operations, host wall {1e3 * wall:.3f} "
              f"ms unprofiled (torch.profiler for the device) on {card}")

    t_profile = time.time()
    for name in ("K4", "tiers"):
        c, kw, traffic = arms[name]
        with KernelShadow(KernelShadow.SERVER) as shadow:
            run = _serve(servers[name], traffic)
        shares = shadow.shares()
        print(f"server [{name}] bf16: every K1, K5 and K4 launch against its plain version on "
              f"the same inputs ({shadow.calls} launches); the largest |kernel - plain| as a "
              f"share of the bar 2e-2 + 1e-2 |plain|: "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
        short = [cap for pb, cap in run["groups"] if pb <= 128]
        want = {"prefill_mha": c.n_layer * (len(short) + sum(short)),
                "block_mha": c.n_layer * (len(run["groups"]) - len(short)),
                "fused_ln_mlp": c.n_layer * run["steps"]}
        if any(v > 1.0 or not math.isfinite(v) for v in shares.values()) or shadow.calls != want:
            raise AssertionError(f"server [{name}]: a kernel leaves its plain version's bar or "
                                 f"was not held at every launch: {shares}, {shadow.calls}, "
                                 f"want {want}")
    for srv in servers.values():
        srv.reset()
    del servers
    torch.cuda.empty_cache()
    t_shadow = time.time()
    _server_identity(card, params, cfg)
    t_identity = time.time()

    # the static reading: arrival-order batches of 64, every batch decoding
    # 128 new tokens (server_bench.py's static arm)
    for i, batch in enumerate([base[:SRV_SLOTS]] + [base[j:j + SRV_SLOTS]
                                                      for j in range(0, len(base), SRV_SLOTS)]):
        if i == 1:
            torch.cuda.synchronize()
            t0, useful = time.time(), 0
        outs, _ = generate_batch(
            params, cfg, [r["prompt_ids"] for r in batch], max_len=SRV_PROMPT + SRV_NEW,
            eos_id=EOS, sp2_id=SP2, imgs=np.stack([r["img"] for r in batch]),
            auds=np.stack([r["aud"] for r in batch]),
            captions=[r["caption_ids"] for r in batch], greedy=True, max_new_tokens=SRV_NEW)
        if i:
            useful += sum(min(len(o), r["max_new_tokens"]) for o, r in zip(outs, batch))
    torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"server static reading: generate_batch over {len(base) // SRV_SLOTS} arrival-order "
          f"batches of {SRV_SLOTS} (after one warm-up batch): {wall:.3f} s, "
          f"{len(base) / wall:.2f} utt/s, {useful / wall:.0f} useful tok/s on {card}")
    print(f"server phase wall s: arms {t_arms - t_phase:.1f}, block profiles "
          f"{t_profile - t_arms:.1f}, shadow runs {t_shadow - t_profile:.1f}, identity "
          f"{t_identity - t_shadow:.1f}, static {time.time() - t_identity:.1f}")
    return {k: {name: run["counts"][k] for name, run in runs.items()}
            for k in ("prefill_mha", "prefill_mha_cross", "block_mha", "fused_ln_mlp")}


def _conversations(rng, n: int) -> list:
    """``n`` conversations: turn 1's prompt (48-96 tokens), the new tokens
    of each later turn (16-48), each turn's budget (16-48 new tokens,
    greedy), and ``_server_traffic``'s caption (on 3 of 4), image and
    audio features, which ride turn 1 (and every turn of a re-prefill)."""
    out = []
    for i in range(n):
        out.append(dict(first=rng.integers(0, 50000, int(rng.integers(48, 97))).tolist(),
                        news=[rng.integers(0, 50000, int(rng.integers(16, 49))).tolist()
                              for _ in range(SRV_TURNS - 1)],
                        budgets=[int(rng.integers(16, 49)) for _ in range(SRV_TURNS)],
                        caption_ids=(None if i % 4 == 3
                                     else rng.integers(0, 50000, CAPTION).tolist()),
                        img=rng.standard_normal(768).astype(np.float32),
                        aud=rng.standard_normal(768).astype(np.float32)))
    return out


def _converse(srv: ContinuousServer, convs: list, sessions: bool, turns: int = SRV_TURNS) -> dict:
    """Each conversation's turns through ``srv`` from a reset and zeroed
    launch counts: turn 1 of every conversation submitted at once, each
    next turn (the last prompt, its reply and the turn's new tokens) when
    the last result arrives, with the conversation's ``session_id`` when
    ``sessions``, else re-prefilled whole. Every turn must return its
    budget of in-vocabulary tokens. Returns the run's readings."""
    srv.reset()
    state, tokens, reqs = {}, {}, {}

    def submit(ci, t, prompt):
        c = convs[ci]
        r = dict(prompt_ids=prompt, max_new_tokens=c["budgets"][t], greedy=True,
                 caption_ids=c["caption_ids"], img=c["img"], aud=c["aud"],
                 session_id=f"conv{ci}" if sessions else None)
        rid = srv.submit(Request(**r))
        state[rid], reqs[(ci, t)] = (ci, t), r

    with _no_sync_in_dispatch(srv) as groups, StepCounter() as steps:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        for ci, c in enumerate(convs):
            submit(ci, 0, c["first"])
        while srv.busy():
            for res in srv.step():
                ci, t = state[res.request_id]
                tokens[(ci, t)] = res.tokens
                if t + 1 < turns:
                    submit(ci, t + 1, reqs[(ci, t)]["prompt_ids"] + res.tokens
                           + convs[ci]["news"][t])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = _launch_counts()
    V = srv.cfg.vocab_size
    for key, r in reqs.items():
        got = tokens[key]
        if len(got) != r["max_new_tokens"] or any(x < 0 or x >= V for x in got):
            raise AssertionError(f"server conversation {key}: {len(got)} tokens for a budget of "
                                 f"{r['max_new_tokens']}, or bad values")
    later = {rid for rid, (_ci, t) in state.items() if t > 0}
    return dict(tokens=tokens, reqs=reqs, wall=wall, groups=groups, steps=steps.steps,
                counts=counts, fed=groups.fed + groups.ext_fed, ext=srv.ext_programs,
                fallbacks=len(later & groups.rids) if sessions else 0, evictions=srv.evictions,
                blocks=srv.server_step,
                phases={k: round(v, 3) for k, v in sorted(srv.phase_seconds.items())})


def _k1_launches(cfg, groups) -> dict:
    """K1's launches for admission groups (prompt bucket, caption): the self
    form n_layer times for each group at a bucket <= 128 (the model's K1
    gate), the cross form for each group carrying a caption (K1's gate
    takes up to 512 queries)."""
    return {"prefill_mha": cfg.n_layer * sum(pb <= 128 for pb, _ in groups),
            "prefill_mha_cross": cfg.n_layer * sum(cap and pb <= 512 for pb, cap in groups)}


def _ext_profile(srv: ContinuousServer, convs: list) -> tuple:
    """Extension programs: every slot of ``srv`` holds a parked turn 1; the
    second turns of half of them are admitted (one extension program over
    the pool for each delta bucket) and timed on the host, then the other
    half's under torch.profiler. Returns (rows extended, programs of the
    profiled pass, host wall s, device ms, device operations)."""
    run = _converse(srv, convs[:srv.S], True, turns=1)
    half = srv.S // 2

    def submit(cis):
        for ci in cis:
            r = run["reqs"][(ci, 0)]
            srv.submit(Request(**dict(r, max_new_tokens=convs[ci]["budgets"][1],
                                      prompt_ids=r["prompt_ids"] + run["tokens"][(ci, 0)]
                                      + convs[ci]["news"][0])))

    with torch.inference_mode():
        submit(range(half))
        torch.cuda.synchronize()
        t0 = time.time()
        srv._admit()
        torch.cuda.synchronize()
        wall = time.time() - t0
        submit(range(half, srv.S))
        ext = srv.ext_programs
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            srv._admit()
            torch.cuda.synchronize()
    programs = srv.ext_programs - ext
    if programs < 1:
        raise AssertionError("extension profile: the admission ran no extension program")
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    srv.reset()
    return (srv.S - half, programs, wall, sum(e.self_device_time_total for e in device) / 1e3,
            sum(e.count for e in device))


def _ext_counts_ok(label: str, cfg, run: dict) -> None:
    """K1 as ``_k1_launches`` says for each admission group (a first chunk
    among them), K5 n_layer times for each group at a bucket over 128, K4
    n_layer times a single-token decode step with ``decode_fused_mlp``, and
    no launch of K1, K4 or K5 inside an extension program or a verify
    window."""
    L, got, groups = cfg.n_layer, run["counts"], run["groups"]
    want = {**_k1_launches(cfg, groups), "block_mha": L * sum(pb > 128 for pb, _ in groups),
            "fused_ln_mlp": L * run["steps"] if cfg.decode_fused_mlp else 0}
    inner = {k: v for k, v in groups.inner.items() if v}
    if {k: got[k] for k in want} != want or inner:
        raise AssertionError(f"server [{label}]: launches {got} over {len(groups)} admission "
                             f"groups and {run['steps']} decode steps, want {want}; inside "
                             f"extensions and verify windows {inner}, want none")


def _long_arrivals(srv: ContinuousServer, shorts: list, longs: list) -> dict:
    """``shorts`` submitted at once, then one of ``longs`` after each
    server step, from a reset and zeroed counts; the wall time of every
    step (its admissions, chunks and block) while a long prompt is queued
    or being admitted. Every request must return its budget."""
    srv.reset()
    long_rids, walls = set(), []
    with _no_sync_in_dispatch(srv) as groups, StepCounter() as steps:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        rids = [srv.submit(Request(**r)) for r in shorts]
        results, pending = {}, list(longs)
        while srv.busy() or pending:
            if pending:
                rid = srv.submit(Request(**pending.pop(0)))
                rids.append(rid)
                long_rids.add(rid)
            admitting = bool(srv._chunks) or any(q[0] in long_rids for q in srv.queue)
            t1 = time.time()
            results.update({r.request_id: r for r in srv.step()})
            torch.cuda.synchronize()
            if admitting or srv._chunks:
                walls.append(time.time() - t1)
        wall = time.time() - t0
        counts = _launch_counts()
    for rid, r in zip(rids, shorts + longs):
        if len(results[rid].tokens) != r["max_new_tokens"]:
            raise AssertionError(f"server long arrivals: request {rid} returned "
                                 f"{len(results[rid].tokens)} tokens of {r['max_new_tokens']}")
    return dict(wall=wall, walls=walls, groups=groups, steps=steps.steps, counts=counts,
                ext=srv.ext_programs, tokens=[results[r].tokens for r in rids],
                phases={k: round(v, 3) for k, v in sorted(srv.phase_seconds.items())})


def _identity(label: str, reqs: list, got: list, want: list, params, cfg, card: str) -> None:
    """Prints how many of ``reqs`` (Request keywords) gave ``want``'s tokens
    in ``got``; a row that differs is looked up in ``generate``'s logits at
    its first difference, and the phase fails unless the top-2 margin
    there is 1e-3 or less (a close call, printed)."""
    equal, close, broken = 0, [], []
    for i, (r, a, b) in enumerate(zip(reqs, got, want)):
        if a == b:
            equal += 1
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        _, rec = _generate_request(params, cfg, dict(r, max_new_tokens=j + 1))
        margin = _top2_margin(rec.at[len(r["prompt_ids"]) + j])
        (close if margin <= 1e-3 else broken).append((i, j, margin))
    print(f"server identity fp32 [{label}]: {equal} of {len(reqs)} requests equal; close calls "
          f"(margin <= 1e-3) {close} on {card}")
    if broken:
        raise AssertionError(f"server identity [{label}]: rows part where the margin is wide: "
                             f"{broken}")


class _ByteTokenizer:
    """Decodes one token a byte (byte-level BPE's worst case for the front
    end's UTF-8-safe text deltas); no encoding is needed: requests carry
    ids."""

    def decode(self, ids):
        return bytes(t % 256 for t in ids).decode("utf-8", errors="replace")


def _http_post(fe, payload: dict):
    req = urllib.request.Request(f"http://{fe.host}:{fe.port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if not payload.get("stream"):
            return json.loads(r.read())["tokens"]
        rows = [json.loads(line) for line in r]
    if not rows[-1].get("done") or any("error" in row for row in rows):
        raise AssertionError(f"HTTP stream ended badly: {rows[-1]}")
    return [t for row in rows[:-1] for t in row["tokens"]]


def _http_health(fe) -> dict:
    with urllib.request.urlopen(f"http://{fe.host}:{fe.port}/health", timeout=60) as r:
        return json.loads(r.read())


def _http_arm(params, cfg, traffic: list, card: str) -> tuple:
    """``ServerFrontend`` on 127.0.0.1 at an ephemeral port over a
    SRV_HTTP_SLOTS-slot server: the requests of ``traffic`` as concurrent
    ``POST /generate`` (every second one streamed), one two-turn session
    (the second turn through an extension), ``GET /health``, and a
    streamed client that disconnects after its first byte, whose request
    must be cancelled and its slot freed. Returns the payloads and their
    tokens."""
    srv = _server(params, cfg, slots=SRV_HTTP_SLOTS, sync_every=SRV_IDENTITY_SYNC)
    fe = ServerFrontend(srv, tokenizer=_ByteTokenizer(), port=0).start()
    try:
        payloads = [{"prompt": r["prompt_ids"], "max_new_tokens": r["max_new_tokens"],
                     "greedy": True, "caption_ids": r["caption_ids"], "stream": i % 2 == 1}
                    for i, r in enumerate(traffic)]
        got = [None] * len(payloads)

        def worker(i):
            got[i] = _http_post(fe, payloads[i])

        t0 = time.time()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.time() - t0
        if any(g is None for g in got):
            raise AssertionError("HTTP: a request got no answer")
        turn1 = payloads[0]["prompt"][:40]
        reply = _http_post(fe, {"prompt": turn1, "max_new_tokens": 8, "greedy": True,
                                "session_id": "http"})
        ext = srv.ext_programs
        turn2 = turn1 + reply + payloads[1]["prompt"][:12]
        _http_post(fe, {"prompt": turn2, "max_new_tokens": 8, "greedy": True,
                        "session_id": "http", "stream": True})
        if srv.ext_programs != ext + 1:
            raise AssertionError("HTTP: the session's second turn did not extend its slot")
        body = json.dumps({"prompt": payloads[0]["prompt"], "max_new_tokens": 300,
                           "greedy": True, "stream": True}).encode()
        sock = socket.create_connection((fe.host, fe.port), timeout=60)
        sock.sendall(b"POST /generate HTTP/1.0\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        sock.recv(1)
        sock.close()
        deadline = time.time() + 120
        while time.time() < deadline:
            h = _http_health(fe)
            if h["cancelled"] == 1 and h["active"] == 0:
                break
            time.sleep(0.05)
        if h["cancelled"] != 1 or h["active"] != 0 or h["served"] != len(payloads) + 2:
            raise AssertionError(f"HTTP: the disconnected stream was not cancelled: {h}")
    finally:
        fe.close()
    print(f"server [HTTP] {len(payloads)} concurrent requests ({len(payloads) // 2} streamed) "
          f"through {SRV_HTTP_SLOTS} slots in {wall:.3f} s, a two-turn session extended, a "
          f"disconnected stream cancelled; health {h} on {card}")
    return srv, payloads, got


def server_ext_phase(card: str) -> dict:
    """The server's extension paths at gpt2 full width (SRV_SLICE: bf16,
    int8 lm_head, random weights from seed 0, captions, image and audio
    features, ``decode_fused_mlp``): SRV_CONVS three-turn conversations
    through SRV_CONV_SLOTS slots with sessions and re-prefilled whole
    (``max_prompt`` 384: buckets over 128 take K5); SRV_LONG_N prompts of
    SRV_CHUNK_PROMPT tokens arriving among SRV_CHUNK_SHORT short requests,
    whole and in SRV_CHUNK-token chunks (1024 slots), with each step's wall
    time while they are admitted; ``_server_traffic``'s first
    SRV_SPEC_REQS requests through speculative blocks (gamma SRV_GAMMA,
    n-gram SRV_NGRAM) and through plain blocks, and one speculative block's
    device time. Every arm's launch counts are checked (``_ext_counts_ok``)
    and every dispatch and extension program runs without a host sync;
    ``KernelShadow`` holds every K1, K5 and K4 launch of the re-prefill,
    chunked and speculative arms against its plain version. Then, in fp32 at full
    width: session turns against a fresh server's full prefill, chunked
    prompts against ``generate``, speculative against plain blocks, and the
    HTTP front end (``_http_arm``) against direct submission. Returns
    {kernel: {arm: launches}}."""
    cfg = ModelConfig.from_model_type(**SRV_SLICE)
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg), cfg)
    k4 = cfg.replace(decode_fused_mlp=True)
    runs, t_phase = {}, time.time()

    convs = _conversations(np.random.default_rng(1), SRV_CONVS)
    srv = _server(params, k4, slots=SRV_CONV_SLOTS, max_prompt=SRV_REPREFILL_MAX,
                  prompt_bucket=128)
    _converse(srv, convs[:8], True, turns=2)  # warm-up
    for name, sessions in (("sessions", True), ("re-prefill", False)):
        run = runs[name] = _converse(srv, convs, sessions)
        _ext_counts_ok(name, k4, run)
        n = len(run["reqs"])
        print(f"server [{name}] {SRV_CONVS} conversations x {SRV_TURNS} turns, {SRV_CONV_SLOTS} "
              f"slots: {run['wall']:.3f} s, {n / run['wall']:.2f} utt/s, prefill tokens fed "
              f"{run['fed']}, extension programs {run['ext']}, continuations that fell back to a "
              f"full prefill {run['fallbacks']}, evictions {run['evictions']}, {run['blocks']} "
              f"blocks, {run['steps']} decode steps, phases {run['phases']}, launches "
              f"{run['counts']}, {len(run['groups'])} admission groups on {card}")
    same = sum(runs["sessions"]["tokens"][k] == runs["re-prefill"]["tokens"][k]
               for k in runs["sessions"]["tokens"])
    print(f"server: [sessions] gives [re-prefill]'s tokens on {same} of "
          f"{len(runs['sessions']['tokens'])} turns (bf16)")
    rows, programs, wall, ms, ops = _ext_profile(srv, convs)
    print(f"server extension programs: an admission pass of {rows} continuations (17-49-token "
          f"deltas) over {SRV_CONV_SLOTS} slots ran {programs} programs (one a delta bucket), "
          f"device time {ms:.3f} ms, {ops} device operations ({ops / programs:.0f} a program); "
          f"the other half's pass {1e3 * wall:.3f} ms of host wall unprofiled "
          f"(torch.profiler for the device) on {card}")
    conv_srv = srv
    t_sessions = time.time()

    rng = np.random.default_rng(2)
    shorts = _server_traffic(rng, SRV_CHUNK_SHORT)
    longs = [dict(r, prompt_ids=rng.integers(0, 50000, SRV_CHUNK_PROMPT).tolist())
             for r in _server_traffic(rng, SRV_LONG_N)]
    chunk_srv = {}
    for name, chunk in (("chunk 0", 0), ("chunk 128", SRV_CHUNK)):
        srv = chunk_srv[name] = _server(
            params, k4, cache_len=SRV_CHUNK_CACHE, prompt_bucket=128, prefill_chunk=chunk,
            max_prompt=SRV_CHUNK if chunk else SRV_CHUNK_PROMPT)
        run = runs[name] = _long_arrivals(srv, shorts, longs)
        _ext_counts_ok(name, k4, run)
        n = len(shorts) + len(longs)
        print(f"server [{name}] {len(shorts)} short requests and {len(longs)} prompts of "
              f"{SRV_CHUNK_PROMPT} tokens arriving among them, {SRV_SLOTS} slots: "
              f"{run['wall']:.3f} s, {n / run['wall']:.2f} utt/s; while the long prompts are "
              f"admitted ({len(run['walls'])} steps) a step's wall median "
              f"{1e3 * float(np.median(run['walls'])):.1f} ms, longest "
              f"{1e3 * max(run['walls']):.1f} ms; extension programs {run['ext']}, "
              f"{run['steps']} decode steps, phases {run['phases']}, launches {run['counts']} "
              f"on {card}")
    t_chunks = time.time()

    traffic = _server_traffic(np.random.default_rng(0))[:SRV_SPEC_REQS]
    spec_srv = {"spec": _server(params, k4, spec_gamma=SRV_GAMMA, spec_ngram=SRV_NGRAM),
                "spec plain": _server(params, k4)}
    _serve(spec_srv["spec"], traffic[:SRV_SLOTS])  # warm-up
    for name, srv in spec_srv.items():
        run = runs[name] = _serve(srv, traffic)
        _ext_counts_ok(name, k4, run)
        n = len(traffic)
        print(f"server [{name}] {n} requests, {SRV_SLOTS} slots: {run['wall']:.3f} s, "
              f"{n / run['wall']:.2f} utt/s, {run['new_tokens'] / run['wall']:.0f} generated "
              f"tok/s, {run['blocks']} blocks; macro steps {srv.spec_macro}, proposed "
              f"{srv.spec_proposed}, accepted {srv.spec_accepted}; phases {run['phases']}, "
              f"launches {run['counts']} on {card}")
    same = sum(a == b for a, b in zip(runs["spec"]["tokens"], runs["spec plain"]["tokens"]))
    print(f"server: [spec] gives [spec plain]'s tokens on {same} of {len(traffic)} requests "
          f"(bf16)")
    n, wall, ms, ops = _block_profile(spec_srv["spec"], traffic)
    print(f"server block [spec]: {n} macro steps over {SRV_SLOTS} slots, device time {ms:.3f} ms "
          f"({ms / n:.3f} ms a macro step), {ops} device operations, host wall "
          f"{1e3 * wall:.3f} ms unprofiled (torch.profiler for the device) on {card}")
    t_spec = time.time()

    # K5 launches in the re-prefill arm (buckets 256 and 384) and in chunk
    # 0's whole long prompts (bucket 512, left-padded)
    arrivals = lambda s: _long_arrivals(s, shorts, longs)  # noqa: E731
    for name, srv, go in (("re-prefill", conv_srv, lambda s: _converse(s, convs, False)),
                          ("chunk 0", chunk_srv["chunk 0"], arrivals),
                          ("chunk 128", chunk_srv["chunk 128"], arrivals),
                          ("spec", spec_srv["spec"], lambda s: _serve(s, traffic)),
                          ("spec plain", spec_srv["spec plain"], lambda s: _serve(s, traffic))):
        with KernelShadow(KernelShadow.SERVER) as shadow:
            run = go(srv)
        shares = shadow.shares()
        want = {"prefill_mha": sum(_k1_launches(k4, run["groups"]).values()),
                "block_mha": k4.n_layer * sum(pb > 128 for pb, _ in run["groups"]),
                "fused_ln_mlp": k4.n_layer * run["steps"]}
        if name in ("re-prefill", "chunk 0") and not want["block_mha"]:
            raise AssertionError(f"server [{name}]: no admission group took K5")
        print(f"server [{name}] bf16: every K1, K5 and K4 launch against its plain version on the "
              f"same inputs ({shadow.calls} launches); the largest |kernel - plain| as a share of "
              f"the bar 2e-2 + 1e-2 |plain|: " + ", ".join(f"{k} {v:.4f}"
                                                          for k, v in shares.items()))
        if any(v > 1.0 or not math.isfinite(v) for v in shares.values()) or shadow.calls != want:
            raise AssertionError(f"server [{name}]: a kernel leaves its plain version's bar or "
                                 f"was not held at every launch: {shares}, {shadow.calls}, "
                                 f"want {want}")
    del conv_srv, chunk_srv, spec_srv, params
    torch.cuda.empty_cache()
    t_shadow = time.time()

    f32 = ModelConfig.from_model_type(**{**SRV_SLICE, "dtype": "float32"})
    p32 = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), f32), f32)
    small = dict(slots=SRV_IDENTITY_SLOTS, sync_every=SRV_IDENTITY_SYNC)
    # sessions: turn 2 of 8 conversations against a fresh server's full prefill
    convs8 = [dict(c, budgets=[min(b, SRV_IDENTITY_NEW) for b in c["budgets"]])
              for c in convs[:SRV_IDENTITY_SLOTS]]
    srv = _server(p32, f32, max_prompt=SRV_REPREFILL_MAX, prompt_bucket=128, **small)
    run = _converse(srv, convs8, True, turns=2)
    turn2 = [run["reqs"][(ci, 1)] for ci in range(len(convs8))]
    fresh = _serve(srv, [dict(r, session_id=None) for r in turn2])
    _identity("session turns vs full prefill", turn2, [run["tokens"][(ci, 1)]
                                                       for ci in range(len(convs8))],
              fresh["tokens"], p32, f32, card)
    # chunked prompts of 200-448 tokens against generate
    rng = np.random.default_rng(4)
    chunked = [dict(r, prompt_ids=rng.integers(0, 50000, int(rng.integers(200, 449))).tolist(),
                    max_new_tokens=min(r["max_new_tokens"], SRV_IDENTITY_NEW))
               for r in _server_traffic(rng, SRV_IDENTITY_SLOTS)]
    srv = _server(p32, f32, max_prompt=64, cache_len=SRV_CHUNK_CACHE, prefill_chunk=64, **small)
    run = _serve(srv, chunked)
    _identity("chunked prefill vs generate", chunked, run["tokens"],
              [_generate_request(p32, f32, r)[0] for r in chunked], p32, f32, card)
    # speculative against plain blocks
    reqs = [dict(r, max_new_tokens=min(r["max_new_tokens"], SRV_IDENTITY_NEW))
            for r in traffic[:SRV_IDENTITY]]
    spec = _serve(_server(p32, f32, spec_gamma=SRV_GAMMA, spec_ngram=SRV_NGRAM, **small), reqs)
    plain = _serve(_server(p32, f32, **small), reqs)
    _identity("speculative vs plain blocks", reqs, spec["tokens"], plain["tokens"], p32, f32,
              card)
    # the HTTP front end against direct submission
    srv, payloads, got = _http_arm(p32, f32, reqs, card)
    direct = [request_from_json({k: v for k, v in p.items() if k != "stream"})
              for p in payloads]
    srv.reset()
    rids = [srv.submit(r) for r in direct]
    res = srv.run_until_drained()
    _identity("HTTP vs direct submission", [dict(r, img=None, aud=None) for r in reqs], got,
              [res[r].tokens for r in rids], p32, f32, card)
    del p32, srv
    torch.cuda.empty_cache()
    print(f"server extension phase wall s: sessions {t_sessions - t_phase:.1f}, chunks "
          f"{t_chunks - t_sessions:.1f}, speculative {t_spec - t_chunks:.1f}, shadow runs "
          f"{t_shadow - t_spec:.1f}, fp32 identities and HTTP {time.time() - t_shadow:.1f}")
    return {k: {name: run["counts"][k] for name, run in runs.items()}
            for k in ("prefill_mha", "prefill_mha_cross", "block_mha", "fused_ln_mlp")}


def _k5_grads(fn, q, k, v, do, **kw) -> list:
    """Output and (dQ, dK, dV) of ``fn`` (K5 or its plain version)."""
    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(qq, kk, vv, **kw)
    return [o, *torch.autograd.grad(o, (qq, kk, vv), do)]


def _k5_instances(label: str, dh: int, q, k, v, do, attempts: int = 3, **kw) -> list:
    """Prints, and returns, the bf16 kernels of ``csrc/block_attention.cu``
    that one K5 forward and backward at ``q``'s shape launch (torch.profiler
    over three calls after one outside it; each trace waits on the host
    before its calls, 0.05 s and ten times longer on each later attempt,
    and synchronises after each call; a trace that lacks any of the
    forward, dQ and dK/dV kernels is taken again, at most ``attempts``
    times); raises unless the last trace that holds them shows the
    ``blk::`` instances at width ``dh``: the forward, dQ and dK/dV kernels
    beside the pre-pass. The launch counters, not this trace, show that
    the main path ran the kernels."""
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def call():
        torch.autograd.grad(block_attention.block_mha(*xs, **kw), xs, do)
    call()
    torch.cuda.synchronize()
    names, events = [], []
    for attempt in range(attempts):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.05 * 10 ** attempt)
            for _ in range(3):
                call()
                torch.cuda.synchronize()
        events = sorted(prof.events(), key=lambda e: e.time_range.start)
        trace = sorted({re.sub(r"^void |ergm_block::|\(.*$", "", e.name) for e in events
                        if "ergm_block::" in e.name})
        if trace:
            names = trace
        if len([n for n in trace if not n.startswith("prep_kernel")]) >= 3:
            break
    if not names:
        print(f"{label}: K5 instances not read, the profiler recorded none of them in "
              f"{attempts} traces")
        return []
    kernels = [n for n in names if not n.startswith("prep_kernel")]
    want = [f"blk::{name}<blk::Shape<{dh}," for name in
            ("bwd_dkdv_kernel", "bwd_dq_kernel", "fwd_kernel")]
    if len(kernels) != 3 or not all(n.startswith(w) for w, n in zip(want, kernels)):
        first = events[0].time_range.start if events else 0
        for e in events[:60]:  # the last trace, for the failure's record
            print(f"  {label} trace: +{(e.time_range.start - first) / 1e3:.3f} ms thread "
                  f"{e.thread} {str(e.device_type)} {e.name[:90]}")
        raise AssertionError(f"{label}: K5 ran {names}, not blk:: at {dh}")
    print(f"{label}: K5 instances {', '.join(names)}")
    return names


def _k5_held(label: str, dtype, got: list, want: list, exact: list, rows=None) -> tuple:
    """Raises unless K5's output is within its bar of the plain version
    (bf16: 2e-2 + 1e-2 |plain|; fp32: F32_TOL) on ``rows`` (all when None)
    and its gradients pass ``_grads_ok`` (fp32 5e-5). Returns the largest
    |kernel - plain| of the output and of the gradients, and the
    gradients' share of their bar."""
    o, o_ref = got[0].float(), want[0].float()
    if rows is not None:
        o, o_ref = (torch.where(rows, x, 0.0) for x in (o, o_ref))
    o_err = (o - o_ref).abs().max().item()
    ok = _bf16_ok(o, o_ref) if dtype == torch.bfloat16 else o_err <= F32_TOL
    if not ok or not bool(torch.isfinite(got[0]).all()) or got[0].shape != want[0].shape:
        raise AssertionError(f"{label}: output disagrees, {o_err:.3e}")
    g_err, g_ratio = _grads_ok(got[1:], want[1:], dtype, 5e-5, exact[1:])
    return o_err, g_err, g_ratio


def _k5_run(fn, q, k, v, do, rate=0.0, m=None) -> list:
    """``_k5_grads`` causal at the 64-wide heads' scale, with ``m`` as both
    the key and the query mask."""
    return _k5_grads(fn, q, k, v, do, causal=True, scale=0.125, q_mask=m, kv_mask=m,
                     dropout_rate=rate, dropout_seed=SEED if rate else None)


def bf16_grad_ratio(got, plain, exact) -> float:
    """How far a bf16 gradient is from its bar; above 1 fails. ``exact`` is
    the same math in f32 on the same (bf16-valued) inputs, TF32 off. The
    kernel's error against it may be at most twice the plain bf16
    version's: over the whole tensor (rms), and in each row (rms over the
    last dim, plus 0.1 rms(exact) for rows the plain version gets exactly:
    the kernels round ds and padj where the plain autograd rounds dP and
    the output, and K5's delta = rowsum(dO∘O) carries O's rounding)."""
    g, p, x = got.float(), plain.float(), exact.float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    ek, ep = g - x, p - x
    whole = ek.pow(2).mean().sqrt() / (2 * ep.pow(2).mean().sqrt()).clamp_min(1e-30)
    rows = ek.pow(2).mean(-1).sqrt() / (2 * ep.pow(2).mean(-1).sqrt()
                                        + 0.1 * x.pow(2).mean().sqrt())
    return max(whole.item(), rows.max().item())


def _grads_ok(got, want, dtype, f32_tol, exact=()) -> tuple:
    """Raises unless every gradient passes: fp32 elementwise within
    f32_tol (atol = rtol) of the plain version; bf16 by
    ``bf16_grad_ratio`` against ``exact``. Returns the largest |kernel -
    plain| and the largest ratio to the bar."""
    worst = (0.0, 0.0)
    for a, b, x in zip(got, want, exact if dtype == torch.bfloat16 else want):
        err = (a.float() - b.float()).abs()
        ratio = (bf16_grad_ratio(a, b, x) if dtype == torch.bfloat16 else
                 (err / (f32_tol + f32_tol * b.float().abs())).max().item())
        if not ratio <= 1.0:
            raise AssertionError(f"{dtype} gradients disagree: max {err.max().item():.3e}, "
                                 f"{ratio:.3f} of the bar")
        worst = (max(worst[0], err.max().item()), max(worst[1], ratio))
    return worst


def train_kernel_phase(gen: torch.Generator) -> dict:
    """K5 and K6 against their plain versions at the training slice's
    shapes, forward and backward, with times. Returns their JSON numbers."""
    res = {name: {"max_abs_err": 0.0} for name in (
        "block_mha", "block_mha_bwd", "fused_softmax_xent", "fused_softmax_xent_bwd")}
    H_, Dh = 12, 64
    # K5: bf16 at the slice, dropout off and on (one seed); fp32 at B=4
    for dtype, b in ((torch.bfloat16, TRAIN_B), (torch.float32, 4)):
        q, k, v, do = (torch.randn((b, H_, TRAIN_L, Dh), generator=gen, device=DEVICE).to(dtype)
                       for _ in range(4))
        for rate in ((0.0, 0.1) if dtype == torch.bfloat16 else (0.1,)):
            got = _k5_run(block_attention.block_mha, q, k, v, do, rate)
            want = _k5_run(block_attention.block_mha_reference, q, k, v, do, rate)
            exact = (_k5_run(block_attention.block_mha_reference,
                             *(x.float() for x in (q, k, v, do)), rate)
                     if dtype == torch.bfloat16 else ())
            torch.cuda.synchronize()
            o_err, g_err, g_ratio = _k5_held(f"K5 {dtype} rate {rate}", dtype, got, want,
                                             list(exact))
            note = ""
            if dtype == torch.bfloat16:
                # the bar must see the late keys, which few queries reach
                late = got[2].clone()
                late[:, :, -64:] = 0
                blind = bf16_grad_ratio(late, want[2], exact[2])
                if blind <= 1.0:
                    raise AssertionError(f"K5: the bar passes dK without its last keys, {blind}")
                note = f"; dK with its last 64 keys zeroed reads {blind:.1f}"
            print(f"K5 {dtype} [{b}, {H_}, {TRAIN_L}, {Dh}] causal, dropout {rate}: max |kernel - "
                  f"plain| output {o_err:.3e}, gradients {g_err:.3e} ({g_ratio:.3f} of the "
                  f"bar{note})")
            key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
            for name, err in (("block_mha", o_err), ("block_mha_bwd", g_err)):
                res[name][key] = max(res[name].get(key, 0.0), err)
            del got, want, exact
    # K5 times at the training configuration (bf16, dropout 0.1); the
    # yardstick is one scaled_dot_product_attention call
    q, k, v, do = (torch.randn((TRAIN_B, H_, TRAIN_L, Dh), generator=gen,
                               device=DEVICE).bfloat16() for _ in range(4))
    kw = dict(causal=True, scale=0.125, dropout_rate=0.1, dropout_seed=SEED)
    fwd = {"kernel": lambda *x: block_attention.block_mha(*x, **kw),
           "plain": lambda *x: block_attention.block_mha_reference(*x, **kw),
           "library": lambda *x: F.scaled_dot_product_attention(*x, is_causal=True,
                                                                dropout_p=0.1, scale=0.125)}
    r = res["block_mha"]
    r["ms"], r["plain_ms"] = _timed_pair("K5 forward", lambda: fwd["kernel"](q, k, v),
                                         lambda: fwd["plain"](q, k, v))
    r["library_ms"] = _median_ms(lambda: fwd["library"](q, k, v))
    pairs = TRAIN_B * H_ * TRAIN_L * (TRAIN_L + 1) // 2  # causal (query, key) pairs
    r.update(bound(4 * _nbytes(q), 2 * 2 * pairs * Dh))
    bwd = {}
    for name, fn in fwd.items():  # one forward graph each, its backward timed
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        bwd[name] = (lambda o=o, xs=xs: torch.autograd.grad(o, xs, do, retain_graph=True))
    r = res["block_mha_bwd"]
    r["ms"], r["plain_ms"] = _timed_pair("K5 backward", bwd["kernel"], bwd["plain"])
    r["library_ms"] = _median_ms(bwd["library"])
    r.update(bound(8 * _nbytes(q), 5 * 2 * pairs * Dh))  # S again, dP, dV, dQ, dK
    for name in ("block_mha", "block_mha_bwd"):
        print(f"{name}: SDPA {res[name]['library_ms']:.4f} ms, bound "
              f"{res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']})")
    _k5_instances(f"K5 [{TRAIN_B}, {H_}, {TRAIN_L}, {Dh}]", Dh, q, k, v, do, **kw)
    # the same kernels without dropout: what the keep-mask hash costs
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o = block_attention.block_mha(*xs, causal=True, scale=0.125)
    f0 = _median_ms(lambda: block_attention.block_mha(q, k, v, causal=True, scale=0.125))
    b0 = _median_ms(lambda: torch.autograd.grad(o, xs, do, retain_graph=True))
    print(f"K5 at dropout 0: forward {f0:.4f} ms, backward {b0:.4f} ms (the hash costs "
          f"{res['block_mha']['ms'] - f0:.4f} and {res['block_mha_bwd']['ms'] - b0:.4f} ms)")
    del fwd, bwd, o, xs

    # K6: bf16 at the slice's N, V, D; fp32 at N=2048. Logits of std 3, as
    # a trained LM head gives, so that the softmax term carries a large
    # share of dh and all of dW's rows without a gold token
    V, D = TRAIN_SLICE["vocab_size"], 768
    for dtype, n in ((torch.float32, 2048), (torch.bfloat16, TRAIN_B * TRAIN_L)):
        h = torch.randn((n, D), generator=gen, device=DEVICE).to(dtype)
        w = (3.0 / math.sqrt(D) * torch.randn((V, D), generator=gen, device=DEVICE)).to(dtype)
        lbl = torch.randint(0, V, (n,), generator=gen, device=DEVICE)
        lbl[::4] = -100
        cot = torch.randn((n,), generator=gen, device=DEVICE)
        outs = []
        runs = [(fused_ce.fused_softmax_xent, dtype),
                (fused_ce.fused_softmax_xent_reference, dtype)]
        if dtype == torch.bfloat16:  # and the same math in f32, for the gradients' bar
            runs.append((fused_ce.fused_softmax_xent_reference, torch.float32))
        for fn, dt in runs:
            hh, ww = (x.to(dt).clone().requires_grad_(True) for x in (h, w))
            nll = fn(hh, ww, lbl)
            outs.append([nll.detach(), *torch.autograd.grad((nll * cot).sum(), (hh, ww))])
            del hh, ww, nll
        torch.cuda.synchronize()
        (nll, dh, dw), (nll_ref, dh_ref, dw_ref) = outs[:2]
        tol = 1e-5 if dtype == torch.float32 else 1e-4
        n_err = (nll - nll_ref).abs().max().item()
        if not bool(((nll - nll_ref).abs() <= tol + tol * nll_ref.abs()).all()):
            raise AssertionError(f"K6 {dtype}: NLL disagrees, {n_err:.3e}")
        if dtype == torch.float32:
            errs = []
            for a, b in ((dh, dh_ref), (dw, dw_ref)):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
                errs.append((a - b).abs().max().item())
            note = ""
        else:
            _, dh_x, dw_x = outs[2]
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in ((dh, dh_ref), (dw, dw_ref))]
            _, ratio = _grads_ok([dh, dw], [dh_ref, dw_ref], dtype, None, [dh_x, dw_x])
            # the bar must see the softmax term, all there is in dW's rows
            # that no token has as its label: the gold term alone fails it
            gw = torch.where(lbl >= 0, cot, 0.0)[:, None]
            gold_dh = -gw * w.float()[lbl.clamp_min(0)]
            gold_dw = torch.zeros_like(dw_x).index_add_(0, lbl.clamp_min(0), -gw * h.float())
            blind = [bf16_grad_ratio(a, b, x) for a, b, x in ((gold_dh, dh_ref, dh_x),
                                                              (gold_dw, dw_ref, dw_x))]
            if min(blind) <= 1.0:
                raise AssertionError(f"K6 bf16: the bar passes the gold term alone, {blind}")
            note = (f" ({ratio:.3f} of the bar; the gold term alone reads {blind[0]:.1f} and "
                    f"{blind[1]:.1f})")
            del gold_dh, gold_dw, dh_x, dw_x
        del outs
        print(f"K6 {dtype} N={n}, V={V}, D={D}: max |kernel - plain| NLL {n_err:.3e}, "
              f"dh {errs[0]:.3e}, dW {errs[1]:.3e}{note}")
        key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
        res["fused_softmax_xent"][key] = n_err
        res["fused_softmax_xent_bwd"][key] = max(errs)
        del dh, dw, dh_ref, dw_ref, nll_ref
    # K6 at the slice (bf16): the backward twice must agree bit for bit;
    # times of the kernels alone and of plain functions computing the same
    # NLL and (dh, dW); the backward's chunk width at 4096, 8192 (the
    # default) and 16384 columns
    l32 = lbl.to(torch.int32)
    _, logz = fused_ce.launch_fwd(h, w, l32)
    g = torch.where(lbl >= 0, cot, 0.0)
    first, second = (fused_ce.launch_bwd(h, w, l32, logz, g) for _ in range(2))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("K6 bf16: two backward runs differ")
    del first, second
    print("K6 bf16: two backward runs are bitwise equal")

    def plain_padj():
        p = torch.softmax(h.float() @ w.float().t(), dim=-1) * g[:, None]
        ok = lbl >= 0
        p[ok, lbl[ok]] -= g[ok]
        return p

    def plain_bwd():
        p = plain_padj()
        return (p @ w.float()).to(h.dtype), (p.t() @ h.float()).to(w.dtype)

    times = {
        "fused_softmax_xent": (lambda: fused_ce.launch_fwd(h, w, l32),
                               lambda: fused_ce.fused_softmax_xent_reference(h, w, lbl), 1),
        "fused_softmax_xent_bwd": (lambda: fused_ce.launch_bwd(h, w, l32, logz, g), plain_bwd, 3),
    }
    for name, (run, plain, products) in times.items():
        r = res[name]
        r["ms"], r["plain_ms"] = _timed_pair(name, run, plain, reps=5)
        r["library_ms"] = None  # no single PyTorch call computes it
        # the forward reads h, W and the labels; the backward also the
        # cotangent and logZ, and writes dh and dW; 1 or 3 products of 2NVD
        nbytes = _nbytes(h, w, l32) + (_nbytes(g, logz, h, w) if name.endswith("bwd") else 0)
        r.update(bound(nbytes, products * 2 * h.shape[0] * V * D))
        print(f"{name}: bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for chunk in (4096, 16384):
        t = _median_ms(lambda: fused_ce.launch_bwd(h, w, l32, logz, g, chunk=chunk), 5)
        print(f"fused_softmax_xent_bwd with {chunk}-column chunks: {t:.4f} ms "
              f"({fused_ce.CHUNK}: {res['fused_softmax_xent_bwd']['ms']:.4f} ms)")
    # context only, not a library_ms: one cuBLAS product of the same shape
    print(f"cuBLAS h @ w.t() [{h.shape[0]}, {D}] x [{D}, {V}] bf16: "
          f"{_median_ms(lambda: h @ w.t(), 5):.4f} ms")
    return res


def flash_kernel_phase(gen: torch.Generator) -> dict:
    """K7 (``flash_attention.flash_mha``) on the shapes of JAX's library
    flash kernel: L=2048, causal, left-pad masks, no dropout, [8, 12, 2048,
    64] in bf16 and [1, 2, 2048, 64] in fp32 (``_k7_case``). Returns the K7
    rows' numbers."""
    res = _k7_case(gen, 64, ((torch.float32, 1, 2), (torch.bfloat16, FLASH_B, 12)))
    return {"flash_mha": res["fwd"], "flash_mha_bwd": res["bwd"]}


def _k7_case(gen: torch.Generator, dh: int, shapes: tuple) -> dict:
    """K7 at head width ``dh``: [b, heads, LONG_L, dh] for each (dtype, b,
    heads) of ``shapes`` (bf16 last), causal, left-pad key and query masks,
    no dropout, ``flash_mha`` forward and backward against the plain
    version of what the card runs (``flash_attention.kernel_reference``: in
    bf16 up to 384 JAX's library flash arithmetic, the one-pass kernels'
    own) on real rows (``_k5_held``), the bf16 run twice bit for bit;
    bf16 times of kernel, plain and SDPA (``is_causal``, no mask) and the
    bound over the pairs of real rows and keys. Returns {"fwd": numbers,
    "bwd": numbers}."""
    L, scale = LONG_L, dh ** -0.5
    res = {k: {"max_abs_err": 0.0} for k in ("fwd", "bwd")}
    for dtype, b, heads in shapes:
        q, k, v, do = (torch.randn((b, heads, L, dh), generator=gen, device=DEVICE).to(dtype)
                       for _ in range(4))
        pads = torch.randint(0, 400, (b,), generator=gen, device=DEVICE)
        pads[0] = 0
        m = (torch.arange(L, device=DEVICE)[None] >= pads[:, None]).to(torch.int32)
        # padded query rows: zeros here, junk in JAX's flash kernel
        kw = dict(causal=True, scale=scale, q_mask=m, kv_mask=m)
        got = _k5_grads(flash_attention.flash_mha, q, k, v, do, **kw)
        want = _k5_grads(flash_attention.kernel_reference, q, k, v, do, **kw)
        exact = (_k5_grads(flash_attention.kernel_reference,
                           *(x.float() for x in (q, k, v, do)), **kw)
                 if dtype == torch.bfloat16 else [])
        torch.cuda.synchronize()
        o_err, g_err, g_ratio = _k5_held(f"K7 Dh={dh} {dtype}", dtype, got, want,
                                         exact, rows=m[:, None, :, None].bool())
        if dtype == torch.bfloat16:
            again = _k5_grads(flash_attention.flash_mha, q, k, v, do, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"K7 Dh={dh}: a second run differs")
            del again
        print(f"K7 {dtype} [{b}, {heads}, {L}, {dh}] causal, left pads up to "
              f"{int(pads.max())}: max |kernel - plain| output {o_err:.3e} (real rows), "
              f"gradients {g_err:.3e} ({g_ratio:.3f} of the bar)"
              + (", bf16 repeats bit for bit" if dtype == torch.bfloat16 else ""))
        key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
        res["fwd"][key], res["bwd"][key] = o_err, g_err
        del got, want, exact
    fwd = {"kernel": lambda *x: flash_attention.flash_mha(*x, **kw),
           "plain": lambda *x: flash_attention.kernel_reference(*x, **kw),
           "library": lambda *x: F.scaled_dot_product_attention(*x, is_causal=True, scale=scale)}
    real_len = (L - pads).long()
    pairs = int((real_len * (real_len + 1) // 2).sum()) * heads
    r = res["fwd"]
    r["ms"], r["plain_ms"] = _timed_pair(f"K7 Dh={dh}, forward",
                                         lambda: fwd["kernel"](q, k, v),
                                         lambda: fwd["plain"](q, k, v), reps=10)
    r["library_ms"] = _median_ms(lambda: fwd["library"](q, k, v))
    r.update(bound(4 * _nbytes(q), 2 * 2 * pairs * dh))
    bwd = {}
    for name, fn in fwd.items():
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        bwd[name] = (lambda o=o, xs=xs: torch.autograd.grad(o, xs, do, retain_graph=True))
    r = res["bwd"]
    r["ms"], r["plain_ms"] = _timed_pair(f"K7 Dh={dh}, backward", bwd["kernel"],
                                         bwd["plain"], reps=10)
    r["library_ms"] = _median_ms(bwd["library"])
    r.update(bound(8 * _nbytes(q), 5 * 2 * pairs * dh))
    for key in ("fwd", "bwd"):
        print(f"K7 Dh={dh} {key}: SDPA {res[key]['library_ms']:.4f} ms, bound "
              f"{res[key]['bound_ms']:.4f} ms ({res[key]['bound_by']})")
    return res


def _train_batch(rng, b: int, L: int, vocab: int, dev, caption: int = 0) -> dict:
    ids = rng.integers(0, vocab, (b, L))
    batch = {"input_ids": ids, "token_type_ids": rng.integers(0, vocab, (b, L)), "labels": ids,
             "emotion_labels": rng.integers(0, 7, (b,)), "valid": np.ones((b,), bool),
             "imgs": rng.standard_normal((b, 768)).astype(np.float32),
             "auds": rng.standard_normal((b, 768)).astype(np.float32)}
    if caption:
        batch["caption_ids"] = rng.integers(0, vocab, (b, caption))
        batch["caption_mask"] = np.ones((b, caption), np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def train_reference_phase() -> None:
    """A small fp32 model: 3 AdamW steps on the card (K5, K6) and on the
    CPU (plain versions) from one init, dropout 0, lr 1e-4, no warmup;
    the losses agree within 1e-4 step by step."""
    cfg = ModelConfig(n_layer=2, n_embd=128, n_head=2, vocab_size=256, n_positions=128,
                      modality_dim=768, dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
                      resid_pdrop=0.0)
    cpu = gpt2.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    steps, losses = 3, {}
    for dev, params in (("cpu", cpu), (DEVICE, card)):
        rng = np.random.default_rng(2)
        tx = AdamW(1e-4)
        state, step = create_train_state(params, tx), make_train_step(cfg, tx, device=dev)
        reset_launches()
        losses[dev] = []
        for _ in range(steps):
            state, m = step(state, _train_batch(rng, 4, 128, 256, dev, caption=8), 0)
            losses[dev].append(float(m["loss"]))
        if dev == DEVICE:
            counts = _train_counts()
            want = {"block_mha": 2 * steps, "block_mha_bwd": 2 * steps,
                    "fused_softmax_xent": steps, "fused_softmax_xent_bwd": steps}
            if counts != want:
                raise AssertionError(f"training reference: launches {counts}, want {want}")
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses[DEVICE]))
    print(f"training reference: small fp32 model, 3 AdamW steps, losses card "
          f"{['%.6f' % x for x in losses[DEVICE]]} vs CPU {['%.6f' % x for x in losses['cpu']]}, "
          f"max diff {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"the card's training steps disagree with the CPU's: {err}")


def long_context_phase(card: str) -> dict:
    """One make_train_step step of gpt2 at full width, n_positions=2048, two
    layers, B=2, L=2048, no attention dropout: self-attention is outside
    JAX's block gate and inside its flash gate, where ``auto`` takes K7
    (``flash_mha``) and never K5. Returns the launch counts of the step."""
    cfg = ModelConfig.from_model_type(**{**TRAIN_SLICE, "n_positions": LONG_L, "n_layer": 2,
                                         "attn_pdrop": 0.0})
    params = gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(3), cfg)
    tx = AdamW(1e-4)
    state, step = create_train_state(params, tx), make_train_step(cfg, tx)
    batch = _train_batch(np.random.default_rng(3), 2, LONG_L, 50000, DEVICE)
    reset_launches()
    t0 = time.time()
    state, m = step(state, batch, SEED)
    torch.cuda.synchronize()
    counts = {**_train_counts(), **_k7_counts()}
    want = {"flash_mha": cfg.n_layer, "flash_mha_bwd": cfg.n_layer, "block_mha": 0,
            "block_mha_bwd": 0}
    if {k: counts[k] for k in want} != want or not math.isfinite(float(m["loss"])):
        raise AssertionError(f"long context: launches {counts}, want {want}; loss {m['loss']}")
    print(f"long context: gpt2 n_positions={LONG_L}, 2 layers, B=2, L={LONG_L}, one train step "
          f"in {time.time() - t0:.3f} s, loss {float(m['loss']):.4f}, launches {counts} on "
          f"{card}")
    return counts


def _k6_memory_step(step, state, batch):
    """One more step with K6's backward wrapped: prints the device memory
    allocated when it starts and the peak before, during and after it."""
    seen = {}
    launch_bwd = fused_ce.launch_bwd

    def probe(*args, **kwargs):
        torch.cuda.synchronize()
        seen["before_peak"] = torch.cuda.max_memory_allocated()
        seen["at_start"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = launch_bwd(*args, **kwargs)
        torch.cuda.synchronize()
        seen["during_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_ce.launch_bwd = probe
    try:
        state, _ = step(state, batch, SEED)
        torch.cuda.synchronize()
    finally:
        fused_ce.launch_bwd = launch_bwd
    if len(seen) != 3:
        raise AssertionError(f"train slice: K6's backward was not reached, {seen}")
    after = torch.cuda.max_memory_allocated()
    gb = {k: v / 1e9 for k, v in seen.items()}
    print(f"train slice memory: {gb['at_start']:.3f} GB allocated as K6's backward starts; "
          f"peak {gb['before_peak']:.3f} GB before it (forward and loss), "
          f"{gb['during_peak']:.3f} GB during it, {after / 1e9:.3f} GB after it (the layers' "
          f"backward and AdamW)")
    return state


def train_slice_phase(card: str) -> dict:
    """gpt2 at full width under train_bench's configuration: make_train_step
    timed, then one Trainer epoch with validation, a checkpoint and a
    resume. Returns the launch counts read over the 8 timed steps."""
    cfg = ModelConfig.from_model_type(**TRAIN_SLICE)
    params = gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    tx = AdamW(1e-4)
    state, step = create_train_state(params, tx), make_train_step(cfg, tx)
    batch = _train_batch(np.random.default_rng(0), TRAIN_B, TRAIN_L, 50000, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, m = step(state, batch, SEED)
    first_loss, first_lm = float(m["loss"]), float(m["lm_loss"])
    print(f"train slice: first step {time.time() - t0:.3f} s, loss {first_loss:.4f} "
          f"(LM {first_lm:.4f})")
    reset_launches()
    chains = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(4):
            state, m = step(state, batch, SEED)
        torch.cuda.synchronize()
        chains.append((time.time() - t0) / 4)
    counts = _train_counts()
    n = 8
    want = {"block_mha": n * cfg.n_layer, "block_mha_bwd": n * cfg.n_layer,
            "fused_softmax_xent": n, "fused_softmax_xent_bwd": n}
    if counts != want:
        raise AssertionError(f"train slice: launches {counts} over {n} steps, want {want}")
    # the LM loss over 24,576 tokens must fall on the repeated batch; the
    # joint loss also carries a 7-way emotion CE over 48 rows, which the
    # first Adam steps swing by a nat or more either way
    loss, lm = float(m["loss"]), float(m["lm_loss"])
    if not (math.isfinite(loss) and lm < first_lm):
        raise AssertionError(f"train slice: LM loss {first_lm:.4f} -> {lm:.4f} (joint "
                             f"{first_loss:.4f} -> {loss:.4f}) after {n} steps")
    best = min(chains)
    tokens = TRAIN_B * TRAIN_L
    mfu = model_flops_per_token(cfg, TRAIN_L) * tokens / best / PEAK_FLOPS[torch.bfloat16]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train slice: gpt2 B={TRAIN_B} L={TRAIN_L} bf16, remat mlp, dropout 0.1: step "
          f"{1e3 * best:.1f} ms (chains {'/'.join(f'{1e3 * c:.1f}' for c in chains)} ms), "
          f"{tokens / best:.0f} tok/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s, peak memory "
          f"{peak_gb:.2f} GB, loss {first_loss:.4f} -> {loss:.4f} (LM {first_lm:.4f} -> "
          f"{lm:.4f}), launches per step "
          f"{ {k: v // n for k, v in counts.items()} } on {card}")
    state = _k6_memory_step(step, state, batch)
    del state, step, params, batch

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_synthetic_dataset(data, prefixes=("train", "valid"), num_dialogues=36,
                                turns_per_dialogue=4, base_vocab_size=50257)
        tcfg = TrainConfig(data_dir=data, ckpt_dir=os.path.join(tmp, "ckpt"),
                           output_dir=os.path.join(tmp, "out"), model_type="gpt2",
                           batch_size=TRAIN_B, num_epochs=1, max_len=TRAIN_L,
                           pad_multiple=TRAIN_L, lr=1e-4, seed=0)
        t0 = time.time()
        tr = Trainer(tcfg)
        reset_launches()
        best_ppl = tr.train()
        epoch_counts = _train_counts()
        if not math.isfinite(best_ppl) or min(epoch_counts.values()) < 1:
            raise AssertionError(f"Trainer: best PPL {best_ppl}, launches {epoch_counts}")
        path = ckpt_lib.find_checkpoint(tcfg.ckpt_dir)
        if path is None or not os.path.basename(path).startswith("best_ckpt_epoch=1_"):
            raise AssertionError(f"Trainer: no best-PPL checkpoint in {tcfg.ckpt_dir}")
        tr2 = Trainer(tcfg.replace(ckpt_name="best"))
        same = all(torch.equal(a, b) for a, b in zip(tr.state.params.parameters(),
                                                     tr2.state.params.parameters()))
        if not same or tr2.state.step != tr.state.step or tr2.last_epoch != 1:
            raise AssertionError("Trainer: the resume did not restore the checkpoint")
        print(f"train slice: Trainer, one epoch of {tr.state.step} steps + validation, "
              f"checkpoint {os.path.basename(path)}, resume checked, {time.time() - t0:.1f} s, "
              f"launches {epoch_counts}")
    return counts


def profile_train_step(card: str, path: str, cfg=None, b: int = TRAIN_B, L: int = TRAIN_L,
                       caption: int = 0) -> None:
    """torch.profiler over two steps of the training slice (or of ``cfg`` at
    [b, L] with a ``caption``-token caption); the table goes to ``path``."""
    cfg = cfg or ModelConfig.from_model_type(**TRAIN_SLICE)
    tx = AdamW(1e-4)
    state = create_train_state(gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                                                cfg), tx)
    step = make_train_step(cfg, tx)
    batch = _train_batch(np.random.default_rng(0), b, L, 50000, DEVICE, caption=caption)
    for _ in range(3):
        state, m = step(state, batch, SEED)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        for _ in range(2):
            state, m = step(state, batch, SEED)
        torch.cuda.synchronize()
        wall = time.time() - t0
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=40,
                                      max_name_column_width=70)
    # device time per step by kind of kernel
    kinds = {"K6 (fused_ce)": ("ergm_xent",), "K5 (block_attention)": ("ergm_block",),
             "cuBLAS GEMM": ("nvjet", "gemm", "cutlass", "xmma"),
             "AdamW": ("multi_tensor", "adam")}
    by_kind, device_ms = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / 2
        device_ms += ms
        kind = next((k for k, pats in kinds.items()
                     if any(s in e.key.lower() for s in pats)), "other (elementwise, copies)")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    split = ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(by_kind.items(), key=lambda x: -x[1]))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card}: per train step, wall {500 * wall:.1f} ms, device time "
                f"{device_ms:.1f} ms: {split}\n{table}\n")
    print(f"profile: per train step (two profiled), wall {500 * wall:.1f} ms, device time "
          f"{device_ms:.1f} ms: {split}; table in {path}")


# ---------------------------------------------------------------------------
# The feature-extraction and test-run paths (pipeline_phase)
# ---------------------------------------------------------------------------

# 16 kHz clips and their frame counts ((n - 400) // 320 + 1): 128, 256, 149
# (the plain math), 1,024 and 1,152 (K5 inside JAX's flash gate); one 1.5 s
# clip at 22.05 kHz (24,000 samples, 74 frames, after resampling)
PIPE_CLIPS, PIPE_22K = (41_040, 82_000, 48_000, 327_760, 368_720), 33_075
PIPE_IMAGES, PIPE_TEXT_UTTS = 2, 256
# run_test: 80 dialogues of 4 turns (5 batches of 64), captions on every
# other dialogue, words across gpt2's whole vocabulary; 32 new tokens at
# top-p 0.8 with the full-sort sampler
PIPE_DIALOGUES, PIPE_TURNS, PIPE_B, PIPE_NEW = 80, 4, 64, 32
PIPE_CORPUS = [
    "I can't believe you did that, it is amazing!",
    "Why are you so upset about the meeting today?",
    "We lost the game again, and I feel terrible.",
    "That sounds wonderful, congratulations on the new job.",
    "Don't worry, everything will be fine in the end.",
    "Are you kidding me? That is the worst news I've heard all week.",
    "Thanks for listening to me, I really needed that.",
    "The weather was cold but the view from the mountain was beautiful.",
]


def _pipe_tone(n: int, sr: int, seed: int) -> np.ndarray:
    t = np.arange(n) / sr
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1330 * t)
            + 0.02 * noise).astype(np.float32)


def _pipe_clips(root: str) -> tuple:
    """Writes the clips directory (dia0: the 16 kHz clips; dia1: the
    22.05 kHz clip and the keyframes, PNGs when PIL imports). Returns
    ({path: frames}, [image arrays, normalised], whether PIL imported)."""
    import wave

    from ergm_tpu_torch.tools.audio import AudioEncoderConfig
    from ergm_tpu_torch.tools.extract_features import normalize_image

    frames = {}
    dirs = {0: [(16000, n) for n in PIPE_CLIPS], 1: [(22050, PIPE_22K)]}
    cfg = AudioEncoderConfig()
    for di, clips in dirs.items():
        d = os.path.join(root, f"dia{di}")
        os.makedirs(d)
        for ci, (sr, n) in enumerate(clips):
            path = os.path.join(d, f"u{ci}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((_pipe_tone(n, sr, ci) * 32767).astype(np.int16).tobytes())
            frames[path] = cfg.frames_for_samples(round(n * 16000 / sr))
    rng = np.random.default_rng(9)
    pixels = [rng.integers(0, 256, (384, 384, 3), dtype=np.uint8) for _ in range(PIPE_IMAGES)]
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        for i, px in enumerate(pixels):
            Image.fromarray(px).save(os.path.join(root, "dia1", f"k{i}.png"))
    return frames, [normalize_image(px.astype(np.float32)) for px in pixels], Image is not None


def _busy_ms(fn, calls: int = 3) -> tuple:
    """One call's device busy time and host wall, read in the same passes:
    ``calls`` calls under torch.profiler after one untraced warm-up step,
    the wall by the host clock around them (synchronised), the busy time as
    the union of their device operations' intervals (operations on
    different streams may overlap: cuDNN runs a grouped convolution as one
    kernel a group on streams of its own). Returns (busy ms, wall ms, the
    three device operations with the largest summed durations, with their
    launches a call)."""
    import warnings

    cuda, trace = torch.autograd.DeviceType.CUDA, {}

    def ready(prof):  # the active step's events, before the profiler clears them
        trace["events"], trace["averages"] = list(prof.events()), prof.key_averages()

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Profiler clears events")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                    on_trace_ready=ready) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.time()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.time() - t0) / calls
            prof.step()
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in trace["events"]
                              if e.device_type == cuda
                              and not e.name.startswith("ProfilerStep")):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    dev = [e for e in trace["averages"]
           if e.device_type == cuda and not e.key.startswith("ProfilerStep")]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    return (busy / 1e3 / calls, wall,
            "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / calls:.3f} ms summed "
                      f"over {e.count // calls} launches" for e in top))


def _audio_convs(card: str, params, cfg) -> None:
    """Each convolution of a 128-frame clip (41,040 samples) alone, as the
    fp32 encoder runs it (cuDNN's TF32 off) on random inputs of its shape:
    CUDA-event medians of 10, operations and rate; the positional conv
    also under cuDNN's autotuner (``cudnn.benchmark``)."""
    from ergm_tpu_torch.tools.audio import fp32_convolutions

    g = torch.Generator(device=DEVICE).manual_seed(3)
    convs, n, c_in = [], 41_040, 1
    for i, layer in enumerate(params.feature_extractor):
        c_out, _, k = layer.conv.shape
        s = cfg.conv_stride[i]
        x = torch.randn((1, c_in, n), generator=g, device=DEVICE)
        n = (n - k) // s + 1
        convs.append((f"conv {i} [{c_in} -> {c_out}, kernel {k}, stride {s}, {n} out]",
                      lambda x=x, w=layer.conv, s=s: F.conv1d(x, w, stride=s),
                      2 * n * c_out * c_in * k))
        c_in = c_out
    w = params.pos_conv.weight
    k, groups = w.shape[-1], cfg.num_conv_pos_embedding_groups
    h = torch.randn((1, cfg.hidden_size, n), generator=g, device=DEVICE)
    pos = (lambda: F.conv1d(h, w, padding=k // 2, groups=groups))
    convs.append((f"positional conv [{cfg.hidden_size}, {groups} groups, kernel {k}, {n + 1} "
                  f"out]", pos, 2 * (n + 1) * cfg.hidden_size * w.shape[1] * k))
    with fp32_convolutions():
        for name, fn, ops in convs:
            ms = _median_ms(fn, reps=10)
            print(f"pipeline audio fp32 {name}: {ms:.4f} ms, {ops / 1e9:.3f} GFLOP, "
                  f"{ops / ms / 1e9:.2f} TFLOP/s on {card}")
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            ms = _median_ms(pos, reps=10)
        finally:
            torch.backends.cudnn.benchmark = saved
    print(f"pipeline audio fp32 positional conv under cudnn.benchmark: {ms:.4f} ms on {card}")


def _pipe_audio(card: str, clips_dir: str, frames: dict) -> dict:
    """The wav2vec2-base encoder (7 convs, 768 wide, 12 layers, random
    weights from seed 0, as ``build_audio_extractor`` draws them) over every
    clip at B=1, fp32 then bf16, entered with cuDNN's TF32 at its default
    (on): K5 must launch n_layer times for each clip whose frame count is a
    multiple of 128 up to 1,024, K7 for one past it (JAX's flash gate),
    neither for the others. Every K5 and K7 launch is then held against its
    plain version, and the fp32 features of three clips against the CPU's.
    Returns {"fp32": {kernel: launches}, "bf16": ...} and the features by
    path (fp32)."""
    from ergm_tpu_torch.tools import audio
    from ergm_tpu_torch.tools.extract_features import load_wav

    base = audio.AudioEncoderConfig()
    params = audio.init_audio_params(torch.Generator().manual_seed(0), base, device=DEVICE)
    paths = sorted(frames)

    @torch.inference_mode()
    def features(path, cfg, on=DEVICE, p=params):
        x, sr = load_wav(path)
        wav = torch.as_tensor(x, device=on)
        if sr != 16000:
            wav = audio.resample(wav, sr, 16000)
        return audio.extract_audio_features(p, cfg, wav[None])[0].float().cpu().numpy()

    launches, feats = {}, {}
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the default: the encoder turns it off itself
    try:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            name = "fp32" if dtype == "float32" else "bf16"
            for path in paths:  # warm-up (cuBLAS and cuDNN plans per shape)
                features(path, cfg)
            runs = {path: [] for path in paths}
            for _ in range(3):  # the median of three timed passes
                total = {"block_mha": 0, "flash_mha": 0}
                for path in paths:
                    reset_launches()
                    t0 = time.time()
                    f = features(path, cfg)
                    runs[path].append(1e3 * (time.time() - t0))
                    got = {"block_mha": block_attention.LAUNCHES,
                           "flash_mha": flash_attention.LAUNCHES}
                    n = base.num_layers if frames[path] % 128 == 0 else 0
                    want = {"block_mha": 0 if frames[path] > 1024 else n,
                            "flash_mha": n if frames[path] > 1024 else 0}
                    if (got != want or not np.isfinite(f).all()
                            or f.shape != (base.hidden_size,)):
                        raise AssertionError(f"audio {name} {os.path.basename(path)} "
                                             f"({frames[path]} frames): launches {got} (want "
                                             f"{want}), features {f.shape}")
                    total = {k: total[k] + got[k] for k in total}
                    if dtype == "float32":
                        feats[path] = f
            walls = [float(np.median(runs[path])) for path in paths]
            launches[name] = total
            print(f"pipeline audio {name}: " + ", ".join(
                f"{frames[p]} frames {w:.1f} ms" for p, w in zip(paths, walls))
                + f" a clip at B=1 (host wall, synchronised; medians of 3); launches a pass "
                f"{total} on {card}")
            clip = next(p for p in paths if frames[p] == 128)
            busy, wall, top = _busy_ms(lambda: features(clip, cfg))
            print(f"pipeline audio {name}: one 128-frame clip under torch.profiler, "
                  f"{busy:.3f} ms of device busy time in {wall:.3f} ms of host wall (the "
                  f"same passes): the device idle {1 - busy / wall:.1%} (most: {top}) on "
                  f"{card}")
            with KernelShadow(((block_attention, "block_mha", None),
                               (flash_attention, "flash_mha", None,
                                flash_attention.kernel_reference))) as shadow:
                for path in paths:
                    features(path, cfg)
            share = max(shadow.shares().values())
            bar = "the fp32 bar (F32_TOL)" if dtype == "float32" else "the bf16 bar"
            if shadow.calls != total or not share <= 1.0:
                raise AssertionError(f"audio {name}: {shadow.calls} K5 and K7 launches "
                                     f"held, largest error {share:.4f} of {bar}")
            print(f"pipeline audio {name}: every K5 and K7 launch ({total}) within {share:.4f} "
                  f"of {bar} of its plain version")
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("the audio encoder left cuDNN's TF32 setting changed")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    _audio_convs(card, params, base)
    cpu = copy.deepcopy(params).to("cpu")
    for path in [p for p in paths if frames[p] in (128, 149, 74)]:
        want = features(path, base, on="cpu", p=cpu)
        err = float(np.abs(feats[path] - want).max())
        if not err <= 1e-3:
            raise AssertionError(f"audio fp32 {frames[path]} frames: card against CPU {err}")
        print(f"pipeline audio fp32 {frames[path]} frames: card within {err:.2e} of the CPU "
              f"(bar 1e-3, cuDNN TF32 on at entry)")
    return launches, feats


def _pipe_vision(card: str, images: list) -> None:
    """The BLIP ViT-B/16 encoder at 384 px (577 tokens: no K5, as on the
    TPU) over the keyframes at B=1, fp32 then bf16: ms per image."""
    from ergm_tpu_torch.tools import vision

    base = vision.VisionEncoderConfig()
    params = vision.init_vision_params(torch.Generator().manual_seed(1), base, device=DEVICE)
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)

        @torch.inference_mode()
        def one(img):
            x = torch.as_tensor(img, device=DEVICE)[None]
            return vision.extract_image_features(params, cfg, x)[0].float().cpu().numpy()

        one(images[0])
        reset_launches()
        t0 = time.time()
        out = [one(img) for img in images]
        wall = 1e3 * (time.time() - t0) / len(images)
        if block_attention.LAUNCHES or not all(np.isfinite(f).all()
                                               and f.shape == (base.hidden_size,) for f in out):
            raise AssertionError(f"vision {dtype}: K5 launched {block_attention.LAUNCHES} "
                                 f"times at 577 tokens (want 0)")
        busy, prof_wall, top = _busy_ms(lambda: one(images[0]))
        print(f"pipeline vision {dtype}: {wall:.1f} ms an image at B=1 (host wall); under "
              f"torch.profiler {busy:.3f} ms of device busy time in {prof_wall:.3f} ms of wall "
              f"(the same passes): the device idle {1 - busy / prof_wall:.1%} (most: {top}), "
              f"577 tokens, K5 not launched on {card}")


def _pipe_extract_main(card: str, clips_dir: str, frames: dict, feats: dict,
                       have_pil: bool) -> int:
    """``extract_features.main`` on the card over the clips directory: K5
    launches n_layer times for each 128-multiple clip up to 1,024 frames,
    K7 for each past it; its audio features equal the direct fp32 ones.
    Returns {kernel: launches}."""
    import pickle

    from ergm_tpu_torch.tools import extract_features
    from ergm_tpu_torch.tools.audio import AudioEncoderConfig

    out = os.path.join(clips_dir, "features.pkl")
    reset_launches()
    t0 = time.time()
    extract_features.main([f"--clips_dir={clips_dir}", f"--output_file={out}",
                           "--split=test", f"--device={DEVICE}"])
    wall = time.time() - t0
    launches = {"block_mha": block_attention.LAUNCHES, "flash_mha": flash_attention.LAUNCHES}
    n = AudioEncoderConfig().num_layers
    want = {"block_mha": n * sum(f % 128 == 0 and f <= 1024 for f in frames.values()),
            "flash_mha": n * sum(f % 128 == 0 and f > 1024 for f in frames.values())}
    with open(out, "rb") as f:
        got = pickle.load(f)["test"]
    paths = sorted(frames)
    aud = [x for dia in got["aud"] for x in dia]
    img = [x for dia in got["img"] for x in dia]
    if launches != want or len(aud) != len(paths) or len(img) != (PIPE_IMAGES if have_pil else 0):
        raise AssertionError(f"extract_features.main: launches {launches} (want "
                             f"{want}), {len(aud)} audio and {len(img)} image features")
    err = max(float(np.abs(a - feats[p]).max()) for a, p in zip(aud, paths))
    if not err <= 1e-5 or not all(np.isfinite(x).all() and x.shape == aud[0].shape for x in img):
        raise AssertionError(f"extract_features.main: audio features {err} from the direct run")
    print(f"pipeline extract_features.main: {len(aud)} clips and {len(img)} images "
          f"{'(PNG through PIL)' if have_pil else '(PIL absent: no image files)'} in "
          f"{wall:.2f} s (the encoders' random init on the CPU included), launches "
          f"{launches}, audio features within {err:.1e} of the direct run, on {card}")
    return launches


def _pipe_text(card: str, params, cfg) -> int:
    """``extract_text_features`` at gpt2 full width in bf16 over 256
    utterances of 8-250 tokens in length order (batches of 16 bucketed to
    64-256 tokens): K5 must launch n_layer times for each 128- and
    256-token batch and never for the others; every launch is held
    against its plain version. Returns the K5 launches."""
    from ergm_tpu_torch.tools.text_features import extract_text_features

    rng = np.random.default_rng(10)
    lens = np.sort(rng.integers(8, 251, PIPE_TEXT_UTTS))
    utts = [rng.integers(0, 50257, int(n)).tolist() for n in lens]
    buckets = [-(-int(lens[s:s + 16].max()) // 64) * 64 for s in range(0, len(lens), 16)]
    want = cfg.n_layer * sum(b % 128 == 0 for b in buckets)
    extract_text_features(params, cfg, utts[:16])
    reset_launches()
    t0 = time.time()
    feats = extract_text_features(params, cfg, utts)
    wall = time.time() - t0
    got = block_attention.LAUNCHES
    if got != want or len(feats) != len(utts) or not all(np.isfinite(f).all() for f in feats):
        raise AssertionError(f"text_features: K5 launched {got} times, want {want} (buckets "
                             f"{buckets})")
    with KernelShadow(((block_attention, "block_mha", _k5_rows),)) as shadow:
        extract_text_features(params, cfg, utts)
    share = shadow.shares()["block_mha"]
    if shadow.calls["block_mha"] != got or not share <= 1.0:
        raise AssertionError(f"text_features: {shadow.calls['block_mha']} K5 launches held "
                             f"(want {got}), largest error {share} of the bf16 bar")
    print(f"pipeline text_features bf16: {len(utts)} utterances in {1e3 * wall:.1f} ms "
          f"({len(utts) / wall:.1f} utt/s), buckets {sorted(set(buckets))}, K5 launched {got} "
          f"times (the 128 and 256 buckets), within {share:.4f} of the bf16 bar, on {card}")
    return got


def _pipe_split(root: str, n_dialogues: int, seed: int):
    """A synthetic test split over gpt2's vocabulary, captions on every other
    dialogue; returns (dataset, SpecialTokens)."""
    from ergm_tpu_torch.data.assembly import write_meta, write_split
    from ergm_tpu_torch.data.dataset import DialogueDataset
    from ergm_tpu_torch.data.synthetic import make_synthetic_split

    payloads, st = make_synthetic_split(num_dialogues=n_dialogues, turns_per_dialogue=PIPE_TURNS,
                                        utter_len=range(4, 24), base_vocab_size=50257,
                                        captions="random", seed=seed)
    caps = payloads["multi"]["cap"]
    for i in range(1, len(caps), 2):
        caps[i] = [[] for _ in caps[i]]
    write_split(payloads, root, "test")
    write_meta(st, root)
    ds = DialogueDataset("test", root, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id)
    return ds, st


class _GreedyGaps:
    """The top-2 logit margin of every full-sort sampling step, per
    ``generate_batch`` call of the runner, and its emotion logits."""

    def __enter__(self):
        from ergm_tpu_torch.infer import generate as gen_mod
        from ergm_tpu_torch.infer import runner

        self.mods = (gen_mod, runner)
        self.real = (gen_mod.top_p_filter, runner.generate_batch)
        self.calls, self.emotion = [], []

        def top_p_filter(probs, top_p):
            top2 = torch.topk(probs, 2, dim=-1).values.double().log()
            self.calls[-1].append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            return self.real[0](probs, top_p)

        def called(params, config, prompts, **kw):
            self.calls.append([])
            outs, emo = self.real[1](params, config, prompts, **kw)
            self.emotion.append(emo)
            return outs, emo
        gen_mod.top_p_filter, runner.generate_batch = top_p_filter, called
        return self

    def __exit__(self, *exc):
        self.mods[0].top_p_filter, self.mods[1].generate_batch = self.real

    def rows(self) -> tuple:
        """([rows, steps] margins, [rows, emotions] logits)."""
        return (np.concatenate([np.stack(c, axis=1) for c in self.calls]),
                np.concatenate(self.emotion))


def _pipe_runner(card: str, params, cfg) -> dict:
    """``run_test`` at gpt2 full width, bf16, over 5 batches of 64 with 32
    new tokens at top-p 0.8 (full sort), then ``Evaluator.evaluate_all``:
    K5 must launch n_layer times and K6 once in each eval step, K1 n_layer
    times (self) in each generate prefill and n_layer times more (cross)
    for each batch carrying captions; a second run holds every K1, K5 and
    K6 launch against its plain version. Then the fp32 identity: a 2-layer
    model of gpt2 width, greedy, on the card and on the CPU. Returns the
    launch counts by kernel."""
    import warnings

    from ergm_tpu_torch.data.dataset import batches
    from ergm_tpu_torch.evaluation.evaluate import Evaluator
    from ergm_tpu_torch.infer.runner import run_test
    from ergm_tpu_torch.train.steps import batch_to_device, make_eval_step

    with tempfile.TemporaryDirectory() as root:
        ds, st = _pipe_split(root, PIPE_DIALOGUES, 11)
    n_batches = -(-len(ds) // PIPE_B)
    prompts = [sum(1 for t in e.input_ids if t != st.eos_id) for e in ds.examples]
    if len(ds) != n_batches * PIPE_B or max(prompts) > 128:
        raise AssertionError(f"runner split: {len(ds)} examples, prompts up to {max(prompts)}")
    kw = dict(batch_size=PIPE_B, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=cfg.n_positions,
              top_p=0.8, max_new_tokens=PIPE_NEW, sampler="full_sort", seed=0)
    reset_launches()
    t0 = time.time()
    res = run_test(params, cfg, ds, **kw)
    wall = time.time() - t0
    counts = {**_launch_counts(), **_train_counts()}
    L = cfg.n_layer
    want = {"block_mha": L * n_batches, "fused_softmax_xent": n_batches,
            "prefill_mha": L * n_batches, "prefill_mha_cross": L * n_batches,
            "block_mha_bwd": 0, "fused_softmax_xent_bwd": 0}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"run_test launches {counts}, want {want}")
    if (len(res.hypotheses) != len(ds) or not all(math.isfinite(x) for x in res.losses)
            or len(res.losses) != n_batches):
        raise AssertionError(f"run_test: {len(res.hypotheses)} hypotheses, losses {res.losses}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        metrics = Evaluator().evaluate_all(
            res.hypotheses, res.references, true_label_ids=res.true_labels, losses=res.losses,
            pred_label_ids=res.pred_labels, loss_token_counts=res.loss_tokens)
    if not any("BERTScore SKIPPED" in str(w.message) for w in caught) or not all(
            math.isfinite(v) for v in metrics.values()) or "ppl" not in metrics:
        raise AssertionError(f"evaluate_all: {metrics}")
    eval_step = make_eval_step(cfg)
    batch = batch_to_device(next(batches(ds, PIPE_B, st.eos_id)), DEVICE)
    eval_step(params, batch)
    torch.cuda.synchronize()
    t1 = time.time()
    for _ in range(5):
        eval_step(params, batch)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.time() - t1) / 5
    eval_busy, eval_wall, top = _busy_ms(lambda: eval_step(params, batch))
    print(f"pipeline run_test bf16: {len(ds)} utterances in {wall:.2f} s ({len(ds) / wall:.1f} "
          f"utt/s), {n_batches} batches of {PIPE_B}, {PIPE_NEW} new tokens, eval step "
          f"{eval_ms:.2f} ms a batch of [{PIPE_B}, 128] (host wall); under torch.profiler "
          f"{eval_busy:.3f} ms of device busy time in {eval_wall:.3f} ms of wall (the same "
          f"passes): the device idle {1 - eval_busy / eval_wall:.1%} (most: {top}); launches "
          f"{counts} on {card}")
    print(f"pipeline evaluate_all: " + json.dumps({k: round(v, 6) for k, v in metrics.items()})
          + " (BERTScore skipped: no local model)")
    shadowed = ((prefill_attention, "prefill_mha", _k1_rows),
                (block_attention, "block_mha", _k5_rows), (fused_ce, "fused_softmax_xent", None))
    with KernelShadow(shadowed) as shadow:
        run_test(params, cfg, ds, **kw)
    shares = shadow.shares()
    if not all(v <= 1.0 for v in shares.values()) or shadow.calls["fused_softmax_xent"] != n_batches:
        raise AssertionError(f"run_test shadow: {shares}, {shadow.calls}")
    print(f"pipeline run_test: every K1, K5 and K6 launch within its plain version's bf16 bar: "
          + ", ".join(f"{k} {v:.4f} over {shadow.calls[k]} launches" for k, v in shares.items()))
    _pipe_identity(card)
    return counts


def _pipe_identity(card: str) -> None:
    """``run_test`` in fp32 on a 2-layer model of gpt2 width, greedy
    (top-p 1e-9, full sort), 64 utterances, on the card and on the CPU:
    hypotheses equal up to each row's first step whose top-2 margin (read
    on the card) is 1e-3 or less, losses within 1e-4 relative, emotion
    labels equal where the logits' margin exceeds 1e-3."""
    from ergm_tpu_torch.infer.runner import run_test

    cfg = ModelConfig.from_model_type("gpt2", vocab_size=50271, dtype="float32",
                                      modality_dim=768, n_layer=2)
    cpu = gpt2.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    on_card = copy.deepcopy(cpu).to(DEVICE)
    with tempfile.TemporaryDirectory() as root:
        ds, st = _pipe_split(root, 16, 12)
    kw = dict(batch_size=PIPE_B, eos_id=st.eos_id, sp2_id=st.sp2_id, max_len=cfg.n_positions,
              top_p=1e-9, max_new_tokens=16, sampler="full_sort")
    with _GreedyGaps() as gaps:
        got = run_test(on_card, cfg, ds, **kw)
    t0 = time.time()
    want = run_test(cpu, cfg, ds, **kw)
    cpu_s = time.time() - t0
    margins, emo = gaps.rows()  # one batch of 64
    rel = max(abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses))
    top2 = np.sort(emo, axis=-1)[:, -2:]
    emo_ok = top2[:, 1] - top2[:, 0] > 1e-3
    whole = 0
    for b, (g, w) in enumerate(zip(got.hypotheses, want.hypotheses)):
        close = np.flatnonzero(margins[b] <= 1e-3)
        k = int(close[0]) if len(close) else None
        if g.split()[:k] != w.split()[:k]:
            raise AssertionError(f"fp32 identity row {b}: {g!r} against the CPU's {w!r} "
                                 f"(first close step {k})")
        whole += k is None
    bad = [b for b in np.flatnonzero(emo_ok) if got.pred_labels[b] != want.pred_labels[b]]
    if not rel <= 1e-4 or bad or got.references != want.references:
        raise AssertionError(f"fp32 identity: loss rel {rel}, emotion rows {bad}")
    print(f"pipeline run_test fp32 identity (2 layers, gpt2 width, {len(ds)} utterances, "
          f"16 greedy tokens): card equals CPU in {whole} of {len(ds)} rows whole, the rest up "
          f"to a step decided by 1e-3 or less; losses within {rel:.2e} relative; emotion "
          f"labels equal in {int(emo_ok.sum())} decided rows; the CPU took {cpu_s:.1f} s; "
          f"on {card}")


def _pipe_tokenizer_repl(card: str) -> int:
    """``train_bpe`` on a small corpus with the native merge loop (built from
    cpp/bpe_core.cpp into ergm_tpu_torch/_build/), ``text2ids.main`` over a
    dialogue file, then three turns of ``run_repl`` at gpt2 width (bf16,
    B=1). Returns K5's launches in the REPL."""
    import io

    from ergm_tpu_torch.core.tokens import ADDITIONAL_SPECIAL_TOKENS, SpecialTokens
    from ergm_tpu_torch.infer.interact import run_repl
    from ergm_tpu_torch.tokenizer import bpe, native
    from ergm_tpu_torch.tools import text2ids

    tok = bpe.train_bpe(PIPE_CORPUS * 4, vocab_size=600, special_tokens=ADDITIONAL_SPECIAL_TOKENS)
    if not tok.native_loaded or native.LIB_PATH.parent != _build.BUILD:
        raise AssertionError(f"native BPE not loaded from {_build.BUILD} ({native.LIB_PATH})")
    with tempfile.TemporaryDirectory() as root:
        tok.save(os.path.join(root, "tok"))
        dialogues = [PIPE_CORPUS[i:i + 3] for i in range(0, len(PIPE_CORPUS), 3)]
        with open(os.path.join(root, "test_sent_emo.json"), "w") as f:
            json.dump(dialogues, f)
        text2ids.main([f"--data_dir={root}", "--prefixes=test",
                       f"--tokenizer_dir={os.path.join(root, 'tok')}"])
        with open(os.path.join(root, "test_sent_emo_ids.json")) as f:
            ids = json.load(f)
    if [[tok.decode(u) for u in d] for d in ids] != dialogues:
        raise AssertionError("text2ids: ids do not decode to the dialogues")
    print(f"pipeline tokenizer: train_bpe ({len(tok)} tokens), text2ids over "
          f"{sum(map(len, dialogues))} utterances, native merge loop loaded from {native.LIB_PATH.relative_to(_build.PACKAGE.parent)}")
    vocab = dict(tok.vocab)
    st = SpecialTokens.register(vocab)
    cfg = ModelConfig.from_model_type("gpt2", vocab_size=st.vocab_size, dtype="bfloat16",
                                      modality_dim=768)
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(2), cfg, device=DEVICE), cfg)
    out = io.StringIO()
    lines = PIPE_CORPUS[:3]
    reset_launches()
    t0 = time.time()
    run_repl(params, cfg, st, tok, max_len=cfg.n_positions, top_p=0.9,
             stdin=io.StringIO("\n".join(lines) + "\n\n"), stdout=out)
    wall = time.time() - t0
    text = out.getvalue()
    if text.count("model>") != 3 or "[error" in text:
        raise AssertionError(f"run_repl: {text}")
    k5 = block_attention.LAUNCHES
    print(f"pipeline run_repl: 3 turns at gpt2 width (bf16, B=1, up to 64 tokens a reply) "
          f"in {wall:.2f} s, K5 launched {k5} times, on {card}")
    return k5


def pipeline_phase(card: str) -> dict:
    """The feature-extraction and test-run paths on the card (see phase 13
    of the module docstring). Returns their launches by kernel:
    {kernel: {path: launches}}."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as clips_dir:
        frames, images, have_pil = _pipe_clips(clips_dir)
        if not have_pil:
            print("pipeline: PIL is absent: the vision encoder runs on normalised arrays and "
                  "extract_features.main finds no image files")
        audio_k5, feats = _pipe_audio(card, clips_dir, frames)
        main_k5 = _pipe_extract_main(card, clips_dir, frames, feats, have_pil)
        _pipe_vision(card, images)
    cfg = ModelConfig.from_model_type("gpt2", vocab_size=50271, dtype="bfloat16",
                                      modality_dim=768)
    params = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE),
        cfg)
    text_k5 = _pipe_text(card, params, cfg)
    runner = _pipe_runner(card, params, cfg)
    repl_k5 = _pipe_tokenizer_repl(card)
    print(f"pipeline phase: {time.time() - t0:.1f} s on {card}")
    return {"block_mha": {"audio fp32": audio_k5["fp32"]["block_mha"],
                          "audio bf16": audio_k5["bf16"]["block_mha"],
                          "extract_features.main": main_k5["block_mha"],
                          "text_features": text_k5, "run_test": runner["block_mha"],
                          "run_repl": repl_k5},
            "flash_mha": {"audio fp32": audio_k5["fp32"]["flash_mha"],
                          "audio bf16": audio_k5["bf16"]["flash_mha"],
                          "extract_features.main": main_k5["flash_mha"]},
            "prefill_mha": {"run_test": runner["prefill_mha"]},
            "prefill_mha_cross": {"run_test": runner["prefill_mha_cross"]},
            "fused_softmax_xent": {"run_test": runner["fused_softmax_xent"]}}


# ---------------------------------------------------------------------------
# The command line (cli_phase): load_data -> train -> infer -> serve -> convert
# ---------------------------------------------------------------------------

# gpt2-medium at full width and CLI_LAYERS of its 24 layers (the depth cut
# that keeps the script near 850 s with the large family's phase, which
# runs the same CLI at gpt2-large's and gpt2-xl's full depth) through the
# port's CLI with train_torch.sh's flags (B=8, --max_len=1024, lr 1e-5, no warmup, bf16,
# remat "mlp"). The train split: utterances of 8-40 tokens over 16 turns with
# captions (16 dialogues: 256 examples, 32 steps an epoch, the longest batch
# bucketed to 512; 24 dialogues before the cut that keeps the script within
# half its time limit); the valid split:
# the default 3-8 tokens over 4 turns. Infer: the first CLI_INFER_DIALOGUES
# valid dialogues (two batches of 64) capped at CLI_INFER_LEN tokens; serve:
# CLI_SERVE_REQS requests through 64 slots; CLI_SHADOW_DIALOGUES dialogues for
# the shadowed training run; CLI_REMAT_STEPS timed steps a remat policy
CLI_MODEL, CLI_B, CLI_TRAIN_DIALOGUES, CLI_TRAIN_TURNS = "gpt2-medium", 8, 16, 16
CLI_VALID_DIALOGUES, CLI_VALID_TURNS, CLI_INFER_DIALOGUES, CLI_INFER_LEN = 32, 4, 32, 128
CLI_SERVE_REQS, CLI_SHADOW_DIALOGUES, CLI_REMAT_STEPS, CLI_LAYERS = 64, 2, 3, 12


@contextlib.contextmanager
def _depth(model: str, n_layer: int):
    """``model``'s preset at ``n_layer`` layers for the duration: the
    command line builds its config from the preset."""
    from ergm_tpu_torch.core import config

    saved = config.GPT2_SIZES[model]
    config.GPT2_SIZES[model] = {**saved, "n_layer": n_layer}
    try:
        yield
    finally:
        config.GPT2_SIZES[model] = saved
# K5 and K6 forwards (with KernelShadow.BACKWARD, the training
# launches) and K1 (infer's prefills)
TRAIN_SHADOWED = ((block_attention, "block_mha", _k5_rows),
                  (fused_ce, "fused_softmax_xent", None))
INFER_SHADOWED = ((prefill_attention, "prefill_mha", _k1_rows),) + TRAIN_SHADOWED
# and K7's (runs with shapes past JAX's block gate)
K7_SHADOWED = TRAIN_SHADOWED + ((flash_attention, "flash_mha", _k5_rows,
                                 flash_attention.kernel_reference),)


def _cli(main, argv: list) -> str:
    """Runs a CLI entry point in this process; its standard output is
    shown and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    print(buf.getvalue(), end="")
    return buf.getvalue()


def _cli_data(root: str) -> tuple:
    """load_data once through the CLI, then both splits at GPT-2's
    vocabulary over one set of special tokens. Returns (data dir, tokens)."""
    from ergm_tpu_torch.cli import load_data

    _cli(load_data.main, ["--source=synthetic", f"--data_dir={root}",
                          f"--model_type={CLI_MODEL}", "--captions"])
    data = os.path.join(root, CLI_MODEL)
    if not os.path.exists(os.path.join(data, "tokenizer_meta.json")):
        raise AssertionError(f"load_data wrote nothing under {data}")
    st = write_synthetic_dataset(data, prefixes=("train",), num_dialogues=CLI_TRAIN_DIALOGUES,
                                 turns_per_dialogue=CLI_TRAIN_TURNS, utter_len=range(8, 41),
                                 base_vocab_size=50257, captions="target", seed=21)
    write_synthetic_dataset(data, prefixes=("valid",), num_dialogues=CLI_VALID_DIALOGUES,
                            turns_per_dialogue=CLI_VALID_TURNS, base_vocab_size=50257,
                            captions="target", seed=22, st=st)
    return data, st


def _k5_gate(b: int, h: int, lq: int, lk: int, causal: bool) -> bool:
    q, k = (torch.empty((b, h, n, 64), device="meta") for n in (lq, lk))
    return block_attention.supported(q, k, k, causal=causal)


def _cli_train_expected(data: str, st, cfg, limit=None, b: int = CLI_B,
                        max_len: int = 0) -> dict:
    """K5's and K6's launches in one Trainer epoch of batch ``b``, from their
    gates at the epoch's batch shapes (train shuffled with seed 1, the
    partial batch dropped; valid in order; batches up to ``max_len``
    tokens, by default the model's n_positions): K5 for the causal
    self-attention and, where the batch's caption bucket passes its gate,
    for the caption's cross-attention. Full and dots remat run each
    layer's forward again in the backward, so K5 launches twice a layer
    forward in a train step."""
    from ergm_tpu_torch.data.dataset import DialogueDataset, batches

    max_len = max_len or cfg.n_positions
    kw = dict(data_dir=data, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id,
              max_len=max_len, limit=limit)
    train = list(batches(DialogueDataset("train", **kw), b, st.eos_id, shuffle=True,
                         seed=1, max_len=max_len, drop_remainder=True))
    valid = list(batches(DialogueDataset("valid", **kw), b, st.eos_id, max_len=max_len))

    def k5(bs):
        n = 0
        for x in bs:
            L = x.input_ids.shape[1]
            n += cfg.n_layer * _k5_gate(b, cfg.n_head, L, L, True)
            if x.caption_ids is not None:
                n += cfg.n_layer * _k5_gate(b, cfg.n_head, L, x.caption_ids.shape[1], False)
        return n
    again = 2 if cfg.remat and cfg.remat_policy in ("full", "dots") else 1
    return {"steps": len(train), "valid_batches": len(valid), "valid_k5": k5(valid),
            "longest": max((x.input_ids.shape[1] for x in train), default=0), "k5_again": again,
            "want": {"block_mha": again * k5(train) + k5(valid), "block_mha_bwd": k5(train),
                     "fused_softmax_xent": len(train) + len(valid),
                     "fused_softmax_xent_bwd": len(train)}}


def _cli_train(card: str, label: str, argv: list, exp: dict, model: str = CLI_MODEL,
               b: int = CLI_B) -> dict:
    """One train_torch.sh run through ``cli.main``: checks the launches
    against the gates and returns the epoch line's readings."""
    from ergm_tpu_torch.cli import main as cli

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    text = _cli(cli.main, argv)
    wall = time.time() - t0
    counts = _train_counts()
    if counts != exp["want"]:
        raise AssertionError(f"cli train {label}: launches {counts}, want {exp['want']}")
    m = re.search(r"Epoch 1: Train Loss: ([0-9.]+).*?\| ([0-9,.]+) tok/s \| step p50 (\d+) ms"
                  r"(?: \| MFU ([0-9.]+)%)?", text)
    v = re.search(r"Valid PPL: ([0-9.]+)", text)
    if (m is None or v is None or not math.isfinite(float(m.group(1)))
            or (m.group(4) is None and DEVICE == "cuda")):
        raise AssertionError(f"cli train {label}: no epoch line with tok/s, step p50 and MFU")
    peak = torch.cuda.max_memory_allocated() / 1e9
    n, nv = exp["steps"], exp["valid_batches"]
    per_step = {"block_mha": (counts["block_mha"] - exp["valid_k5"]) / n,
                "block_mha_bwd": counts["block_mha_bwd"] / n,
                "fused_softmax_xent": (counts["fused_softmax_xent"] - nv) / n,
                "fused_softmax_xent_bwd": counts["fused_softmax_xent_bwd"] / n}
    print(f"cli train, {label}: {model} B={b}, {n} steps, batches up to "
          f"{exp['longest']} tokens: {m.group(2)} tok/s, step p50 {m.group(3)} ms, MFU "
          f"{m.group(4)}% of 989 TFLOP/s (the Trainer's epoch line), valid PPL {v.group(1)}, "
          f"peak memory {peak:.2f} GB, {wall:.1f} s for the call; launches a step {per_step} "
          f"(and over {nv} valid batches K5 {exp['valid_k5']}, K6 {nv}) on {card}")
    return {"tok_s": float(m.group(2).replace(",", "")), "step_p50_ms": float(m.group(3)),
            "mfu_pct": float(m.group(4) or "nan"), "peak_gb": peak, "launches": counts,
            "train_loss": float(m.group(1)), "s": wall}


def _cli_remat(card: str, cfg, data: str, st) -> dict:
    """One train step of gpt2-medium under remat none, mlp, full and dots from
    the same parameters, batch (the train split's longest bucket) and seed:
    the losses equal bit for bit, the gradients within the bf16 bar of
    no-remat's. Then CLI_REMAT_STEPS timed steps, the peak memory at the
    optimizer's entry (the forward and backward) and over the step, and the
    device's busy time in the same profiled steps. Returns {policy: launches
    of the first step}."""
    from ergm_tpu_torch.data.dataset import DialogueDataset, batches
    from ergm_tpu_torch.train.steps import batch_to_device

    ds = DialogueDataset("train", data, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id,
                         max_len=cfg.n_positions)
    batch = max(batches(ds, CLI_B, st.eos_id, max_len=cfg.n_positions, drop_remainder=True),
                key=lambda b: b.input_ids.shape[1])
    L = batch.input_ids.shape[1]
    batch = batch_to_device(batch, DEVICE)
    base = gpt2.init_params(torch.Generator().manual_seed(0), cfg, device=DEVICE)
    launches, ref = {}, None
    for policy in ("none", "mlp", "full", "dots"):
        c = cfg.replace(remat=policy != "none", remat_policy="mlp" if policy == "none" else policy)
        tx, seen = AdamW(1e-5), {}

        def first_update(params, g, state, _tx=tx, _seen=seen):
            _seen["grads"] = [x.clone() for x in g]
            del _tx.update  # the class's method from here on
            return _tx.update(params, g, state)
        tx.update = first_update
        state = create_train_state(copy.deepcopy(base), tx)
        step = make_train_step(c, tx, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_launches()
        state, m = step(state, batch, SEED)
        loss, grads = float(m["loss"]), seen.pop("grads")
        counts = _train_counts()
        k5 = c.n_layer * (2 if policy in ("full", "dots") else 1)
        want = {"block_mha": k5, "block_mha_bwd": c.n_layer, "fused_softmax_xent": 1,
                "fused_softmax_xent_bwd": 1}
        if counts != want:
            raise AssertionError(f"remat {policy}: launches {counts}, want {want}")
        if ref is None:
            ref = (loss, grads)
        ok = all(_bf16_ok(g, r) for g, r in zip(grads, ref[1]))
        err = max(float((g - r).abs().max()) for g, r in zip(grads, ref[1]))
        if loss != ref[0] or not ok:
            raise AssertionError(f"remat {policy}: loss {loss!r} against {ref[0]!r}, gradients "
                                 f"within the bf16 bar: {ok} (max |diff| {err})")
        del grads  # no-remat's stay in ref, alike for every policy

        def entry_peak(params, g, state, _tx=tx, _seen=seen):
            _seen.setdefault("fwd_bwd", torch.cuda.max_memory_allocated())
            return AdamW.update(_tx, params, g, state)
        tx.update = entry_peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        for _ in range(CLI_REMAT_STEPS):
            state, m = step(state, batch, SEED)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.time() - t0) / CLI_REMAT_STEPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy, wall, top = _busy_ms(lambda: step(state, batch, SEED), calls=CLI_REMAT_STEPS)
        launches[policy] = counts
        print(f"cli remat {policy}: {CLI_MODEL} B={CLI_B} L={L} bf16, loss {loss!r} (equal to "
              f"no remat's), gradients within the bf16 bar (max |diff| {err:.3e}), step "
              f"{step_ms:.1f} ms (mean of {CLI_REMAT_STEPS}), peak memory "
              f"{seen['fwd_bwd'] / 1e9:.2f} GB at the optimizer's entry and {peak:.2f} GB over "
              f"the step; under torch.profiler {busy:.1f} ms of device busy time in {wall:.1f} "
              f"ms of wall (idle {1 - busy / wall:.1%}; most: {top}); launches {counts} on "
              f"{card}")
        del state, step
    return launches


def _cli_infer_expected(data: str, st, cfg) -> dict:
    """K1's (self and cross), K5's and K6's launches of ``--mode=infer``,
    from their gates at the run's shapes: per batch of 64 the eval step (K5
    a layer at the 128-bucket, K6 once), then generate's prefill at the
    prompts' 64-bucket (K1 self at <= 128 with B >= 64, else K5 inside its
    gate) and the caption's 32-bucket (K1 cross)."""
    from ergm_tpu_torch.data.dataset import DialogueDataset, batches
    from ergm_tpu_torch.infer.generate import _bucket

    ds = DialogueDataset("valid", data, sp1_id=st.sp1_id, sp2_id=st.sp2_id, eos_id=st.eos_id,
                         max_len=CLI_INFER_LEN, limit=CLI_INFER_DIALOGUES)
    L, H = cfg.n_layer, cfg.n_head
    want = {"prefill_mha": 0, "prefill_mha_cross": 0, "block_mha": 0, "fused_softmax_xent": 0}
    for b in batches(ds, 64, st.eos_id, max_len=CLI_INFER_LEN):
        rows = np.flatnonzero(b.valid)
        lp = _bucket(max(max(int((b.input_ids[i] != st.eos_id).sum()), 1) for i in rows), 64)
        lc = _bucket(max(int(b.caption_mask[i].sum()) for i in rows), 32)
        k1 = len(rows) >= 64 and lp <= 128 and prefill_attention.supported(len(rows), lp, cfg,
                                                                             True)
        want["prefill_mha"] += L * k1
        want["block_mha"] += L * (not k1 and _k5_gate(len(rows), H, lp, lp, True))
        want["prefill_mha_cross"] += L * (len(rows) >= 64 and lc % 8 == 0 and
                                          prefill_attention.supported(len(rows), lp, cfg, True))
        le = b.input_ids.shape[1]
        want["block_mha"] += L * _k5_gate(64, H, le, le, True)
        want["fused_softmax_xent"] += 1
    return {"utterances": len(ds), "want": want}


def _cli_infer(card: str, argv: list, exp: dict, data: str) -> dict:
    """``--mode=infer`` through ``cli.main``: launches against the gates, the
    results and generations files; then ``run_test`` again on the same
    weights and dataset holds every K1, K5 and K6 launch against its plain
    version."""
    from ergm_tpu_torch.cli import main as cli
    from ergm_tpu_torch.infer import runner

    seen = {}
    real = runner.run_test

    def run_test(*args, **kwargs):
        t0 = time.time()
        res = real(*args, **kwargs)
        seen["s"], seen["tokens"] = time.time() - t0, sum(len(h.split()) for h in res.hypotheses)
        seen["counts"] = {**_launch_counts(), **_train_counts()}
        with KernelShadow(INFER_SHADOWED) as shadow:
            real(*args, **kwargs)
        seen["shadow"] = shadow
        return res
    runner.run_test = run_test
    try:
        reset_launches()
        _cli(cli.main, argv)
    finally:
        runner.run_test = real
    counts = seen["counts"]
    got = {k: counts[k] for k in exp["want"]}
    if got != exp["want"] or counts["block_mha_bwd"] or counts["fused_softmax_xent_bwd"]:
        raise AssertionError(f"cli infer: launches {counts}, want {exp['want']}")
    results = os.path.join(data, "best_evaluation_results.txt")
    gens = os.path.join(data, "best_generations.txt")
    rows = dict(line.split(": ", 1) for line in open(results).read().splitlines())
    if (not math.isfinite(float(rows["ppl"])) or rows["top_p"] != "0.8"
            or open(gens).read().count("GPT-2:") != exp["utterances"]):
        raise AssertionError(f"cli infer: results {rows}")
    utt_s = exp["utterances"] / seen["s"]
    print(f"cli infer: {exp['utterances']} utterances at B=64, top-p 0.8 (full sort), "
          f"{CLI_INFER_LEN}-token cap: run_test {seen['s']:.2f} s ({utt_s:.1f} utt/s, "
          f"{seen['tokens']} tokens generated), PPL {rows['ppl']}, emotion acc "
          f"{rows['emotion_acc']}; launches {got} on {card}")
    shadow, w = seen["shadow"], exp["want"]
    shares = shadow.shares()
    calls = {"prefill_mha": w["prefill_mha"] + w["prefill_mha_cross"],
             "block_mha": w["block_mha"], "fused_softmax_xent": w["fused_softmax_xent"]}
    if not all(v <= 1.0 for v in shares.values()) or shadow.calls != calls:
        raise AssertionError(f"cli infer shadow: {shares}, {shadow.calls}, want {calls}")
    print("cli infer: every K1, K5 and K6 launch within its plain version's bf16 bar: "
          + ", ".join(f"{k} {v:.4f} over {shadow.calls[k]} launches" for k, v in shares.items()))
    return {"utt_s": utt_s, "launches": got}


def _cli_serve(card: str, root: str, argv: list, n_layer: int) -> dict:
    """``--mode=serve`` over a requests file of CLI_SERVE_REQS requests: half
    greedy, half sampled (every fourth with its own top-p and seed), a
    caption on every third; every response line present. The weights are
    the seeded init (no checkpoint), which seldom picks eos, so the decode
    loop runs: at least 90% of the budgeted tokens must come back. The 64
    requests fill the 64 slots as one admission group whose prompts (16-64
    tokens) bucket inside K1's gate and which holds captions: K1 self and
    cross launch once a layer, nothing else. A second run holds each of
    those launches against its plain version."""
    from ergm_tpu_torch.cli import main as cli

    rng = np.random.default_rng(23)
    path = os.path.join(root, "requests.jsonl")
    budgets = []
    with open(path, "w") as f:
        for i in range(CLI_SERVE_REQS):
            r = {"prompt": rng.integers(0, 50000, int(rng.integers(16, 65))).tolist(),
                 "max_new_tokens": int(rng.integers(8, 33)), "greedy": i % 2 == 0}
            if i % 4 == 1:
                r.update(top_p=0.9, seed=i)
            if i % 3 == 0:
                r["caption_ids"] = rng.integers(0, 50000, int(rng.integers(8, 33))).tolist()
            budgets.append(r["max_new_tokens"])
            f.write(json.dumps(r) + "\n")
    reset_launches()
    text = _cli(cli.main, [*argv, f"--requests_file={path}"])
    counts = _launch_counts()
    out = [json.loads(line) for line in open(path + ".responses.jsonl")]
    tokens = sum(len(r.get("tokens", ())) for r in out)
    if [r["index"] for r in out] != list(range(CLI_SERVE_REQS)) or any(
            "error" in r or not 1 <= len(r["tokens"]) <= b for r, b in zip(out, budgets)):
        raise AssertionError(f"cli serve: responses {out[:3]}")
    if tokens < 0.9 * sum(budgets):
        raise AssertionError(f"cli serve: {tokens} tokens generated of {sum(budgets)} budgeted")
    got = {k: v for k, v in counts.items() if v}
    if got != {"prefill_mha": n_layer, "prefill_mha_cross": n_layer}:
        raise AssertionError(f"cli serve: launches {counts}, want K1 self and cross {n_layer}")
    m = re.search(r"Served \d+ requests in ([0-9.]+)s \(([0-9.]+) req/s\)", text)
    print(f"cli serve: {CLI_SERVE_REQS} requests (16-64 + 8-32 tokens, half sampled, captions "
          f"on a third) through 64 slots: {m.group(2)} req/s ({m.group(1)} s), {tokens} tokens "
          f"generated of {sum(budgets)} budgeted (eos ends a row); launches {got} on {card}")
    with KernelShadow(KernelShadow.SERVER) as shadow:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([*argv, f"--requests_file={path}"])
    shares = shadow.shares()
    calls = {"prefill_mha": 2 * n_layer, "block_mha": 0, "fused_ln_mlp": 0}
    if not all(v <= 1.0 for v in shares.values()) or shadow.calls != calls:
        raise AssertionError(f"cli serve shadow: {shares}, {shadow.calls}, want {calls}")
    print(f"cli serve: every K1 launch within its plain version's bf16 bar: prefill_mha "
          f"{shares['prefill_mha']:.4f} over {shadow.calls['prefill_mha']} launches (self and "
          f"cross)")
    return {"req_s": float(m.group(2)), "launches": counts}


def _cli_convert(card: str, root: str, best: str, cfg) -> None:
    """``convert_ckpt --reverse`` of the trained checkpoint, then
    ``convert_ckpt`` back: the parameters equal bit for bit, and so do the
    fp32 logits of the two models on the card."""
    from ergm_tpu_torch.cli import convert_ckpt

    hf, back = os.path.join(root, "hf.pt"), os.path.join(root, "params.pt")
    t0 = time.time()
    _cli(convert_ckpt.main, ["--reverse", f"--src={best}", f"--dst={hf}",
                             f"--model_type={CLI_MODEL}"])
    _cli(convert_ckpt.main, [f"--src={hf}", f"--dst={back}", f"--model_type={CLI_MODEL}"])
    wall = time.time() - t0
    orig = torch.load(os.path.join(best, ckpt_lib.STATE_FILE), map_location="cpu",
                      weights_only=True)["params"]
    conv = torch.load(back, map_location="cpu", weights_only=True)["params"]
    if orig.keys() != conv.keys() or not all(torch.equal(orig[k], conv[k]) for k in orig):
        raise AssertionError("convert round trip: the parameters changed")
    cfg32 = cfg.replace(dtype="float32")
    ids = torch.as_tensor(np.random.default_rng(24).integers(0, 50000, (2, 64)), device=DEVICE)
    logits = []
    for sd in (orig, conv):
        params = gpt2.GPT2(cfg32, device=DEVICE)
        params.load_state_dict(sd, strict=True)
        with torch.no_grad():
            logits.append(gpt2.forward(params, cfg32, ids).logits)
        del params
    if not torch.equal(*logits):
        raise AssertionError("convert round trip: the fp32 logits changed")
    print(f"cli convert: {CLI_MODEL} checkpoint -> HF state dict -> params in {wall:.1f} s, "
          f"{len(orig)} tensors equal bit for bit, fp32 logits [2, 64, {logits[0].shape[-1]}] "
          f"equal on {card}")


def cli_phase(card: str) -> dict:
    """load_data -> train (two recipes, then a shadowed run) -> remat
    policies -> infer -> serve -> convert through the port's CLI at
    gpt2-medium's full width and CLI_LAYERS layers (phase 14 of the module
    docstring). Returns {kernel: {path: launches}}."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root, _depth(CLI_MODEL, CLI_LAYERS):
        data, st = _cli_data(root)
        cfg = ModelConfig.from_model_type(CLI_MODEL, vocab_size=st.vocab_size, dtype="bfloat16")
        exp = _cli_train_expected(data, st, cfg)
        if exp["longest"] < 512 or exp["steps"] < 32:
            raise AssertionError(f"cli data: {exp}")
        train_sh = ["--mode=train", "--seed=0", f"--data_dir={root}", "--train_prefix=train",
                    "--valid_prefix=valid", f"--model_type={CLI_MODEL}", "--lr=1e-5",
                    "--warmup_ratio=0.0", f"--batch_size={CLI_B}", "--num_epochs=1",
                    "--max_len=1024", "--dtype=bfloat16", f"--output_dir={root}/out"]
        ref = _cli_train(card, "reference recipe (remat mlp)",
                         [*train_sh, f"--ckpt_dir={root}/ckpt", "--num_workers=0"], exp)
        jax_recipe = _cli_train(
            card, "the JAX help's gpt2-medium recipe (bf16 first moment, 2 micro-batches an "
            "update, 2 loader workers)", [*train_sh, f"--ckpt_dir={root}/ckpt2",
                                          "--adam_mu_dtype=bfloat16", "--grad_accum_steps=2",
                                          "--num_workers=2"], exp)
        shutil.rmtree(os.path.join(root, "ckpt2"))
        shadow_exp = _cli_train_expected(data, st, cfg, limit=CLI_SHADOW_DIALOGUES)
        from ergm_tpu_torch.cli import main as cli
        with KernelShadow(TRAIN_SHADOWED, KernelShadow.BACKWARD) as shadow:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main([*train_sh, f"--ckpt_dir={root}/ckpt3",
                          f"--limit={CLI_SHADOW_DIALOGUES}"])
        shutil.rmtree(os.path.join(root, "ckpt3"))
        shares = shadow.shares()
        if not all(v <= 1.0 for v in shares.values()) or shadow.calls != shadow_exp["want"]:
            raise AssertionError(f"cli train shadow: {shares}, {shadow.calls}, want "
                                 f"{shadow_exp['want']}")
        kernel, jax_arith = shadow.readings["block_mha_bwd"]
        print(f"cli train (reference recipe, {CLI_SHADOW_DIALOGUES} dialogues, "
              f"{shadow_exp['steps']} steps): every K5 and K6 launch, forward and backward, "
              f"within its plain version's bar (outputs: share of 2e-2 + 1e-2 |plain|; "
              f"gradients: bf16_grad_ratio against JAX's backward arithmetic): " + ", ".join(
                  f"{k} {v:.4f} over {shadow.calls[k]} launches" for k, v in shares.items())
              + f"; K5's gradients against the autograd of its plain forward: {kernel:.4f}, "
              f"JAX's arithmetic itself {jax_arith:.4f}, on {card}")
        remat = _cli_remat(card, cfg, data, st)
        best = ckpt_lib.find_checkpoint(os.path.join(root, "ckpt", CLI_MODEL))
        serving = [f"--data_dir={root}", f"--model_type={CLI_MODEL}", "--batch_size=64",
                   f"--max_len={CLI_INFER_LEN}", "--top_p=0.8", "--dtype=bfloat16", "--seed=0"]
        infer = _cli_infer(card, ["--mode=infer", "--valid_prefix=valid", "--max_turns=35",
                                  f"--limit={CLI_INFER_DIALOGUES}", f"--ckpt_dir={root}/ckpt",
                                  "--ckpt_name=best", *serving],
                           _cli_infer_expected(data, st, cfg), data)
        serve = _cli_serve(card, root, ["--mode=serve", *serving], cfg.n_layer)
        _cli_convert(card, root, best, cfg)
    readings = {"train reference": {k: v for k, v in ref.items() if k != "launches"},
                "train JAX recipe": {k: v for k, v in jax_recipe.items() if k != "launches"},
                "infer utt/s": infer["utt_s"], "serve req/s": serve["req_s"]}
    print(f"cli phase: {time.time() - t0:.1f} s on {card}; {json.dumps(readings)}")
    paths = {"train reference": ref["launches"], "train JAX recipe": jax_recipe["launches"],
             **{f"remat {p}": c for p, c in remat.items()}, "infer": infer["launches"],
             "serve": serve["launches"]}
    kernels = ("prefill_mha", "prefill_mha_cross", "block_mha", "block_mha_bwd",
               "fused_softmax_xent", "fused_softmax_xent_bwd")
    return {k: {p: c[k] for p, c in paths.items() if k in c} for k in kernels}


# parallel_phase: (a) the CLI's training in a world of every card (NCCL),
# PAR_DIALOGUES train dialogues at CLI_B rows = PAR_STEPS steps; (b) two
# processes sharing card 0 over gloo, gpt2 at full width, PAR_B x PAR_L,
# PAR_GLOO_STEPS steps a case; (c) profiling around one bf16 train step
PAR_DIALOGUES, PAR_STEPS, PAR_B, PAR_L, PAR_GLOO_STEPS = 4, 8, 16, 128, 4


@contextlib.contextmanager
def _launcher_env(world: int, rank: int, port: int):
    """torchrun's variables for this process for the duration."""
    env = dict(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _StepLosses:
    """Records every train step's loss (device tensors, read after the run)
    and the calls of ``fused_lm_loss_sharded``."""

    def __enter__(self):
        from ergm_tpu_torch.train import trainer

        self.trainer, self.real = trainer, (trainer.make_train_step, fused_ce.fused_lm_loss_sharded)
        self.losses, self.sharded = [], 0

        def make(*args, **kwargs):
            step = self.real[0](*args, **kwargs)

            def recorded(state, batch, seed):
                state, m = step(state, batch, seed)
                self.losses.append(m["loss"])
                return state, m
            return recorded

        def sharded(*args, **kwargs):
            self.sharded += 1
            return self.real[1](*args, **kwargs)
        trainer.make_train_step, fused_ce.fused_lm_loss_sharded = make, sharded
        return self

    def __exit__(self, *exc):
        self.trainer.make_train_step, fused_ce.fused_lm_loss_sharded = self.real
        self.losses = [float(x) for x in self.losses]


@contextlib.contextmanager
def _saves_recorded(saves: list):
    """The Trainer's best-checkpoint saves recorded, not written (a
    gpt2-medium checkpoint is 4.3 GB; one run of the phase writes its own)."""
    real = ckpt_lib.save_checkpoint

    def record(ckpt_dir, state, epoch, best_ppl, keep_best=None, mesh=None):
        saves.append((epoch, best_ppl, mesh is not None))
        return os.path.join(ckpt_dir, "not-written")
    ckpt_lib.save_checkpoint = record
    try:
        yield
    finally:
        ckpt_lib.save_checkpoint = real


def _par_cli(argv: list, world: int, shadow=None, write_checkpoint: bool = False) -> dict:
    """One ``cli.main --mode=train`` run, in a world of ``world`` ranks
    (torchrun's variables; 0: one process, no world): the step losses, K5's
    and K6's launches, the sharded loss's calls, the checkpoint saves, the
    output."""
    from ergm_tpu_torch.cli import main as cli

    reset_launches()
    t0 = time.time()
    saves = []
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(_StepLosses())
        if world:
            stack.enter_context(_launcher_env(world, 0, _free_port()))
        if shadow is not None:
            stack.enter_context(shadow)
        if not write_checkpoint:
            stack.enter_context(_saves_recorded(saves))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    return {"losses": rec.losses, "counts": _train_counts(), "sharded": rec.sharded,
            "saves": saves, "text": buf.getvalue(), "s": time.time() - t0}


def _par_two_cards(base: list, root: str, card: str) -> None:
    """On a machine with two cards or more: the CLI starts a world of 2
    itself (``--mesh_shape=2``), fp32, dropout 0, default mesh and ZeRO-1;
    its epoch line's loss must equal a world of 1's (printed to 4 places)."""
    base = [*base, "--dtype=float32", "--attn_pdrop=0", "--resid_pdrop=0", "--embd_pdrop=0"]
    want = None
    for label, extra in (("1 card", []), ("2 cards", ["--mesh_shape=2"]),
                         ("2 cards, ZeRO-1", ["--mesh_shape=2", "--shard_opt_state"])):
        out = subprocess.run([sys.executable, "-m", "ergm_tpu_torch.cli.main", *base,
                              f"--ckpt_dir={root}/two_{len(extra)}", *extra],
                             capture_output=True, text=True, timeout=600)
        m = re.search(r"Train Loss: ([0-9.]+)", out.stdout)
        if out.returncode or m is None:
            raise AssertionError(f"parallel, {label}: {out.stderr[-2000:]}")
        want = m.group(1) if want is None else want
        print(f"parallel (a) fp32, {label}: epoch loss {m.group(1)} on {card}")
        if m.group(1) != want:
            raise AssertionError(f"parallel, {label}: epoch loss {m.group(1)}, want {want}")


def _gloo_rank(rank: int, port: int, go) -> dict:
    """One of two processes that share card 0 over a gloo group: probes the
    collectives on CUDA tensors, then each case's PAR_GLOO_STEPS mesh steps
    against the single-process steps (which each rank also runs): the loss
    and this rank's part of every reduced gradient."""
    import torch.distributed as dist

    from ergm_tpu_torch.core.mesh import (batch_rows, make_mesh, shard_opt_state, shard_params,
                                          split_model, zero1_sharding_tree)
    from ergm_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    _build.load()
    info = distributed.initialize(f"127.0.0.1:{port}", 1, 0, local_rank=rank, local_world_size=2,
                                  device=dev, backend="gloo")
    go.wait()  # started early; the card's work waits for (a) to end
    probes = {}
    for name, fn in (("all_reduce", lambda t: dist.all_reduce(t)),
                     ("broadcast", lambda t: dist.broadcast(t, 0)),
                     ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)] * 2, t))):
        try:
            fn(torch.full((4,), float(rank + 1), device=dev))
            probes[name] = "ok"
        except Exception as e:  # noqa: BLE001 - the refusal is the reading
            probes[name] = f"{type(e).__name__}: {str(e)[:160]}"
    out = {"info": info, "probes": probes, "cases": {}}
    cases = (("data=2, sharded K6 loss, ZeRO-1", (2,), ("data",), 0.0, True),
             ("model=2, K5 on 6 heads a rank, dropout 0.1", (1, 2), ("data", "model"), 0.1, False))
    for label, shape, names, drop, zero in cases:
        if zero and probes["all_gather"] != "ok":
            out["cases"][label] = {"skipped": "gloo refused all_gather on CUDA tensors"}
            continue
        cfg = ModelConfig.from_model_type(
            "gpt2", vocab_size=50271, dtype="float32", modality_dim=768, remat=True,
            remat_policy="mlp", attn_pdrop=drop, resid_pdrop=drop, embd_pdrop=drop)
        init = gpt2.init_params(torch.Generator(device=dev).manual_seed(5), cfg, device=dev)
        rng = np.random.default_rng(5)
        batches = [_train_batch(rng, PAR_B, PAR_L, cfg.vocab_size, dev, caption=32)
                   for _ in range(PAR_GLOO_STEPS)]
        runs = {}
        for arm in ("single", "mesh"):
            mesh = make_mesh(shape, names) if arm == "mesh" else None
            params = copy.deepcopy(init)
            if mesh is not None:
                shard_params(params, mesh)
            tx = AdamW(1e-5)
            state = create_train_state(params, tx)
            dims = None
            if mesh is not None and zero:
                dims = zero1_sharding_tree(params, mesh)
                shard_opt_state(state.opt_state, mesh, dims)
            grads, real = [], tx.update

            def update(ps, gs, st, reduce=None, _real=real, _grads=grads):
                _real(ps, gs, st, reduce=reduce)  # gs is reduced in place first
                _grads.append([g.clone() for g in gs])
            tx.update = update
            step = make_train_step(cfg, tx, device=dev, mesh=mesh, opt_shardings=dims)
            lo, hi = batch_rows(PAR_B, mesh)
            reset_launches()
            losses, times = [], []
            for b in batches:
                t = time.time()
                state, m = step(state, {k: v[lo:hi] for k, v in b.items()}, 0)
                losses.append(float(m["loss"]))
                times.append(time.time() - t)
            runs[arm] = (losses, grads, _train_counts(), times, mesh, params)
        (ref, ref_g, _, ref_s, *_), (got, got_g, counts, times, mesh, params) = (
            runs["single"], runs["mesh"])
        names_ = [n for n, _ in params.named_parameters()]
        gerr = max(float((g - split_model(n, r, cfg, mesh)).abs().max())
                   for gs, rs in zip(got_g, ref_g) for n, g, r in zip(names_, gs, rs))
        out["cases"][label] = {
            "loss_err": max(abs(a - b) for a, b in zip(ref, got)), "grad_err": gerr,
            "losses": got, "launches": counts, "step_s": times, "single_s": ref_s}
    distributed.shutdown()
    return out


def _gloo_worker(rank: int, port: int, queue, go) -> None:
    import traceback

    try:
        queue.put((rank, _gloo_rank(rank, port, go)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _par_profile(card: str) -> None:
    """(c): ``capture`` around one bf16 train step of gpt2 (the training
    configuration at B=8, L=128) must write a trace holding the
    ``annotate`` region and K5's and K6's kernels; ``StepTimer`` over 6
    steps; ``start_server``'s endpoint records a trace while this thread
    launches steps, and the kernels must be in it."""
    from ergm_tpu_torch.utils.profiling import (StepTimer, annotate, capture, start_server,
                                                trace_files)

    cfg = ModelConfig.from_model_type(**TRAIN_SLICE)
    params = gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE)
    tx = AdamW(1e-5)
    state, step = create_train_state(params, tx), make_train_step(cfg, tx, device=DEVICE)
    batch = _train_batch(np.random.default_rng(0), 8, 128, cfg.vocab_size, DEVICE, caption=32)
    state, m = step(state, batch, 0)
    float(m["loss"])
    with tempfile.TemporaryDirectory() as logdir:
        with capture(logdir):
            with annotate("ergm.train_step"):
                state, m = step(state, batch, 0)
                float(m["loss"])
        files = trace_files(logdir)
        text = open(files[-1]).read() if files else ""
        found = {k: k in text for k in ("ergm.train_step", "ergm_block", "ergm_xent")}
        print(f"profiling: capture wrote {len(files)} trace ({len(text) / 1e6:.1f} MB); "
              f"holds {found}")
        if not files or not all(found.values()):
            raise AssertionError(f"profiling: the trace lacks {found}")
        timer = StepTimer()
        for _ in range(6):
            with timer.step(fetch=lambda: m["loss"]):
                state, m = step(state, batch, 0)
        print(f"profiling: StepTimer over 6 bf16 gpt2 steps (B=8, L=128) {timer.summary()} "
              f"on {card}")
        srv = start_server(0, logdir)
        port = srv.server_address[1]
        got = {}
        client = threading.Thread(target=lambda: got.update(json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/capture?duration_ms=1500&logdir={logdir}/server",
            timeout=60).read())))
        client.start()
        t0 = time.time()
        while client.is_alive() and time.time() - t0 < 60:  # this thread launches the steps
            state, m = step(state, batch, 0)
            float(m["loss"])
        client.join()
        srv.shutdown()
        srv.server_close()
        text = open(got["trace"]).read() if got.get("trace") else ""
        seen = {k: k in text for k in ("ergm_block", "ergm_xent")}
        print(f"profiling: start_server's endpoint recorded {got.get('events')} events over "
              f"1,500 ms from its own thread while the main thread launched steps; kernels in "
              f"its trace: {seen}")
        if not all(seen.values()):
            raise AssertionError(f"profiling: the endpoint's trace lacks {seen}")


def parallel_phase(card: str) -> dict:
    """Multi-device training (phase 15 of the module docstring): (a) the
    CLI's gpt2-medium training in a world of every card over NCCL, fp32
    and bf16, default mesh and ZeRO-1, against the plain Trainer; (b) data=2
    with the sharded K6 loss and ZeRO-1, and model=2 with dropout, in two
    processes sharing card 0 over gloo, against one process; (c) the
    profiling utilities. Returns {kernel: {path: launches a step}}."""
    import multiprocessing

    t0 = time.time()
    cards = torch.cuda.device_count()
    launches = {}
    # (b)'s two processes import, build and join their group while (a) runs
    ctx = multiprocessing.get_context("spawn")
    queue, port, go = ctx.Queue(), _free_port(), ctx.Event()
    procs = [ctx.Process(target=_gloo_worker, args=(r, port, queue, go)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        launches = _par_nccl(card, cards)
        go.set()
        results = {}
        for _ in procs:
            rank, res = queue.get(timeout=600)
            results[rank] = res
    finally:
        go.set()
        for p in procs:
            p.join(30)
            if p.exitcode is None:
                p.kill()
    for rank, res in sorted(results.items()):
        if "error" in res:
            raise AssertionError(f"gloo rank {rank}: {res['error']}")
    launches.update(_par_gloo_readings(results))
    _par_profile(card)
    print(f"parallel phase: {time.time() - t0:.1f} s on {card}")
    kernels = ("block_mha", "block_mha_bwd", "fused_softmax_xent", "fused_softmax_xent_bwd")
    return {k: {p: c[k] for p, c in launches.items()} for k in kernels}


def _par_nccl(card: str, cards: int) -> dict:
    """(a): the CLI's training in a one-rank NCCL world against the plain
    Trainer (and, with two cards or more, the CLI's own world of 2).
    Returns {path: launches a step}."""
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        data, st = _cli_data(root)
        cfg = ModelConfig.from_model_type(CLI_MODEL, vocab_size=st.vocab_size)
        exp = _cli_train_expected(data, st, cfg, limit=PAR_DIALOGUES)
        if exp["steps"] != PAR_STEPS:
            raise AssertionError(f"parallel data: {exp['steps']} steps, want {PAR_STEPS}")
        base = ["--mode=train", "--seed=0", f"--data_dir={root}", "--train_prefix=train",
                "--valid_prefix=valid", f"--model_type={CLI_MODEL}", "--lr=1e-5",
                "--warmup_ratio=0.0", f"--batch_size={CLI_B}", "--num_epochs=1",
                "--max_len=1024", "--output_dir=", f"--limit={PAR_DIALOGUES}"]
        runs = {}
        shadow_exp = _cli_train_expected(data, st, cfg, limit=CLI_SHADOW_DIALOGUES)
        for dtype, label, world, extra in (
                ("float32", "plain Trainer", 0, []),
                ("float32", "world of 1 (NCCL), default mesh", 1, []),
                ("float32", "world of 1 (NCCL), --shard_opt_state", 1, ["--shard_opt_state"]),
                ("bfloat16", "world of 1 (NCCL), default mesh", 1, []),
                ("bfloat16", "world of 1 (NCCL), --shard_opt_state", 1, ["--shard_opt_state"]),
                ("bfloat16", "world of 1 (NCCL), shadowed", 1, ["--shard_opt_state"])):
            # as cli_phase, a shorter run (CLI_SHADOW_DIALOGUES dialogues) holds
            # every K5 and K6 launch, forward and backward, against its plain version
            shadowed = label.endswith("shadowed")
            shadow = KernelShadow(TRAIN_SHADOWED, KernelShadow.BACKWARD) if shadowed else None
            ckpt = f"{root}/par_{len(runs)}"
            argv = [*base, f"--dtype={dtype}", f"--ckpt_dir={ckpt}", *extra]
            if shadowed:
                argv.append(f"--limit={CLI_SHADOW_DIALOGUES}")
            # the fp32 default mesh's run writes its checkpoint (gathered,
            # written by the primary rank); the others record their saves
            writes = dtype == "float32" and label.endswith("default mesh")
            run = _par_cli(argv, world, shadow, write_checkpoint=writes)
            if writes and ckpt_lib.find_checkpoint(os.path.join(ckpt, CLI_MODEL)) is None:
                raise AssertionError(f"parallel {label}: no checkpoint written under {ckpt}")
            if not writes and len(run["saves"]) != 1:
                raise AssertionError(f"parallel {label}: saves {run['saves']}, want one")
            shutil.rmtree(ckpt, ignore_errors=True)
            want = (shadow_exp if shadowed else exp)["want"]
            steps_want = (shadow_exp if shadowed else exp)["steps"]
            if run["counts"] != want or len(run["losses"]) != steps_want:
                raise AssertionError(f"parallel {label} {dtype}: launches {run['counts']} in "
                                     f"{len(run['losses'])} steps, want {want}")
            if world and ("backend nccl" not in run["text"]
                          or run["sharded"] != want["fused_softmax_xent"]):
                raise AssertionError(f"parallel {label}: not NCCL, or K6 not through "
                                     f"fused_lm_loss_sharded ({run['sharded']} calls)")
            if shadow is not None:
                run["shadow"] = shadow.shares()
                if not all(v <= 1.0 for v in run["shadow"].values()):
                    raise AssertionError(f"parallel shadow: {run['shadow']}")
            runs[(dtype, label)] = run
            p50 = re.search(r"step p50 (\d+) ms", run["text"])
            print(f"parallel (a) {dtype}, {label}: {CLI_MODEL} B={CLI_B}, {steps_want} steps, "
                  f"step p50 {p50.group(1) if p50 else '?'} ms (the epoch line), "
                  f"losses {run['losses']}"
                  + (f"; every K5 and K6 launch within its plain version's bar {run['shadow']}"
                     if shadow is not None else "") + f"; {run['s']:.1f} s on {card}")
        plain = runs[("float32", "plain Trainer")]["losses"]
        for (dtype, label), run in runs.items():
            if dtype == "float32" and run["losses"] != plain:  # bit for bit
                raise AssertionError(f"parallel {label}: fp32 losses {run['losses']} differ from "
                                     f"the plain Trainer's {plain}")
        if cards >= 2:
            _par_two_cards(base, root, card)
        one = runs[("bfloat16", "world of 1 (NCCL), default mesh")]["counts"]
        launches["data-parallel step, NCCL world"] = {
            k: (v - {"block_mha": exp["valid_k5"], "fused_softmax_xent": exp["valid_batches"]
                     }.get(k, 0)) / PAR_STEPS for k, v in one.items()}
    print(f"parallel (a): the fp32 losses of the NCCL world (default mesh and ZeRO-1) equal "
          f"the plain Trainer's bit for bit over {PAR_STEPS} steps")
    return launches


def _par_gloo_readings(results: dict) -> dict:
    """(b)'s readings from both ranks, held to their bars. Returns {path:
    launches a step}."""
    launches = {}
    r0 = results[0]
    print(f"parallel (b): gloo on CUDA tensors (two processes, card 0): {r0['probes']}")
    for label in r0["cases"]:
        per = [results[r]["cases"][label] for r in (0, 1)]
        if "skipped" in per[0]:
            print(f"parallel (b) {label}: not run on the card ({per[0]['skipped']}); held on the "
                  f"CPU (tests/test_torch_parallel.py)")
            continue
        lerr = max(c["loss_err"] for c in per)
        gerr = max(c["grad_err"] for c in per)
        print(f"parallel (b) {label}: gpt2 fp32 B={PAR_B} L={PAR_L}, {PAR_GLOO_STEPS} steps "
              f"against one process: loss err {lerr:.3e} (1e-5), gradient err {gerr:.3e} (1e-4); "
              f"launches {per[0]['launches']}; step seconds (a reading of gloo through the host "
              f"on one shared card, not the port's speed) {[round(x, 3) for x in per[0]['step_s']]} "
              f"against one process's {[round(x, 3) for x in per[0]['single_s']]}")
        if not (lerr <= 1e-5 and gerr <= 1e-4):
            raise AssertionError(f"parallel (b) {label}: loss {lerr}, gradients {gerr}")
        launches[f"{label} step, gloo"] = {k: v / PAR_GLOO_STEPS
                                           for k, v in per[0]["launches"].items()}
    return launches


# -- 16. inference over several devices (mesh_infer_phase) ---------------------

# gpt2 at full width and depth over data=2 x model=2: MESH_RANKS processes
# sharing card 0 over gloo (NCCL takes one rank a device). MESH_B prompts of
# MESH_PROMPT tokens and MESH_NEW new ones; the K2 arm buckets them to
# MESH_K2_PROMPT (a cache of MESH_K2_PROMPT + MESH_NEW slots); beam search
# over the first MESH_BEAM_B at MESH_BEAM_W beams; MESH_SRV_REQS server
# requests (budgets cut to MESH_SRV_NEW) through MESH_SRV_SLOTS slots;
# gpt2-xl's head geometry at MESH_XL_LAYERS layers over model=2 (ranks 0
# and 1), MESH_XL_B prompts of MESH_XL_PROMPT tokens
MESH_RANKS, MESH_B, MESH_PROMPT, MESH_NEW = 4, 64, 128, 32
MESH_K2_PROMPT, MESH_BEAM_B, MESH_BEAM_W, MESH_BEAM_NEW = 512, 8, 4, 16
MESH_SRV_REQS, MESH_SRV_SLOTS, MESH_SRV_NEW = 64, 16, 16
MESH_XL_LAYERS, MESH_XL_B, MESH_XL_PROMPT, MESH_XL_NEW = 2, 8, 64, 16
MESH_KW = dict(max_len=MESH_PROMPT + MESH_NEW, eos_id=EOS, sp2_id=SP2, prompt_bucket=64,
               caption_bucket=32, max_new_tokens=MESH_NEW, greedy=True)
# what the mesh's decode path launches, each launch held against its plain
# version: K1 (both forms), K2, and K3's and K4's tensor-parallel forms
MESH_SHADOWED = ((prefill_attention, "prefill_mha", _k1_rows),
                 (decode_attention, "decode_mha_int8", None),
                 (cross_decode, "fused_cross_decode_partial", None),
                 (fused_decode, "fused_ln_mlp_partial", None))


def _tp_counts() -> dict:
    return {"fused_cross_decode_tp": cross_decode.TP_LAUNCHES,
            "fused_ln_mlp_tp": fused_decode.TP_LAUNCHES}


def _mesh_cfg(dtype: str, **kw) -> ModelConfig:
    """The serving slice (int8 KV and cross caches, int8 lm_head) with
    ``decode_fused_mlp`` (K4)."""
    return ModelConfig.from_model_type(**{**SLICE, "dtype": dtype, "decode_fused_mlp": True,
                                          **kw})


def _mesh_params(cfg: ModelConfig, mesh=None, seed: int = 0):
    """The seeded init for inference, whole or this rank's shard."""
    from ergm_tpu_torch.core.mesh import shard_params

    p = gpt2.params_for_inference(
        gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, device=DEVICE),
        cfg)
    return p if mesh is None else shard_params(p, mesh)


def _mesh_requests(b: int = MESH_B, prompt: int = MESH_PROMPT) -> tuple:
    """``b`` prompts of ``prompt`` tokens with sp2 token types, a 32-token
    caption on 3 of 4, image and audio features."""
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 50000, prompt).tolist() for _ in range(b)]
    caps = [None if i % 4 == 3 else rng.integers(0, 50000, CAPTION).tolist() for i in range(b)]
    feats = rng.standard_normal((2, b, 768)).astype(np.float32)
    return prompts, dict(token_types=[[SP2] * prompt] * b, captions=caps, imgs=feats[0],
                         auds=feats[1])


class _Margins:
    """Each row's top-2 logit margin at every ``lm_logits`` call (the
    prefill, then each decode step), recorded on the device."""

    def __enter__(self):
        self.real, self.steps = gpt2.lm_logits, []

        def recorded(params, hidden):
            logits = self.real(params, hidden)
            top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            self.steps.append(top[:, 0] - top[:, 1])
            return logits
        gpt2.lm_logits = recorded
        return self

    def __exit__(self, *exc):
        gpt2.lm_logits = self.real
        self.steps = [m.cpu().numpy() for m in self.steps]


def _margin_rule(label: str, want: list, got: list, margins: list) -> tuple:
    """``got`` must equal ``want`` on each row up to the row's first
    decision whose margin in ``want``'s run is 1e-3 or less (through its
    end with none). Returns (tokens compared, rows equal)."""
    compared = equal = 0
    for b, row in enumerate(want):
        for j, tok in enumerate(row):
            if j >= len(margins) or margins[j][b] <= 1e-3:
                break
            if j >= len(got[b]) or got[b][j] != tok:
                raise AssertionError(f"{label}: row {b} parts at token {j} where the margin is "
                                     f"{margins[j][b]:.3e}")
            compared += 1
        else:
            if got[b] != row:
                raise AssertionError(f"{label}: row {b} differs past its end")
        equal += got[b] == row
    return compared, equal


class _StepTimes(StepCounter):
    """``StepCounter`` that also sums each decode step's wall time (with a
    device sync at its end when ``timed``)."""

    def __init__(self, timed: bool = False):
        self.timed, self.seconds = timed, 0.0

    def __enter__(self):
        super().__enter__()
        counted = gpt2.forward

        def forward(params, config, input_ids, *args, **kwargs):
            step = kwargs.get("cache") is not None and input_ids.shape[1] == 1
            t0 = time.time()
            out = counted(params, config, input_ids, *args, **kwargs)
            if step and self.timed:
                torch.cuda.synchronize()
                self.seconds += time.time() - t0
            return out
        gpt2.forward = forward
        return self


def _mesh_server(params, cfg, mesh, traffic: list, **kw) -> list:
    """``traffic`` through the slot-axis server (rank 0 submits, the others
    follow); each request's tokens, on every rank."""
    srv = ContinuousServer(params, cfg, slots=MESH_SRV_SLOTS, eos_id=EOS, sp2_id=SP2,
                           max_prompt=SRV_PROMPT, prompt_bucket=64, cache_len=SRV_CACHE,
                           caption_len=CAPTION, sync_every=8, cache_grow_step=SRV_GROW,
                           mesh=mesh, **kw)
    rids = ([srv.submit(Request(**r)) for r in traffic] if srv.primary
            else list(range(len(traffic))))
    res = srv.run_until_drained(max_iters=100_000)
    return [res[r].tokens for r in rids]


def _mesh_rank(rank: int, port: int, go, device: str) -> dict:
    """One of MESH_RANKS processes sharing card 0 over gloo: every path of
    inference over data=2 x model=2, each run from launch counts of 0 (see
    ``mesh_infer_phase``)."""
    from ergm_tpu_torch.core.mesh import make_mesh
    from ergm_tpu_torch.parallel import distributed
    from ergm_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.load()
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, local_rank=rank,
                           local_world_size=MESH_RANKS, device=dev, backend="gloo")
    go.wait()  # started early; the card's work waits for the parent's references and (c)
    try:
        mesh = make_mesh((2, 2), ("data", "model"))
        xl_mesh = make_mesh((1, 2), ("data", "model"))  # ranks 0 and 1
        out = {"coords": (mesh.index("data"), mesh.index("model"))}
        prompts, feats = _mesh_requests()

        def run(key, names, call, shadowed=False, timed=False):
            with contextlib.ExitStack() as stack:
                stack.enter_context(switches(*names))
                steps = stack.enter_context(_StepTimes(timed))
                shadow = (stack.enter_context(KernelShadow(MESH_SHADOWED)) if shadowed
                          else None)
                reset_launches()
                decode_attention.LAST_CLUSTER = 0
                torch.cuda.synchronize()
                t0 = time.time()
                res = call()
                torch.cuda.synchronize()
                r = {"s": time.time() - t0, "steps": steps.steps, "step_s": steps.seconds,
                     "counts": {**_launch_counts(), **_tp_counts()},
                     "cluster": decode_attention.LAST_CLUSTER}
            if shadow is not None:
                r["shares"], r["calls"] = shadow.shares(), dict(shadow.calls)
            out[key] = r
            return res

        cfg = _mesh_cfg("float32")
        params = _mesh_params(cfg, mesh)
        res = run("fp32", ("ERGM_CROSS_KERNEL",),
                  lambda: generate_batch(params, cfg, prompts, mesh=mesh, **feats, **MESH_KW))
        out["fp32"]["tokens"], out["fp32"]["emotion"] = res
        del params
        torch.cuda.empty_cache()

        cfg = _mesh_cfg("bfloat16")
        params = _mesh_params(cfg, mesh)
        gen = lambda **kw: generate_batch(params, cfg, prompts, mesh=mesh,  # noqa: E731
                                          **feats, **{**MESH_KW, **kw})
        run("bf16", ("ERGM_CROSS_KERNEL",), gen, shadowed=True)
        run("bf16_timed", ("ERGM_CROSS_KERNEL",), gen, timed=True)
        run("k2", ("ERGM_CROSS_KERNEL", "ERGM_DECODE_KERNEL"),
            lambda: gen(prompt_bucket=MESH_K2_PROMPT, max_len=MESH_K2_PROMPT + MESH_NEW),
            shadowed=True)
        beams = run("beam", ("ERGM_CROSS_KERNEL",), lambda: beam.beam_search_batch(
            params, cfg, prompts[:MESH_BEAM_B], num_beams=MESH_BEAM_W,
            max_len=MESH_PROMPT + MESH_BEAM_NEW, eos_id=EOS, sp2_id=SP2,
            max_new_tokens=MESH_BEAM_NEW, prompt_bucket=64, caption_bucket=32, mesh=mesh,
            **{k: v[:MESH_BEAM_B] for k, v in feats.items()}), shadowed=True)
        out["beam"]["tokens"] = beams[0]
        del params
        torch.cuda.empty_cache()

        # the server: compute-dtype caches (the speculative blocks' and the
        # caption cache's), K1 at admissions, K4's partial form a step
        scfg = _mesh_cfg("bfloat16", kv_cache_dtype="auto", cross_kv_dtype="auto")
        params = _mesh_params(scfg, mesh)
        traffic = [dict(r, max_new_tokens=min(r["max_new_tokens"], MESH_SRV_NEW))
                   for r in _server_traffic(np.random.default_rng(0), MESH_SRV_REQS)]
        served = run("server", (), lambda: _mesh_server(params, scfg, mesh, traffic),
                     shadowed=True)
        out["server"]["tokens"] = served
        served = run("spec", (), lambda: _mesh_server(params, scfg, mesh, traffic,
                                                      spec_gamma=SRV_GAMMA, spec_ngram=SRV_NGRAM))
        out["spec"]["tokens"] = served
        out["budgets"] = [r["max_new_tokens"] for r in traffic]
        del params
        torch.cuda.empty_cache()

        if xl_mesh.coords is not None:  # gpt2-xl's 25 heads over model=2
            xcfg = ModelConfig.from_model_type("gpt2-xl", n_layer=MESH_XL_LAYERS,
                                               vocab_size=50271, dtype="float32",
                                               modality_dim=768)
            xp = _mesh_params(xcfg, xl_mesh)
            xprompts, xfeats = _mesh_requests(MESH_XL_B, MESH_XL_PROMPT)
            out["xl_heads"] = xp.blocks[0].attn.c_attn.kernel.shape[1] // (3 * xcfg.head_dim)
            out["xl"] = generate_batch(xp, xcfg, xprompts, mesh=xl_mesh, **xfeats,
                                       **{**MESH_KW, "max_len": MESH_XL_PROMPT + MESH_XL_NEW,
                                          "max_new_tokens": MESH_XL_NEW})
            del xp
            torch.cuda.empty_cache()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            out["dryrun"] = dryrun_multichip(MESH_RANKS, dev)
        out["dryrun"]["s"] = time.time() - t0
        return out
    finally:
        distributed.shutdown()


def _mesh_worker(rank: int, port: int, queue, go, device: str) -> None:
    import traceback

    try:
        queue.put((rank, _mesh_rank(rank, port, go, device)))
    except BaseException:  # noqa: BLE001 - reported to the parent, then re-raised
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _mesh_references(card: str) -> dict:
    """The parent's one-process runs: the fp32 generate_batch of the mesh's
    first run (with each decision's margin) and the xl geometry's."""
    refs = {}
    cfg = _mesh_cfg("float32")
    params = _mesh_params(cfg)
    prompts, feats = _mesh_requests()
    with switches("ERGM_CROSS_KERNEL"), _Margins() as m:
        refs["fp32"] = generate_batch(params, cfg, prompts, **feats, **MESH_KW)
    refs["fp32_margins"] = m.steps
    del params
    xcfg = ModelConfig.from_model_type("gpt2-xl", n_layer=MESH_XL_LAYERS, vocab_size=50271,
                                       dtype="float32", modality_dim=768)
    xp = _mesh_params(xcfg)
    xprompts, xfeats = _mesh_requests(MESH_XL_B, MESH_XL_PROMPT)
    with _Margins() as m:
        refs["xl"] = generate_batch(xp, xcfg, xprompts, **xfeats,
                                    **{**MESH_KW, "max_len": MESH_XL_PROMPT + MESH_XL_NEW,
                                       "max_new_tokens": MESH_XL_NEW})
    refs["xl_margins"] = m.steps
    del xp
    torch.cuda.empty_cache()
    return refs


def _tp_kernel_numbers(gen: torch.Generator) -> dict:
    """K3's and K4's tensor-parallel forms at the mesh path's shapes (a data
    rank's MESH_B / 2 rows, gpt2's 6 heads and 1,536 MLP columns of model
    rank 0) against their plain versions, bf16: the JSON rows' numbers."""
    from ergm_tpu_torch.core.mesh import make_mesh, split_model

    cfg = _mesh_cfg("bfloat16")
    blk = _random_block(cfg, gen)
    mesh = make_mesh((1, 2), ("data", "model"), world_size=2, rank=0)
    with torch.no_grad():
        for name, p in list(blk.named_parameters()):
            mod, leaf = name.rsplit(".", 1)
            setattr(blk.get_submodule(mod), leaf, torch.nn.Parameter(
                split_model(f"blocks.0.{name}", p.detach(), cfg, mesh).clone(),
                requires_grad=False))
    b, Dl, Fl, D = MESH_B // 2, blk.cross_attn.q_attn.kernel.shape[1], blk.mlp.c_fc.kernel.shape[1], cfg.n_embd
    h = torch.randn((b, 1, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    codes = [torch.randint(-127, 128, (2, b, CAPTION, Dl), generator=gen, device=DEVICE,
                           dtype=torch.int8) for _ in range(2)]
    scales = [0.001 + 0.02 * torch.rand((2, b, CAPTION, Dl // 64), generator=gen,
                                        device=DEVICE) for _ in range(2)]
    clens = torch.randint(1, CAPTION + 1, (b,), generator=gen, device=DEVICE)
    cmask = (torch.arange(CAPTION, device=DEVICE)[None] < clens[:, None]).float()
    stacks = (*codes, *scales)
    cases = {
        "fused_cross_decode_tp": (
            lambda: cross_decode.fused_cross_decode_partial(h, blk, 1, 0.125, stacks, cmask, cfg),
            lambda: cross_decode.fused_cross_decode_partial_reference(h, blk, 1, 0.125, stacks,
                                                                      cmask, cfg),
            bound(_nbytes(h, codes[0][1], codes[1][1], scales[0][1], scales[1][1], cmask,
                          *blk.ln_cross.parameters(), *blk.cross_attn.q_attn.parameters(),
                          blk.cross_attn.c_proj.kernel) + 4 * b * D,
                  2 * 2 * b * D * Dl + 2 * 2 * b * CAPTION * Dl)),
        "fused_ln_mlp_tp": (
            lambda: fused_decode.fused_ln_mlp_partial(h, blk.ln_2, blk.mlp, cfg),
            lambda: fused_decode.fused_ln_mlp_partial_reference(h, blk.ln_2, blk.mlp, cfg),
            bound(_nbytes(h, *blk.ln_2.parameters(), *blk.mlp.c_fc.parameters(),
                          blk.mlp.c_proj.kernel) + 4 * b * D, 2 * 2 * b * D * Fl))}
    res = {}
    for name, (run, plain, bnd) in cases.items():
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if got.dtype != torch.float32 or not _bf16_ok(got, want):
            raise AssertionError(f"{name}: the partial form disagrees with its plain version: "
                                 f"{err}")
        grid = _k4_grid(b, D, Fl) if name == "fused_ln_mlp_tp" else {}
        ms, plain_ms = _timed_pair(name, run, plain)
        res[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                     "library_ms": None, **grid}
        print(f"{name}: {b} rows, {Dl // 64} heads / {Fl} MLP columns of model rank 0, bf16: "
              f"max |kernel - plain| = {err:.3e}; bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']})")
    return res


def _mesh_cli(card: str) -> None:
    """(c): ``cli.main --mode=infer`` and ``--mode=serve`` at gpt2's full
    width and depth (bf16, the seeded init as a checkpoint) in a world of
    one rank over NCCL (torchrun's variables) against the same runs
    without a world: generations and responses equal."""
    from ergm_tpu_torch.cli import main as cli

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "gpt2")
        st = write_synthetic_dataset(data, prefixes=("valid",), num_dialogues=4,
                                     turns_per_dialogue=4, base_vocab_size=50257,
                                     captions="target", seed=22)
        cfg = ModelConfig.from_model_type("gpt2", vocab_size=st.vocab_size)
        params = gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                                  device=DEVICE)
        os.makedirs(os.path.join(root, "ck", "gpt2", "seeded"))
        torch.save({"params": params.state_dict()},
                   os.path.join(root, "ck", "gpt2", "seeded", ckpt_lib.STATE_FILE))
        del params
        base = ["--seed=0", f"--data_dir={root}", "--model_type=gpt2", "--batch_size=16",
                "--max_len=96", f"--ckpt_dir={root}/ck", "--top_p=0.8",
                f"--gpu={'0' if DEVICE == 'cuda' else 'cpu'}"]
        rng = np.random.default_rng(24)
        reqs = os.path.join(root, "requests.jsonl")
        with open(reqs, "w") as f:
            for i in range(16):
                f.write(json.dumps({"prompt": rng.integers(0, 50000, int(rng.integers(16, 65)))
                                    .tolist(), "max_new_tokens": int(rng.integers(8, 17)),
                                    "greedy": True}) + "\n")
        runs = {}
        for label, world in (("no world", False), ("world of 1 (NCCL)", True)):
            with contextlib.ExitStack() as stack:
                if world:
                    stack.enter_context(_launcher_env(1, 0, _free_port()))
                reset_launches()
                t0 = time.time()
                text = _cli(cli.main, ["--mode=infer", "--ckpt_name=seeded", *base])
                gens = open(os.path.join(data, "seeded_generations.txt")).read()
                infer_counts = _launch_counts()
                text += _cli(cli.main, ["--mode=serve", *base, f"--requests_file={reqs}"])
                served = [json.loads(line)["tokens"] for line in open(reqs + ".responses.jsonl")]
            runs[label] = (gens, served, text)
            print(f"mesh (c) cli {label}: --mode=infer over 16 utterances, --mode=serve over 16 "
                  f"requests: {time.time() - t0:.1f} s; infer launches {infer_counts} on {card}")
        (g0, s0, _), (g1, s1, text) = runs.values()
        backend = "nccl" if DEVICE == "cuda" else "gloo"
        if f"backend {backend}" not in text or "world: 1 ranks" not in text:
            raise AssertionError("mesh (c): the world of one is not an NCCL world")
        if g1 != g0 or s1 != s0 or g0.count("GPT-2:") != 16:
            raise AssertionError("mesh (c): the world's generations or responses differ")
    print("mesh (c): in a world of one rank over NCCL the command line's generations and "
          "responses equal those without a world")


def mesh_infer_phase(card: str, gen: torch.Generator) -> dict:
    """Inference over several devices (phase 16 of the module docstring):
    (a) MESH_RANKS processes sharing card 0 over gloo, data=2 x model=2 at
    gpt2's full width and depth: fp32 generate_batch against the parent's
    one process (the margin rule, emotion logits within 1e-4); in bf16
    every K1-K4 launch of every rank held against its plain version and
    counted; the K2 arm; beam search; the slot-axis server, plain and
    speculative; (b) gpt2-xl's head geometry over model=2 (ranks 0 and 1)
    against one process; (c) the command line in a world of one over NCCL;
    (d) ``dryrun_multichip(4)``. Returns {kernel: {path: launches}} and the
    tensor-parallel forms' JSON numbers."""
    import multiprocessing

    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    queue, port, go = ctx.Queue(), _free_port(), ctx.Event()
    device = "cuda:0" if DEVICE == "cuda" else DEVICE
    procs = [ctx.Process(target=_mesh_worker, args=(r, port, queue, go, device))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    try:
        tp = _tp_kernel_numbers(gen)
        refs = _mesh_references(card)
        _mesh_cli(card)  # before the ranks' work, so that no reading of theirs overlaps it
        go.set()
        results = {}
        for _ in procs:
            rank, res = queue.get(timeout=900)
            if "error" in res:
                raise AssertionError(f"mesh rank {rank}: {res['error']}")
            results[rank] = res
    finally:
        go.set()
        for p in procs:
            p.join(60)
            if p.exitcode is None:
                p.kill()
    L = _mesh_cfg("float32").n_layer
    r0 = results[0]
    # (a) the fp32 identity with one process
    compared, equal = _margin_rule("mesh fp32", refs["fp32"][0], r0["fp32"]["tokens"],
                                   refs["fp32_margins"])
    emo = float(np.abs(np.asarray(r0["fp32"]["emotion"]) - refs["fp32"][1]).max())
    if emo > 1e-4:
        raise AssertionError(f"mesh fp32: emotion logits {emo} from one process's")
    print(f"mesh (a) fp32 generate_batch, {MESH_B} prompts of {MESH_PROMPT} + {MESH_NEW} tokens "
          f"over data=2 x model=2 (6 heads a rank): {equal} of {MESH_B} rows equal to one "
          f"process's, {compared} tokens compared under the margin rule; emotion logits within "
          f"{emo:.2e} on {card}")
    for rank, res in sorted(results.items()):
        if res["fp32"]["tokens"] != r0["fp32"]["tokens"]:
            raise AssertionError(f"mesh rank {rank}: its gathered tokens differ from rank 0's")
        for key in ("fp32", "bf16", "bf16_timed", "k2", "beam", "server", "spec"):
            run = res[key]
            n, c = L * run["steps"], run["counts"]
            want = {"fused_cross_decode": n, "fused_cross_decode_tp": n, "fused_ln_mlp": n,
                    "fused_ln_mlp_tp": n}
            if key in ("fp32", "bf16", "bf16_timed"):
                want.update(prefill_mha=L, prefill_mha_cross=L, decode_mha_int8=0, block_mha=0)
            elif key == "k2":
                want.update(decode_mha_int8=n, prefill_mha=0, prefill_mha_cross=L,
                            block_mha=L * _k5_gate(MESH_B // 2, 6, MESH_K2_PROMPT,
                                                   MESH_K2_PROMPT, True))
            elif key == "beam":
                want.update(prefill_mha=0, prefill_mha_cross=0, decode_mha_int8=0)
            else:  # the server: no cross kernel over its compute-dtype caption cache
                want = {"fused_cross_decode": 0, "fused_ln_mlp": n, "fused_ln_mlp_tp": n,
                        "decode_mha_int8": 0}
            if {k: c[k] for k in want} != want or (run["steps"] < 1 and key != "spec"):
                raise AssertionError(f"mesh rank {rank} [{key}]: launches {c} over "
                                     f"{run['steps']} steps, want {want}")
            if "shares" in run and not all(v <= 1.0 for v in run["shares"].values()):
                raise AssertionError(f"mesh rank {rank} [{key}]: a launch outside its plain "
                                     f"version's bar: {run['shares']}")
        worst = max(v for k in ("bf16", "k2", "beam", "server") for v in res[k]["shares"].values())
        shadowed = sum(n for k in ("bf16", "k2", "beam", "server") for n in res[k]["calls"].values())
        print(f"mesh rank {rank} {res['coords']}: launches "
              + "; ".join(f"{k} {({n: v for n, v in res[k]['counts'].items() if v})} over "
                          f"{res[k]['steps']} steps" for k in ("bf16", "k2", "beam", "server",
                                                                "spec"))
              + f"; K2's cluster {res['k2']['cluster']} CTAs a row at {MESH_B // 2} rows x 6 "
              f"heads; {shadowed} shadowed launches, the worst at {worst:.4f} of the bf16 bar; "
              f"a bf16 decode step {1e3 * res['bf16_timed']['step_s'] / max(res['bf16_timed']['steps'], 1):.1f} ms "
              f"of wall time over gloo (a reading: the host carries the collectives and "
              f"{MESH_RANKS} processes share the card)")
    for key, budgets in (("server", r0["budgets"]), ("spec", r0["budgets"])):
        got = r0[key]["tokens"]
        if any(not 1 <= len(t) <= b for t, b in zip(got, budgets)) or sum(map(len, got)) < 0.9 * sum(budgets):
            raise AssertionError(f"mesh [{key}]: {sum(map(len, got))} tokens of {sum(budgets)}")
        if any(results[r][key]["tokens"] != got for r in results):
            raise AssertionError(f"mesh [{key}]: the ranks' results differ")
    same = sum(a == b for a, b in zip(r0["server"]["tokens"], r0["spec"]["tokens"]))
    print(f"mesh (a) server bf16: {MESH_SRV_REQS} requests through {MESH_SRV_SLOTS} slots "
          f"({MESH_SRV_SLOTS // 2} a data rank), {sum(map(len, r0['server']['tokens']))} tokens, "
          f"{r0['server']['s']:.2f} s; speculative blocks {r0['spec']['s']:.2f} s, {same} of "
          f"{MESH_SRV_REQS} requests equal to the plain blocks' (bf16) on {card}")
    # (b) gpt2-xl's 13/12 heads
    heads = sorted(results[r]["xl_heads"] for r in (0, 1))
    compared, equal = _margin_rule("mesh xl", refs["xl"][0], r0["xl"][0], refs["xl_margins"])
    if heads != [12, 13] or results[1]["xl"][0] != r0["xl"][0]:
        raise AssertionError(f"mesh xl: heads {heads}, or the ranks differ")
    print(f"mesh (b) gpt2-xl geometry ({MESH_XL_LAYERS} layers, 25 heads: {heads} over model=2) "
          f"fp32, {MESH_XL_B} prompts of {MESH_XL_PROMPT} + {MESH_XL_NEW}: {equal} of {MESH_XL_B} "
          f"rows equal to one process's, {compared} tokens compared under the margin rule")
    # (d) the dry run
    d = r0["dryrun"]
    if any(results[r]["dryrun"]["loss"] != d["loss"] for r in results):
        raise AssertionError("mesh dryrun: the ranks' losses differ")
    print(f"mesh (d) dryrun_multichip({MESH_RANKS}) on the card over gloo: loss {d['loss']:.4f}, "
          f"mesh {d['mesh']}, decode lengths {d['lengths'][:4]}, xl loss {d['xl_loss']:.4f} "
          f"({d['xl_heads']} heads on rank 0), ZeRO-1 shards {d['zero1_sharded']}; "
          f"{d['s']:.1f} s")
    print(f"mesh phase: {time.time() - t0:.1f} s on {card}")
    launches = {name: {f"mesh {key}, rank 0": r0[key]["counts"][name]
                       for key in ("bf16", "k2", "beam", "server")}
                for name in ("prefill_mha", "prefill_mha_cross", "fused_cross_decode",
                             "fused_ln_mlp", "decode_mha_int8", "fused_cross_decode_tp",
                             "fused_ln_mlp_tp")}
    for name in tp:
        tp[name]["launches"] = r0["bf16"]["counts"][name]
    return {"launches": launches, "tp": tp}


# large_phase: the large GPT-2 family at full width. LARGE gives each
# model's recipe batch (ergm_tpu's README: gpt2-large B=12, gpt2-xl B=4,
# both with full remat and a bf16 first moment) at LARGE_L tokens and
# LARGE_STEPS steps, trained at LARGE_TRAIN_LAYERS layers (cut from 36 and
# 48 so that the script keeps within its time limit with wide_phase; the
# serving arms keep full depth); the serving arms take LARGE_SRV_B prompts of
# LARGE_SRV_PROMPT tokens and LARGE_SRV_NEW new tokens, the long-history
# arm LARGE_LONG_B prompts of LARGE_LONG_PROMPT tokens and as many new ones
# in LARGE_LONG_SLOTS slots
LARGE = {"gpt2-large": 12, "gpt2-xl": 4}
LARGE_TRAIN_LAYERS = {"gpt2-large": 12, "gpt2-xl": 12}
LARGE_L, LARGE_STEPS = 512, 8
LARGE_SRV_B, LARGE_SRV_PROMPT, LARGE_SRV_NEW = 64, 128, 32
LARGE_LONG_B, LARGE_LONG_PROMPT, LARGE_LONG_SLOTS = 16, 384, 512
LARGE_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                             "large_agreement.json")
# K1 (both forms), K3 and K4 on the serving arms; K2 and K5 on the long one
LARGE_SHADOWED = ((prefill_attention, "prefill_mha", _k1_rows),
                  (block_attention, "block_mha", _k5_rows),
                  (cross_decode, "fused_cross_decode", None),
                  (fused_decode, "fused_ln_mlp", None),
                  (decode_attention, "decode_mha_int8", None))


def _large_k6(gen: torch.Generator, model: str, n: int) -> dict:
    """K6 at ``model``'s training shape (n tokens, GPT-2's vocabulary, its
    width) in bf16 and fp32 (``_k6_case``). Returns the numbers of its
    forward and backward rows."""
    return _k6_case(gen, model, ModelConfig.from_model_type(model).n_embd, n, n,
                    SLICE["vocab_size"])


def _k6_case(gen: torch.Generator, label: str, d: int, n: int, n_f32: int, V: int,
             repeat: bool = False) -> dict:
    """K6 at width ``d`` over a vocabulary of ``V`` rows, n tokens in bf16
    and n_f32 in fp32 (TF32 off), logits of std 3: the kernels on operands
    padded to ``padded_width(d)`` (as ``fused_softmax_xent`` runs them)
    against the plain version, NLL within 1e-4 + 1e-4 |plain| (bf16) and
    1e-5 + 1e-5 |plain| (fp32), gradients by ``bf16_grad_ratio`` against the
    plain version in bf16 and in f32 (bf16) and within rtol 1e-4 / atol 1e-5
    (fp32; its plain version in float64, ``_k6_f64``); with
    ``repeat`` the bf16 backward twice, bit for bit; CUDA-event times of
    kernel and plain in turns and the bound at the true ``d``. Returns the
    numbers of its forward and backward rows; the kernels' times are the
    wrapper's, pad copies included."""
    width = fused_ce.padded_width(d)
    res = {k: {"shape": [n, V, d], "library_ms": None} for k in ("fwd", "bwd")}
    for dtype, rows in ((torch.bfloat16, n), (torch.float32, n_f32)):
        h = torch.randn((rows, d), generator=gen, device=DEVICE).to(dtype)
        w = (3.0 / math.sqrt(d) * torch.randn((V, d), generator=gen, device=DEVICE)).to(dtype)
        lbl = torch.randint(0, V, (rows,), generator=gen, device=DEVICE)
        lbl[::4] = -100
        l32 = lbl.to(torch.int32)
        g = torch.where(lbl >= 0, torch.randn((rows,), generator=gen, device=DEVICE), 0.0)
        hp, wp = (F.pad(x, (0, width - d)) for x in (h, w))
        nll, logz = fused_ce.launch_fwd(hp, wp, l32)
        got = [x[:, :d] for x in fused_ce.launch_bwd(hp, wp, l32, logz, g)]
        args = (h, w, lbl, logz, g)
        if dtype == torch.bfloat16:
            with torch.no_grad():
                nll_ref = fused_ce.fused_softmax_xent_reference(h, w, lbl)
            want = _k6_bwd_plain(args, dtype)
        else:
            nll_ref, *want = _k6_f64(h, w, lbl, g)
        torch.cuda.synchronize()
        n_err = (nll - nll_ref).abs().max().item()
        tol = 1e-4 if dtype == torch.bfloat16 else 1e-5
        if not bool(((nll - nll_ref).abs() <= tol + tol * nll_ref.abs()).all()):
            raise AssertionError(f"K6 {label} D={d} {dtype}: NLL disagrees, {n_err:.3e}")
        if dtype == torch.bfloat16:
            _, ratio = _grads_ok(got, want, dtype, None, _k6_bwd_plain(args, torch.float32))
        else:  # JAX's bars: rtol 1e-4, atol 1e-5
            ratio = max(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max().item()
                        for a, b in zip(got, want))
            if not ratio <= 1.0:
                raise AssertionError(f"K6 {label} D={d} fp32: gradients at {ratio:.3f} of the "
                                     f"bar")
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        suffix = "" if dtype == torch.bfloat16 else "_f32"
        res["fwd"][f"max_abs_err{suffix}"] = n_err
        res["bwd"][f"max_abs_err{suffix}"] = max(errs)
        res["bwd"][f"bar_share{suffix}"] = ratio
        print(f"K6 {label} {dtype} N={rows}, V={V}, D={d} (run at {width}): max |kernel - "
              f"plain{' in float64' if dtype == torch.float32 else ''}| NLL {n_err:.3e}, dh "
              f"{errs[0]:.3e}, dW {errs[1]:.3e} ({ratio:.3f} of the gradients' bar)")
        del got, want, nll_ref
        if repeat and dtype == torch.bfloat16:
            first, second = (fused_ce.launch_bwd(hp, wp, l32, logz, g) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"K6 {label} D={d} bf16: two backward runs differ")
            del first, second
            print(f"K6 {label} D={d} bf16: two backward runs are bitwise equal")

        def plain_bwd():
            p = torch.softmax(h.float() @ w.float().t(), dim=-1) * g[:, None]
            ok = lbl >= 0
            p[ok, lbl[ok]] -= g[ok]
            return (p @ w.float()).to(h.dtype), (p.t() @ h.float()).to(w.dtype)

        reps = 5 if dtype == torch.bfloat16 else 2
        # the kernels are timed through the wrapper, as the main path calls
        # them: with its pad copies where D is padded, and the backward's
        # slices of dh and dW
        hg, wg = (x.detach().requires_grad_(True) for x in (h, w))
        loss = fused_ce.fused_softmax_xent(hg, wg, lbl)
        pairs = {"fwd": (lambda: fused_ce.fused_softmax_xent(h, w, lbl),
                         lambda: fused_ce.fused_softmax_xent_reference(h, w, lbl)),
                 "bwd": (lambda: torch.autograd.grad(loss, (hg, wg), g, retain_graph=True),
                         plain_bwd)}
        if width != d:
            pad_ms = _median_ms(lambda: (F.pad(h, (0, width - d)), F.pad(w, (0, width - d))),
                                reps)
            print(f"K6 {label} D={d} {dtype}: the wrapper's pad copies to {width} take "
                  f"{pad_ms:.4f} ms a call (in the times below)")
        for key, extra, products in (("fwd", (), 1), ("bwd", (g, logz, h, w), 3)):
            run, plain = pairs[key]
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (_median_ms(f, reps) for f in (plain, run, run, plain))
            ms, plain_ms = min(k1, k2), min(p1, p2)
            r = res[key]
            r[f"ms{suffix}"], r[f"plain_ms{suffix}"] = ms, plain_ms
            b = bound(_nbytes(h, w, l32, *extra), products * 2 * rows * V * d, dtype)
            if dtype == torch.bfloat16:
                r.update(b)
            else:
                r["bound_ms_f32"] = b["bound_ms"]
            print(f"K6 {label} D={d} {dtype} {key}: kernel {ms:.4f} ms (runs {k1:.4f}/{k2:.4f}), "
                  f"plain {plain_ms:.4f} ms (runs {p1:.4f}/{p2:.4f}; medians of {reps}), "
                  f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        del h, w, hp, wp, nll, logz, hg, wg, loss
        torch.cuda.empty_cache()
    return res


def _large_decode_kernels(gen: torch.Generator, cfg: ModelConfig,
                          names=("prefill_mha", "prefill_mha_cross", "fused_cross_decode",
                                 "fused_ln_mlp")) -> dict:
    """K1 (self with a left-pad mask, and cross over a ragged caption), K3
    and K4 (those of ``names``) at ``cfg``'s width and the serving arm's
    shapes (B=64, a 128-token prompt, a 32-token caption; bf16 and fp32
    with TF32 off) against their plain versions, with times, bounds and,
    for K1, one ``scaled_dot_product_attention`` call as the yardstick.
    Returns their rows' numbers."""
    b, L, lc, D, H = LARGE_SRV_B, LARGE_SRV_PROMPT, CAPTION, cfg.n_embd, cfg.n_head
    res = {k: {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "library_ms": None} for k in names}
    for dtype in (torch.bfloat16, torch.float32):
        c = cfg.replace(dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
        blk = _random_block(c, gen)
        qkv = torch.randn((b, L, 3 * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = qkv.split(D, dim=-1)
        ck, cv = torch.randn((b, lc, 2 * D), generator=gen, device=DEVICE).to(dtype).split(D, -1)
        lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device=DEVICE)
        leftpad = (torch.arange(L, device=DEVICE)[None] >= L - lens[:, None]).float()
        clens = torch.randint(1, lc + 1, (b,), generator=gen, device=DEVICE)
        cmask = (torch.arange(lc, device=DEVICE)[None] < clens[:, None]).float()
        h = torch.randn((b, 1, D), generator=gen, device=DEVICE).to(dtype)
        codes = [torch.randint(-127, 128, (2, b, lc, D), generator=gen, device=DEVICE,
                               dtype=torch.int8) for _ in range(2)]
        scales = [0.001 + 0.02 * torch.rand((2, b, lc, H), generator=gen, device=DEVICE)
                  for _ in range(2)]
        stacks = (*codes, *scales)
        qc = q.contiguous()  # the cross form's own projection (outside the timed calls)
        cases = {
            "prefill_mha": (
                lambda: prefill_attention.prefill_mha(q, k, v, leftpad, n_head=H, scale=0.125),
                lambda: prefill_attention.prefill_mha_reference(q, k, v, leftpad, n_head=H,
                                                                scale=0.125),
                leftpad[:, :, None], F32_TOL),
            "prefill_mha_cross": (
                lambda: prefill_attention.prefill_mha(qc, ck, cv, cmask, n_head=H, scale=0.125,
                                                      causal=False),
                lambda: prefill_attention.prefill_mha_reference(qc, ck, cv, cmask, n_head=H,
                                                                scale=0.125, causal=False),
                1.0, F32_TOL),
            "fused_cross_decode": (
                lambda: cross_decode.fused_cross_decode(h, blk, 1, 0.125, stacks, cmask, c),
                lambda: cross_decode.fused_cross_decode_reference(h, blk, 1, 0.125, stacks,
                                                                  cmask, c), 1.0, K3_TOL),
            "fused_ln_mlp": (
                lambda: fused_decode.fused_ln_mlp(h, blk.ln_2, blk.mlp, c),
                lambda: fused_decode.fused_ln_mlp_reference(h, blk.ln_2, blk.mlp, c), 1.0,
                K4_TOL)}
        for name in names:
            run, plain, rows, tol = cases[name]
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = ((got.float() - want.float()) * rows).abs().max().item()
            ok = (got.shape == want.shape and bool(torch.isfinite(got).all()) and (
                _bf16_ok(got * rows, want * rows) if dtype == torch.bfloat16 else err <= tol))
            print(f"{name} D={D} {dtype}: max |kernel - plain| = {err:.3e}")
            if not ok:
                raise AssertionError(f"{name} at D={D} {dtype} disagrees with its plain "
                                     f"version: {err}")
            r = res[name]
            r["max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"] = err
            if dtype != torch.bfloat16:
                continue
            if name.startswith("prefill"):
                r.update(_k1_grid(b, H, L))
            elif name == "fused_ln_mlp":
                r.update(_k4_grid(b, D, cfg.inner_dim))
            r["ms"], r["plain_ms"] = _timed_pair(f"{name} D={D}", run, plain)
            if name.startswith("prefill"):
                causal = name == "prefill_mha"
                kk = k if causal else ck
                heads = [x.view(b, -1, H, D // H).transpose(1, 2)
                         for x in ((q, k, v) if causal else (qc, ck, cv))]
                m = leftpad if causal else cmask
                allowed = m[:, None, None, :] > 0
                if causal:
                    allowed = allowed & torch.ones(L, L, dtype=torch.bool, device=DEVICE).tril()
                r["library_ms"] = _median_ms(lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=allowed, scale=0.125))
                lk = kk.shape[1]
                pairs = b * H * (L * (L + 1) // 2 if causal else L * lk)
                r.update(bound(2 * _nbytes(q) + 2 * b * lk * D * q.element_size(),
                               2 * 2 * pairs * (D // H)))
            elif name == "fused_cross_decode":
                r.update(bound(2 * _nbytes(h) + _nbytes(
                    codes[0][1], codes[1][1], scales[0][1], scales[1][1], cmask,
                    *blk.ln_cross.parameters(), *blk.cross_attn.q_attn.parameters(),
                    *blk.cross_attn.c_proj.parameters()), 2 * 2 * b * D * D + 2 * 2 * b * lc * D))
            else:
                r.update(bound(2 * _nbytes(h) + _nbytes(*blk.ln_2.parameters(),
                                                        *blk.mlp.parameters()),
                               2 * 2 * b * D * cfg.inner_dim))
            print(f"{name} D={D}: {r['ms']:.4f} ms against a bound of {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
        del blk
    return res


def _large_data(root: str, model: str) -> tuple:
    """load_data for ``model``, then a train split of 6-turn dialogues with
    utterances of 200-256 tokens and captions (two examples a dialogue,
    each over LARGE_L tokens: every batch is LARGE_L long) and a valid split
    of 4 short dialogues. Returns (the --limit that makes LARGE_STEPS
    steps of the model's batch, the launches its epoch should make)."""
    from ergm_tpu_torch.cli import load_data

    _cli(load_data.main, ["--source=synthetic", f"--data_dir={root}", f"--model_type={model}",
                          "--captions"])
    data = os.path.join(root, model)
    b = LARGE[model]
    st = write_synthetic_dataset(data, prefixes=("train",), num_dialogues=60,
                                 turns_per_dialogue=6, utter_len=range(200, 257),
                                 base_vocab_size=50257, captions="target", seed=31)
    write_synthetic_dataset(data, prefixes=("valid",), num_dialogues=4, turns_per_dialogue=4,
                            base_vocab_size=50257, captions="target", seed=32, st=st)
    cfg = ModelConfig.from_model_type(model, vocab_size=st.vocab_size, dtype="bfloat16",
                                      remat=True, remat_policy="full")
    for limit in range(1, 61):
        exp = _cli_train_expected(data, st, cfg, limit=limit, b=b, max_len=LARGE_L)
        if exp["steps"] == LARGE_STEPS:
            if exp["longest"] != LARGE_L:
                raise AssertionError(f"{model} data: batches up to {exp['longest']} tokens")
            return limit, exp
    raise AssertionError(f"{model} data: no limit gives {LARGE_STEPS} steps of B={b}")


def _large_train(card: str, root: str, model: str) -> dict:
    """ergm_tpu's recipe for ``model`` through ``cli.main --mode=train``
    (B from LARGE, LARGE_L tokens, full remat, a bf16 first moment, the
    default attention dropout and ``lm_loss_impl``), LARGE_STEPS steps:
    K5's and K6's launches as their gates give (K5 twice a layer forward
    under full remat, and for the caption's cross-attention in batches
    whose caption bucket passes its gate), the epoch line's readings and
    the peak memory; then the same run again with every K5 and K6
    launch, forward and backward, held against its plain version. The
    checkpoints (7.7 and 15.5 GB at full depth) go under ``root`` and are
    deleted."""
    from ergm_tpu_torch.cli import main as cli

    limit, exp = _large_data(root, model)
    b = LARGE[model]
    argv = ["--mode=train", "--seed=0", f"--data_dir={root}", "--train_prefix=train",
            "--valid_prefix=valid", f"--model_type={model}", "--lr=1e-5", "--warmup_ratio=0.0",
            f"--batch_size={b}", "--num_epochs=1", f"--max_len={LARGE_L}", "--dtype=bfloat16",
            "--remat_policy=full", "--adam_mu_dtype=bfloat16", f"--limit={limit}",
            f"--output_dir={root}/out", f"--ckpt_dir={root}/ckpt"]
    # the Trainer times blocks of this many steps and leaves the slowest
    # (the first: warm-up) out of its rate: 4 blocks of 2 over 8 steps
    saved = os.environ.get("ERGM_METRIC_FETCH_EVERY")
    os.environ["ERGM_METRIC_FETCH_EVERY"] = "2"
    try:
        run = _cli_train(card, "ergm_tpu's recipe (full remat, bf16 first moment; blocks of 2 "
                         "steps, the first left out)", argv, exp, model=model, b=b)
    finally:
        os.environ.pop("ERGM_METRIC_FETCH_EVERY")
        if saved is not None:
            os.environ["ERGM_METRIC_FETCH_EVERY"] = saved
    shutil.rmtree(os.path.join(root, "ckpt"))
    torch.cuda.empty_cache()
    t0 = time.time()
    with KernelShadow(TRAIN_SHADOWED, KernelShadow.BACKWARD) as shadow:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
    shutil.rmtree(os.path.join(root, "ckpt"))
    torch.cuda.empty_cache()
    shares = shadow.shares()
    if not all(v <= 1.0 for v in shares.values()) or shadow.calls != exp["want"]:
        raise AssertionError(f"{model} train shadow: {shares}, {shadow.calls}, want "
                             f"{exp['want']}, readings {shadow.readings}")
    print(f"{model} train shadowed ({LARGE_STEPS} steps, {time.time() - t0:.1f} s): every K5 "
          f"and K6 launch, forward and backward, within its plain version's bar (gradients "
          f"against JAX's backward arithmetic): " + ", ".join(
              f"{k} {v:.4f} over {shadow.calls[k]} launches" for k, v in shares.items())
          + "; against the autograd of the plain forward, the kernel and JAX's arithmetic "
          "read: " + ", ".join(f"{k} {a:.4f} and {b:.4f}" for k, (a, b) in
                               shadow.readings.items()) + f" on {card}")
    return {**run, "shares": shares, "readings": shadow.readings, "steps": exp["steps"],
            "tokens_per_step": b * LARGE_L}


def _parting(want: list, got: list, want_margins: list, got_margins: list) -> dict:
    """Where each row of ``got`` first leaves ``want``: the rows that part,
    and at the first parting of each the top-2 logit margins of both runs
    there (``*_margins``: [decision][row])."""
    parts = []
    for b, (w, g) in enumerate(zip(want, got)):
        j = next((j for j, (x, y) in enumerate(zip(w, g)) if x != y),
                 None if len(w) == len(g) else min(len(w), len(g)))
        if j is not None:
            parts.append({"row": b, "token": j, "margin": float(want_margins[j][b]),
                          "margin_on": float(got_margins[j][b])})
    return {"rows": len(want), "parted": parts}


def _large_serving(card: str, model: str, make_cfg=None,
                   arm_names=("serve", "long history")) -> dict:
    """``model`` at full width and depth in the serving configuration (int8
    KV and caption caches, int8 lm_head, random weights from seed 0):
    ``generate_batch`` over LARGE_SRV_B prompts (a 32-token caption on 3 of
    4, image and audio features) with the decode switches off, then with
    ``ERGM_CROSS_KERNEL`` and ``decode_fused_mlp`` on; the long-history arm
    (``generate``, LARGE_LONG_B prompts in LARGE_LONG_SLOTS slots) without
    and with ``ERGM_DECODE_KERNEL``. K1 (self and cross) n_layer times a
    prefill, K3 and K4 n_layer times a step where D % 128 == 0 (JAX's
    gates), none otherwise (the prompt's attention then takes the plain
    math, JAX's rule for short prompts at B >= 64); K2 n_layer times a step
    and K5 n_layer times a prefill on the long arm. In bf16 every launch of
    the kernels-on runs is held against its plain version
    (``KernelShadow``), where the kernels-on tokens part from the
    kernels-off ones is reported with both runs' top-2 margins there, and
    each arm is timed once more; in fp32 (TF32 off) the kernels-on tokens
    must equal the kernels-off ones up to each row's first decision whose
    kernels-off margin is at most 1e-3. ``make_cfg(dtype)`` builds the
    config (default: ``model``'s preset), ``arm_names`` picks the arms.
    Returns {"launches": {path: counts}, readings}."""
    rng = np.random.default_rng(15)
    long_in = _gpt2_inputs(rng, LARGE_LONG_B, LARGE_LONG_PROMPT)
    long_cap = LARGE_LONG_PROMPT + LARGE_SRV_NEW
    prompts, feats = _mesh_requests(LARGE_SRV_B, LARGE_SRV_PROMPT)
    kw = dict(max_len=LARGE_SRV_PROMPT + LARGE_SRV_NEW, eos_id=EOS, sp2_id=SP2, prompt_bucket=64,
              caption_bucket=32, max_new_tokens=LARGE_SRV_NEW, greedy=True, **feats)
    # arm: (call, the switches of its kernels-on run, decode_fused_mlp there)
    arms = {"serve": (lambda p, c: generate_batch(p, c, prompts, **kw)[0],
                      ("ERGM_CROSS_KERNEL",), True),
            "long history": (lambda p, c: _large_long(p, c, long_in, long_cap),
                             ("ERGM_DECODE_KERNEL",), False)}
    arms = {k: v for k, v in arms.items() if k in arm_names}
    out = {"launches": {}, "utt_s": {}, "parting": {}}
    for dtype in ("bfloat16", "float32"):
        cfg = (make_cfg(dtype) if make_cfg else
               ModelConfig.from_model_type(**{**SLICE, "model_type": model, "dtype": dtype}))
        L, wide = cfg.n_layer, cfg.n_embd % 128 == 0
        k1 = wide and prefill_attention.supported(LARGE_SRV_B, LARGE_SRV_PROMPT, cfg, True)
        t0 = time.time()
        params = gpt2.params_for_inference(
            gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE),
            cfg)
        torch.cuda.synchronize()
        print(f"{model} serving {dtype}: init + int8 lm_head in {time.time() - t0:.2f} s")
        for arm, (call, names, fused) in arms.items():
            runs = {}
            for label in ("off", "on"):
                c = cfg.replace(decode_fused_mlp=fused and label == "on")
                shadowed = dtype == "bfloat16" and label == "on"
                with contextlib.ExitStack() as stack:
                    stack.enter_context(switches(*(names if label == "on" else ())))
                    steps = stack.enter_context(StepCounter())
                    margins = stack.enter_context(_Margins())
                    shadow = (stack.enter_context(KernelShadow(LARGE_SHADOWED)) if shadowed
                              else None)
                    reset_launches()
                    tokens = call(params, c)
                    torch.cuda.synchronize()
                    counts = _launch_counts()
                n, on = steps.steps, label == "on"
                if arm == "serve":
                    # a prompt of at most 128 tokens at B >= 64 takes K1 or,
                    # where K1's gate is shut, the plain math (JAX's rule)
                    want = {"prefill_mha": L * k1, "prefill_mha_cross": L * k1,
                            "block_mha": 0, "decode_mha_int8": 0,
                            "fused_cross_decode": L * n * (wide and on),
                            "fused_ln_mlp": L * n * (wide and on)}
                else:
                    want = {"prefill_mha": 0, "prefill_mha_cross": 0, "block_mha": L,
                            "decode_mha_int8": L * n * on, "fused_cross_decode": 0,
                            "fused_ln_mlp": 0}
                if counts != want or n < 1:
                    raise AssertionError(f"{model} {arm} {dtype} [{label}]: launches {counts} "
                                         f"over {n} decode steps, want {want}")
                if shadow is not None:
                    shares = {k: v for k, v in shadow.shares().items() if shadow.calls[k]}
                    if not all(v <= 1.0 for v in shares.values()):
                        raise AssertionError(f"{model} {arm}: shadow {shares}")
                    print(f"{model} {arm} bf16 [on]: every launch within its plain version's "
                          f"bf16 bar: " + (", ".join(f"{k} {v:.4f} over {shadow.calls[k]} "
                                                     f"launches" for k, v in shares.items())
                                           or "no kernel launched"))
                    out["launches"][f"{arm} on"] = counts
                runs[label] = (tokens, margins.steps, counts, n)
            (want_tok, want_m, _, _), (got_tok, got_m, _, _) = runs["off"], runs["on"]
            if dtype == "float32":
                compared, equal = _margin_rule(f"{model} {arm} fp32", want_tok, got_tok, want_m)
                print(f"{model} {arm} fp32: tokens with the kernels on equal those with them "
                      f"off by the margin rule ({compared} tokens compared, {equal} of "
                      f"{len(want_tok)} rows equal throughout) on {card}")
                continue
            part = out["parting"][arm] = _parting(want_tok, got_tok, want_m, got_m)
            print(f"{model} {arm} bf16: {part['rows'] - len(part['parted'])} of {part['rows']} "
                  f"rows with the kernels on equal those with them off throughout; partings "
                  f"(row, token, top-2 margin off / on there): " + (", ".join(
                      f"({x['row']}, {x['token']}, {x['margin']:.3e} / {x['margin_on']:.3e})"
                      for x in part["parted"]) or "none"))
            for label in ("off", "on"):
                c = cfg.replace(decode_fused_mlp=fused and label == "on")
                with switches(*(names if label == "on" else ())):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    tokens = call(params, c)
                    torch.cuda.synchronize()
                    wall = time.time() - t0
                new = sum(len(t) for t in tokens)
                out["utt_s"][f"{arm} {label}"] = len(tokens) / wall
                print(f"{model} {arm} bf16 [{label}] B={len(tokens)}: {wall:.3f} s, "
                      f"{len(tokens) / wall:.2f} utt/s, {new / wall:.0f} new tok/s ({new} "
                      f"tokens, {runs[label][3]} decode steps), launches {runs[label][2]} on "
                      f"{card}")
        del params
        torch.cuda.empty_cache()
    return out


def _large_long(params, cfg, inputs: dict, cap: int) -> list:
    """The long-history arm: ``generate`` over ``inputs``' LARGE_LONG_PROMPT-
    token prompts in LARGE_LONG_SLOTS slots up to ``cap`` tokens a row;
    each row's new tokens."""
    dt = cfg.compute_dtype
    out = generate(params, cfg, inputs["input_ids"], LARGE_LONG_PROMPT, max_len=LARGE_LONG_SLOTS,
                   logical_cap=cap, eos_id=EOS, sp2_id=SP2,
                   token_type_ids=inputs["token_type_ids"], imgs=inputs["imgs"].to(dt),
                   auds=inputs["auds"].to(dt), caption_ids=inputs["caption_ids"], greedy=True)
    _check_generate(out, cfg, inputs["input_ids"], LARGE_LONG_PROMPT, LARGE_LONG_SLOTS)
    return [out.tokens[i, LARGE_LONG_PROMPT:int(n)].tolist()
            for i, n in enumerate(out.lengths.tolist())]


def _large_agreement(card: str) -> dict:
    """The full-width agreement with ergm_tpu at gpt2-large's width and the
    fixture's depth (``models/seeded.py::AGREEMENT``): ``_agreement``, emotion
    logits within 1e-3."""
    from ergm_tpu_torch.models import seeded

    return _agreement(card, "large agreement", seeded.AGREEMENT, LARGE_FIXTURE,
                      seeded.EMOTION_TOL)


def _agreement(card: str, label: str, a: dict, fixture: str, emotion_tol: float) -> dict:
    """The agreement with ergm_tpu on recipe ``a`` of ``models/seeded.py``:
    the seeded weights through ``params_from_numpy`` on the card, fp32 with
    TF32 off, against ``fixture`` (``scripts/large_agreement.py``). Greedy
    ``generate`` over the fixture's requests: tokens equal to JAX's up to
    each row's first decision whose JAX margin is at most 1e-3, emotion
    logits within ``emotion_tol``. Two AdamW steps on the fixture's batch
    through ``make_train_step`` (K5's and K6's fp32 routes): the LM loss of
    step 1 within 1e-5 and of step 2 within 2e-3 of JAX's, relative."""
    from ergm_tpu_torch.models import seeded
    from ergm_tpu_torch.models.convert import params_from_numpy

    with open(fixture) as f:
        fx = json.load(f)
    if fx["agreement"] != a:
        raise AssertionError(f"{label}: the fixture was written for another recipe")
    cfg = seeded.agreement_config(ModelConfig, a)
    t0 = time.time()
    tree = seeded.seeded_tree(cfg, a["seed"])
    inputs = seeded.agreement_inputs(cfg, a["seed"], a)
    lp, res = a["prompt"], {}
    req = {k: torch.as_tensor(v, device=DEVICE) for k, v in inputs["generate"].items()}
    params = gpt2.params_for_inference(params_from_numpy(tree, cfg, device=DEVICE), cfg)
    print(f"{label}: seeded {a['model_type']} width at {a['n_layer']} layers in "
          f"{time.time() - t0:.1f} s")
    out = generate(params, cfg, req["input_ids"], lp, max_len=lp + a["new"], eos_id=a["eos_id"],
                   sp2_id=a["sp2_id"], token_type_ids=req["token_type_ids"], imgs=req["imgs"],
                   auds=req["auds"], caption_ids=req["caption_ids"], greedy=True)
    got = out.tokens[:, lp:].tolist()
    compared = 0
    for b, row in enumerate(fx["tokens"]):
        for j, tok in enumerate(row[:fx["lengths"][b] - lp]):
            if fx["margins"][b][j] <= seeded.MARGIN:
                break
            if got[b][j] != tok:
                raise AssertionError(f"{label}: row {b} parts at token {j} (JAX margin "
                                     f"{fx['margins'][b][j]:.3e})")
            compared += 1
    emo = (out.emotion_logits.float().cpu() - torch.tensor(fx["emotion_logits"])).abs().max()
    if not float(emo) <= emotion_tol:
        raise AssertionError(f"{label}: emotion logits {float(emo):.3e} apart")
    res.update(tokens_compared=compared, emotion_max_abs_err=float(emo))
    del params
    torch.cuda.empty_cache()

    params = params_from_numpy(tree, cfg, device=DEVICE)
    del tree
    tx = AdamW(a["lr"])
    state = create_train_state(params, tx)
    step = make_train_step(cfg, tx, device=DEVICE)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in inputs["train"].items()}
    reset_launches()
    losses = [float(step(state, batch, 0)[1]["lm_loss"]) for _ in range(a["steps"])]
    counts = _train_counts()
    rel = [abs(x - y) / abs(y) for x, y in zip(losses, fx["lm_losses"])]
    if rel[0] > seeded.STEP1_RTOL or max(rel[1:]) > seeded.STEP2_RTOL:
        raise AssertionError(f"{label}: LM losses {losses} against JAX's {fx['lm_losses']}")
    if counts["fused_softmax_xent"] != a["steps"] or counts["block_mha"] < 1:
        raise AssertionError(f"{label}: launches {counts}")
    res.update(losses=losses, jax_losses=fx["lm_losses"], loss_rel_err=rel)
    print(f"{label} with ergm_tpu ({a['model_type']} width, {a['n_layer']} layers, fp32, "
          f"TF32 off): {compared} greedy tokens equal to JAX's of {len(fx['tokens'])} x "
          f"{a['new']} (rows stop at a margin <= {seeded.MARGIN:g}), emotion logits "
          f"{float(emo):.3e} apart; LM losses {losses} against {fx['lm_losses']} (relative "
          f"{rel[0]:.2e} and {rel[1]:.2e}); launches {counts} on {card}")
    del state, step, params
    torch.cuda.empty_cache()
    return res


def large_phase(card: str, gen: torch.Generator) -> dict:
    """The large GPT-2 family on the card (phase 17 of the module
    docstring): (a) K6 at each model's training shape, K1, K3 and K4 at
    gpt2-large's serving shapes; (b, c) each model's recipe through the
    command line; (d) serving; (e) the agreement with ergm_tpu. Returns
    {"rows": extra JSON rows, "launches": {kernel: {path: launches}}}."""
    t0 = time.time()
    k6 = {m: _large_k6(gen, m, b * LARGE_L) for m, b in LARGE.items()}
    wide = _large_decode_kernels(gen, ModelConfig.from_model_type(**{
        **SLICE, "model_type": "gpt2-large"}))
    train, serving = {}, {}
    with tempfile.TemporaryDirectory() as root:
        for model in LARGE:
            with _depth(model, LARGE_TRAIN_LAYERS[model]):
                train[model] = _large_train(card, root, model)
    for model in LARGE:
        serving[model] = _large_serving(card, model)
    agreement = _large_agreement(card)
    readings = {m: {k: train[m][k] for k in ("tok_s", "step_p50_ms", "mfu_pct", "peak_gb",
                                             "train_loss")} | {"utt_s": serving[m]["utt_s"]}
                for m in LARGE}
    print(f"large phase: {time.time() - t0:.1f} s on {card}; {json.dumps(readings)}; "
          f"agreement {json.dumps(agreement)}")
    launches = {}
    for m in LARGE:
        for path, counts in [("train", train[m]["launches"]), *serving[m]["launches"].items()]:
            for k, v in counts.items():
                launches.setdefault(k, {})[f"{m} {path}"] = v
    serve_on = serving["gpt2-large"]["launches"]["serve on"]
    rows = []
    for m in LARGE:
        for key, name, tpu in (("fwd", "fused_softmax_xent", "fused_ce.py:172"),
                               ("bwd", "fused_softmax_xent_bwd", "fused_ce.py:220")):
            rows.append((f"{name}_{m}", "fused_ce", tpu, {f"{name}_{m}": train[m]["launches"][name]},
                         k6[m][key]))
    for name, src, tpu in (("prefill_mha", "prefill_attention", "prefill_attention.py:111"),
                           ("prefill_mha_cross", "prefill_attention", "prefill_attention.py:111"),
                           ("fused_cross_decode", "cross_decode", "cross_decode.py:127"),
                           ("fused_ln_mlp", "fused_decode", "fused_decode.py:99")):
        rows.append((f"{name}_gpt2-large", src, tpu, {f"{name}_gpt2-large": serve_on[name]},
                     wide[name]))
    return {"rows": rows, "launches": launches}


# domain_phase: K5 and K6 over the whole domain of their JAX kernels. K5 at
# the training slice's [TRAIN_B, H, TRAIN_L, Dh] with H * Dh = 768 for each
# Dh of DOMAIN_HEADS (32, 96 and 128 have kernels of their own, 24 is padded
# to 32) and at K7's shape [2, 6, LONG_L, 128]; K6 at gpt2's training shape
# (TRAIN_B * TRAIN_L tokens, GPT-2's vocabulary DOMAIN_V) for each D of
# DOMAIN_WIDTHS (padded to the next multiple of 64); the models of DOMAIN_TRAIN (n_embd,
# n_head; 2 layers, bf16, dropout 0.1) through ``Trainer`` for DOMAIN_STEPS
# steps of DOMAIN_B x TRAIN_L tokens: the first four launch K5 at Dh 128,
# 32, 24 and 96 and K6 at 768 and 96; the next three K6 at 32, 100 and 776
# (K5 at 8, padded to 32; at 25 and 97, outside JAX's block gate, only in
# validation, without dropout, through the flash gate: K7); the last two K6 at
# 1,088 and 2,112 and K5 at Dh 64, while Dh 136 takes the plain math,
# outside both gates' head widths
DOMAIN_HEADS = (24, 32, 96, 128)
DOMAIN_WIDTHS = (32, 96, 100, 776)
DOMAIN_V = 50257
DOMAIN_TRAIN = ((768, 6), (768, 24), (96, 4), (768, 8), (32, 4), (100, 4), (776, 8), (1088, 8),
                (2112, 33))
DOMAIN_B, DOMAIN_STEPS = 8, 2
GPT2_FIXTURE = os.path.join(os.path.dirname(LARGE_FIXTURE), "gpt2_agreement.json")


def _domain_k5(gen: torch.Generator, dh: int) -> dict:
    """K5 at [TRAIN_B, 768 / dh, TRAIN_L, dh] (fp32 at B=4), causal and not,
    dropout 0 and 0.1, forward and backward against the plain version; in
    bf16 the times of kernel, plain and ``scaled_dot_product_attention`` at
    the training configuration (causal, dropout 0.1) and the bound. Returns
    the numbers of its forward and backward rows."""
    heads, scale = 768 // dh, dh ** -0.5
    res = {k: {"shape": [TRAIN_B, heads, TRAIN_L, dh], "max_abs_err": 0.0,
               "max_abs_err_f32": 0.0} for k in ("fwd", "bwd")}
    for dtype, b in ((torch.bfloat16, TRAIN_B), (torch.float32, 4)):
        q, k, v, do = (torch.randn((b, heads, TRAIN_L, dh), generator=gen, device=DEVICE).to(dtype)
                       for _ in range(4))
        key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
        for causal in (True, False):
            for rate in (0.0, 0.1):
                kw = dict(causal=causal, scale=scale, dropout_rate=rate,
                          dropout_seed=SEED if rate else None)
                got = _k5_grads(block_attention.block_mha, q, k, v, do, **kw)
                want = _k5_grads(block_attention.block_mha_reference, q, k, v, do, **kw)
                exact = (_k5_grads(block_attention.block_mha_reference,
                                   *(x.float() for x in (q, k, v, do)), **kw)
                         if dtype == torch.bfloat16 else [])
                torch.cuda.synchronize()
                o_err, g_err, ratio = _k5_held(f"K5 Dh={dh} {dtype} causal={causal} dropout "
                                               f"{rate}", dtype, got, want, exact)
                print(f"K5 Dh={dh} {dtype} [{b}, {heads}, {TRAIN_L}, {dh}] causal={causal}, "
                      f"dropout {rate}: max |kernel - plain| output {o_err:.3e}, gradients "
                      f"{g_err:.3e} ({ratio:.3f} of the bar)")
                res["fwd"][key] = max(res["fwd"][key], o_err)
                res["bwd"][key] = max(res["bwd"][key], g_err)
                del got, want, exact
        del q, k, v, do
    q, k, v, do = (torch.randn((TRAIN_B, heads, TRAIN_L, dh), generator=gen,
                               device=DEVICE).bfloat16() for _ in range(4))
    kw = dict(causal=True, scale=scale, dropout_rate=0.1, dropout_seed=SEED)
    fwd = {"kernel": lambda *x: block_attention.block_mha(*x, **kw),
           "plain": lambda *x: block_attention.block_mha_reference(*x, **kw),
           "library": lambda *x: F.scaled_dot_product_attention(*x, is_causal=True,
                                                                dropout_p=0.1, scale=scale)}
    _k5_instances(f"K5 Dh={dh} [{TRAIN_B}, {heads}, {TRAIN_L}, {dh}]",
                  block_attention.head_width(dh), q, k, v, do, **kw)
    pairs = TRAIN_B * heads * TRAIN_L * (TRAIN_L + 1) // 2  # causal (query, key) pairs
    r = res["fwd"]
    r["ms"], r["plain_ms"] = _timed_pair(f"K5 Dh={dh} forward", lambda: fwd["kernel"](q, k, v),
                                         lambda: fwd["plain"](q, k, v))
    r["library_ms"] = _median_ms(lambda: fwd["library"](q, k, v))
    r.update(bound(4 * _nbytes(q), 2 * 2 * pairs * dh))
    bwd = {}
    for name, fn in fwd.items():  # one forward graph each, its backward timed
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        bwd[name] = (lambda o=o, xs=xs: torch.autograd.grad(o, xs, do, retain_graph=True))
    r = res["bwd"]
    r["ms"], r["plain_ms"] = _timed_pair(f"K5 Dh={dh} backward", bwd["kernel"], bwd["plain"])
    r["library_ms"] = _median_ms(bwd["library"])
    r.update(bound(8 * _nbytes(q), 5 * 2 * pairs * dh))  # S again, dP, dV, dQ, dK
    for key in ("fwd", "bwd"):
        print(f"K5 Dh={dh} {key}: kernel {res[key]['ms']:.4f} ms, plain "
              f"{res[key]['plain_ms']:.4f} ms, SDPA {res[key]['library_ms']:.4f} ms, bound "
              f"{res[key]['bound_ms']:.4f} ms ({res[key]['bound_by']})")
    del fwd, bwd, o, xs
    torch.cuda.empty_cache()
    return res


def _domain_train(card: str) -> dict:
    """Each model of DOMAIN_TRAIN through ``Trainer`` (``auto`` routes, 2
    layers, bf16, dropout 0.1; DOMAIN_STEPS steps of DOMAIN_B rows padded to
    TRAIN_L tokens, then validation): K5 launches forward and backward in
    training exactly where its head width is in JAX's block gate (a
    multiple of 8 up to 128), K7 forward in validation at the other widths
    of JAX's flash domain (any below 128), K6 at every width, every launch
    within its plain version's bar (``KernelShadow``); where the block
    gate's widths end the step runs on the plain math, and the explicit
    ``block`` route raises. Then K7's route at the widest head: one step at
    n_embd 768, 6 heads, B=2, L=LONG_L, no attention dropout (K7 twice
    forward and twice backward). Returns {(n_embd, n_head): launches,
    "long": launches}."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        st = write_synthetic_dataset(data, prefixes=("train", "valid"),
                                     num_dialogues=DOMAIN_B * DOMAIN_STEPS // 4,
                                     turns_per_dialogue=4, base_vocab_size=50257)
        for n_embd, n_head in DOMAIN_TRAIN:
            dh = n_embd // n_head
            k5 = block_attention.head_ok(dh)
            k7_eval = not k5 and flash_attention.flash_head_ok(dh)
            cfg = ModelConfig(n_layer=2, n_embd=n_embd, n_head=n_head, vocab_size=st.vocab_size,
                              dtype="bfloat16", attn_pdrop=0.1, resid_pdrop=0.1, embd_pdrop=0.1)
            tag = f"{n_embd}x{n_head}"
            tcfg = TrainConfig(data_dir=data, ckpt_dir=os.path.join(tmp, f"ckpt{tag}"),
                               output_dir=os.path.join(tmp, f"out{tag}"), model_type="gpt2",
                               batch_size=DOMAIN_B, num_epochs=1, max_len=TRAIN_L,
                               pad_multiple=TRAIN_L, lr=1e-4, seed=0)
            t0 = time.time()
            with KernelShadow(K7_SHADOWED, KernelShadow.K7_BACKWARD) as shadow:
                with contextlib.redirect_stdout(io.StringIO()):
                    tr = Trainer(tcfg, model_config=cfg)
                    reset_launches()
                    best = tr.train()
                torch.cuda.synchronize()
            counts = {**_train_counts(), **_k7_counts()}
            shares = {k: v for k, v in shadow.shares().items() if shadow.calls[k]}
            fired = {"K5": ((counts["block_mha"] > 0) == k5
                            and (counts["block_mha_bwd"] > 0) == k5),
                     "K7": ((counts["flash_mha"] > 0) == k7_eval
                            and counts["flash_mha_bwd"] == 0),
                     "K6": (counts["fused_softmax_xent"] > 0
                            and counts["fused_softmax_xent_bwd"] > 0)}
            if (tr.state.step != DOMAIN_STEPS or not math.isfinite(best)
                    or not all(v <= 1.0 for v in shares.values()) or not all(fired.values())):
                raise AssertionError(f"domain train {tag}: {tr.state.step} steps, best PPL {best}, "
                                     f"launches {counts}, shadow {shares}")
            note = ""
            if not k5:
                route = {"attention_impl": "block"}
                tx = AdamW(1e-4)
                step = make_train_step(cfg.replace(**route), tx)
                batch = _train_batch(np.random.default_rng(0), 2, TRAIN_L, 50000, DEVICE)
                try:
                    step(create_train_state(tr.state.params, tx), batch, SEED)
                except ValueError as e:
                    note = f"; explicit {route} raises: {str(e)[:90]}"
                else:
                    raise AssertionError(f"domain train {tag}: explicit {route} did not raise")
            print(f"domain train {tag} (Dh={dh}): Trainer {tr.state.step} steps + validation in "
                  f"{time.time() - t0:.1f} s, best PPL {best:.1f}, launches {counts}, every launch "
                  f"within its plain version's bar: "
                  + (", ".join(f"{k} {v:.4f} over {shadow.calls[k]}" for k, v in shares.items())
                     or "none") + note)
            out[(n_embd, n_head)] = counts
            del tr
            torch.cuda.empty_cache()
    cfg = ModelConfig.from_model_type(**{**TRAIN_SLICE, "n_positions": LONG_L, "n_layer": 2,
                                         "n_head": 6, "attn_pdrop": 0.0})
    params = gpt2.init_params(torch.Generator(device=DEVICE).manual_seed(3), cfg)
    tx = AdamW(1e-4)
    state, step = create_train_state(params, tx), make_train_step(cfg, tx)
    batch = _train_batch(np.random.default_rng(3), 2, LONG_L, 50000, DEVICE)
    reset_launches()
    state, m = step(state, batch, SEED)
    torch.cuda.synchronize()
    counts = {**_train_counts(), **_k7_counts()}
    if (counts["flash_mha"], counts["flash_mha_bwd"], counts["block_mha"]) != (2, 2, 0) or (
            not math.isfinite(float(m["loss"]))):
        raise AssertionError(f"domain long context Dh=128: launches {counts}, loss {m['loss']}")
    print(f"domain long context: n_embd 768, 6 heads (Dh=128), B=2, L={LONG_L}, one step, loss "
          f"{float(m['loss']):.4f}, launches {counts} on {card}")
    out["long"] = counts
    del state, step, params
    torch.cuda.empty_cache()
    return out


def domain_phase(card: str, gen: torch.Generator) -> dict:
    """K5 and K6 over the whole domain of their JAX kernels (phase 18 of the
    module docstring): (a) K5 at DOMAIN_HEADS and K7's shape at Dh=128, (b)
    K6 at DOMAIN_WIDTHS, (c) DOMAIN_TRAIN through ``Trainer`` and K7's route
    at Dh=128, (d) gpt2 at its full 12 layers against ergm_tpu
    (``tests/fixtures/gpt2_agreement.json``). Returns {"rows": JSON rows}."""
    from ergm_tpu_torch.models import seeded

    t0 = time.time()
    k5 = {dh: _domain_k5(gen, dh) for dh in DOMAIN_HEADS}
    print("K5's kernels (bf16, blk:: at Dh = 32, 64, 96 and 128), ptxas: "
          + json.dumps(_build.ptxas_report(_build.build_log(), "block_attention.cu", "blk")))
    k7 = _k7_case(gen, 128, ((torch.float32, 2, 6), (torch.bfloat16, 2, 6)))
    # K6 at gpt2's training shape (fp32 at 2,048 tokens); D = 100 runs padded
    # to 128 and its bf16 backward must repeat bit for bit
    k6 = {d: _k6_case(gen, "gpt2 shape", d, TRAIN_B * TRAIN_L, 2048, DOMAIN_V, repeat=d == 100)
          for d in DOMAIN_WIDTHS}
    train = _domain_train(card)
    agreement = _agreement(card, "gpt2 agreement", seeded.GPT2_AGREEMENT, GPT2_FIXTURE,
                           seeded.GPT2_EMOTION_TOL)
    print(f"domain phase: {time.time() - t0:.1f} s on {card}; gpt2 agreement "
          f"{json.dumps(agreement)}")
    # each row's launches: the (first) Trainer run at its width
    runs = {k: c for k, c in train.items() if k != "long"}
    k5_runs = {dh: next(c for (e, h), c in runs.items() if e // h == dh) for dh in DOMAIN_HEADS}
    k6_runs = {d: next(c for (e, _), c in runs.items() if e == d) for d in DOMAIN_WIDTHS}
    rows = []
    for dh in DOMAIN_HEADS:
        for key, name, tpu in (("fwd", "block_mha", "block_attention.py:218"),
                               ("bwd", "block_mha_bwd", "block_attention.py:236")):
            label = f"{name}_dh{dh}"
            rows.append((label, "block_attention", tpu, {label: k5_runs[dh][name]}, k5[dh][key]))
    for key, name in (("fwd", "flash_mha"), ("bwd", "flash_mha_bwd")):
        label = f"{name}_dh128"
        rows.append((label, "block_attention", "flash_attention.py:66",
                     {label: train["long"][name]}, k7[key]))
    for d in DOMAIN_WIDTHS:
        for key, name, tpu in (("fwd", "fused_softmax_xent", "fused_ce.py:172"),
                               ("bwd", "fused_softmax_xent_bwd", "fused_ce.py:220")):
            label = f"{name}_d{d}"
            rows.append((label, "fused_ce", tpu, {label: k6_runs[d][name]}, k6[d][key]))
    return {"rows": rows}


# wide_phase: K6 and K7 over the rest of their JAX kernels' domain, and
# Cerebras-GPT-2.7B's width. K6 at each D of WIDE_WIDTHS (2,560:
# Cerebras-GPT-2.7B; 4,096: GPT-J-6B and Cerebras-6.7B; 5,120:
# Cerebras-13B) over WIDE_N tokens (fp32: WIDE_N_F32) and GPT-2's
# vocabulary; K7 at [2, 16, LONG_L, Dh] for each Dh of WIDE_HEADS (100:
# padded to the one-pass kernels' 128 in bf16, K5's 128-wide template in
# fp32; 256 and 384: the one-pass kernels, 384 a reading in the 256 rows);
# Cerebras-GPT-2.7B's published widths
# (models/seeded.py::CEREBRAS_2P7B) at CEREBRAS_LAYERS of its 32 layers
# through Trainer (bf16, full remat, CEREBRAS_STEPS steps of CEREBRAS_B x
# CEREBRAS_L tokens: K6 at 2,560, K5 at Dh 80 on the 96-wide template) and
# generate_batch (large_phase's serving arm, K3 and K4 on against off); the
# models of WIDE_LONG (n_embd, n_head, n_inner; 2 layers, no attention
# dropout) through Trainer for WIDE_STEPS steps of WIDE_LONG_B x LONG_L
# tokens, where JAX's flash gate routes every self-attention call: GPT-J-6B's
# attention (16 heads of 256, K6 at 4,096), 16 heads of 100 at gpt2-xl's
# width, Cerebras-13B's width (40 heads of 128, K6 at 5,120); the agreement
# with ergm_tpu at 2.7B's width.
WIDE_WIDTHS = (2560, 4096, 5120)
WIDE_N, WIDE_N_F32 = 2048, 1024
WIDE_HEADS = (100, 256, 384)
CEREBRAS_LAYERS, CEREBRAS_B, CEREBRAS_L, CEREBRAS_STEPS = 8, 4, 1024, 2
WIDE_LONG = ((4096, 16, 16384), (1600, 16, 6400), (5120, 40, 20480))
WIDE_LONG_B, WIDE_STEPS = 2, 2
CEREBRAS_FIXTURE = os.path.join(os.path.dirname(LARGE_FIXTURE), "cerebras_2p7b_agreement.json")


def _wide_train(card: str, tag: str, cfg: ModelConfig, b: int, L: int, steps: int) -> dict:
    """``cfg`` through ``Trainer`` (``auto`` routes) for ``steps`` steps of
    ``b`` rows padded to ``L`` tokens, then validation, every K5 and K6
    launch, forward and backward, held against its plain version
    (``KernelShadow``): K6 must launch forward and backward, its backward
    once a step, and the attention kernel of the run's shapes too: K5
    (``block_mha``) inside JAX's block gate, K7 (``flash_mha``) past it.
    Returns the launches and readings."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        st = write_synthetic_dataset(data, prefixes=("train", "valid"),
                                     num_dialogues=max(1, b * steps // 4), turns_per_dialogue=4,
                                     base_vocab_size=50257)
        cfg = cfg.replace(vocab_size=st.vocab_size)
        tcfg = TrainConfig(data_dir=data, ckpt_dir=os.path.join(tmp, "ckpt"),
                           output_dir=os.path.join(tmp, "out"), model_type="gpt2", batch_size=b,
                           num_epochs=1, max_len=L, pad_multiple=L, lr=1e-4, seed=0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with KernelShadow(K7_SHADOWED, KernelShadow.K7_BACKWARD) as shadow:
            with contextlib.redirect_stdout(io.StringIO()):
                tr = Trainer(tcfg, model_config=cfg)
                reset_launches()
                best = tr.train()
            torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {**_train_counts(), **_k7_counts()}
        shares = {k: v for k, v in shadow.shares().items() if shadow.calls[k]}
        attn = "flash_mha" if L > 1024 else "block_mha"
        if (tr.state.step != steps or not math.isfinite(best)
                or not all(v <= 1.0 for v in shares.values())
                or min(counts[k] for k in (attn, f"{attn}_bwd", "fused_softmax_xent")) < 1
                or counts["fused_softmax_xent_bwd"] != steps):
            raise AssertionError(f"{tag}: {tr.state.step} steps, best PPL {best}, launches "
                                 f"{counts}, shadow {shares}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"{tag} (n_embd {cfg.n_embd}, {cfg.n_head} heads of {cfg.head_dim}, n_inner "
              f"{cfg.inner_dim}, {cfg.n_layer} layers, remat {cfg.remat_policy if cfg.remat else 'off'}, "
              f"attention dropout {cfg.attn_pdrop}): Trainer {steps} steps of {b} x {L} + "
              f"validation in {wall:.1f} s, best PPL {best:.1f}, peak {peak:.1f} GB, launches "
              f"{counts}, every launch within its plain version's bar: "
              + ", ".join(f"{k} {v:.4f} over {shadow.calls[k]}" for k, v in shares.items())
              + f" on {card}")
        del tr
        torch.cuda.empty_cache()
    return {"launches": counts, "shares": shares, "s": wall, "peak_gb": peak}


def wide_phase(card: str, gen: torch.Generator) -> dict:
    """K6 and K7 over the rest of their JAX kernels' domain and
    Cerebras-GPT-2.7B's width (phase 19 of the module docstring): (a) K6 at
    WIDE_WIDTHS, (b) K7 at WIDE_HEADS, (c) 2.7B's width through ``Trainer``
    and ``generate_batch``, K3 and K4 at its width, (d) WIDE_LONG through
    ``Trainer`` on JAX's flash route, (e) the agreement with ergm_tpu at
    2.7B's width (``tests/fixtures/cerebras_2p7b_agreement.json``). Returns
    {"rows": JSON rows, "launches": {kernel: {path: launches}}}."""
    from ergm_tpu_torch.models import seeded

    t0 = time.time()
    k6 = {d: _k6_case(gen, "wide", d, WIDE_N, WIDE_N_F32, DOMAIN_V, repeat=d == 2560)
          for d in WIDE_WIDTHS}
    torch.cuda.empty_cache()
    k7 = {}
    for dh in WIDE_HEADS:
        k7[dh] = _k7_case(gen, dh, ((torch.float32, 2, 16), (torch.bfloat16, 2, 16)))
        torch.cuda.empty_cache()
    print("K7's one-pass kernels (bf16, Dh = 64, 128, 256 and 384), ptxas: "
          + json.dumps(_build.ptxas_report(_build.build_log(), "block_attention.cu", "flash")))
    # K7's route refuses a head width above 128 that is not a multiple of 128
    # (JAX's library kernel raises there): auto takes the plain math, flash raises
    x = torch.randn((1, 2, LONG_L, 200), generator=gen, device=DEVICE).bfloat16()
    reset_launches()
    gpt2.multihead_attention(x, x, x, causal=True, impl="auto")
    try:
        gpt2.multihead_attention(x, x, x, causal=True, impl="flash")
    except ValueError as e:
        note = str(e)[:80]
    else:
        raise AssertionError("flash at Dh = 200 did not raise")
    if block_attention.LAUNCHES or flash_attention.LAUNCHES:
        raise AssertionError("auto at Dh = 200 launched K5 or K7")
    print(f"Dh = 200: auto takes the plain math, flash raises ({note})")
    del x

    base = dict(**seeded.CEREBRAS_2P7B, n_layer=CEREBRAS_LAYERS, modality_dim=768)
    kernels = _large_decode_kernels(gen, ModelConfig(**base, vocab_size=50271),
                                    names=("fused_cross_decode", "fused_ln_mlp"))
    train = {"cerebras": _wide_train(
        card, f"Cerebras-GPT-2.7B width, {CEREBRAS_LAYERS} of 32 layers",
        ModelConfig(**base, dtype="bfloat16", remat=True, remat_policy="full"), CEREBRAS_B,
        CEREBRAS_L, CEREBRAS_STEPS)}
    serving_base = {**{k: v for k, v in SLICE.items() if k not in ("model_type", "dtype")},
                    **base}
    serving = _large_serving(card, "Cerebras-GPT-2.7B width", arm_names=("serve",),
                             make_cfg=lambda dt: ModelConfig(**serving_base, dtype=dt))
    serve_on = serving["launches"]["serve on"]
    if not (serve_on["fused_cross_decode"] and serve_on["fused_ln_mlp"]):
        raise AssertionError(f"Cerebras-GPT-2.7B serving: K3 and K4 did not launch: {serve_on}")
    for n_embd, n_head, n_inner in WIDE_LONG:
        cfg = ModelConfig(n_layer=2, n_embd=n_embd, n_head=n_head, n_inner=n_inner,
                          n_positions=LONG_L, dtype="bfloat16", attn_pdrop=0.0)
        train[n_embd] = _wide_train(card, f"flash route {n_embd} x {n_head}", cfg, WIDE_LONG_B,
                                    LONG_L, WIDE_STEPS)
    agreement = _agreement(card, "Cerebras-GPT-2.7B agreement", seeded.CEREBRAS_2P7B_AGREEMENT,
                           CEREBRAS_FIXTURE, seeded.EMOTION_TOL)
    if max(agreement["loss_rel_err"]) > seeded.STEP1_RTOL:
        raise AssertionError(f"Cerebras-GPT-2.7B agreement: losses {agreement['losses']} against "
                             f"{agreement['jax_losses']}")
    print(f"wide phase: {time.time() - t0:.1f} s on {card}; agreement {json.dumps(agreement)}; "
          f"utt/s {json.dumps(serving['utt_s'])}")

    # each row's launches: the Trainer run at its width (K6) or head width (K7);
    # a head width no run takes (384) is a reading in the widest row's
    runs = {base["n_embd"]: train["cerebras"], **{n: train[n] for n, _, _ in WIDE_LONG}}
    heads = {n // h: train[n] for n, h, _ in WIDE_LONG}
    rows = []
    for d in WIDE_WIDTHS:
        for key, name, tpu in (("fwd", "fused_softmax_xent", "fused_ce.py:172"),
                               ("bwd", "fused_softmax_xent_bwd", "fused_ce.py:220")):
            label = f"{name}_d{d}"
            rows.append((label, "fused_ce", tpu, {label: runs[d]["launches"][name]}, k6[d][key]))
    routed = [dh for dh in WIDE_HEADS if dh in heads]
    for dh in routed:
        for key, name in (("fwd", "flash_mha"), ("bwd", "flash_mha_bwd")):
            label = f"{name}_dh{dh}"
            nums = dict(k7[dh][key])
            if dh == routed[-1]:
                nums["other_shapes"] = {f"dh{x}": k7[x][key] for x in WIDE_HEADS
                                        if x not in heads}
            rows.append((label, "block_attention", "flash_attention.py:66",
                         {label: heads[dh]["launches"][name]}, nums))
    for name, src, tpu in (("fused_cross_decode", "cross_decode", "cross_decode.py:127"),
                           ("fused_ln_mlp", "fused_decode", "fused_decode.py:99")):
        label = f"{name}_cerebras-2.7b"
        rows.append((label, src, tpu, {label: serve_on[name]}, kernels[name]))
    launches = {}
    for tag, run in train.items():
        for k, v in run["launches"].items():
            launches.setdefault(k, {})[f"train {tag}"] = v
    for k, v in serve_on.items():
        launches.setdefault(k, {})["Cerebras-GPT-2.7B serve on"] = v
    return {"rows": rows, "launches": launches}


def _descendants() -> list:
    """The pids of the live (not zombie) processes below this one."""
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except (OSError, ValueError):
                continue
            if state != "Z":
                parent[int(entry)] = int(ppid)
    found, front = [], [os.getpid()]
    while front:
        above = front.pop()
        kids = [pid for pid, pp in parent.items() if pp == above]
        found += kids
        front += kids
    return found


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_processes() -> None:
    """Stops every process the run started beside this one before it
    exits: the fork server of the loader's workers and the resource
    tracker it started (both would outlive this process for a moment),
    then whatever else is still below it (SIGTERM, SIGKILL after 5 s)."""
    import multiprocessing.forkserver
    import multiprocessing.resource_tracker
    import signal

    below = _descendants()
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()
    left = [pid for pid in below if _alive(pid)]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(OSError):
                os.kill(pid, sig)
        deadline = time.time() + 5
        while left and time.time() < deadline:
            with contextlib.suppress(ChildProcessError):
                while os.waitpid(-1, os.WNOHANG)[0]:
                    pass
            left = [pid for pid in left if _alive(pid)]
            time.sleep(0.05)
    if below:
        # after the last line of standard output, so on standard error
        print(f"processes stopped at exit: {len(below)}", file=sys.stderr)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _build.load()
    print(f"build: K1-K7 compiled and loaded in {time.time() - t0:.2f} s")
    print(_build.build_log().strip())
    print("K1's and K4's Hopper kernels (bf16), ptxas: "
          + json.dumps({**_ptxas("prefill_attention.cu", "hop"), **_ptxas("fused_decode.cu", "wg")}))

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    seconds = {}

    def phase(fn, *args):
        """Runs one phase and keeps its wall time (the script's time limit)."""
        t = time.time()
        out = fn(*args)
        seconds[fn.__name__] = round(time.time() - t, 1)
        return out

    k1 = phase(kernel_phase, gen)
    decode = phase(decode_kernel_phase, gen)
    k2_shapes = phase(k2_shapes_phase, gen)
    decode["decode_mha_int8"]["launch_floor_ms"] = k2_shapes.pop("launch_floor_ms")
    decode["decode_mha_int8"]["other_shapes"] = k2_shapes
    train = phase(train_kernel_phase, gen)
    torch.cuda.empty_cache()
    flash = phase(flash_kernel_phase, gen)
    torch.cuda.empty_cache()
    phase(reference_phase)
    on, long_on, step_tables = phase(slice_phase, card)
    # this slice's paths, counted from 0 just before each run
    spec_counts = phase(spec_phase, card)
    beam_on = phase(beam_phase, card)
    server_on = phase(server_phase, card)
    for k, arms in phase(server_ext_phase, card).items():
        server_on[k].update(arms)
    pipeline_on = phase(pipeline_phase, card)
    phase(train_reference_phase)
    long_ctx = phase(long_context_phase, card)
    train_on = phase(train_slice_phase, card)
    torch.cuda.empty_cache()
    cli_on = phase(cli_phase, card)
    par_on = phase(parallel_phase, card)
    mesh_on = phase(mesh_infer_phase, card, gen)
    torch.cuda.empty_cache()
    large_on = phase(large_phase, card, gen)
    torch.cuda.empty_cache()
    domain_on = phase(domain_phase, card, gen)
    torch.cuda.empty_cache()
    wide_on = phase(wide_phase, card, gen)
    print(f"phase seconds: {json.dumps(seconds)}; {time.time() - t0:.1f} s since the build "
          f"started")
    for arg in sys.argv[1:]:
        if arg.startswith("--profile="):
            path = arg.split("=", 1)[1]
            profile_train_step(card, path)
            root, ext = os.path.splitext(path)
            # the command line's gpt2-medium step (train_torch.sh's B=8, the
            # train split's longest bucket, its 64-token caption bucket)
            profile_train_step(card, f"{root}_medium{ext}", ModelConfig.from_model_type(
                CLI_MODEL, vocab_size=50271, dtype="bfloat16", remat=True), CLI_B, 512, 64)
            with open(f"{root}_decode{ext}", "w") as f:
                f.write("\n\n".join(step_tables.values()) + "\n")
            print(f"profile: decode-step tables in {root}_decode{ext}")

    rows = [("prefill_mha", "prefill_attention", "prefill_attention.py:111", on,
             k1["prefill_mha"]),
            ("prefill_mha_cross", "prefill_attention", "prefill_attention.py:111", on,
             k1["prefill_mha_cross"]),
            ("fused_cross_decode", "cross_decode", "cross_decode.py:127", on,
             decode["cross_decode"]),
            ("fused_ln_mlp", "fused_decode", "fused_decode.py:99", on, decode["fused_ln_mlp"]),
            ("decode_mha_int8", "decode_attention", "decode_attention.py:151", long_on,
             decode["decode_mha_int8"]),
            ("block_mha", "block_attention", "block_attention.py:218", train_on,
             train["block_mha"]),
            ("block_mha_bwd", "block_attention", "block_attention.py:236", train_on,
             train["block_mha_bwd"]),
            ("flash_mha", "block_attention", "flash_attention.py:66", long_ctx,
             flash["flash_mha"]),
            ("flash_mha_bwd", "block_attention", "flash_attention.py:66", long_ctx,
             flash["flash_mha_bwd"]),
            ("fused_softmax_xent", "fused_ce", "fused_ce.py:172", train_on,
             train["fused_softmax_xent"]),
            ("fused_softmax_xent_bwd", "fused_ce", "fused_ce.py:220", train_on,
             train["fused_softmax_xent_bwd"]),
            # K3's and K4's tensor-parallel forms: launches on the mesh's bf16
            # generate_batch (rank 0), times at a data rank's rows
            ("fused_cross_decode_tp", "cross_decode", "cross_decode.py:127",
             {"fused_cross_decode_tp": mesh_on["tp"]["fused_cross_decode_tp"].pop("launches")},
             mesh_on["tp"]["fused_cross_decode_tp"]),
            ("fused_ln_mlp_tp", "fused_decode", "fused_decode.py:99",
             {"fused_ln_mlp_tp": mesh_on["tp"]["fused_ln_mlp_tp"].pop("launches")},
             mesh_on["tp"]["fused_ln_mlp_tp"])]
    # K6 at gpt2-large's and gpt2-xl's widths (launches: their recipes'
    # epochs through the command line), K1, K3 and K4 at gpt2-large's
    # (launches: its serving arm with the kernels on)
    rows += large_on["rows"]
    # K5, K7 and K6 at the other head widths and hidden widths of their JAX
    # kernels' domain (launches: the Trainer run at each width)
    rows += domain_on["rows"]
    # K6 past 2,048, K7 past the block gate's head widths, K3 and K4 at
    # Cerebras-GPT-2.7B's width (launches: the Trainer and serving runs at
    # each width)
    rows += wide_on["rows"]
    # launches on the speculative and beam paths: K5 in a B=1 request's
    # prefills on each route, K2-K5 in the beam search with the kernels on
    spec_beam = {k: {f"B=1 {r}": c[k] for r, c in spec_counts.items()} | {"beam": beam_on[k]}
                 for k in ("block_mha",)}
    spec_beam.update({k: {"beam": beam_on[k]}
                      for k in ("decode_mha_int8", "fused_cross_decode", "fused_ln_mlp")})
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"ergm_tpu_torch/csrc/{src}.cu",
        "replaces": f"ergm_tpu/ops/{tpu}", "launches": counts[name], **nums,
        **({"spec_beam_launches": spec_beam[name]} if name in spec_beam else {}),
        # launches on the server's path: each arm's run of the 256 requests
        **({"server_launches": server_on[name]} if name in server_on else {}),
        # launches on the feature-extraction and test-run paths
        **({"pipeline_launches": pipeline_on[name]} if name in pipeline_on else {}),
        # launches on the command line's paths (gpt2-medium)
        **({"cli_launches": cli_on[name]} if name in cli_on else {}),
        # launches a step on the multi-device training paths
        **({"parallel_launches": par_on[name]} if name in par_on else {}),
        # launches on the mesh's inference paths (rank 0 of data=2 x model=2)
        **({"mesh_launches": mesh_on["launches"][name]} if name in mesh_on["launches"]
           else {}),
        # launches on the large family's paths (train: the recipe's epoch;
        # serve and long history: the kernels-on arms)
        **({"large_launches": large_on["launches"][name]} if name in large_on["launches"]
           else {}),
        # launches on the wide phase's paths (its Trainer and serving runs)
        **({"wide_launches": wide_on["launches"][name]} if name in wide_on["launches"]
           else {})}
        for name, src, tpu, counts, nums in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_processes()
