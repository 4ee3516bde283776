"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a repository checkout
    python3 chip_smoke.py --kernels 3c,3e,7a [--src DIR] [--parent FILE]
    python3 chip_smoke.py --ml-tier
    python3 chip_smoke.py --decoders
    python3 chip_smoke.py --ladder
    python3 chip_smoke.py --train-recurrent
    python3 chip_smoke.py --scale-out
    python3 chip_smoke.py --dryrun
    python3 chip_smoke.py --analysis

The second form runs only the named kernel phases (after phases 1 and 2)
and prints their records with no contract line; `--src` builds and checks
the `repro_torch` under another source directory (an unpacked parent
commit, say), so two trees are timed by the same checks in one call.
`--parent` takes the last line of such a run of the parent (its kernels'
JSON record): phases 3d and 7a then print each case's parent time beside
the case's own (3d its fp32 cases). The third form runs phase 4's main
path and phase 14 (the M_L tier) alone after the build, with no contract
line; the fourth phase 15 (the four remaining decoders) and those archs'
phase-5 fixtures, the same way; the fifth phase 16 (the ladder) alone;
the sixth phase 17 (recurrent training, remat, attn_chunk) alone, after
phase 7a's loss-kernel checks at its two Stage-2 shapes; the seventh
phase 18 (sharding and the expert- and sequence-parallel paths) alone;
the eighth phase 19 (the dry-run, its count against the card, the
examples) alone; the ninth phase 20 (the static analysis) alone.

Phases, in the order they run; any failure raises and the script exits
non-zero:

  1. The card: name and power limit as nvidia-smi reports them.
  2. Build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, sm_90a, in parallel) into `build/repro_torch_kernels/`,
     and print the build time and ptxas's register / shared-memory report.
  3. Hold the GQA decode and paged write kernels against their plain
     PyTorch versions at the full-width internlm2-1.8b decode shapes (8
     rows, 16/8/128 heads, block 16, fp32 q, bf16 pages, ragged positions,
     one all-trash row; plus fp32 pages), and time kernel, plain version
     and a PyTorch library call with CUDA events, beside the bytes /
     operations bound; the same for the decode at a 4,096-token cache (8
     full rows), at llama3-405b's 128/8 heads (group 16), at the qwens'
     MHA (20/20 and 40/40 heads, group 1) and at kimi-k2's 64/8 x 112. The write is
     a decode layer's: K and V into their two leaves in one
     `paged_write_token_pair` launch, timed beside two `index_put_`.
  3b. The same for the MLA decode kernel at the full-width DeepSeek-V2
     decode shapes (8 rows, 128 heads, kv_lora 512, rope 64, block 16):
     bf16 q, pages and norm weight (the main path's types), all fp32, and
     all bf16 at a 4,096-token cache (8 full rows); two calls bit-equal,
     and the device time by kernel (split and merge) under torch.profiler.
  3c. The deferral-signal kernel `deferral_entropy` against its plain
     version at the engine's shapes (8 x 92544, 8 x 102400 and, for
     rwkv6-3b and zamba2-1.2b, 8 x 65536 and 8 x 32000 fp32 logits), the
     evaluation's (2048 x
     92544), phase 10's classifier logits (1000 x 8, 3000 x 8, and
     3000 x 10, whose rows take the scalar loads) and phase 12's (8 x
     51865, whisper-small's odd vocabulary on the scalar loads, and 8 x
     32064, phi-3-vision's), and phase 15's (8 x 151936, 8 x 152064,
     8 x 128256, 8 x 163840: qwen1.5-4b, qwen1.5-32b, llama3-405b,
     kimi-k2-1t-a32b), with a row of equal
     logits, a row with an exact top tie and a vocabulary tail no span
     divides, two calls bit-equal; timed beside its bytes bound (no
     single PyTorch call computes the triple, so no library time), and
     by kernel under torch.profiler.
  3d. The prefill kernel `flash_attention` against its plain version at
     the full-width internlm2-1.8b prefill chunk (8 rows, 128 queries,
     16/8 heads of 128, a 288-position view, q_offset 0, 48 and 128), bf16
     and all fp32 (three TF32 products a product, the paths' type), two
     calls bit-equal, plus a reduced sliding-window case; timed beside its
     bound (fp32 at the three-product rate, the SIMT-rate bound kept
     beside) and SDPA with the same boolean mask, and the two kernels'
     times side by side at each q_offset. Then zamba2-1.2b's shared
     block's prefill (8 x 128 queries over a 288-position slot cache,
     32/32 heads of 64,
     bf16, window 288), timed beside its bound and SDPA. Then the head
     dims past the old instantiations at the same chunk: phi-3-vision's 96
     (32/32 heads) and kimi-k2's 112 (64/8, q_offset 0, 48 and 128, its
     main path's), and 256 on 2 rows; phase 15's qwen1.5-4b chunk (20/20
     x 128) and llama3-405b's (128/8 x 128) at q_offset 0 and 128. Then
     phase 12's five calls: whisper-small's encoder (8 x 1500 frames,
     non-causal, 12/12 heads of 64), its cross-attention at prefill (16
     queries) and at a decode step (1 query) over the 1500 encoder
     states (non-causal), its decoder's causal prefill over the 32-slot
     cache, and phi-3-vision-4.2b's causal prefill of 576 patches + BOS
     (32/32 heads of 96). Then the paged engine's prefill dispatches of
     1, 2 and 4 rows (internlm2-1.8b's chunk at q_offset 0 and 128, and
     zamba2-1.2b's shared block at 0), the grids under one wave that
     `kv_split` may split. Then phase 19b's prefill whole: 8 prompts of
     4,096 tokens over themselves, causal, 16/8 heads of 128.
  3e. The recurrence kernel `wkv_scan` against its plain version (the JAX
     algorithms) in both modes: "rwkv" at the full-width rwkv6-3b decode
     step (8 rows, T 1, 40 heads, K = V = 64; the per-token kernel),
     "mamba" at zamba2-1.2b's decode step (64 heads, scalar decay, T 1)
     and its large tier's (128 heads),
     "rwkv" at rwkv6-3b's prefill (the chunked kernels: T 128, the prime
     T 97, one row of 256 tokens, RWKV6's strong decays down to -20 a
     token; T 2, 16, 32, 48 and 64 about the paths' crossover), "mamba" at
     zamba2-1.2b's prefill (64 heads, scalar decay [B,T,H,1], T 128, and
     the large tier's 128 heads), and
     K = V = 256 in both modes
     (8 heads, T 128), atol = rtol = 5e-4, the state written in place,
     two calls bit-equal; at T > 1 the other path (`wkv_scan_path`)
     checked and timed beside the one T picks; timed beside its bytes
     bound (no PyTorch call computes the recurrence, so no library time),
     and each path's first case's device time split by kernel
     (torch.profiler).
  4. The first main path: a full-width internlm2-1.8b M_S -> M_L cascade
     on the paged backend with the kernels on, through `build_ladder`,
     `ContinuousCascadeEngine.calibrate` and `.run`, with the launch
     counters reset just before and checked just after (the paged decode
     and the paired write once per layer of each decode step;
     `deferral_entropy` per decode step, per seeding
     prefill dispatch and per M_L or calibration generate step and
     prefill; `flash_attention` per layer of each prefill); plus one
     full-width decode step, kernel path against plain path, by logits
     (a row whose MoE top-k expert set differs between the paths is
     reported apart), one full-width paged prefill, flash kernel against
     `_attend` (fp32 activations and cache, and the main path's bf16
     under a guard),
     and a profiled decode step with its signal.
  8. The paper's cascade evaluation on phase 4's models at full width:
     `core.cascade.Cascade` with the eq.-8 sequence signal over 16 x 128
     tokens (`calibrate_tau` for deferral 0.3, `predict_dense` equal to
     `predict_sparse` up to M_L's batch-to-batch bf16 roundings on
     deferred rows, `metrics.summarize_deferral`), one
     `deferral_entropy` per model's logits and 24 or 4 `flash_attention`
     per forward; then `launch.steps.make_prefill` and one
     `make_serve_step` step through the kernels against the plain
     `fused_confidence` of the same hidden states.
  13. Memory pressure and overload on phase 4's models: a width probe
     (the main path's first 8 prompts prefilled through the engine's
     paged prefill as one 8-row dispatch and as dispatches of 4, 2 and
     1 rows, with `kv_split` as shipped and with no key split, then
     re-prefilled from token 48 as a resume may:
     the largest |d| of the seed logits and the layers whose K/V pages
     are bit-equal); phase 4's 16 requests at its tau on about 2/3 of
     the blocks the first 8 need at full length, oversubscribed x2,
     preempt (bound 4) and a 32-block swap tier: every request DONE,
     preemptions, pool invariants, the launches counted exactly (resume
     re-prefills and dispatches that seed nothing included), tokens,
     deferral and confidences held to phase 4's run (a difference
     passes only where the probe measured a width drift and the
     reference's top-2 margin there is within twice it), the host cost
     of each snapshot and restore; the same requests under Poisson
     arrivals at 8x the rate phase 4's slots served, with a 4-deep queue
     and deadlines
     (each request terminal exactly once, some shed); then the reduced fp32
     internlm2 fixture under tests/test_serving_pressure.py's scenario,
     kernels on: tokens equal to the unconstrained run bit for bit.
  14. The asynchronous and remote M_L tier on phase 4's models. Two
     server processes start first, each with its own CUDA context (this
     script with `--ml-server`: the full-width large tier alone, from
     the same seed, warmed by one generate, behind two `MLServer`s; and
     `python -m repro_torch.launch.ml_server`), and listen before
     anything is timed:
     14a. Phase 4's 16 requests at its tau with M_L through `thread` (a
         worker thread on a CUDA stream of its own), `stub` and `socket`
         (an in-process `MLServer`, its worker on its own stream), each
         with `large_batch` None and then 4 with `max_wait` None, then
         `pool` over two in-process replicas with the first killed as
         its first batch starts (its requests re-dispatched): every
         request DONE, M_S tokens, deferral and confidences bit-equal to
         phase 4's sync run, M_L tokens bit-equal wherever a request's
         M_L batch kept phase 4's rows (elsewhere held to the width rule
         with M_L's own width drift), launches exact with the worker
         threads' and servers'.
     14b. Everything deferred on 16 prompts of two lengths under Poisson
         arrivals, `large_batch` 4, `max_wait` 0.05 s, through `thread`,
         `sync` and `socket` to the second process: the M_S steps
         between each large_submit and its large_complete, the M_L
         queue-depth peak, the makespans, and a profiled thread run's
         kernels and busy time per stream, their overlap and the
         device-busy share.
     14c. Phase 4's requests through `socket` to the second process:
         everything bit-equal to phase 4's sync run, both processes'
         launches exact, the child's start time printed.
     (Then phase 13's reduced pressure run.)
     14d. tests/test_serving_async.py's reduced fp32 fixture, kernels on,
         through the legacy constructor and sync / thread / stub /
         socket / pool: tokens and masks identical; then
         `launch.serve.main()` with --large-backend sync, thread, pool
         --ml-spawn 2, and socket to the `python -m
         repro_torch.launch.ml_server` process: tokens equal.
  16. The N-tier ladder on internlm2-1.8b at published width, through
     `build_ladder(ARCH, SEED, 3, reduce=False)`: tier 0 phase 4's M_S
     (24 layers, 1.889 B), a mid tier of 14 layers with d_ff 12288
     (1.612 B) and the large tier (4 layers at twice the width, 1.631 B),
     each tier's parameters and the peak memory printed; the width rule's
     drift from phase 13's probe (probed anew when run alone) and one bf16
     decode step kernel vs plain:
     16a. Phase 4's 16 requests and prompts, max_new 32, on the paged
         backend with the kernels on and early exit off, both edges on
         mean_confidence, taus from `calibrate_edges` at 0.3 per edge,
         under a caller-owned `Observability` (16e): every request DONE
         at exactly one tier, `tier_served`, `tier_reach`,
         `edge_deferrals` and `compute_cost == ladder_compute_cost(reach,
         costs)` consistent, launches exact (`_expected_launches` over
         every tier's generates, the calibration's included), then the
         sequential reference (each tier's `generate` over what reached
         it): tier 0 row by row under the width rule, each differing row
         printed; tiers 1 and 2 bit for bit over what the engine sent
         them.
     16b. The same ladder with `RecalibConfig(warmup=4)` toward 0.3, early
         exit on, the last tier on its own `thread` backend (its own CUDA
         stream): `edge_tau == tau_final`, and a host replay of
         `EdgeRecalibrator` over the audit log's `recalibrate` events
         gives the run's summary; launches exact.
     16c. `core.prng` on the card: uint32 bits and uniforms equal to the
         numpy version at [4, 92544] over seeds past 2^31 and several
         fold_in steps, the gumbel noise within 2e-6, one draw's time and
         kernel launches; two `sample` calls equal; then the ladder with
         `SemanticAgreementSignal(k=4, temperature=0.8)` on edge 1:
         launches exact (a `sample` is one flash prefill a call), each
         gated request's score and each `finalize`'s milliseconds printed.
     16d. The reduced fp32 three-tier ladder, semantic agreement on both
         edges and recalibration on, every kernel on and then off: taus,
         tokens, tiers, confidences and tau trace equal.
     16e. 16a's runtime: GET /metrics shows serving_requests_retired 16,
         the profiler window's Chrome trace (5 iterations) names
         `gqa_decode_kernel`, the engine's trace passes
         `validate_chrome_trace`; then `python -m
         repro_torch.launch.serve --tiers 3 --signal semantic_agreement
         --recalibrate --metrics-port 0 --profile-dir ...` at the reduced
         size in a process of its own exits 0.
  6. The second main path, the same way: DeepSeek-V2 (MLA + MoE) at its
     published widths, M_S cut to 2 layers (one dense, one MoE layer with
     all 160 routed experts), M_L `build_ladder`'s 4-layer large tier.
     Freed before phase 9.
  9. The third main path: rwkv6-3b (RWKV6, attention-free) at its
     published widths and all 32 layers as M_S, M_L `build_ladder`'s
     4-layer large tier (d 5120), on the slot backend (a recurrent state
     does not page): one full-width prefill of 8 x 128 tokens and one
     decode step, `wkv_scan` against the plain recurrence by logits (fp32
     activations held tight, the config's bf16 layer-0 residual under a
     stated guard), a profiled decode step with its signal, then
     `calibrate` and `.run` with the counters reset just before and
     checked just after, per path: the chunked `wkv_scan` once per layer
     of every prefill (each M_S prefill group, the calibration's prefill,
     each M_L batch's), the per-token one once per layer of every decode
     step of either model, `deferral_entropy` once per such step). Freed
     before phase 11.
  11. The fourth main path, the same way on the slot backend: zamba2-1.2b
     (Mamba2 with one shared attention + MLP block after every 6 layers)
     at its published widths and all 38 Mamba2 layers as M_S, M_L
     `build_ladder`'s 4-layer large tier (d 4096, 128 Mamba2 heads; too
     shallow to call its shared block), fp32 weights and bf16
     activations: `wkv_scan` (mode "mamba") and the shared block's
     `flash_attention` against their plain versions by the logits of one
     prefill and one decode step (fp32 activations held tight, the bf16
     residual stream under a stated guard), a profiled decode step, then
     `calibrate` and `.run` with the launches counted exactly: the
     chunked `wkv_scan` once per Mamba2 layer of every prefill, the
     per-token one once per layer of every decode step,
     `flash_attention` 6 times per M_S prefill and never for M_L,
     `deferral_entropy` as in phase 9. Freed before phase 15.
  15. The four remaining decoders, phase 6's checks on each, one after
     another, each freed before the next: qwen1.5-4b (all 40 layers,
     fp32 weights; MHA with a QKV bias; M_L `tier_runner`'s large tier
     with 8 KV heads), qwen1.5-32b (24 of 64 layers, bf16; M_L the large
     tier), llama3-405b (2 of 126 layers, bf16; M_L the published widths
     at 4 layers) and kimi-k2-1t-a32b (GQA + MoE: the dense layer and
     one MoE layer with all 384 experts; M_L its attention and dense-FFN
     widths, 3 layers, no experts), each cut printed with its reason
     (DECODER_CUTS): the ladder, one decode step and one paged prefill
     kernel path against plain path by logits (fp32 activations to
     STEP_LOGIT_ATOL with no route flip, bf16 under DECODER_LOGIT_GUARD
     with Kimi's rows of another top-8 route apart), a profiled decode
     step, then `calibrate` and `.run` with the launches counted exactly
     as in phase 4; each arch's seconds and peak device memory, which
     must leave DECODER_FREE_GIB of the card free. Freed before phase 5.
  5. The reduced fp32 fixtures of the eight served architectures
     (rwkv6-3b and zamba2-1.2b on the slot backend), every kernel of the
     path switched together by the engine's `paged_kernel`, at a
     calibrated tau: identical deferral masks and greedy tokens per
     request (a request whose confidence lies within 1e-5 of tau is
     reported, not held), and `launch.serve.main()` with defaults and
     with --arch for each of the other seven.
  10. The classifier cascade, tests/test_system.py's flow on the port's
     own draw (seed 0) at that test's sizes: M_S a (64, 64) MLP on 2,000
     rows for 1,500 steps, M_L a (256, 256) MLP on 12,000 rows for 2,500
     steps, M_S tuned with the Gatekeeper loss (alpha 0.1, 1,500 steps on
     a 3,000-row split), acc / s_d / s_o / AUROC before and after tuning
     on the 3,000-row test split, and `Cascade(signal="max_softmax")`
     calibrated at deferral 0.3 on 1,000 of those rows and run by
     `predict_sparse` on the rest; the accuracy gap, s_o down and the
     cascade beating M_S at cost < 1 held; the wall seconds of each fit,
     the tuning and the evaluation; `deferral_entropy` counted exactly
     (one per `evaluate_classifier` batch and per model's logits in
     `calibrate_tau` / `predict_sparse`) and held against its plain
     version on every such logits tensor.
  12. The encoder-decoder and vision-language families through
     `launch.steps` (the JAX engine takes neither frames nor patches):
     12a. whisper-small at its published widths and all 12 + 12 layers
         (stub frames [8, 1500, 768] from the seed, a 16-token decoder
         prompt): the kernel path (`flash_attention` non-causal in the
         encoder and every cross-attention, causal in the decoder's
         prefill; `deferral_entropy`) against the plain one by the
         prefill's and the first step's logits (fp32 activations held to
         1e-3, the config's bf16 under a stated guard) and by the greedy
         tokens and defer masks of make_prefill + 16 make_serve_step
         steps; one profiled serve step; the main path (make_prefill + 16
         steps, kernels on, tau at the 0.3 quantile of the prefill
         confidences) with the launches counted exactly (36
         `flash_attention` per prefill and 12 per step, one
         `deferral_entropy` per prefill and per step); one full-width
         Stage-2 make_train_step step (one `gatekeeper_loss_tokens`).
     12b. phi-3-vision-4.2b the same way at all 32 layers for serving (8
         `make_captions` rows, their 576 patches [8, 576, 3072] prepended
         to BOS; 32 `flash_attention` per prefill, none per step), its
         Stage-2 step cut to 8 layers at its widths (the patch positions
         out of the loss). Each model is freed before the next.
     12c. The reduced fp32 configs, kernel path against plain path:
         identical greedy tokens and defer masks.
  7. Training, after the serving ladders are freed:
     7a. The fused Gatekeeper-loss kernel against its plain version at the
         full-width Stage-2 shapes (T = 16*128 tokens, d 2048, vocab
         92544; bf16 x and fp32 table as the main path gives them, and all
         fp32), twice and bit-equal, bf16 x bit-equal to the same x
         widened to fp32, timed beside its bound at the kernel's TF32 rate
         (the SIMT-rate one beside) and cuBLAS's fp32 logits GEMM; the
         same at phase 12's Stage-2 shapes (whisper-small: 8 x 16 tokens,
         d 768, vocab 51865; phi-3-vision: 8 x (576 + 3) positions, d
         3072, vocab 32064, with `gatekeeper_loss_fused`'s loss under the
         patch mask held against the plain reduction), and phase 17's
         (rwkv6-3b: 16 x 128 tokens, d 2560, vocab 65536; zamba2-1.2b: d
         2048, vocab 32000); phi-3-vision's
         Stage-2 loss forward + backward through `launch.steps`, which
         hands the kernel only its 24 loss rows, against autograd through
         the plain version, and timed; and the gradients of
         `gatekeeper_loss_fused` (kernel forward, chunked backward)
         against autograd through the plain version.
     7b. The training main path: `launch.train.run` on internlm2-1.8b at
         its published width, 2 Stage-1 (CE) and 3 Stage-2 (Gatekeeper)
         steps of 16 x 128 tokens, with the loss kernel's counter set to 0
         just before and checked after every step: none in Stage 1, one
         per Stage-2 step; then one more Stage-2 step under the profiler.
     7c. Reduced fp32 internlm2-1.8b and DeepSeek-V2: one Stage-2 loss and
         gradient through the kernel against `loss_kernel=False`; then a
         reduced `launch.train.run` with --ckpt whose Stage-2 checkpoint
         restores bit for bit.
  17. Training the recurrent families, remat and attn_chunk (autograd):
     17a. `launch.train.run --arch rwkv6-3b --remat full` at its published
         width (32 layers, d 2560, 3.100 B; 49.6 GB of fp32 weight,
         gradient and AdamW state, printed with the reason for full
         remat), 2 Stage-1 and 3 Stage-2 steps of 16 x 128 tokens, the
         counters set to 0 just before and read after every step:
         `wkv_scan` (`wkv_scan_fused`'s forward, all chunked) 32 x (1 +
         1 recompute) a step, one loss kernel a Stage-2 step; peak memory
         per stage, step walls, finite metrics.
     17b. The same for zamba2-1.2b (38 Mamba2 layers and the shared block
         every 6, 1.170 B) with remat none: 38 `wkv_scan` (mode "mamba")
         a step; then one Stage-2 step profiled (device busy and idle,
         top kernels).
     17c. One internlm2-1.8b Stage-2 loss and gradient (16 x 128) under
         remat none, full and dots from the same parameters: each one's
         peak and host wall, full's and dots' gradients held leaf by leaf
         to none's (REMAT_GRAD_RTOL_OF_MAX); then rwkv6-3b's widths at 2
         layers the same way, `wkv_scan` launched 2 x (1 + recomputes)
         times in each mode.
     17d. DeepSeek-V2's published widths, one layer, fp32 activations,
         one 4,096-token prompt with `attn_chunk` 1024 and 0: each one's
         peak, the logits within ATTN_CHUNK_LOGIT_ATOL.
     17e. Reduced fp32 rwkv6-3b and zamba2-1.2b: a Stage-2 loss and
         gradient with the `wkv_scan` kernel forward against the plain
         forward under autograd, every leaf within
         KERNEL_GRAD_RTOL_OF_MAX; then one full-width rwkv6-3b layer in
         its bf16 types under RWKV_LAYER_GRAD_GUARD.
  18. Sharding, ParallelContext and the expert- and sequence-parallel
      paths. First two processes try one NCCL all_reduce on the card and
      the phase prints what NCCL says (it refuses two ranks on one
      device), so 18b-18e run 8 ranks as threads of this process in
      torch's "threaded" process group (created here, not by the port):
      their tensors are on the card and their collectives torch ops, so
      no byte crosses NVLink. Every line names its backend.
     18a. A world of one over NCCL on a (1, 1) DeviceMesh: internlm2-1.8b
         at its widths, depth cut to SCALE_LAYERS, through SCALE_STEPS
         make_serve_step steps and one Stage-2 make_train_step with the
         context, every output, cache leaf and updated parameter bit-equal
         to ctx=None, the launches set to 0 just before and exact after
         (one `deferral_entropy` a step, one loss kernel); one NCCL
         all_to_all_single and one all_reduce.
     18b. One DeepSeek-V2 MoE layer at published width (d 5120, 160
         experts top-6, d_ff 1536, 2 shared of 3072, bf16) on a (2, 4)
         mesh: the scatter path (8 x 128 tokens) and the decode path
         (8 x 1) at capacity factor 8 against `_moe_local_math` on the
         same card (MOE_BF16_GUARD); the dropped share at the published
         1.25.
     18c. One kimi-k2-1t-a32b MoE layer (384 experts top-8, d 7168, d_ff
         2048, 31.6 GiB) through the decode path under expert_ffn ->
         data: weight blocks as views, the peak above the weights under
         one rank's block.
     18d. The sequence-sharded GQA decode against the dense decode (fp32
         activations, bf16 cache, SHARD_DECODE_ATOL), the owner ranks'
         cache write against the dense path's, and the rest of the cache
         against a copy taken before: kimi-k2's 64/8 x 112 at
         `decode_32k` (B 128, S 32768, cache_seq -> (data, model)) and
         llama3-405b's 128/8 x 128 at B 1 over 524,288 positions
         (default rules: the KV heads shard over model).
     18e. Kimi-k2's serve-step signal with unembed_d -> data: each rank's
         summed partial logits through one `deferral_entropy` launch,
         8 launches. The summed logits against the full product
         (SHARD_LOGIT_ATOL); each rank's kernel result against
         `deferral_entropy_plain` on its logits at these 128 rows
         (SIGNAL_ATOL); the sharded signal against the unsharded one
         within twice the first-order effect of the measured logit
         error plus the two kernels' measured errors.
  19. The dry-run (`launch.dryrun`), held against the card, and the
      examples, each part alone on the host. 19a: DRYRUN_WORKERS spawned
      processes trace DRYRUN_COMBOS, one per family and shape kind at
      published widths (meta tensors, a fake world of 256 ranks; full
      depth but for rwkv6-3b's and zamba2-1.2b's train and prefill, cut
      to DRYRUN_CUT layers), llama3-405b train_4k on 2 x 16 x 16 and
      JAX's gather-tokens MoE decode, one line a combo (dominant term,
      compute / memory / collective seconds, fits_hbm, per-rank peak and
      sharded-state GiB, collective GiB by op, trace seconds), all
      written to chiprun_out/dryrun_torch.jsonl; any combo that raises
      fails the phase.
     19b. internlm2-1.8b at its published width, all 24 layers, bf16
         (`adapt_for_shape`), a world of one with ctx None, at
         ROOF_SHAPES (prefill 8 x 4096, decode 32 rows over a 4,096-token
         cache, Stage-2 train 2 x 2048): (i) the meta trace's FLOP count
         equals FlopCounterMode's of the same step on the card with the
         kernels off, as integers; (ii) the plain step's median wall (CUDA
         events, ROOF_CALLS calls after a warm-up) is at least
         ROOF_MIN_RATIO x max(compute_s, memory_s) of its roofline, and
         its device time by kernel under torch.profiler is printed; (iii)
         `max_memory_allocated` over one plain step lies within
         ROOF_PEAK_RTOL of the traced peak; (iv) the same step with the
         kernels on launches exactly 24 `flash_attention` + 1
         `deferral_entropy` (prefill), 1 `deferral_entropy` (decode) or 1
         `gatekeeper_loss_tokens` (train), its outputs held as phases 8
         and 7 hold theirs (the prefill: the K/V of every layer, row
         and position within PREFILL_CACHE_RTOL, the last position's
         logits within PREFILL_LOGIT_GUARD, the step's signal against the
         plain one on the kernel path's logits as phase 8 holds it; phase
         3d holds the flash kernel alone at this shape), and its time
         printed beside the bound.
     19c. examples/torch_quickstart.py, torch_lm_cascade.py,
         torch_serve_cascade.py at their defaults and torch_train_100m.py
         at 20 + 10 steps, as four child processes at once: each exits 0
         with its JSON result line last.
  20. The port's static analysis on the machine that builds the kernels:
      (a) `python -m repro_torch.analysis --paths src/repro_torch
      chip_smoke.py`, as CI runs it, exits 0 modulo
      analysis_baseline_torch.json (findings by rule, baselined and stale
      counts printed); (b) each csrc/*.cu through `nvcc -E -x cu` with the
      build's flags gives the extern "C" signatures of the raw source's
      parse (`kernel_contracts.own_text` keeps the source's own lines);
      (c) `nm -D --defined-only` on each built library: its C-linkage
      exports are exactly that set; (d) a copy of a kernel module with one
      argtypes entry dropped makes the CLI exit 1 with KC001. The phase's
      seconds are printed beside the card's name and power limit.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or the repository's sources are missing.
"""
import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
H100_TF32X3_FLOPS = 495e12 / 3   # fp32 as three TF32 tensor-core products
                                 # (495 TFLOP/s dense TF32, data sheet)
H100_TF32X2_FLOPS = 495e12 / 2   # bf16 x fp32 as two TF32 products (the
                                 # bf16 operand is exact in TF32)
H100_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores

# main-path configurations (full width, one card)
ARCH = "internlm2-1.8b"
MLA_ARCH = "deepseek-v2-236b"
MLA_SMALL_LAYERS = 2            # one dense + one MoE layer: a whole period
N_SLOTS, BLOCK, CHUNK = 8, 16, 128
N_REQUESTS, RAGGED, MAX_NEW, DEFERRAL = 16, (64, 256), 32, 0.3
SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 200_000_000      # ~0.1 s of GPU clock ahead of each timing

# tolerances
DECODE_ATOL = 1e-4     # fp32 accumulation in both, summed in other orders
STEP_LOGIT_ATOL = 1e-3  # one full-width decode step with fp32 activations
                        # over the bf16 cache: fp32 rounding through 24 layers
STEP_LOGIT_GUARD = 0.2  # the same step with the main config's bf16
                        # activations: a last-bit difference after the fp32
                        # attention can flip a bf16 rounding of the residual
                        # stream. Sound readings on an H100 were 0.053 and
                        # 0.064; the guard is about 3x the larger
MLA_STEP_LOGIT_GUARD = 0.2  # DeepSeek-V2 step in bf16, rows whose MoE
                        # routes agree: the plain path also rounds the normed
                        # latent to bf16 (as JAX does) where the kernel keeps
                        # it fp32. Sound readings on an H100 were 0.0586 and
                        # 0.0568; the guard is about 3x the larger
MAX_ROUTE_FLIPS = N_SLOTS // 2  # bf16 step: rows whose top-k expert set may
                        # differ between the paths. Such a row takes another
                        # expert's output, a change as large as a logit's
                        # spread, so it is reported and held to no bound;
                        # the fp32 step allows none
L2_BYTES = 50e6
LONG_CACHE = 4096       # phases 3, 3b: tokens per row of the long-cache decode

# phases 3c, 3d and 8: the deferral signal, prefill attention, evaluation
SIGNAL_ATOL = 1e-4      # neg_entropy / max_prob: fp32 sums over the
                        # vocabulary in other orders, then exp/log
FLASH_ATOL = 1e-4       # fp32 online softmax against a one-shot softmax
FLASH_BF16_RTOL = 2 ** -7  # bf16 outputs, on top of FLASH_ATOL: both sides
                        # round nearly equal fp32 values to bf16, at most
                        # one bf16 step (<= 2^-7 of the value) apart
CONF_NEAR_TAU = 1e-5    # reduced fixtures: a request this close to tau
                        # may defer on one path only; reported, not held
EVAL_SEQS, EVAL_LEN, EVAL_DEFERRAL = 16, 128, 0.3
# (rows, vocabulary): the engine's internlm2-1.8b and DeepSeek-V2 decode
# logits, then the evaluation's [EVAL_SEQS * EVAL_LEN, V], then phase 10's
# classifier logits (calibration rows, test split) and a class count whose
# rows are not 16-byte aligned (the kernel's scalar loads), then phase 12's
# whisper-small (an odd vocabulary: scalar loads) and phi-3-vision logits,
# then phase 15's: qwen1.5-4b, qwen1.5-32b, llama3-405b and kimi-k2-1t-a32b
SIGNAL_SHAPES = ((N_SLOTS, 92544), (N_SLOTS, 102400), (N_SLOTS, 65536),
                 (N_SLOTS, 32000), (EVAL_SEQS * EVAL_LEN, 92544), (1000, 8),
                 (3000, 8), (3000, 10), (N_SLOTS, 51865), (N_SLOTS, 32064),
                 (N_SLOTS, 151936), (N_SLOTS, 152064), (N_SLOTS, 128256),
                 (N_SLOTS, 163840))

# phase 13: memory pressure and overload on phase 4's models
PRESSURE_OVERSUB = 2.0  # the paged pool's virtual budget over its blocks
PRESSURE_SHARE = 2 / 3  # blocks: this share of what the first N_SLOTS
                        # requests need at full length (never under the
                        # largest request's)
PRESSURE_MAX_PREEMPT, PRESSURE_SWAP = 4, 32
PROBE_WIDTHS = (4, 2, 1)  # prefill dispatch widths held to one of N_SLOTS
PROBE_RESUME_AT = 48    # a block-aligned, not chunk-aligned, re-prefill
OVERLOAD_QUEUE = 4      # the overload run's ready-queue bound
OVERLOAD_RATE_X = 8.0   # its arrival rate over the rate phase 4's 8 slots
                        # served (its makespan less the M_L drain): the 16
                        # arrive before the first 8 finish, the queue fills
OVERLOAD_DEADLINE_SHARE = 0.25  # its deadline over the pressure makespan

# phase 14: the asynchronous and remote M_L tier on phase 4's models
ML_BATCH = 4            # rows per M_L batch in 14a's second pass, 14b, 14d
ML_MAX_WAIT = 0.05      # 14b: seconds a partial M_L batch may wait
ML_LENS = (96, 160)     # 14b: prompt lengths, alternating, so that M_L's
                        # length groups fill (as in the JAX test)
ML_STUB_LATENCY = 0.002  # 14a's stub backend: injected seconds a batch
ML_PROBE_PROMPTS = 2    # prompts of the M_L width probe
ML_START_TIMEOUT = 600  # seconds a server process may take to listen
ML_RPC_TIMEOUT = 120.0  # socket / pool request timeout (full-width batches)

# phase 10: the classifier cascade, tests/test_system.py's flow on the
# port's own draw (seed SEED) at that test's sizes
CLS_CLASSES, CLS_HARD_FRAC = 8, 0.45
CLS_SPLITS = {"train": (None, 2000), "train_large": (5, 12000),
              "cal": (7, 3000), "test": (1, 3000)}   # name: (fold, rows)
CLS_SMALL, CLS_LARGE = (64, 64), (256, 256)           # hidden widths
CLS_SMALL_STEPS, CLS_LARGE_STEPS, CLS_TUNE_STEPS = 1500, 2500, 1500
CLS_BATCH, CLS_ALPHA, CLS_DEFERRAL, CLS_CAL_ROWS = 256, 0.1, 0.3, 1000
CLS_EVAL_BATCH = 4096   # evaluate_classifier's rows per signal launch
CLS_PROFILE_STEPS = 20  # steps of each model's step under the profiler

# phases 3e and 9: the RWKV recurrence and rwkv6-3b serving
RWKV_ARCH = "rwkv6-3b"
WKV_ATOL = WKV_RTOL = 5e-4  # as tests/test_kernels.py holds the TPU kernel:
                        # fp32 sequential recurrence against the chunked
                        # algebra's exp(cum_t - cum_s) sums
# (label, mode, B, T, H, K, scalar decay, strong decay): rwkv6-3b's and
# zamba2-1.2b's decode steps (M_S and the large tier), rwkv6-3b's prefill
# (a prime T, short segments about the paths' crossover at
# wkv_scan.CHUNKED_MIN_T, one row of the longest prompt, RWKV6's strong
# decays down to -20 a token), zamba2-1.2b's Mamba2 prefills, K = V = 256
# in both modes
WKV_CASES = (
    ("rwkv decode", "rwkv", N_SLOTS, 1, 40, 64, False, False),
    ("mamba decode (zamba2)", "mamba", N_SLOTS, 1, 64, 64, True, False),
    ("mamba decode (zamba2 M_L)", "mamba", N_SLOTS, 1, 128, 64, True,
     False),
    ("rwkv prefill", "rwkv", N_SLOTS, CHUNK, 40, 64, False, False),
    ("rwkv prefill, prime T", "rwkv", N_SLOTS, 97, 40, 64, False, False),
    ("rwkv prefill, T 2", "rwkv", N_SLOTS, 2, 40, 64, False, False),
    ("rwkv prefill, T 16", "rwkv", N_SLOTS, 16, 40, 64, False, False),
    ("rwkv prefill, T 32", "rwkv", N_SLOTS, 32, 40, 64, False, False),
    ("rwkv prefill, T 48", "rwkv", N_SLOTS, 48, 40, 64, False, False),
    ("rwkv prefill, T 64", "rwkv", N_SLOTS, 64, 40, 64, False, False),
    ("rwkv prefill, one row", "rwkv", 1, RAGGED[1], 40, 64, False, False),
    ("rwkv prefill, strong decay", "rwkv", N_SLOTS, CHUNK, 40, 64, False,
     True),
    ("mamba (zamba2)", "mamba", N_SLOTS, CHUNK, 64, 64, True, False),
    ("mamba (zamba2 M_L)", "mamba", N_SLOTS, CHUNK, 128, 64, True, False),
    ("rwkv K=V=256", "rwkv", N_SLOTS, CHUNK, 8, 256, False, False),
    ("mamba K=V=256", "mamba", N_SLOTS, CHUNK, 8, 256, True, False))
WKV_PROFILE_CALLS = 10  # calls of each path's first case under the profiler
RWKV_PROMPT = CHUNK     # the one-step check's prompt length
RWKV_LOGIT_GUARD = 1.0  # the same checks in the config's own types: the
                        # residual stream is bf16 in layer 0 only, where a
                        # last-bit difference of the recurrence's output can
                        # flip a bf16 rounding (2^-8 of the value) that 31
                        # fp32 layers of random weights amplify (the fp32
                        # prefill already moves by 4.3e-4 from differences
                        # near 1e-6). A sound prefill reading on an H100 was
                        # 0.309; the guard is about 3x it

# phase 11: zamba2-1.2b serving (the phase 9 checks on a Mamba2 hybrid)
ZAMBA_ARCH = "zamba2-1.2b"
ZAMBA_LOGIT_GUARD = {"prefill": 0.95, "decode step": 0.28}  # the
                        # kernel-vs-plain checks in the config's own types:
                        # the residual stream stays bf16 through all 38
                        # Mamba2 layers and 6 shared-block calls, so a
                        # last-bit difference of a recurrence's or an
                        # attention's output flips a bf16 rounding that
                        # every later layer carries. tools/zamba_bf16_probe.py
                        # (three seeds, H100) found it: 0.7% of layer 0's
                        # bf16 outputs differ by one step, 96% of layer
                        # 37's; the plain recurrence summed in another
                        # order, with no kernel, moves the logits as much
                        # (0.265-0.297 prefill, 0.073-0.093 decode) as the
                        # kernels (0.270-0.318, 0.083-0.091), and fp32
                        # activations hold them to 1.7e-4. Each guard is
                        # about 3x the largest reading; the binding check
                        # of the kernels is the fp32 one at STEP_LOGIT_ATOL

# phase 15: the four remaining decoders at published widths, the depth
# cut only where one card forces it. Per arch: (M_S layers, or None for
# all; M_L: None for `tier_runner`'s large tier, else the replacements
# of a `ModelRunner` over the published config on the tier-1 seed)
DECODER_ARCHS = ("qwen1.5-4b", "qwen1.5-32b", "llama3-405b",
                 "kimi-k2-1t-a32b")
DECODER_TIERS = {
    "qwen1.5-4b": (None, None),
    "qwen1.5-32b": (24, None),
    "llama3-405b": (2, dict(n_layers=4)),
    "kimi-k2-1t-a32b": (2, dict(n_layers=3, family="dense", moe=None)),
}
DECODER_CUTS = {      # each cut with its reason (parameters from the configs)
    "qwen1.5-4b": "M_S all 40 layers (3.95 B fp32 parameters, 15.8 GB); "
                  "M_L tier_runner's large tier (d 5120, 4 layers) with 8 KV "
                  "heads in place of 20, since 20 KV heads over its 8 query "
                  "heads is no GQA (2.49 B fp32, 10.0 GB)",
    "qwen1.5-32b": "M_S 24 of 64 layers (14.2 B bf16 parameters, 28.3 GB): "
                   "all 64 hold 35.2 B (70.4 GB) and leave no room for M_L; "
                   "M_L tier_runner's large tier (d 10240, 4 layers, 8 KV "
                   "heads; 10.0 B, 20.0 GB)",
    "llama3-405b": "M_S 2 of 126 layers (3.19 B parameters a layer; 10.6 B, "
                   "21.2 GB with the two 2.1 B vocabulary tables); M_L the "
                   "published widths at 4 layers on the tier-1 seed (17.0 B, "
                   "33.9 GB): tier_runner's doubled-width tier holds 41.9 B "
                   "parameters (84 GB) in its FFNs alone",
    "kimi-k2-1t-a32b": "M_S 2 of 61 layers, the dense one and one MoE layer "
                       "with all 384 routed experts (16.9 B expert "
                       "parameters, 33.8 GB; 19.9 B, 39.9 GB in all); M_L "
                       "Kimi's attention and dense-FFN widths with no routed "
                       "experts (family dense), 3 layers (3.9 B, 7.8 GB): a "
                       "second MoE layer would add 33.8 GB, tier_runner's "
                       "doubled-width MoE layer is 67.6 GB",
}
DECODER_LOGIT_GUARD = {  # the bf16 steps, kernel vs plain path, on rows
    # whose MoE routes agree: a last-bit difference after the fp32
    # attention can flip a bf16 rounding of the residual stream. Sound
    # readings on an H100 in two runs (decode; prefill): qwen1.5-4b
    # 0.0746, 0.0772; 0.0872. qwen1.5-32b 0.0795, 0.0854; 0.0864.
    # llama3-405b 0.0497, 0.0509; 0.0497. Kimi 0.0508, 0.0496; 0.0544,
    # 0.0555 (each with one row of another top-8 route apart, 0.34-0.47).
    # The guards are about 3x the larger reading, never looser than
    # phase 4's
    "qwen1.5-4b": STEP_LOGIT_GUARD,
    "qwen1.5-32b": STEP_LOGIT_GUARD,
    "llama3-405b": 0.15,
    "kimi-k2-1t-a32b": 0.15,
}
DECODER_FREE_GIB = 10   # each arch's peak must leave this much of the card

# phase 16: the N-tier ladder, recalibration, semantic agreement, obs
LADDER_TIERS = 3        # internlm2-1.8b, a 14-layer mid tier, the large tier
LADDER_WARMUP = 4       # 16b: observations before a controller may move
SEMANTIC_K, SEMANTIC_T = 4, 0.8  # 16c, 16d: samples a vote, temperature
PRNG_SHAPE = (SEMANTIC_K, 92544)  # 16c: one sampled step's noise
PRNG_SEEDS = (2 ** 31, 2 ** 31 + 12345, 2 ** 32 - 1)
PRNG_STEPS = (0, 1, MAX_NEW - 1)
GUMBEL_ATOL = 2e-6      # -log(-log(u)): each library's fp32 log, a few
                        # ulp of values below 17 (tests/test_torch_cuda.py)
OBS_PROFILE_ITERS = 5   # 16e: engine iterations in the profiler window
LADDER_CLI_TIMEOUT = 300  # 16e: seconds the reduced serve CLI may take

# phase 7: training
TRAIN_BATCH, TRAIN_SEQ, STAGE1_STEPS, STAGE2_STEPS = 16, 128, 2, 3
LOSS_T = TRAIN_BATCH * TRAIN_SEQ  # Stage-2 tokens per step
LOSS_ATOL = 1e-3        # ce / kl / entropy: fp32 logits over d = 2048 summed
                        # in other orders than cuBLAS's, then exp/log
TIE_GAP = 1e-4          # rows whose top-2 logits lie closer may flip
                        # `correct`; they are reported and held to no bound
DX_RTOL_OF_MAX = 1e-2   # bf16 dx: both sides round nearly equal fp32
                        # gradients to bf16, which can land one bf16 step
                        # (up to 2^-7 of the largest entry) apart
DTABLE_RTOL_OF_MAX = 1e-4  # fp32 dtable, the same sums in other orders
REDUCED_GRAD_RTOL_OF_MAX = 1e-4  # reduced fp32 step, kernel vs chunked loss

# phase 12: the encoder-decoder and VLM families through launch.steps
WHISPER_ARCH = "whisper-small"
VLM_ARCH = "phi-3-vision-4.2b"
ENC_PROMPT = 16         # whisper's decoder prompt (tokens)
GREEDY_STEPS = 16       # make_serve_step steps after make_prefill
STEPS_TAU_QUANTILE = 0.3  # tau: this quantile of the prefill confidences
STEPS_LOGIT_GUARD = 0.3  # kernel vs plain logits with the configs' bf16
                        # activations: a last-bit difference of an fp32
                        # attention output can flip a bf16 rounding of the
                        # residual stream, which every later layer carries
                        # (whisper's encoder output also feeds every cross
                        # K/V). Sound readings on an H100 were 0.036
                        # (whisper's prefill) and 0.096 (phi-3-vision's);
                        # the guard is about 3x the larger. The binding
                        # check of the path's kernels is the fp32-activation
                        # one at STEP_LOGIT_ATOL
VLM_TRAIN_LAYERS = 8    # phi-3-vision's Stage-2 step: the depth cut. fp32
                        # weights, gradients and two AdamW moments take 16 B
                        # a parameter: 57 GiB at all 32 layers before
                        # activations. At 8 layers (1.103 B parameters, 16.4
                        # GiB of state) the plain attention's saved scores
                        # and probabilities (8 x 32 x 579^2 fp32, 0.34 GB
                        # each, per layer) and the MLP's activations leave
                        # a wide margin on the 80 GB card

# phase 17: training RWKV6 and the Mamba2 hybrid at published widths, remat
# and attn_chunk
REMAT_RECOMPUTES = {"none": 0, "full": 1, "dots": 1}  # forwards of each
                        # layer the backward reruns: the port's remat
                        # recomputes a layer once, whatever it saved
RECURRENT_TRAIN = ((RWKV_ARCH, "full"), (ZAMBA_ARCH, "none"))
STATE_BYTES_PER_PARAM = 16  # fp32 weights, gradients and AdamW's two moments
REMAT_REASON = {
    "full": "fp32 weights, gradients and two AdamW moments take 16 B a "
            "parameter before any activation, so each layer keeps only "
            "its input and recomputes the rest in the backward",
    "none": "its weights, gradients and moments leave room for every "
            "layer's activations"}
REMAT_LAYERS_RWKV = 2   # 17c's recurrent case: rwkv6-3b's widths, 2 layers
REMAT_GRAD_RTOL_OF_MAX = 1e-5  # 17c: full and dots against none, per leaf
                        # (readings on an H100: 0, every leaf bit-equal at
                        # both configs: the recompute reruns the same ops)
ATTN_CHUNK, ATTN_CHUNK_PROMPT = 1024, 4096  # 17d: DeepSeek-V2, one layer
ATTN_CHUNK_LOGIT_ATOL = 1e-4  # tests/test_torch_remat.py's chunked-vs-
                        # unchunked logits bound, fp32 activations
KERNEL_GRAD_RTOL_OF_MAX = 1e-4  # 17e: reduced fp32, kernel forward vs plain
RWKV_LAYER_GRAD_GUARD = 2e-2  # 17e: one full-width rwkv6-3b layer in its
                        # own bf16 types, kernel forward vs plain, per leaf:
                        # the kernel's fp32 output, a last bit apart from
                        # the plain one's, flips bf16 roundings of the
                        # layer's residual add, which the loss's gradients
                        # carry back; about 3x the H100 reading of 0.0060
                        # (the reduced fp32 readings: 2.1e-5 and 1.2e-5)


def phase(name: str, t_start: float) -> None:
    """Mark the start of a phase with the script's elapsed seconds."""
    print(f"[time] {time.perf_counter() - t_start:7.1f} s  phase {name}")


def _fail_early(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(2)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of `fn`: CUDA events around
    `iters` calls. A sleep kernel queued first keeps the GPU busy while
    the host enqueues the calls, so host launch overhead is hidden and
    the calls run back to back."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = H100_FP32_FLOPS):
    """Least milliseconds for the work: bytes over the memory rate or
    operations over the peak rate of their inputs' type, the larger."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def case_tables(torch, rng, pos=None) -> dict:
    """The main path's decode state at its widest: 8 rows, a table as wide
    as the widest active prefix, ragged positions with one row at the last
    position the main path reaches, and row 7 unmapped (all trash). Given
    `pos`, every row is mapped up to its position instead."""
    B, bs = N_SLOTS, BLOCK
    trash = pos is None
    if trash:
        M = math.ceil((RAGGED[1] + MAX_NEW) / bs)    # 18 blocks per row
        pos = [70, RAGGED[1] + MAX_NEW - 1, 130, 200, 96, 180, 240, 150]
    else:
        M = math.ceil((max(pos) + 1) / bs)
    n_map = [math.ceil((p + 1) / bs) for p in pos]
    if trash:
        n_map[-1] = 0                                # the all-trash row
    N = N_SLOTS * M
    perm = rng.permutation(N) + 1
    tables = torch.zeros((B, M), dtype=torch.int32)
    used = 0
    for b, n in enumerate(n_map):
        tables[b, :n] = torch.from_numpy(perm[used:used + n].astype("int32"))
        used += n
    valid_tokens = sum(min(p + 1, n * bs) for p, n in zip(pos, n_map))
    # table entries the decode reads: those of blocks 0 .. pos // bs
    table_entries = sum(min(M, math.ceil((p + 1) / bs)) for p in pos)
    return dict(tables=tables.to(DEV),
                pos=torch.tensor(pos, dtype=torch.int32, device=DEV),
                valid_tokens=valid_tokens, table_entries=table_entries,
                B=B, M=M, N=N, trash_row=trash)


def decode_case(torch, kv_dtype, rng, H=16, KV=8, pos=None, copies=8,
                hd=128):
    """Full-width GQA decode inputs on `case_tables` (internlm2-1.8b's
    16/8 heads of 128 by default). The rotating page copies exceed the
    50 MB L2, so timed launches read their pages from device memory as the
    decode loop does (24 layers of weights pass through L2 between two
    visits of one layer's cache)."""
    c = case_tables(torch, rng, pos)
    q = torch.randn((c["B"], 1, H, hd), device=DEV)
    c["pages"] = [
        (torch.randn((c["N"] + 1, BLOCK, KV, hd), device=DEV).to(kv_dtype),
         torch.randn((c["N"] + 1, BLOCK, KV, hd), device=DEV).to(kv_dtype))
        for _ in range(copies)]
    c.update(q=q, H=H, KV=KV, hd=hd)
    return c


def mla_case(torch, dtype, rng, pos=None):
    """Full-width DeepSeek-V2 MLA decode inputs on `case_tables` (`pos`
    as there), every operand in `dtype`. Enough rotating page copies to
    exceed twice the L2 (between two visits of one layer's cache the main
    path streams gigabytes of expert weights through it)."""
    c = case_tables(torch, rng, pos)
    H, r, dr = 128, 512, 64
    copy_bytes = (c["N"] + 1) * BLOCK * (r + dr) * torch.finfo(dtype).bits / 8
    R = math.ceil(2 * L2_BYTES / copy_bytes)
    c["pages"] = [
        (torch.randn((c["N"] + 1, BLOCK, r), device=DEV).to(dtype),
         torch.randn((c["N"] + 1, BLOCK, dr), device=DEV).to(dtype))
        for _ in range(R)]
    c.update(q_abs=torch.randn((c["B"], 1, H, r), device=DEV).to(dtype),
             q_rope=torch.randn((c["B"], 1, H, dr), device=DEV).to(dtype),
             kv_norm=(0.1 * torch.randn(r, device=DEV)).to(dtype),
             H=H, r=r, dr=dr, scale=1.0 / math.sqrt(128 + dr))
    return c


class Rotation:
    """Cycles through input copies, one per call."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def __call__(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def check_decode_kernel(torch, pa, c, label, smi) -> dict:
    """paged_flash_decode_gqa against its plain version; times both and
    SDPA. Returns the kernel's record."""
    q, tables, pos = c["q"], c["tables"], c["pos"]
    kp, vp = c["pages"][0]
    out = pa.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    ref = pa.paged_flash_decode_gqa_plain(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and err <= DECODE_ATOL):
        raise AssertionError(f"paged_flash_decode_gqa ({label}) "
                             f"max |err| {err} > {DECODE_ATOL}")
    if c["trash_row"] and out[-1].abs().max() != 0:
        raise AssertionError("all-trash row is not exact zeros")
    pages = Rotation(c["pages"])
    ms = time_ms(lambda: pa.paged_flash_decode_gqa(q, *pages(), tables, pos))
    plain_ms = time_ms(lambda: pa.paged_flash_decode_gqa_plain(
        q, *pages(), tables, pos))
    # yardstick only, never called by the port: SDPA over the pre-gathered
    # bf16 view, K/V heads expanded to the query heads beforehand
    S, group = c["M"] * BLOCK, c["H"] // c["KV"]
    mask = ((torch.arange(S, device=DEV)[None, :] <= pos[:, None])
            & (tables.repeat_interleave(BLOCK, 1) > 0))[:, None, None, :]
    idx = tables.long().reshape(-1)
    views = Rotation([tuple(
        t[idx].reshape(c["B"], S, c["KV"], c["hd"]).transpose(1, 2)
        .repeat_interleave(group, dim=1).to(torch.bfloat16) for t in pg)
        for pg in c["pages"]])
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, *views(), attn_mask=mask))
    n_bytes = (2 * c["valid_tokens"] * c["KV"] * c["hd"] * kp.element_size()
               + 2 * q.numel() * q.element_size() + 4 * c["table_entries"]
               + 4 * pos.numel())
    flops = 4 * c["valid_tokens"] * c["H"] * c["hd"]
    bound_ms, bound_by = bound(n_bytes, flops)
    print(f"[kernel] paged_flash_decode_gqa q fp32, {label} ({c['B']} rows,"
          f" {c['H']}/{c['KV']} heads, {c['valid_tokens']} valid tokens, "
          f"table {c['M']} blocks): max|err| {err:.3g} (atol {DECODE_ATOL})"
          + (", all-trash row exact 0" if c["trash_row"] else "")
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa(gathered) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: {n_bytes} B,"
          f" {flops} fp32 flop; {len(c['pages'])} page copies) on {smi}")
    return dict(name="paged_flash_decode_gqa", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def check_write_kernel(torch, pa, c, kv_name, kv_dtype, smi) -> dict:
    """The paged write of one decode layer: fp32 K and V values into two
    leaves, in place, through one `paged_write_token_pair` launch; each
    leaf bit for bit against its plain version outside the trash block,
    and the one-leaf `paged_write_token` the same way. Times the layer's two writes, their plain versions and
    two `index_put_`. Returns the kernel's record."""
    tables, pos = c["tables"], c["pos"]
    vk, vv = (torch.randn((c["B"], c["KV"], c["hd"]), device=DEV)
              for _ in range(2))
    pairs = [(pg[0].clone(), pg[1].clone()) for pg in c["pages"]]
    ka, va = pairs[0]
    ref_k = pa.paged_write_token_plain(ka.clone(), tables, pos, vk)
    ref_v = pa.paged_write_token_plain(va.clone(), tables, pos, vv)
    single = pa.paged_write_token(ka.clone(), tables, pos, vk)

    def write(k, v):
        return pa.paged_write_token_pair(k, v, tables, pos, vk, vv)
    got_k, got_v = write(ka, va)
    torch.cuda.synchronize()
    err = max(float((g[1:].float() - r[1:].float()).abs().max())
              for g, r in ((got_k, ref_k), (got_v, ref_v), (single, ref_k)))
    if err != 0 or got_k is not ka or got_v is not va:
        raise AssertionError(f"paged write ({kv_name} leaves) is not "
                             f"bit-exact in place outside block 0: {err}")
    leaves = Rotation(pairs)
    ms = time_ms(lambda: write(*leaves()))

    def plain(k, v):
        pa.paged_write_token_plain(k, tables, pos, vk)
        pa.paged_write_token_plain(v, tables, pos, vv)
    plain_ms = time_ms(lambda: plain(*leaves()))
    blk = torch.clamp(pos.long() // BLOCK, 0, c["M"] - 1)
    phys = tables.long().gather(1, blk[:, None])[:, 0]
    off = pos.long() % BLOCK
    ck, cv = vk.to(kv_dtype), vv.to(kv_dtype)

    def index_put(k, v):
        k.index_put_((phys, off), ck)
        v.index_put_((phys, off), cv)
    lib_ms = time_ms(lambda: index_put(*leaves()))
    # both leaves' values, one table entry and one position a row
    n_bytes = (2 * vk.numel() * (4 + ka.element_size()) + 4 * c["B"]
               + 4 * pos.numel())
    bound_ms, bound_by = bound(n_bytes, 0)
    print(f"[kernel] paged write fp32 K and V -> two {kv_name} leaves "
          f"(one paged_write_token_pair launch): bit-exact outside block 0, the one-leaf write too; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, 2 x index_put_ "
          f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {n_bytes}"
          f" B) on {smi}")
    return dict(name="paged_write_token", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:250",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def check_mla_kernel(torch, pa, c, name, smi) -> dict:
    """paged_flash_decode_mla against its plain version, two calls
    bit-equal; times both and SDPA, and the kernel's device time by kernel
    under torch.profiler. Returns the kernel's record."""
    tables, pos, scale = c["tables"], c["pos"], c["scale"]
    qa, qr, w = c["q_abs"], c["q_rope"], c["kv_norm"]
    ckv, kr = c["pages"][0]
    out = pa.paged_flash_decode_mla(qa, qr, ckv, kr, w, tables, pos,
                                    scale=scale)
    again = pa.paged_flash_decode_mla(qa, qr, ckv, kr, w, tables, pos,
                                      scale=scale)
    ref = pa.paged_flash_decode_mla_plain(qa, qr, ckv, kr, w, tables, pos,
                                          scale=scale)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not (out.dtype == torch.float32 and torch.isfinite(out).all()
            and err <= DECODE_ATOL):
        raise AssertionError(f"paged_flash_decode_mla ({name}) max |err| "
                             f"{err} > {DECODE_ATOL}")
    if not torch.equal(out, again):
        raise AssertionError(f"paged_flash_decode_mla ({name}): two calls "
                             f"differ")
    if c["trash_row"] and out[-1].abs().max() != 0:
        raise AssertionError("MLA all-trash row is not exact zeros")
    pages = Rotation(c["pages"])
    ms = time_ms(lambda: pa.paged_flash_decode_mla(
        qa, qr, *pages(), w, tables, pos, scale=scale))
    by_kernel = kernel_split(
        torch, lambda: pa.paged_flash_decode_mla(qa, qr, *pages(), w, tables,
                                                 pos, scale=scale),
        20, r"(mla_\w*kernel)")
    plain_ms = time_ms(lambda: pa.paged_flash_decode_mla_plain(
        qa, qr, *pages(), w, tables, pos, scale=scale))
    # yardstick only, never called by the port: one SDPA over the
    # pre-gathered, pre-normed bf16 view, the latent as one shared KV head
    # and the 128 query heads as its query rows
    B, S = c["B"], c["M"] * BLOCK
    idx = tables.long().reshape(-1)
    mask = ((torch.arange(S, device=DEV)[None, :] <= pos[:, None])
            & (tables.repeat_interleave(BLOCK, 1) > 0))[:, None, None, :]

    def view(pg):
        lat = pg[0][idx].reshape(B, S, c["r"]).float()
        lat = lat * torch.rsqrt(lat.pow(2).mean(-1, keepdim=True) + 1e-6) * (
            1.0 + w.float())
        k = torch.cat([lat, pg[1][idx].reshape(B, S, c["dr"]).float()], -1)
        return (k[:, None].to(torch.bfloat16),
                lat[:, None].to(torch.bfloat16))
    views = Rotation([view(pg) for pg in c["pages"]])
    qb = torch.cat([qa, qr], -1).transpose(1, 2).to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, *views(), attn_mask=mask, scale=scale))
    H, r, dr = c["H"], c["r"], c["dr"]
    n_bytes = (c["valid_tokens"] * (r + dr) * ckv.element_size()
               + qa.numel() * qa.element_size() + qr.numel() * qr.element_size()
               + w.numel() * w.element_size() + out.numel() * 4
               + 4 * c["table_entries"] + 4 * pos.numel())
    # per valid position: scores 2H(r+dr), values 2Hr, the rms-norm 4r;
    # all-bf16 operands at the tensor cores' bf16 rate
    flops = c["valid_tokens"] * (2 * H * (r + dr) + 2 * H * r + 4 * r)
    bf16 = ckv.dtype == torch.bfloat16
    rate = H100_BF16_FLOPS if bf16 else H100_FP32_FLOPS
    bound_ms, bound_by = bound(n_bytes, flops, rate)
    print(f"[kernel] paged_flash_decode_mla {name} ({c['B']} rows, "
          f"{c['valid_tokens']} valid tokens, table {c['M']} blocks): "
          f"max|err| {err:.3g} (atol {DECODE_ATOL}), two calls bit-equal"
          + (", all-trash row exact 0" if c["trash_row"] else "")
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa(gathered, "
          f"normed) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{n_bytes} B, {flops} {'bf16' if bf16 else 'fp32'} flop; "
          f"{len(c['pages'])} page copies); by kernel (torch.profiler, 20 "
          f"calls): " + ", ".join(f"{k} {t:.4f} ms"
                                  for k, t in by_kernel.items())
          + f" on {smi}")
    return dict(name="paged_flash_decode_mla", route="cuda",
                source="src/repro_torch/kernels/csrc/mla_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:198",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms,
                by_kernel_ms=by_kernel)


def kernel_split(torch, call, calls: int, pattern: str) -> dict:
    """Device ms per call of each kernel whose name matches `pattern`
    (keyed by its first group), over `calls` calls of `call` under
    torch.profiler."""
    def run():
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ranked = profile_steps(torch, run, calls)[2]
    split = {}
    for name, t in ranked:
        found = re.search(pattern, name)
        if found:
            split[found.group(1)] = round(split.get(found.group(1), 0.0) + t,
                                          5)
    return split


def signal_case(torch, T: int, V: int):
    """Logits [T, V] fp32 of std 3 with row 0 all equal, row 1 an exact
    top tie at two far columns (7 and V - 5; 1 and V - 1 for a handful of
    classes), row 2 at two neighbouring columns. Returns (logits, top-2 gap
    per row, the first argmax of rows 0-2)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + T + V)
    x = torch.randn((T, V), generator=g, device=DEV) * 3
    x[0] = 0.25
    far = (7, V - 5) if V > 12 else (1, V - 1)
    x[1, far[0]] = x[1, far[1]] = x[1].max() + 1
    x[2, V // 3] = x[2, V // 3 + 1] = x[2].max() + 1
    top2 = torch.topk(x, 2, dim=-1).values
    return x, top2[:, 0] - top2[:, 1], [0, far[0], V // 3]


def check_deferral_kernel(torch, de, smi) -> dict:
    """deferral_entropy against its plain version at the engine's, the
    evaluation's and the classifier cascade's shapes, two calls bit-equal; times both, and the kernel
    by name under torch.profiler. Returns the kernel's record at the
    engine's internlm2-1.8b shape (the decode steps' call)."""
    rec = None
    for T, V in SIGNAL_SHAPES:
        x, gap, first_want = signal_case(torch, T, V)
        got = de.deferral_entropy(x)
        again = de.deferral_entropy(x)
        want = de.deferral_entropy_plain(x)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got[:2],
                                                              want[:2]))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        clear = gap > TIE_GAP
        ties = gap == 0
        flips = int((got[2][clear | ties] != want[2][clear | ties]).sum())
        first = got[2][:3].tolist() == first_want
        print(f"[kernel] deferral_entropy {T} x {V} fp32: max|err| "
              f"neg_entropy/max_prob {err:.3g} (atol {SIGNAL_ATOL}); argmax "
              f"differs on {flips} rows with a top-2 gap > {TIE_GAP} or an "
              f"exact tie ({int((~clear & ~ties).sum())} rows under the gap "
              f"not held); ties to the lowest index: {first}; two calls "
              f"bit-equal: {same}")
        if not (err <= SIGNAL_ATOL and flips == 0 and first and same
                and all(bool(torch.isfinite(t).all()) for t in got[:2])):
            raise AssertionError(f"deferral_entropy {T} x {V}: err {err}, "
                                 f"{flips} flips, first index {first}, "
                                 f"two calls bit-equal {same}")
        iters = 20 if x.numel() < 1 << 26 else 5
        ms = time_ms(lambda: de.deferral_entropy(x), iters=iters)
        by_kernel = kernel_split(
            torch, lambda: de.deferral_entropy(x), iters,
            r"de_(partial|merge|signal)_kernel")
        plain_ms = time_ms(lambda: de.deferral_entropy_plain(x), iters=iters)
        # a yardstick of one launch that reads the same logits: one PyTorch
        # row max, not the signal
        amax_ms = time_ms(lambda: x.amax(dim=1), iters=iters)
        n_bytes = x.numel() * 4 + 3 * 4 * T
        # one exp, a compare and two multiply-adds per logit
        bound_ms, bound_by = bound(n_bytes, 4 * x.numel())
        print(f"[kernel] deferral_entropy {T} x {V}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B); library — (no single PyTorch "
              f"call computes (neg_entropy, max_prob, argmax)); one "
              f"PyTorch row max over the same logits {amax_ms:.4f} ms; by "
              f"kernel (torch.profiler, {iters} calls): "
              + ", ".join(f"{k} {t:.4f} ms" for k, t in by_kernel.items())
              + f" on {smi}")
        if rec is None:
            rec = dict(name="deferral_entropy", route="cuda",
                       source="src/repro_torch/kernels/csrc/"
                              "deferral_entropy.cu",
                       replaces="src/repro/kernels/deferral_entropy.py:63",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                       shape=[T, V])
        rec.setdefault("by_shape", {})[f"{T}x{V}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err,
            by_kernel_ms=by_kernel, row_max_ms=amax_ms)
        del x, got, want
    return rec


def check_flash_kernel(torch, fa, smi, parent=None) -> dict:
    """flash_attention against its plain version, twice and bit-equal, in
    fp32 (three TF32 products a product, split-KV where the grid is under
    one wave) and bf16, each case timed beside its plain version, SDPA
    over the same mask and its bound.
    The main paths run fp32: their q/k/v come out of fp32 projections
    (fp32 weights promote the bf16 activations) and `_prefill_attend` casts
    K/V to q's type. The cases: internlm2-1.8b's prefill chunk at
    q_offset 0, 48 and 128; zamba2-1.2b's shared block as the slot engine
    gives it (8 prompts of 128 tokens at q_offset 0 over the 288-position
    slot cache, 32/32 heads of 64, the cache's length as the window);
    other configs' head dims (kimi-k2's 64/8 x 112 at its main path's
    q_offsets); phase 15's qwen1.5-4b (20/20 x 128) and llama3-405b
    (128/8 x 128) chunks; a window that cuts (24 over 100 tokens);
    phase 12's five calls: whisper-small's encoder (8 x 1500 frames over
    themselves, non-causal, 12/12 heads of 64; 1500 is no multiple of the
    64-key tile), its cross-attention at prefill (16 queries over the 1500
    encoder states, non-causal) and at a decode step (1 query), its
    decoder's causal self-attention (16 prompt queries over the 32-slot
    cache), and phi-3-vision-4.2b's prefill (576 patches + BOS, causal
    over its 593-slot cache, 32/32 heads of 96); the internlm2 chunk and
    zamba2's block again at 1, 2 and 4 rows, as the paged engine
    dispatches a prefill group of next_pow2(k) rows once the first wave
    of admissions has gone; internlm2-1.8b's whole prefill as phase 19b
    runs it (ROOF_SHAPES' 8 x 4096, causal over itself).
    The bound counts q and the output once, K/V only at the positions
    some query sees, and the visible pairs' products at the rate of the
    kernel's products: three TF32 products for fp32 (the SIMT-rate bound
    is kept beside as `bound_simt_ms`), one bf16 product for bf16 (exact
    in fp32 accumulation). `parent` is a parent tree's kernels record
    (`--parent`): each fp32 case prints and keeps its time beside.
    Returns the internlm2 chunk at q_offset 128 in fp32, with every case
    under "cases" and zamba2's path case under "zamba2_shared"."""
    B, T = N_SLOTS, CHUNK
    S = math.ceil((RAGGED[1] + MAX_NEW) / BLOCK) * BLOCK     # 288
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    F = 1500                                                 # frames
    P0 = 576 + 1                       # phi-3-vision: patches + BOS
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count

    def splits_of(*shape, **mask):
        """kv_split's count, or None on a tree whose wrapper has none
        or one of another signature (a parent's)."""
        try:
            return fa.kv_split(*shape, n_sms, **mask)[2]
        except (AttributeError, TypeError, IndexError):
            return None
    parent_cases = {}
    for r in (parent or {}).get("kernels", []):
        if r.get("name") == "flash_attention":
            parent_cases = r.get("cases", {})
    # label, B, T, S, H, KV, hd, window, q_offsets, on a main path, causal
    cases = (("internlm2 chunk", B, T, S, 16, 8, 128, 0, (0, 48, 128), True,
              True),
             ("zamba2 shared block", B, T, S, 32, 32, 64, S, (0,), True,
              True),
             ("phi-3-vision hd 96", B, T, S, 32, 32, 96, 0, (48,), False,
              True),
             ("kimi-k2 hd 112", B, T, S, 64, 8, 112, 0, (0, 48, 128), True,
              True),
             ("qwen1.5-4b chunk", B, T, S, 20, 20, 128, 0, (0, 128), True,
              True),
             ("llama3-405b chunk", B, T, S, 128, 8, 128, 0, (0, 128), True,
              True),
             ("hd 256", 2, T, S, 4, 2, 256, 0, (48,), False, True),
             ("window 24", 2, 100, 100, 4, 2, 128, 24, (0,), False, True),
             ("whisper encoder", B, F, F, 12, 12, 64, 0, (0,), True, False),
             ("whisper cross prefill", B, ENC_PROMPT, F, 12, 12, 64, 0, (0,),
              True, False),
             ("whisper cross decode", B, 1, F, 12, 12, 64, 0, (0,), True,
              False),
             ("whisper decoder self", B, ENC_PROMPT, ENC_PROMPT
              + GREEDY_STEPS, 12, 12, 64, 0, (0,), True, True),
             ("phi-3-vision prefill", B, P0, P0 + GREEDY_STEPS, 32, 32, 96, 0,
              (0,), True, True))
    cases += tuple(
        (f"{label} {rows} rows", rows, T, S, H, KV, hd, window, offsets,
         True, True)
        for rows in (1, 2, 4)
        for label, H, KV, hd, window, offsets in (
            ("internlm2 chunk", 16, 8, 128, 0, (0, 128)),
            ("zamba2 shared block", 32, 32, 64, S, (0,))))
    _, T19, B19 = ROOF_SHAPES[0]
    cases += (("19b prefill", B19, T19, T19, 16, 8, 128, 0, (0,), True,
               True),)
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:72",
               path_dtype="float32", cases={})
    for (label, Bc, Tc, Sc, H, KV, hd, window, offsets, on_path,
         causal) in cases:
        base = [torch.randn(shape, generator=g, device=DEV) for shape in
                ((Bc, Tc, H, hd), (Bc, Sc, KV, hd), (Bc, Sc, KV, hd))]
        for name, dtype, rtol, rate in (
                ("fp32", torch.float32, 0.0, H100_TF32X3_FLOPS),
                ("bf16", torch.bfloat16, FLASH_BF16_RTOL, H100_BF16_FLOPS)):
            q, k, v = (t.to(dtype) for t in base)
            tol = f"atol {FLASH_ATOL}" + (f" + {rtol:.3g}|ref|" if rtol
                                          else "")
            fp32 = dtype == torch.float32
            for off in offsets:
                kw = dict(causal=causal, window=window, q_offset=off)
                splits = splits_of(Bc, Tc, Sc, H, hd, **kw) if fp32 else 1
                key = f"{label} {name} q_offset {off}"
                out = fa.flash_attention(q, k, v, **kw)
                again = fa.flash_attention(q, k, v, **kw)
                ref = fa.flash_attention_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                err = float(diff.max())
                # the largest error as a share of its element's tolerance
                share = float((diff / (FLASH_ATOL + rtol * ref.float().abs()))
                              .max())
                what = f"flash_attention {label} {name} q_offset {off}"
                if not (out.dtype == dtype and torch.isfinite(out).all()
                        and share <= 1.0):
                    raise AssertionError(f"{what}: max|err| {err}, "
                                         f"{share:.3g} of {tol}")
                if not torch.equal(out, again):  # no atomics, fixed orders
                    raise AssertionError(f"{what}: two calls differ")
                ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
                plain_ms = time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, **kw), iters=5)
                mask = fa.visible_mask(Tc, Sc, causal=causal, window=window,
                                       q_offset=off, device=DEV)
                # yardstick only, never called by the port: SDPA over the
                # same mask, K/V heads expanded to the query heads first
                qs = q.transpose(1, 2)
                ks, vs = (t.transpose(1, 2).repeat_interleave(H // KV, dim=1)
                          .contiguous() for t in (k, v))
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask))
                del ks, vs
                visible = int(mask.sum()) * Bc
                seen_keys = int(mask.any(0).sum())
                n_bytes = ((q.numel() + out.numel()) * q.element_size()
                           + 2 * Bc * seen_keys * KV * hd * k.element_size())
                flops = 4 * visible * H * hd
                bound_ms, bound_by = bound(n_bytes, flops, rate)
                r = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         max_abs_err=err, on_path=on_path and fp32)
                extra = ""
                if fp32:
                    simt_ms, simt_by = bound(n_bytes, flops, H100_FP32_FLOPS)
                    r.update(bound_simt_ms=simt_ms, splits=splits)
                    extra = (f", SIMT-rate bound {simt_ms:.5f} ms "
                             f"({simt_by}), key splits {splits}")
                    p_ms = parent_cases.get(key, {}).get("ms")
                    if parent:
                        r["parent_ms"] = p_ms
                        extra += (f"; parent {p_ms:.4f} ms ({ms / p_ms:.3f}x)"
                                  if p_ms else "; parent not measured")
                path = ", the main path's" if r["on_path"] else ""
                print(f"[kernel] {what} (B {Bc} T {Tc} S {Sc}, {H}/{KV}x"
                      f"{hd}, {'causal' if causal else 'non-causal'}, window "
                      f"{window or '-'}{path}): max|err| {err:.3g}, at most "
                      f"{share:.3g} of ({tol})"
                      f", two calls bit-equal; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
                      f"({ms / lib_ms:.3f}x), bound {bound_ms:.5f} ms "
                      f"({bound_by}: {visible} visible pairs per head at "
                      f"{rate / 1e12:.0f} TFLOP/s, {seen_keys} of {Sc} key "
                      f"positions seen, {n_bytes} B){extra} on {smi}")
                rec["cases"][key] = r
    rec.update(rec["cases"]["internlm2 chunk fp32 q_offset 128"],
               q_offset=128)
    rec["zamba2_shared"] = rec["cases"]["zamba2 shared block fp32 q_offset 0"]
    rec["phase12"] = {label: rec["cases"][f"{label} fp32 q_offset 0"]
                      for label in ("whisper encoder", "whisper cross prefill",
                                    "whisper cross decode",
                                    "whisper decoder self",
                                    "phi-3-vision prefill")}
    for off in (0, 48, 128):
        c = rec["cases"]
        print(f"[kernel] flash_attention internlm2 chunk q_offset {off}: "
              f"fp32 (TF32 x 3, the main path's) "
              f"{c[f'internlm2 chunk fp32 q_offset {off}']['ms']:.4f} ms, "
              f"bf16 "
              f"{c[f'internlm2 chunk bf16 q_offset {off}']['ms']:.4f} ms on "
              f"{smi}")
    return rec


def wkv_case(torch, mode, B, T, H, K, scalar, strong, seed):
    """Inputs of one `wkv_scan` call as the block gives them (fp32, decay
    logw in [-1, -0.05], or -exp(U(-3, 3)) when `strong`), in enough
    copies to exceed twice the L2: between two visits of one layer's state
    the main path streams the other layers' weights through it."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def one():
        q, k, v = (0.5 * torch.randn((B, T, H, K), generator=g, device=DEV)
                   for _ in range(3))
        r = torch.rand((B, T, H, 1 if scalar else K), generator=g,
                       device=DEV)
        lw = -torch.exp(6 * r - 3) if strong else -(0.05 + 0.95 * r)
        s0 = 0.2 * torch.randn((B, H, K, K), generator=g, device=DEV)
        return q, k, v, lw, s0
    first = one()
    n_bytes = sum(t.numel() * 4 for t in first)
    copies = [first] + [one() for _ in range(
        max(0, math.ceil(2 * L2_BYTES / n_bytes) - 1))]
    u = 0.3 * torch.randn((H, K), generator=g, device=DEV)
    return copies, u


def wkv_share(y, st, y_ref, s_ref):
    """(max |err|, largest share of atol + rtol |ref|) over y and state."""
    pairs = ((y, y_ref), (st, s_ref))
    return (max(float((a - b).abs().max()) for a, b in pairs),
            max(float(((a - b).abs() / (WKV_ATOL + WKV_RTOL * b.abs()))
                      .max()) for a, b in pairs))


def check_wkv_kernel(torch, wk, smi) -> dict:
    """wkv_scan against its plain version (the JAX algorithms: chunked
    when 32 divides T, else the per-step scan) in both modes at the main
    path's shapes and zamba2's; times kernel and plain version beside the
    bytes / operations bound (no single PyTorch call computes the
    recurrence, so no library time). The state goes to `out` in place, as
    the model's layers write their cache. The path T picks must have run,
    two calls must give the same bits, and at T > 1 the other path
    (`wkv_scan_path`) is checked and timed beside it. Each path's first
    case is profiled by kernel. Returns the records of the two paths:
    "wkv_scan" (the per-token kernel) at the rwkv6-3b decode shape and
    "wkv_scan_chunked" at its prefill."""
    recs = {}
    for i, (label, mode, B, T, H, K, scalar, strong) in enumerate(WKV_CASES):
        copies, u = wkv_case(torch, mode, B, T, H, K, scalar, strong,
                             SEED + 20 + i)
        q, k, v, lw, s0 = copies[0]
        chunked = T >= wk.CHUNKED_MIN_T
        n_chunked = wk.wkv_scan.launches_chunked
        out = torch.empty_like(s0)
        y, st = wk.wkv_scan(q, k, v, lw, u, s0, mode=mode, out=out)
        ran_chunked = wk.wkv_scan.launches_chunked - n_chunked
        y_ref, s_ref = wk.wkv_scan_plain(q, k, v, lw, u, s0, mode=mode)
        torch.cuda.synchronize()
        err, share = wkv_share(y, st, y_ref, s_ref)
        ok = (st.data_ptr() == out.data_ptr() and share <= 1.0
              and ran_chunked == int(chunked)
              and torch.isfinite(y).all() and torch.isfinite(st).all())
        y2, st2 = wk.wkv_scan(q, k, v, lw, u, s0, mode=mode)
        torch.cuda.synchronize()
        ok = ok and torch.equal(y, y2) and torch.equal(st, st2)
        other_share = None
        if T > 1:
            yo, sto = wk.wkv_scan_path(q, k, v, lw, u, s0,
                                       chunked=not chunked, mode=mode)
            torch.cuda.synchronize()
            other_share = wkv_share(yo, sto, y_ref, s_ref)[1]
            ok = ok and other_share <= 1.0
        if not ok:
            raise AssertionError(
                f"wkv_scan {label}: max|err| {err}, {share:.3g} of atol "
                f"{WKV_ATOL} + rtol {WKV_RTOL} (other path {other_share}), "
                f"chunked launches {ran_chunked} for T {T}, or two calls "
                f"differ")
        rot = Rotation(copies)

        def kernel():
            q_, k_, v_, lw_, s_ = rot()
            wk.wkv_scan(q_, k_, v_, lw_, u, s_, mode=mode, out=s_)
        def other():
            q_, k_, v_, lw_, s_ = rot()
            wk.wkv_scan_path(q_, k_, v_, lw_, u, s_, chunked=not chunked,
                             mode=mode, out=s_)
        def plain():
            q_, k_, v_, lw_, s_ = rot()
            wk.wkv_scan_plain(q_, k_, v_, lw_, u, s_, mode=mode)
        ms = time_ms(kernel)
        other_ms = time_ms(other) if T > 1 else None
        plain_ms = time_ms(plain, iters=5)
        copy_ms = None
        if T == 1:
            # a yardstick of what moving the state costs in one launch: one
            # PyTorch copy of it (the same bytes read and written), not the
            # recurrence
            def copy():
                src = rot()[4]
                rot()[4].copy_(src)
            copy_ms = time_ms(copy)
        n_bytes = (sum(t.numel() * 4 for t in (q, k, v, lw, s0)) + y.numel()
                   * 4 + st.numel() * 4 + (u.numel() * 4 if mode == "rwkv"
                                           else 0))
        # per token and state entry: kv, then two multiply-adds (rwkv adds
        # the bonus's third)
        flops = B * T * H * K * K * (6 if mode == "rwkv" else 4)
        bound_ms, bound_by = bound(n_bytes, flops)
        path, other_path = (("chunked", "per-token") if chunked
                            else ("per-token", "chunked"))
        print(f"[kernel] wkv_scan {label} ({mode}, B {B} T {T} H {H} K=V "
              f"{K}, logw [..., {1 if scalar else K}]"
              + (", strong decay" if strong else "")
              + f"): {path} path, max|err| {err:.3g}, at most {share:.3g} "
              f"of (atol {WKV_ATOL} + rtol {WKV_RTOL}|ref|), state in place"
              f", two calls bit-equal"
              + (f", {other_path} path at most {other_share:.3g}" if T > 1
                 else "")
              + f"; kernel {ms:.4f} ms"
              + (f" ({other_path} path {other_ms:.4f} ms, "
                 f"{other_ms / ms:.2f}x)" if T > 1 else "")
              + f", plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}: {n_bytes} B, {flops} fp32 flop; {len(copies)} "
              f"input copies); library — (no single PyTorch call computes "
              f"the recurrence)"
              + (f"; one PyTorch copy of the state {copy_ms:.4f} ms"
                 if T == 1 else "")
              + f" on {smi}")
        name = "wkv_scan_chunked" if chunked else "wkv_scan"
        if name not in recs:
            # the path's first case: device time by kernel of the path
            by_kernel = kernel_split(
                torch, kernel, WKV_PROFILE_CALLS,
                r"wkv_chunk_(\w+?)_kernel" if chunked
                else r"(wkv_(?:decode_)?kernel)")
            print(f"[kernel] wkv_scan {label}, {path} path by kernel "
                  f"(torch.profiler, {WKV_PROFILE_CALLS} calls): "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in by_kernel.items())
                  + f" on {smi}")
        case = dict(mode=mode, shape=[B, T, H, K], path=path, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    max_abs_err=err)
        if T > 1:
            case[f"{other_path}_ms"] = other_ms
        else:
            case["state_copy_ms"] = copy_ms
        if name not in recs:
            recs[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/wkv_scan.cu",
                replaces="src/repro/kernels/wkv_scan.py:83",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, shape=[B, T, H, K],
                by_kernel_ms=by_kernel)
        recs[name].setdefault("by_case", {})[label] = case
        del copies, y, st, y_ref, s_ref
    torch.cuda.empty_cache()
    return recs


def describe_ladder(torch, small, large, t_init: float) -> None:
    cfg, lcfg = small.cfg, large.cfg
    n_params = [sum(t.numel() for t in _leaves(r.params))
                for r in (small, large)]
    extra = ""
    if cfg.mla is not None:
        extra = (f" MLA q_lora {cfg.mla.q_lora} kv_lora {cfg.mla.kv_lora} "
                 f"rope {cfg.mla.rope_dim};")
    if cfg.family == "hybrid":
        extra += (f" Mamba2 d_state {cfg.ssm_state} head_dim "
                  f"{cfg.ssm_head_dim}, a shared attention + MLP block "
                  f"after every {cfg.shared_attn_every} layers;")
    if cfg.moe is not None:
        extra += (f" MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
                  f"d_ff {cfg.moe.d_ff_expert} + {cfg.moe.n_shared_experts} "
                  f"shared, {cfg.moe.n_dense_layers} dense layer(s);")
    print(f"[main] {cfg.name}: {cfg.n_layers} layers d_model "
          f"{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads} heads hd "
          f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size},{extra} "
          f"{n_params[0] / 1e9:.3f} B params; M_L {lcfg.n_layers} layers "
          f"d_model {lcfg.d_model} {lcfg.n_heads}/{lcfg.n_kv_heads} heads "
          f"d_ff {lcfg.d_ff}{' MoE' if lcfg.moe else ''}, "
          f"{n_params[1] / 1e9:.3f} B params; {cfg.param_dtype} weights, "
          f"{cfg.compute_dtype} activations/cache; init {t_init:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")


def check_one_step(torch, tfm, small, rng, guard: float) -> None:
    """One full-width decode step, kernel path against plain path, with
    fp32 activations (isolates the kernels) and with the config's own. The
    bound holds on every row whose MoE routes agree between the paths."""
    cfg = small.cfg
    for label, step_cfg, tol, max_flips in (
            ("fp32 activations", cfg.replace(compute_dtype="float32"),
             STEP_LOGIT_ATOL, 0),
            (f"{cfg.compute_dtype} activations", cfg, guard,
             MAX_ROUTE_FLIPS)):
        err, agree, scale, flipped, flip_err = decode_step_check(
            torch, tfm, small.params, step_cfg, rng)
        routes = ""
        if cfg.moe is not None:
            routes = (f"; rows with another top-{cfg.moe.top_k} route "
                      f"{flipped} (at most {max_flips}), their max|dlogit| "
                      f"{flip_err:.4g}")
        print(f"[main] one decode step, kernel vs plain path, {label}, "
              f"bf16 cache: max|dlogit| {err:.4g} over rows with the same "
              f"routes (atol {tol}; logit std {scale:.3g}), argmax agreement "
              f"{agree:.3f}{routes}")
        if not (err <= tol and len(flipped) <= max_flips):
            raise AssertionError(f"full-width decode step ({label}): logits "
                                 f"differ by {err} > {tol}, or routes differ "
                                 f"in rows {flipped}")


def check_prefill_paths(torch, tfm, small,
                        guard: float = STEP_LOGIT_GUARD) -> None:
    """One full-width paged prefill of 8 ragged prompts (one chunk each, up
    to 256 tokens), flash kernel against `_attend`, by last-token logits:
    with fp32 activations over an fp32 cache (isolates the kernel: over a
    bf16 cache a last-bit difference in one layer's K/V can flip its bf16
    rounding, and every later layer reads it) and with the main path's
    bf16 activations and cache, where `_attend` also rounds the
    probabilities to bf16 before P @ V and the kernel keeps them fp32.
    As in `check_one_step`, the bound holds on the rows whose logits read
    the same MoE routes on both paths (every prompt token's in the MoE
    layers before the last, the last token's in the last: an MoE model's
    last layer is an MoE layer); a row where one took another top-k set
    is reported apart (none allowed in fp32)."""
    import numpy as np
    cfg = small.cfg
    for label, pcfg, cache_dtype, tol, max_flips in (
            ("fp32 activations and cache", cfg.replace(
                compute_dtype="float32"), torch.float32, STEP_LOGIT_ATOL,
             0),
            (f"{cfg.compute_dtype} activations, bf16 cache", cfg,
             torch.bfloat16, guard, MAX_ROUTE_FLIPS)):
        out, experts = {}, {}
        for kernel in (True, False):
            with recorded_routes(torch) as experts[kernel]:
                d = prepare_decode(torch, tfm, small.params, pcfg,
                                   np.random.default_rng(SEED + 12),
                                   paged_kernel=kernel,
                                   cache_dtype=cache_dtype)
            out[kernel] = d["logits"]
        torch.cuda.synchronize()
        # the routes a row's last-token logits read: every prompt token's
        # in the MoE layers before the last (later layers attend to their
        # outputs), and the last token's own in the last layer
        t = torch.arange(int(d["pos"].max()), device=DEV)[None, :]
        valid, last = t < d["pos"][:, None], t == d["pos"][:, None] - 1
        same = torch.ones(N_SLOTS, dtype=torch.bool, device=DEV)
        for i, (a, b) in enumerate(zip(experts[True], experts[False])):
            differs = (a != b).any(-1).reshape(N_SLOTS, -1)
            read = last if i == len(experts[True]) - 1 else valid
            same &= ~(differs & read).any(-1)
        row_err = (out[True] - out[False]).abs().amax(-1)
        err = float(row_err[same].max()) if bool(same.any()) else math.inf
        flipped = (~same).nonzero()[:, 0].tolist()
        agree = float((out[True].argmax(-1) == out[False].argmax(-1))
                      .float().mean())
        routes = ""
        if cfg.moe is not None:
            flip_err = float(row_err[~same].max()) if flipped else 0.0
            routes = (f"; rows with another top-{cfg.moe.top_k} route "
                      f"read {flipped} (at most {max_flips}), "
                      f"their max|dlogit| {flip_err:.4g}")
        print(f"[main] full-width paged prefill, flash kernel vs _attend, "
              f"{label}: max|dlogit| {err:.4g} over rows with the same "
              f"routes (atol {tol}; logit std "
              f"{float(out[False].std()):.3g}), argmax agreement "
              f"{agree:.3f}{routes}")
        if not (torch.isfinite(out[True]).all() and err <= tol
                and len(flipped) <= max_flips):
            raise AssertionError(f"full-width prefill ({label}): logits "
                                 f"differ by {err} > {tol}, or routes "
                                 f"differ in rows {flipped}")


def report_profile(torch, tfm, small, rng, smi) -> None:
    wall_ms, busy_ms, ranked = profile_decode(torch, tfm, small.params,
                                              small.cfg, rng)
    busy = ("not measured (profiler saw no device time)" if busy_ms is None
            else f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}, "
                 f"idle {1 - busy_ms / wall_ms:.1%})")
    print(f"[main] full-width decode step (8 rows, kernels on, with its "
          f"deferral signal): host wall {wall_ms:.3f} ms, {busy} on {smi}")
    # the top six, then the port's own kernels further down
    ours = ("::de_", "gqa_", "mla_", "write_tokens_")
    for name, ms in ranked[:6] + [(n, ms) for n, ms in ranked[6:]
                                  if any(k in n for k in ours)]:
        print(f"[main]   {ms:.4f} ms/step  {name[:90]}")


KERNELS = ("paged_flash_decode_gqa", "paged_flash_decode_mla",
           "paged_write_token", "deferral_entropy", "flash_attention",
           "wkv_scan", "wkv_scan_chunked")


def _wrappers() -> list:
    """The kernel wrappers, each carrying `.launches`."""
    from repro_torch.kernels import deferral_entropy as de
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv_scan as wk
    return [pa.paged_flash_decode_gqa, pa.paged_flash_decode_mla,
            pa.paged_write_token, de.deferral_entropy, fa.flash_attention,
            wk.wkv_scan]


def reset_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0
    _wrappers()[-1].launches_chunked = 0


def read_counts() -> dict:
    """{kernel name: launches since the last reset}; `wkv_scan`'s two
    paths apart: "wkv_scan" the per-token kernel (T = 1, decode),
    "wkv_scan_chunked" the chunked kernels (T >= 2, prefill)."""
    gqa, mla, write, de, fa, wk = _wrappers()
    return {"paged_flash_decode_gqa": gqa.launches,
            "paged_flash_decode_mla": mla.launches,
            "paged_write_token": write.launches,
            "deferral_entropy": de.launches,
            "flash_attention": fa.launches,
            "wkv_scan": wk.launches - wk.launches_chunked,
            "wkv_scan_chunked": wk.launches_chunked}


def flash_layers(cfg) -> int:
    """flash_attention launches per prefill: one per GQA layer (MLA
    prefill stays plain)."""
    return 0 if cfg.mla is not None else cfg.n_layers


def serve_main_path(torch, small, large, per_step: dict, smi) -> dict:
    """Calibrate and run the cascade on the paged backend with the kernels
    on; every kernel's counter is set to 0 just before and read just after.
    Checks that paged kernel k launched per_step[k] times per decode step,
    and the signal and prefill kernels as the run's steps, prefill
    dispatches and M_L batches give them (and the others never). Returns
    (the counts, the run's result, the calibrated tau)."""
    import numpy as np
    from repro_torch.data.synthetic import (make_lm_stream,
                                            make_ragged_lm_stream)
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig,
                                     make_requests)
    from repro_torch.serving.request import DONE
    cfg = small.cfg
    engine = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large),
        EngineConfig(n_slots=N_SLOTS, backend="paged",
                     paged=PagedConfig(block_size=BLOCK, prefill_chunk=CHUNK,
                                       paged_kernel=True)))
    cal_len = sum(RAGGED) // 2
    cal = make_lm_stream([SEED, 1], N_REQUESTS, cal_len, cfg.vocab_size)
    live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                 cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tau = engine.calibrate(cal, cal_len, MAX_NEW, DEFERRAL)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    res = engine.run(make_requests(live, MAX_NEW), MAX_NEW)
    torch.cuda.synchronize()
    launches = read_counts()
    st = res.stats
    print(f"[main] calibrated tau {tau:.4f} for deferral {DEFERRAL} in "
          f"{t_cal:.2f} s; served {N_REQUESTS} requests (prompts "
          f"{RAGGED[0]}-{RAGGED[1]} tokens, max_new {MAX_NEW}) on "
          f"{N_SLOTS} slots in {st['makespan_s']:.3f} s: "
          f"{st['throughput_tok_s']:.1f} tok/s, M_S "
          f"{st['small_tok_s']:.1f} tok/s, deferral_ratio "
          f"{res.deferral_ratio:.3f}, early exits "
          f"{int(res.early_exited.sum())}, {res.steps} decode steps, "
          f"{st['prefill_dispatches']} prefill dispatches, peak blocks "
          f"{st['peak_blocks']}/{st['n_blocks']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    print("[main] phases (host wall s): " + ", ".join(
        f"{k[6:-2]} {v:.3f}" for k, v in st.items()
        if k.startswith("phase_")))
    if not all(r.state == DONE for r in res.requests):
        raise AssertionError("not every request finished")
    if res.tokens.shape != (N_REQUESTS, MAX_NEW) or not np.isfinite(
            res.confidence).all():
        raise AssertionError("malformed serving result")
    want = {k: per_step.get(k, 0) * res.steps for k in KERNELS}
    # calibration: one M_S generate (prefill + MAX_NEW - 1 steps); run:
    # decode steps, seeding prefill dispatches, M_L generates per batch
    n_ml = st["ml_batches"]
    want["deferral_entropy"] = (MAX_NEW + res.steps
                                + st["prefill_seed_dispatches"]
                                + MAX_NEW * n_ml)
    want["flash_attention"] = (flash_layers(cfg)
                               * (1 + st["prefill_dispatches"])
                               + flash_layers(large.cfg) * n_ml)
    print(f"[main] kernel launches {launches}, expected {want} ("
          + ", ".join(f"{n} {k}" for k, n in per_step.items())
          + f" per decode step; deferral_entropy {MAX_NEW} (calibration) + "
          f"{res.steps} steps + {st['prefill_seed_dispatches']} seeding "
          f"prefill dispatches + {MAX_NEW} x {n_ml} M_L batches; "
          f"flash_attention {flash_layers(cfg)} x (1 + "
          f"{st['prefill_dispatches']} prefill dispatches) + "
          f"{flash_layers(large.cfg)} x {n_ml})")
    if launches != want or res.steps == 0:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches, res, tau


def evaluate_cascade(torch, small, large, smi) -> dict:
    """The paper's offline evaluation at full width: `Cascade` over M_S
    and M_L with the eq.-8 sequence signal on EVAL_SEQS x EVAL_LEN tokens,
    counters set to 0 before each call and checked after it; then
    make_prefill and one make_serve_step step against `fused_confidence`.
    Returns the launch counts of the whole phase."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.core.cascade import Cascade
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    cfg, lcfg = small.cfg, large.cfg
    toks = torch.from_numpy(make_lm_stream(
        [SEED, 4], EVAL_SEQS, EVAL_LEN, cfg.vocab_size).astype(np.int64)
        ).to(DEV)
    cascade = Cascade(lambda p, x: tfm.forward(p, cfg, x),
                      lambda p, x: tfm.forward(p, lcfg, x),
                      small.params, large.params, signal="seq_neg_entropy")
    fs, fl = flash_layers(cfg), flash_layers(lcfg)
    total = dict.fromkeys(KERNELS, 0)

    def counted(label, fn, want):
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        for k, n in got.items():
            total[k] += n
        want = {k: want.get(k, 0) for k in KERNELS}
        print(f"[eval] {label}: {time.perf_counter() - t0:.3f} s, launches "
              f"deferral_entropy {got['deferral_entropy']}, flash_attention "
              f"{got['flash_attention']} (expected {want['deferral_entropy']}"
              f", {want['flash_attention']})")
        if got != want:
            raise AssertionError(f"{label}: launches {got} != {want}")
        return out

    tau = counted("calibrate_tau(deferral_ratio=0.3)",
                  lambda: cascade.calibrate_tau(
                      toks, deferral_ratio=EVAL_DEFERRAL),
                  {"deferral_entropy": 1, "flash_attention": fs})
    dense = counted("predict_dense", lambda: cascade.predict_dense(toks),
                    {"deferral_entropy": 2, "flash_attention": fs + fl})
    n_def = int(dense.deferred.sum())
    sparse = counted("predict_sparse", lambda: cascade.predict_sparse(toks),
                     {"deferral_entropy": 1 + (n_def > 0),
                      "flash_attention": fs + fl * (n_def > 0)})
    for name in ("deferred", "small_predictions", "confidence"):
        if not np.array_equal(getattr(dense, name), getattr(sparse, name)):
            raise AssertionError(f"predict_dense and predict_sparse differ "
                                 f"in {name}")
    keep = ~dense.deferred
    if not (dense.predictions.shape == (EVAL_SEQS, EVAL_LEN)
            and np.isfinite(dense.confidence).all()
            and np.array_equal(dense.predictions[keep],
                               sparse.predictions[keep])):
        raise AssertionError("malformed cascade evaluation")
    # M_L sees all 16 sequences in predict_dense and the deferred ones in
    # predict_sparse: cuBLAS picks its GEMM by shape, so with bf16
    # activations the two batches' logits differ by roundings. A deferred
    # position may take another argmax only where M_L's top-2 gap is within
    # twice that batch-to-batch logit difference.
    idx = torch.from_numpy(np.nonzero(dense.deferred)[0]).to(DEV)
    flips = flips_unexplained = 0
    drift_max = 0.0
    if idx.numel():
        l_all = tfm.forward(large.params, lcfg, toks)[idx]
        l_sub = tfm.forward(large.params, lcfg, toks[idx])
        drift = (l_all - l_sub).abs().amax(-1)
        top2 = torch.topk(l_all, 2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        del l_all, l_sub
        d = np.nonzero(dense.deferred)[0]
        diff = torch.from_numpy(dense.predictions[d]
                                != sparse.predictions[d]).to(DEV)
        flips = int(diff.sum())
        flips_unexplained = int((diff & (gap > 2 * drift)).sum())
        drift_max = float(drift.max())
    print(f"[eval] predict_dense vs predict_sparse: deferred mask, M_S "
          f"tokens, confidence and the kept rows' predictions equal; M_L "
          f"argmax differs at {flips} of {int(idx.numel()) * EVAL_LEN} "
          f"deferred positions, {flips_unexplained} with a top-2 gap above "
          f"twice the batch-to-batch logit difference (max {drift_max:.3g})")
    if flips_unexplained:
        raise AssertionError(f"predict_sparse: {flips_unexplained} M_L "
                             f"predictions differ beyond rounding")
    # random weights: M_S counts as correct on the half of the sequences
    # where its token agreement with M_L is highest, M_L as always correct.
    # That shows the path runs, not how good a tuned cascade is
    agree = (dense.small_predictions == dense.large_predictions).mean(-1)
    small_ok = np.zeros(EVAL_SEQS)
    small_ok[np.argsort(agree, kind="stable")[EVAL_SEQS // 2:]] = 1.0
    summ = metrics.summarize_deferral(dense.confidence, small_ok,
                                      np.ones_like(small_ok))
    print(f"[eval] {cfg.name} -> {lcfg.name} on {EVAL_SEQS} x {EVAL_LEN} "
          f"tokens, seq_neg_entropy: tau {tau:.5f}, deferral ratio "
          f"{dense.deferral_ratio:.4f} ({n_def} of {EVAL_SEQS}), compute cost "
          f"{dense.compute_cost:.3f}; "
          f"summarize_deferral (random weights, M_S correct on the half of "
          f"the sequences where it agrees most with M_L: the values only "
          f"show the path runs): s_d "
          f"{summ['s_d']:.4g}, s_o {summ['s_o']:.4g}, auroc "
          f"{summ['auroc']:.4g}, acc_small {summ['acc_small']:.4g}")

    # make_prefill + one make_serve_step step through the kernels, against
    # the plain fused_confidence of the same decode state
    B, P = N_SLOTS, 64
    prompts = toks[:B, :P]
    cache = tfm.init_cache(cfg, B, P + 1, device=DEV)
    tok, nent0, cache = counted(
        "make_prefill", lambda: steps.make_prefill(cfg)(
            small.params, cache, {"tokens": prompts}),
        {"deferral_entropy": 1, "flash_attention": fs})
    twin = {kind: {k: v.clone() for k, v in leaves.items()}
            for kind, leaves in cache.items()}
    nxt, conf, defer, _ = counted(
        "make_serve_step", lambda: steps.make_serve_step(cfg, tau=-1.0)(
            small.params, cache, tok, P), {"deferral_entropy": 1})
    x, _ = steps._decode_hidden(small.params, cfg, tok, P, twin,
                                paged_kernel=False)
    table = small.params.get("unembed", small.params["embedding"])
    ref_nent, _, ref_tok = steps.fused_confidence(x, table)
    top2 = torch.topk(x.float() @ table.float().t(), 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TIE_GAP
    err = float((conf - ref_nent).abs().max())
    flips = int((nxt[clear] != ref_tok[clear]).sum())
    print(f"[eval] make_serve_step at full width ({B} rows, position {P}): "
          f"tokens equal to fused_confidence's on {int(clear.sum())} rows "
          f"with a top-2 gap > {TIE_GAP} ({flips} differ), max|d neg_entropy|"
          f" {err:.3g} (atol {SIGNAL_ATOL}); defer at tau -1: "
          f"{defer.int().tolist()}; prefill confidence "
          f"{[round(float(c), 4) for c in nent0]}")
    if flips or err > SIGNAL_ATOL or not torch.equal(defer, conf < -1.0):
        raise AssertionError(f"make_serve_step: {flips} token flips, "
                             f"neg_entropy err {err}")
    return total


def probe_prefill(torch, tfm, small, prompts, width: int, start: int = 0,
                  one_split: bool = False, base=None):
    """Prefill `prompts` (one slot each, the engine's table layout, the
    main path's bf16 cache) from token `start` through the engine's paged
    prefill with the kernels on: CHUNK-token chunks at start, start +
    CHUNK, ..., each offset's rows in dispatches of up to `width` rows
    padded to a power of two, as the engine's `_prefill_chunk_once` makes
    them. `base` (a pool of the same layout) is copied in first: the
    blocks a resume keeps. `one_split` makes `kv_split` split no call's
    keys, at any width. Returns (each row's seed logits [n, V] fp32, the
    pool)."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.paged_pool import PagedCachePool, next_pow2
    cfg = small.cfg
    longest = max(len(p) for p in prompts)
    max_len = longest + MAX_NEW
    pool = PagedCachePool(cfg, len(prompts),
                          len(prompts) * math.ceil(max_len / BLOCK), BLOCK,
                          max_len, DEV)
    for p in prompts:
        s = pool.alloc()
        pool.reserve(s, len(p) + MAX_NEW - 1)
        pool.ensure_mapped(s, len(p))
    if base is not None:
        for kind, leaves in pool.cache.items():
            for name, leaf in leaves.items():
                leaf.copy_(base.cache[kind][name])
    seeds = [None] * len(prompts)
    shipped = fa.kv_split
    if one_split:
        fa.kv_split = lambda B, T, S, *_, **__: (0, S, 1)
    try:
        for off in range(start, longest, CHUNK):
            rows = [i for i, p in enumerate(prompts) if len(p) > off]
            for j in range(0, len(rows), width):
                group = rows[j:j + width]
                Bc = next_pow2(len(group))
                chunks = np.zeros((Bc, CHUNK), np.int64)
                tbl = np.zeros((Bc, pool.max_blocks), np.int32)
                last = np.zeros((Bc,), np.int64)
                for r, i in enumerate(group):
                    piece = prompts[i][off:off + CHUNK]
                    chunks[r, :len(piece)] = piece
                    tbl[r] = pool.tables[i]
                    last[r] = min(len(prompts[i]) - 1 - off, CHUNK - 1)
                logits, _ = tfm.prefill(
                    small.params, cfg, torch.from_numpy(chunks).to(DEV),
                    pool.cache, cache_offset=off,
                    pages=torch.from_numpy(tbl).to(DEV),
                    last_index=torch.from_numpy(last).to(DEV),
                    paged_kernel=True)
                for r, i in enumerate(group):
                    if off + CHUNK >= len(prompts[i]):
                        seeds[i] = logits[r, 0].float()
    finally:
        fa.kv_split = shipped
    torch.cuda.synchronize()
    return torch.stack(seeds), pool


def layers_equal(torch, a, b, prompts, lo: int = 0) -> list:
    """Per layer: are the K and V of every row's positions [lo, len) the
    same bits in pools `a` and `b` (same table layout)?"""
    blk, off = [], []
    for i, p in enumerate(prompts):
        pos = range(lo, len(p))
        blk += [int(a.tables[i, t // BLOCK]) for t in pos]
        off += [t % BLOCK for t in pos]
    blk = torch.tensor(blk, device=DEV)
    off = torch.tensor(off, device=DEV)
    same = None
    for kind, leaves in a.cache.items():
        for name, leaf in leaves.items():
            eq = (leaf[:, blk, off] == b.cache[kind][name][:, blk, off])
            eq = eq.reshape(eq.shape[0], -1).all(-1)
            same = eq if same is None else same & eq
    return same.tolist()


def _neg_entropy(torch, logits):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (logp.exp() * logp).sum(-1)


def width_probe(torch, tfm, small, smi) -> dict:
    """Does a row's prefill depend on its dispatch width, or on where its
    chunks start? The main path's first 8 prompts prefilled through the
    engine's paged prefill (kernels on, bf16 cache) as 8-row dispatches
    and as dispatches of 4, 2 and 1 rows, with `kv_split` as shipped
    (its key split depends on the launch's rows) and with no key split
    at any width; then re-prefilled from token PROBE_RESUME_AT
    (block-aligned, not chunk-aligned: where a resume may re-prefill)
    over the 8-row run's first blocks. Prints each comparison's largest
    |d seed logit| and |d seed neg-entropy| and how many layers' K/V
    pages are bit-equal: layer 0's K/V come from the projections alone,
    with no attention before them, so a difference there is the GEMMs'.
    Returns the shipped plan's largest differences over the widths
    ("drift", "conf_drift"), the resume probe's ("resume_drift") and the
    unsplit variant's ("unsplit_drift")."""
    from repro_torch.data.synthetic import make_ragged_lm_stream
    cfg = small.cfg
    prompts = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                    cfg.vocab_size)[:N_SLOTS]
    L = cfg.n_layers
    out = {}
    for plan, unsplit in (("kv_split as shipped", False),
                          ("no key split at any width", True)):
        ref_seed, ref_pool = probe_prefill(torch, tfm, small, prompts,
                                           N_SLOTS, one_split=unsplit)
        ref_conf = _neg_entropy(torch, ref_seed)
        parts = []
        drift = conf_drift = 0.0
        for w in PROBE_WIDTHS:
            seed, pool = probe_prefill(torch, tfm, small, prompts, w,
                                       one_split=unsplit)
            d = float((seed - ref_seed).abs().max())
            dc = float((_neg_entropy(torch, seed) - ref_conf).abs().max())
            eq = layers_equal(torch, ref_pool, pool, prompts)
            drift, conf_drift = max(drift, d), max(conf_drift, dc)
            parts.append(f"{w} row{'s' if w > 1 else ''}: max|dseed logit| "
                         f"{d:.4g}, |dseed neg-entropy| {dc:.3g}, K/V "
                         f"bit-equal in {sum(eq)}/{L} layers"
                         + (f" (first other layer {eq.index(False)})"
                            if not all(eq) else ""))
            del pool
        print(f"[pressure] width probe, {plan}, against one {N_SLOTS}-row "
              f"dispatch of the main path's first {N_SLOTS} prompts "
              f"(chunks of {CHUNK}): " + "; ".join(parts) + f" on {smi}")
        out[plan] = dict(drift=drift, conf_drift=conf_drift)
        if not unsplit:
            seed, pool = probe_prefill(torch, tfm, small, prompts, N_SLOTS,
                                       start=PROBE_RESUME_AT, base=ref_pool)
            eq = layers_equal(torch, ref_pool, pool, prompts,
                              lo=PROBE_RESUME_AT)
            d = float((seed - ref_seed).abs().max())
            print(f"[pressure] resume probe, {plan}: re-prefilled from "
                  f"token {PROBE_RESUME_AT} over the first blocks of the "
                  f"{N_SLOTS}-row run: max|dseed logit| {d:.4g}, K/V of "
                  f"positions {PROBE_RESUME_AT}.. bit-equal in "
                  f"{sum(eq)}/{L} layers"
                  + (f" (first other layer {eq.index(False)})"
                     if not all(eq) else "") + f" on {smi}")
            out["resume_drift"] = d
            del pool
        del ref_pool
        torch.cuda.empty_cache()
    return dict(drift=out["kv_split as shipped"]["drift"],
                conf_drift=out["kv_split as shipped"]["conf_drift"],
                resume_drift=out["resume_drift"],
                unsplit_drift=out["no key split at any width"]["drift"])


def top2_margin(torch, tfm, small, prompt, tokens) -> float:
    """M_S's top-2 logit margin for the token after `prompt` + `tokens`
    (one forward of the whole context)."""
    import numpy as np
    ctx = np.concatenate([prompt, tokens]).astype(np.int64)
    logits = tfm.forward(small.params, small.cfg,
                         torch.from_numpy(ctx[None]).to(DEV))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def hold_to_reference(torch, tfm, small, res, ref, tau: float, probe: dict,
                      label: str) -> None:
    """Every DONE request of `res` against phase 4's unconstrained run
    `ref`: tokens, deferral and confidence equal. A request the pressure
    policy deferred to M_L (`deferred_reason` "oom") is held only to the
    M_S tokens it made before its eviction and to a full M_L generation.
    A request that differs is printed with its first differing M_S step
    and the reference's top-2 margin there; it is explained only when the
    probe measured a width drift and the margin is within twice it (a
    deferral or confidence that differs over equal M_S tokens: the
    confidence difference, or for a deferral the nearer confidence's
    distance to tau, within twice the probe's neg-entropy drift). Raises
    unless every difference is explained."""
    import numpy as np
    from repro_torch.serving.request import DONE
    drift, cdrift = probe["drift"], probe["conf_drift"]
    bad, n_diff, n_oom = [], 0, 0
    for a, b in zip(res.requests, ref.requests):
        if a.state != DONE:
            continue
        sa, sb = a.small_tokens, b.small_tokens
        n = min(len(sa), len(sb))
        diff = np.nonzero(sa[:n] != sb[:n])[0]
        if a.deferred_reason == "oom":
            n_oom += 1
            if not (a.tier == 1 and len(a.tokens) == a.max_new):
                bad.append(f"rid {a.rid}: OOM deferral without a full M_L "
                           f"generation")
        elif (np.array_equal(a.tokens, b.tokens)
              and a.deferred == b.deferred
              and a.confidence == b.confidence):
            continue
        if a.deferred_reason == "oom" and not diff.size:
            continue
        n_diff += 1
        if diff.size:
            j = int(diff[0])
            margin = top2_margin(torch, tfm, small, b.prompt, sb[:j])
            ok = drift > 0 and margin <= 2 * drift
            what = (f"rid {a.rid}: M_S token {j} {int(sa[j])} vs "
                    f"{int(sb[j])}, reference top-2 margin {margin:.4g}")
        else:
            dconf = abs(a.confidence - b.confidence)
            near = min(abs(a.confidence - tau), abs(b.confidence - tau))
            ok = cdrift > 0 and (dconf <= 2 * cdrift
                                 if a.deferred == b.deferred
                                 else near <= 2 * cdrift)
            what = (f"rid {a.rid}: equal M_S tokens, deferred "
                    f"{a.deferred} vs {b.deferred}, confidence "
                    f"{a.confidence:.7g} vs {b.confidence:.7g} (tau "
                    f"{tau:.7g})")
        print(f"[pressure] {label} differs from phase 4's run, {what}: "
              f"{'within' if ok else 'NOT within'} twice the probe's "
              f"drift")
        if not ok:
            bad.append(what)
    n_done = sum(r.state == DONE for r in res.requests)
    print(f"[pressure] {label}: {n_done - n_diff - n_oom} of {n_done} "
          f"finished requests equal phase 4's tokens, deferral and "
          f"confidence bit for bit, {n_oom} deferred to M_L for OOM (their "
          f"M_S tokens before eviction held); {n_diff} differ, {len(bad)} "
          f"beyond the width rule (probe drift {drift:.4g} logit, "
          f"{cdrift:.3g} neg-entropy)")
    if bad:
        raise AssertionError(f"{label}: {bad}")


def _nbytes(snapshot) -> int:
    return sum(t.numel() * t.element_size() for blk in snapshot
               for leaves in blk.values() for t in leaves.values())


def _expected_launches(small, large, res, n_ml=None,
                       extra_calls=()) -> dict:
    """The paged path's launches in a run without calibration: the decode
    and the paired write once per layer of each decode step; the signal
    once per decode step, per seeding prefill dispatch and per generate
    step of an upper tier (MAX_NEW a batch); flash_attention once per
    layer of each prefill dispatch (resume re-prefills too) and of each
    upper tier's batch's prefill. `large` is M_L's runner, or a ladder's
    upper tiers' runners (tier e+1 generating behind edge e,
    `ml_batches_per_edge[e]` batches). `n_ml` is the M_L generates run in
    this process (default: the run's batches per edge). `extra_calls`
    are (runner, generates, samples) made besides the backends' batches
    (a calibration's generates; a sampling signal's `sample` calls, each
    one prefill and no signal launch)."""
    st = res.stats
    L = small.cfg.n_layers
    uppers = list(large) if isinstance(large, (list, tuple)) else [large]
    if n_ml is None:
        n_ml = st.get("ml_batches_per_edge", [st["ml_batches"]])
    elif not isinstance(n_ml, (list, tuple)):
        n_ml = [n_ml]
    want = dict.fromkeys(KERNELS, 0)
    want["paged_flash_decode_gqa"] = want["paged_write_token"] = (
        L * res.steps)
    n_gen = sum(n_ml) + sum(g for _, g, _ in extra_calls)
    want["deferral_entropy"] = (res.steps + st["prefill_seed_dispatches"]
                                + MAX_NEW * n_gen)
    want["flash_attention"] = (
        flash_layers(small.cfg) * st["prefill_dispatches"]
        + sum(flash_layers(r.cfg) * n for r, n in zip(uppers, n_ml))
        + sum(flash_layers(r.cfg) * (g + k) for r, g, k in extra_calls))
    return want


def pressure_phase(torch, tfm, small, large, tau, ref, probe, smi):
    """Phase 4's cascade under memory pressure, then under overload, at
    phase 4's tau, on its 16 requests: the paged pool oversubscribed
    x PRESSURE_OVERSUB over about PRESSURE_SHARE of what the first 8
    requests need at full length, the preempt policy (bound
    PRESSURE_MAX_PREEMPT, then defer-on-OOM) and a PRESSURE_SWAP-block
    host swap tier. The pressure run: every request DONE, preemptions,
    pool invariants, exact launches, and tokens, deferral and confidences
    held to phase 4's run (`hold_to_reference`); the host cost of each
    snapshot and restore. The overload run: Poisson arrivals at
    OVERLOAD_RATE_X times the rate phase 4's slots served requests (its
    makespan less the M_L drain), the ready queue bounded
    at OVERLOAD_QUEUE and a deadline of OVERLOAD_DEADLINE_SHARE of the
    pressure run's makespan: each request terminal once, DONE ones full
    and held to phase 4's, shed ones empty, and some shed. Returns both
    runs' launch counts."""
    import numpy as np
    from repro_torch.data.synthetic import make_ragged_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig,
                                     PressureConfig, make_requests,
                                     poisson_arrivals)
    from repro_torch.serving.paged_pool import PagedCachePool
    from repro_torch.serving.request import DONE, EXPIRED, REJECTED
    cfg = small.cfg
    live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                 cfg.vocab_size)
    need = [math.ceil((len(p) + MAX_NEW - 1) / BLOCK) for p in live]
    n_blocks = max(max(need), round(PRESSURE_SHARE * sum(need[:N_SLOTS])))
    pressure = PressureConfig(oversubscribe=PRESSURE_OVERSUB,
                              policy="preempt",
                              max_preemptions=PRESSURE_MAX_PREEMPT,
                              swap_blocks=PRESSURE_SWAP)

    def engine(**kw):
        return ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=tau),
            EngineConfig(n_slots=N_SLOTS, backend="paged", paged=PagedConfig(
                block_size=BLOCK, n_blocks=n_blocks, prefill_chunk=CHUNK,
                paged_kernel=True, pressure=pressure), **kw))

    def run(eng, reqs):
        reset_counts()
        res = eng.run(reqs, MAX_NEW)
        torch.cuda.synchronize()
        launches = read_counts()
        eng.pool.check_invariants()
        want = _expected_launches(small, large, res)
        if launches != want or res.steps == 0:
            raise AssertionError(f"launch counts {launches} != {want}")
        return res, launches

    # host clock of each snapshot and restore the engine makes
    costs = {"save": [], "restore": []}
    save0, restore0 = (PagedCachePool.save_block_span,
                       PagedCachePool.restore_block_span)

    def save(pool, *args):
        t0 = time.perf_counter()
        snap = save0(pool, *args)
        costs["save"].append((time.perf_counter() - t0, _nbytes(snap)))
        return snap

    def restore(pool, slot, lo, hi, saved):
        t0 = time.perf_counter()
        restore0(pool, slot, lo, hi, saved)
        costs["restore"].append((time.perf_counter() - t0, _nbytes(saved)))

    PagedCachePool.save_block_span = save
    PagedCachePool.restore_block_span = restore
    try:
        eng = engine()
        torch.cuda.reset_peak_memory_stats()
        res, launches = run(eng, make_requests(live, MAX_NEW))
    finally:
        PagedCachePool.save_block_span = save0
        PagedCachePool.restore_block_span = restore0
    st = res.stats
    print(f"[pressure] {N_REQUESTS} requests (prompts {RAGGED[0]}-"
          f"{RAGGED[1]}, max_new {MAX_NEW}) on {N_SLOTS} slots over "
          f"{n_blocks} blocks of {BLOCK} (the first {N_SLOTS} requests "
          f"need {sum(need[:N_SLOTS])} at full length, the largest "
          f"{max(need)}), oversubscribed x{PRESSURE_OVERSUB} to "
          f"{st['virtual_blocks']}, preempt (bound {PRESSURE_MAX_PREEMPT}),"
          f" swap tier {PRESSURE_SWAP} blocks, tau {tau:.4f}: makespan "
          f"{st['makespan_s']:.3f} s ({ref.stats['makespan_s']:.3f} s "
          f"unconstrained), {st['throughput_tok_s']:.1f} tok/s, "
          f"{st['n_preemptions']} preemptions, {st['swap_outs']} swap outs,"
          f" {st['swap_ins']} swap ins, {st['pressure_reliefs']} reliefs, "
          f"{st['oom_deferrals']} OOM deferrals, at most "
          f"{max(r.n_preempted for r in res.requests)} preemptions of one "
          f"request, peak blocks "
          f"{st['peak_blocks']}/{n_blocks}, {res.steps} decode steps, "
          f"{st['prefill_dispatches']} prefill dispatches "
          f"({ref.stats['prefill_dispatches']} unconstrained), peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
          f"{smi}")
    print(f"[pressure] launches {launches} (exact)")
    for kind, rows in costs.items():
        if rows:
            ms = [t * 1e3 for t, _ in rows]
            nb = [b for _, b in rows]
            print(f"[pressure] {kind} of a preempted request's decode "
                  f"blocks, host clock: {len(rows)} calls, mean "
                  f"{np.mean(ms):.4f} ms, max {max(ms):.4f} ms, "
                  f"{int(np.mean(nb))} B a call (max {max(nb)} B) on {smi}")
    if not (all(r.state == DONE for r in res.requests)
            and st["n_preemptions"] > 0):
        raise AssertionError(f"pressure run: states "
                             f"{[r.state for r in res.requests]}, "
                             f"{st['n_preemptions']} preemptions")
    # a request deferred for OOM mid-prefill has no M_S confidence
    seen = np.array([r.n_small_steps > 0 for r in res.requests])
    if res.tokens.shape != (N_REQUESTS, MAX_NEW) or not np.isfinite(
            res.confidence[seen]).all():
        raise AssertionError("malformed pressure result")
    hold_to_reference(torch, tfm, small, res, ref, tau, probe,
                      "pressure run")
    # a snapshot and restore of 3 blocks, synchronised: the device's share
    pool = eng.pool
    s = pool.alloc()
    pool.reserve(s, 3 * BLOCK)
    pool.ensure_mapped(s, 3 * BLOCK)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = pool.save_block_span(s, 0, 3 * BLOCK)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pool.restore_block_span(s, 0, 3 * BLOCK, snap)
        torch.cuda.synchronize()
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    pool.release(s)
    save_ms, restore_ms = min(times)
    print(f"[pressure] 3-block snapshot and restore ({_nbytes(snap)} B, "
          f"{cfg.n_layers} layers), synchronised, best of 3: save "
          f"{save_ms:.4f} ms, restore {restore_ms:.4f} ms on {smi}")

    # overload: Poisson arrivals above the drain rate, a bounded queue and
    # deadlines
    served_s = ref.stats["makespan_s"] - ref.stats["phase_drain_s"]
    rate = OVERLOAD_RATE_X * N_REQUESTS / served_s
    deadline = OVERLOAD_DEADLINE_SHARE * st["makespan_s"]
    reqs = make_requests(live, MAX_NEW, poisson_arrivals(N_REQUESTS, rate,
                                                         seed=SEED))
    over, o_launches = run(engine(max_queue=OVERLOAD_QUEUE,
                                  deadline_s=deadline), reqs)
    ost = over.stats
    states = [r.state for r in over.requests]
    print(f"[pressure] overload: Poisson arrivals at {rate:.2f} requests/s "
          f"({OVERLOAD_RATE_X}x phase 4's {N_REQUESTS} in "
          f"{served_s:.3f} s before its M_L drain), max_queue "
          f"{OVERLOAD_QUEUE}, "
          f"deadline {deadline * 1e3:.1f} ms: {ost['n_completed']} done, "
          f"{ost['n_rejected']} rejected, {ost['n_expired']} expired, "
          f"{ost['n_preemptions']} preemptions, makespan "
          f"{ost['makespan_s']:.3f} s; launches {o_launches} (exact) on "
          f"{smi}")
    terminal = all(
        (r.state == DONE and len(r.tokens) == r.max_new)
        or (r.state in (REJECTED, EXPIRED) and len(r.tokens) == 0)
        for r in over.requests)
    if not (terminal and len({r.rid for r in over.requests}) == N_REQUESTS
            and ost["n_completed"] + ost["n_rejected"] + ost["n_expired"]
            == N_REQUESTS and ost["n_completed"] < N_REQUESTS):
        raise AssertionError(f"overload run: states {states}")
    hold_to_reference(torch, tfm, small, over, ref, tau, probe,
                      "overload run")
    return launches, o_launches


def reduced_pressure(torch, serve) -> dict:
    """tests/test_serving_pressure.py's scenario on the card, kernels on:
    the reduced fp32 internlm2-1.8b, 10 ragged prompts of 6-20 tokens,
    max_new 10, 4 slots, block 4, chunk 4, 4 steps a sync, 16 blocks
    oversubscribed x4 with the preempt policy and an 8-block swap tier,
    against 64 blocks and no pressure: tokens equal bit for bit,
    preemptions, pool invariants, exact launches. Returns the counts."""
    import numpy as np
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, MLBackendConfig,
                                     PagedConfig, PressureConfig,
                                     make_requests)
    from repro_torch.serving.request import DONE
    small, large = serve.build_ladder(ARCH, SEED, 2, device=DEV)
    lens = np.random.default_rng(7).integers(6, 21, size=10)
    base = make_lm_stream([SEED, 5], 10, 20, small.cfg.vocab_size)
    prompts = [base[i, :n] for i, n in enumerate(lens)]
    max_new = 10
    out = {}
    for name, n_blocks, pressure in (
            ("unconstrained", 64, None),
            ("pressure", 16, PressureConfig(oversubscribe=4.0,
                                            policy="preempt",
                                            max_preemptions=50,
                                            swap_blocks=8))):
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=-1e9),
            EngineConfig(n_slots=4, early_exit=False, steps_per_sync=4,
                         backend="paged", ml=MLBackendConfig(large_batch=4),
                         paged=PagedConfig(block_size=4, n_blocks=n_blocks,
                                           prefill_chunk=4, paged_kernel=True,
                                           pressure=pressure)))
        reset_counts()
        res = eng.run(make_requests(prompts, max_new), max_new)
        torch.cuda.synchronize()
        counts = read_counts()
        eng.pool.check_invariants()
        want = _expected_launches(small, large, res)
        if counts != want or res.stats["ml_batches"]:
            raise AssertionError(f"reduced {name} run: launches {counts} "
                                 f"!= {want}")
        out[name] = (res, counts)
    res, counts = out["pressure"]
    st = res.stats
    same = np.array_equal(res.tokens, out["unconstrained"][0].tokens)
    print(f"[reduced] {small.cfg.name} fp32 under pressure (16 blocks of 4 "
          f"against 64, x4, preempt, swap 8): {st['n_preemptions']} "
          f"preemptions, {st['swap_outs']} swap outs, {st['swap_ins']} swap "
          f"ins, {st['n_completed']}/10 done, tokens "
          f"{'equal' if same else 'NOT equal'} to the unconstrained run bit "
          f"for bit; launches {counts} (exact)")
    if not (same and st["n_preemptions"] > 0
            and all(r.state == DONE for r in res.requests)):
        raise AssertionError("reduced pressure run differs from the "
                             "unconstrained run")
    return counts


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def _audit_widths(path) -> dict:
    """{rid: rows of the M_L batch that regenerated it} from an audit log."""
    with open(path) as f:
        return {e["rid"]: e["pad_to"] for e in map(json.loads, f)
                if e["event"] == "large_complete"}


def _ref_widths(ref) -> dict:
    """M_L batch rows per deferred rid of a run with `large_batch` None
    (phase 4's): its prompt length's group, exact size, at the drain."""
    by_len = {}
    for r in ref.requests:
        if r.deferred:
            by_len[r.prompt_len] = by_len.get(r.prompt_len, 0) + 1
    return {r.rid: by_len[r.prompt_len] for r in ref.requests if r.deferred}


def ml_width_drift(torch, tfm, large, prompts, widths) -> float:
    """Does M_L's seed depend on its batch's rows? Each prompt prefilled
    by M_L (kernels on, a generate's cache) repeated to each width in
    `widths` and alone, as a padded batch repeats its first row: the
    largest |d seed logit| between any two widths."""
    import numpy as np
    drift = 0.0
    for p in prompts:
        seeds = []
        for w in sorted(set(widths) | {1}):
            toks = torch.from_numpy(np.repeat(
                np.asarray(p, np.int64)[None], w, 0)).to(DEV)
            cache = tfm.init_cache(large.cfg, w, len(p) + MAX_NEW,
                                   device=DEV)
            logits, _ = tfm.prefill(large.params, large.cfg, toks, cache,
                                    last_only=True, paged_kernel=True)
            seeds.append(logits[0, -1].float())
        for a in seeds:
            for b in seeds:
                drift = max(drift, float((a - b).abs().max()))
    return drift


def hold_ml_run(torch, tfm, large, res, ref, widths, ref_widths, drift_of,
                label: str, hold_small: bool = True) -> int:
    """`res` against a run `ref` of the same requests and tau: every
    request DONE, deferral equal, and (`hold_small`) M_S tokens and
    confidence bit-equal. A request's final tokens are bit-equal where
    its M_L batch had the reference's rows (rows regenerate
    independently of the others in a batch of one shape); where the rows
    differ (a re-dispatch, a clock-cut batch) a difference passes only
    where M_L's top-2 margin at the first differing token lies within
    twice `drift_of(widths seen)`, M_L's width drift. Returns how many
    requests differ."""
    import numpy as np
    from repro_torch.serving.request import DONE
    bad, n_diff, drift = [], 0, None
    for a, b in zip(res.requests, ref.requests):
        if a.state != DONE:
            bad.append(f"rid {a.rid} {a.state}")
            continue
        if a.deferred != b.deferred:
            bad.append(f"rid {a.rid}: deferred {a.deferred} vs {b.deferred}")
            continue
        if hold_small and not (np.array_equal(a.small_tokens, b.small_tokens)
                               and a.confidence == b.confidence):
            bad.append(f"rid {a.rid}: M_S tokens or confidence differ")
            continue
        if np.array_equal(a.tokens, b.tokens):
            continue
        n_diff += 1
        w, w_ref = widths.get(a.rid), ref_widths.get(a.rid)
        if not a.deferred or w == w_ref:
            bad.append(f"rid {a.rid}: tokens differ in a batch of the "
                       f"reference's {w_ref} rows")
            continue
        if drift is None:
            drift = drift_of(set(widths.values()) | set(ref_widths.values()))
        j = int(np.nonzero(a.tokens != b.tokens)[0][0])
        margin = top2_margin(torch, tfm, large, b.prompt, b.tokens[:j])
        ok = drift > 0 and margin <= 2 * drift
        print(f"[ml] {label}: rid {a.rid} M_L token {j} {int(a.tokens[j])} "
              f"vs {int(b.tokens[j])} in a batch of {w} rows (reference "
              f"{w_ref}), M_L top-2 margin {margin:.4g}: "
              f"{'within' if ok else 'NOT within'} twice the width drift "
              f"{drift:.4g}")
        if not ok:
            bad.append(f"rid {a.rid}: M_L margin {margin:.4g}")
    if bad:
        raise AssertionError(f"{label}: {bad}")
    return n_diff


class TimedRunner:
    """A runner whose `generate` calls are timed on the host clock (each
    ends in its one host copy of the tokens, so the time is the call's)."""

    def __init__(self, runner):
        self.runner, self.device, self.cfg = runner, runner.device, runner.cfg
        self.seconds = []

    def generate(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.runner.generate(*args, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return out


def _socket_factory(address):
    """The engine's M_L backend factory for one `MLServer` at `address`."""
    from repro_torch.serving.remote import SocketBackend

    def factory(runner=None, max_new=0, large_batch=None, max_wait=None,
                stub_latency=0.0, registry=None):
        return SocketBackend(address, request_timeout=ML_RPC_TIMEOUT,
                             registry=registry)
    return factory


def start_ml_processes(torch, src):
    """Start phase 14's two server processes at once: this script as an
    M_L server child (14c: the full-width large tier alone, from the same
    seed) and `python -m repro_torch.launch.ml_server` (14d: the reduced
    CLI ladder). Each process holds its own CUDA context on the card;
    neither is a fork. Returns {name: (process, start time, lines read
    so far, ready event)}."""
    import os
    import threading
    env = dict(os.environ, PYTHONPATH=str(src))
    cmds = {"child": [sys.executable, str(Path(__file__).resolve()),
                      "--ml-server", "--src", str(src)],
            "cli": [sys.executable, "-m", "repro_torch.launch.ml_server"]}
    procs = {}
    for name, cmd in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        lines, ready = [], threading.Event()

        def read(proc=proc, lines=lines, ready=ready):
            for line in proc.stdout:
                lines.append((time.perf_counter(), line.rstrip()))
                if "listening" in line:
                    ready.set()
            ready.set()
        threading.Thread(target=read, daemon=True).start()
        procs[name] = (proc, t0, lines, ready)
    return procs


def ml_address(procs, name: str):
    """(host:port, seconds from the process's start to its listening
    line) of a server process of `start_ml_processes`."""
    proc, t0, lines, ready = procs[name]
    if not ready.wait(timeout=ML_START_TIMEOUT) or proc.poll() is not None:
        raise AssertionError(f"M_L server process {name} did not start: "
                             + " | ".join(line for _, line in lines[-20:]))
    t, line = next((t, line) for t, line in lines if "listening" in line)
    addr = (line.split("--ml-address ")[1].split()[0] if "--ml-address"
            in line else line.split("listening ")[1].split()[0])
    return addr, t - t0


def stop_ml_process(procs, name: str) -> list:
    """Send the server process a shutdown frame, wait for it and return
    its output lines; raises unless it exits 0."""
    import socket as socket_lib
    from repro_torch.serving.remote import wire
    proc, _, lines, _ = procs[name]
    if proc.poll() is None:
        host, port = ml_address(procs, name)[0].rsplit(":", 1)
        with socket_lib.create_connection((host, int(port)),
                                          timeout=30.0) as s:
            s.settimeout(30.0)
            wire.send_frame(s, wire.envelope("shutdown"))
            wire.recv_frame(s)
        proc.wait(timeout=120)
    time.sleep(0.1)                     # the reader thread's last lines
    if proc.returncode != 0:
        raise AssertionError(f"M_L server process {name} exited "
                             f"{proc.returncode}: "
                             + " | ".join(line for _, line in lines[-20:]))
    return [line for _, line in lines]


def ml_server_child(torch) -> int:
    """`--ml-server`: phase 14's second process. Builds only the
    full-width large tier of phase 4's ladder (same config and seed, so
    the same weights), runs one warm-up generate (the process's first
    launches: library loads, cuBLAS handles), and serves it through two
    `MLServer`s, kernels on: the first with one exact-size batch per
    prompt length at the drain, as phase 4's sync backend (14c), the
    second with 14b's batching. When a shutdown frame stops the first it
    stops the second and prints each one's batches and the process's
    exact launches."""
    import numpy as np
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving.remote import MLServer
    large = serve.tier_runner(get_config(ARCH), SEED, 1, DEV)
    large.generate(np.zeros((1, RAGGED[0]), np.int32), RAGGED[0], MAX_NEW,
                   paged_kernel=True)
    torch.cuda.synchronize()
    reset_counts()
    srv = MLServer(large, max_new=MAX_NEW, paged_kernel=True).start()
    batched = MLServer(large, max_new=MAX_NEW, large_batch=ML_BATCH,
                       max_wait=ML_MAX_WAIT, paged_kernel=True).start()
    print(f"[child] listening {srv.address[0]}:{srv.address[1]} and "
          f"{batched.address[0]}:{batched.address[1]} after "
          f"{time.perf_counter() - t0:.2f} s in the process (weights "
          f"{sum(p.numel() for p in _leaves(large.params)) / 1e9:.3f} B)",
          flush=True)
    try:
        while srv.running:
            time.sleep(0.05)
    finally:
        srv.stop(timeout=120)
        batched.stop(timeout=120)
    torch.cuda.synchronize()
    print("[child] " + json.dumps({
        "batches": len(srv.batch_log),
        "batches_second": len(batched.batch_log), "launches": read_counts(),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}),
        flush=True)
    return 0


def child_second_address(procs) -> str:
    """host:port of the `--ml-server` child's second server (14b's
    batching)."""
    _, _, lines, _ = procs["child"]
    line = next(line for _, line in lines if "listening" in line)
    return line.split(" and ")[1].split()[0]


def ml_backends_phase(torch, tfm, small, large, tau, ref, smi, procs: dict,
                      src) -> dict:
    """14a. Phase 4's 16 requests at its tau on the paged engine (kernels
    on), after `start_ml_processes` has filled `procs` and both server
    processes listen: M_L through `sync` (this phase's yardstick of
    time), then `thread`, `stub` and `socket` (an in-process `MLServer`,
    its worker on a stream of its own), each with
    `large_batch` None and then ML_BATCH with `max_wait` None (batches
    fixed by submission order), then `pool` over two in-process replicas
    with the first killed when its first batch starts (orphans
    re-dispatched to the survivor). Each run: every request DONE, held to
    phase 4's sync run by `hold_ml_run` (M_S bit-equal; M_L bit-equal
    unless a batch's rows changed), launches counted exactly (the worker
    threads' and the servers' included: MAX_NEW signal launches and one
    flash_attention a layer per M_L generate). Returns the summed
    counts."""
    import shutil
    import tempfile
    import threading
    from repro_torch.data.synthetic import make_ragged_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, MLBackendConfig,
                                     PagedConfig, make_requests)
    from repro_torch.serving.obs import MetricsRegistry
    from repro_torch.serving.remote import MLServer, ReplicaPool
    live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                 small.cfg.vocab_size)
    ref_w = _ref_widths(ref)
    probe_prompts = [r.prompt for r in ref.requests
                     if r.deferred][:ML_PROBE_PROMPTS]
    drifts = {}

    def drift_of(widths):
        key = tuple(sorted(widths))
        if key not in drifts:
            drifts[key] = ml_width_drift(torch, tfm, large, probe_prompts,
                                         key)
        return drifts[key]

    tmp = Path(tempfile.mkdtemp(prefix="ml_phase_"))
    total = dict.fromkeys(KERNELS, 0)
    rows = []

    timed = TimedRunner(large)

    def run(label, kind, lb, servers=()):
        timed.seconds = []
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, timed, tau=tau),
            EngineConfig(n_slots=N_SLOTS, backend="paged", paged=PagedConfig(
                block_size=BLOCK, prefill_chunk=CHUNK, paged_kernel=True),
                ml=MLBackendConfig(kind=kind, large_batch=lb,
                                   stub_latency=ML_STUB_LATENCY)))
        audit = tmp / f"{label.replace(' ', '_')}.jsonl"
        reset_counts()
        res = eng.run(make_requests(live, MAX_NEW), MAX_NEW,
                      audit_path=str(audit))
        for srv in servers:
            srv.stop(timeout=120)       # a killed replica's last batches
        torch.cuda.synchronize()
        counts = read_counts()
        n_ml = (sum(len(srv.batch_log) for srv in servers) if servers
                else res.stats["ml_batches"])
        want = _expected_launches(small, large, res, n_ml=n_ml)
        if counts != want:
            raise AssertionError(f"{label}: launches {counts} != {want}")
        widths = _audit_widths(audit)
        n_diff = hold_ml_run(torch, tfm, large, res, ref, widths, ref_w,
                             drift_of, label)
        st = res.stats
        rows.append(f"{label} {st['makespan_s']:.3f} s (decode "
                    f"{st['phase_decode_s']:.3f}, drain "
                    f"{st['phase_drain_s']:.3f}; {n_ml} M_L generates, "
                    + ", ".join(f"{t:.3f}" for t in timed.seconds)
                    + f" s; {n_diff} M_L rows differ)")
        for k in KERNELS:
            total[k] += counts[k]
        return res

    try:
        procs.update(start_ml_processes(torch, src))
        for name in procs:
            addr, t_up = ml_address(procs, name)
            print(f"[ml] server process {name} listening at {addr} "
                  f"after {t_up:.2f} s")
        run("sync large_batch None", "sync", None)
        for lb in (None, ML_BATCH):
            for kind in ("thread", "stub"):
                run(f"{kind} large_batch {lb}", kind, lb)
            srv = MLServer(timed, max_new=MAX_NEW, large_batch=lb,
                           paged_kernel=True).start()
            try:
                run(f"socket large_batch {lb}", _socket_factory(srv.address),
                    lb, servers=(srv,))
            finally:
                srv.stop(timeout=120)
        # the pool, its first replica killed as its first batch starts
        started = threading.Event()

        class FirstBatchSignal:
            """M_L that signals when its first generate starts."""
            device = large.device
            cfg = large.cfg

            def generate(self, *args, **kw):
                started.set()
                return large.generate(*args, **kw)

        doomed = MLServer(FirstBatchSignal(), max_new=MAX_NEW,
                          large_batch=ML_BATCH, paged_kernel=True).start()
        survivor = MLServer(timed, max_new=MAX_NEW, large_batch=ML_BATCH,
                            paged_kernel=True).start()
        reg = MetricsRegistry()
        made = []

        def pool_factory(runner=None, max_new=0, large_batch=None,
                         max_wait=None, stub_latency=0.0, registry=None):
            made.append(ReplicaPool(
                [doomed.address, survivor.address],
                request_timeout=ML_RPC_TIMEOUT, retries=1, backoff=0.01,
                health_interval=0.1, max_new=max_new,
                large_batch=large_batch, registry=reg))
            return made[-1]

        def kill_when_started():
            if started.wait(timeout=ML_START_TIMEOUT):
                doomed.kill()
        killer = threading.Thread(target=kill_when_started, daemon=True)
        killer.start()
        try:
            run("pool of 2, one killed", pool_factory, ML_BATCH,
                servers=(doomed, survivor))
        finally:
            started.set()
            killer.join(timeout=60)
            doomed.stop(timeout=120)
            survivor.stop(timeout=120)
        scrape = reg.render()
        ejected = redispatched = 0
        for line in scrape.splitlines():
            if line.startswith("serving_ml_replica_ejections_total"):
                ejected = float(line.split()[-1])
            if line.startswith("serving_ml_redispatched_requests_total"):
                redispatched = float(line.split()[-1])
        print(f"[ml] pool: the killed replica ran {len(doomed.batch_log)} "
              f"M_L generates whose results were dropped, the survivor "
              f"{len(survivor.batch_log)}; {int(ejected)} ejection, "
              f"{int(redispatched)} requests re-dispatched, "
              f"{made[0].n_alive} replica alive")
        if not (ejected == 1 and redispatched > 0 and made[0].n_alive == 1):
            raise AssertionError("pool: the killed replica's work was not "
                                 "re-dispatched")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[ml] 14a: phase 4's {N_REQUESTS} requests at tau {tau:.4f}, "
          f"makespans (phase 4's sync {ref.stats['makespan_s']:.3f} s, decode "
          f"{ref.stats['phase_decode_s']:.3f}, drain "
          f"{ref.stats['phase_drain_s']:.3f}): "
          + "; ".join(rows) + f"; every request DONE, M_S tokens, deferral "
          f"and confidences bit-equal to phase 4's, launches exact on {smi}"
          + (f"; M_L width drift {max(drifts.values()):.4g}" if drifts
             else ""))
    return total


def _kernel_intervals(trace: dict):
    """{stream: [(start us, end us)]} of the GPU kernels in a Chrome trace
    that torch.profiler exported (raises when it holds none)."""
    out = {}
    events = trace.get("traceEvents", [])
    for e in events:
        if str(e.get("cat", "")).lower() == "kernel" and "dur" in e:
            stream = e.get("args", {}).get("stream", e.get("tid"))
            out.setdefault(stream, []).append((e["ts"], e["ts"] + e["dur"]))
    if not out:
        cats = sorted({str(e.get("cat")) for e in events})
        raise AssertionError(f"the profiler's trace holds no kernel event "
                             f"(categories {cats})")
    return out


def _union(intervals):
    """Merged, sorted intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap_us(xs, ys) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_phase(torch, tfm, small, large, procs, smi):
    """14b. JAX's test_threaded_steps_interleave_with_large_regeneration
    at full width: 16 prompts of ML_LENS tokens (alternating), everything
    deferred (tau +inf, early exit after min_tokens 2), Poisson arrivals
    at about the rate M_L regenerates batches of ML_BATCH, `large_batch`
    ML_BATCH and `max_wait` ML_MAX_WAIT, through `thread`, then `sync`,
    then `socket` to the `--ml-server` child's second server (M_L in
    another process: no GIL shared with the engine's loop). The clock
    cuts batches, so M_L rows are held to the sync run's by the width
    rule, and M_S's discarded tokens are not held. Prints the M_S steps
    between each large_submit and its large_complete, the queue depth's
    peak, the three makespans and, from a thread run under
    torch.profiler, the kernels and busy time on each stream, their
    overlap and the device-busy share. Returns (the timed thread and
    socket runs' counts summed, the socket run's M_L batches)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, MLBackendConfig,
                                     PagedConfig, make_requests,
                                     poisson_arrivals)
    base = make_lm_stream([SEED, 6], N_REQUESTS, max(ML_LENS),
                          small.cfg.vocab_size)
    prompts = [base[i, :ML_LENS[i % 2]] for i in range(N_REQUESTS)]
    for plen in ML_LENS:                 # warm M_L's shapes
        large.generate(np.zeros((ML_BATCH, plen), np.int32), plen, MAX_NEW,
                       paged_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    large.generate(np.zeros((ML_BATCH, max(ML_LENS)), np.int32),
                   max(ML_LENS), MAX_NEW, paged_kernel=True)
    t_batch = time.perf_counter() - t0
    rate = ML_BATCH / t_batch
    arrivals = poisson_arrivals(N_REQUESTS, rate, seed=SEED)
    tmp = Path(tempfile.mkdtemp(prefix="ml_overlap_"))

    def run(kind, label, n_ml=None):
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=math.inf, min_tokens=2),
            EngineConfig(n_slots=N_SLOTS, backend="paged", paged=PagedConfig(
                block_size=BLOCK, prefill_chunk=CHUNK, paged_kernel=True),
                ml=MLBackendConfig(kind=kind, large_batch=ML_BATCH,
                                   max_wait=ML_MAX_WAIT)))
        audit = tmp / f"{label}.jsonl"
        reset_counts()
        res = eng.run(make_requests(prompts, MAX_NEW, arrivals), MAX_NEW,
                      audit_path=str(audit))
        torch.cuda.synchronize()
        counts = read_counts()
        want = _expected_launches(small, large, res, n_ml=n_ml)
        if counts != want:
            raise AssertionError(f"14b {label}: launches {counts} != {want}")
        if not res.deferred.all():
            raise AssertionError(f"14b {label}: not every request deferred")
        return res, counts, audit

    try:
        thr, counts, audit = run("thread", "thread")
        syn, _, audit_sync = run("sync", "sync")
        sock, sock_counts, audit_sock = run(
            _socket_factory(child_second_address(procs)),
            "process", n_ml=0)
        events = [json.loads(line) for line in open(audit)]
        submit = {e["rid"]: i for i, e in enumerate(events)
                  if e["event"] == "large_submit"}
        done = {e["rid"]: i for i, e in enumerate(events)
                if e["event"] == "large_complete"}
        between = [sum(1 for e in events[submit[r] + 1:done[r]]
                       if e["event"] == "step")
                   for r in sorted(submit)]
        from repro_torch.serving.request import DONE
        if not (set(submit) == set(done) == set(range(N_REQUESTS))
                and all(r.state == DONE for r in
                        thr.requests + syn.requests + sock.requests)):
            raise AssertionError("14b: a deferral never completed")

        def drift_of(widths):
            return ml_width_drift(torch, tfm, large,
                                  prompts[:ML_PROBE_PROMPTS], widths)
        n_diff = hold_ml_run(
            torch, tfm, large, thr, syn, _audit_widths(audit),
            _audit_widths(audit_sync), drift_of, "14b thread against sync",
            hold_small=False)
        n_diff_sock = hold_ml_run(
            torch, tfm, large, sock, syn, _audit_widths(audit_sock),
            _audit_widths(audit_sync), drift_of,
            "14b second process against sync", hold_small=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_res = run("thread", "profiled")[0]
            wall_us = (time.perf_counter() - t0) * 1e6
        trace_path = tmp / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        trace = json.loads(trace_path.read_text())
        os.remove(trace_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = _kernel_intervals(trace)
    by_stream = {s: _union(iv) for s, iv in kernels.items()}
    busy = {s: sum(b - a for a, b in iv) for s, iv in by_stream.items()}
    n_kernels = {s: len(iv) for s, iv in kernels.items()}
    streams = sorted(by_stream, key=lambda s: -busy[s])
    overlap = (_overlap_us(by_stream[streams[0]], by_stream[streams[1]])
               if len(streams) > 1 else 0.0)
    every = _union([iv for ivs in by_stream.values() for iv in ivs])
    window = (every[-1][1] - every[0][0]) if every else 0.0
    dev_busy = sum(b - a for a, b in every)
    st, sst, kst = thr.stats, syn.stats, sock.stats
    print(f"[ml] 14b: {N_REQUESTS} prompts of {ML_LENS} tokens, everything "
          f"deferred, Poisson arrivals at {rate:.2f} requests/s (one M_L "
          f"generate of {ML_BATCH} x {max(ML_LENS)} + {MAX_NEW} tokens took "
          f"{t_batch * 1e3:.1f} ms), large_batch {ML_BATCH}, max_wait "
          f"{ML_MAX_WAIT} s: thread makespan {st['makespan_s']:.3f} s, sync "
          f"{sst['makespan_s']:.3f} s, socket to the second process "
          f"{kst['makespan_s']:.3f} s ({kst['ml_batches']} M_L batches, "
          f"queue-depth peak {kst['ml_queue_depth_peak']}, {n_diff_sock} M_L "
          f"rows differ from the sync run); M_S steps between each large_submit "
          f"and its large_complete {between} (total {sum(between)}); "
          f"ml_queue_depth_peak {st['ml_queue_depth_peak']} (sync "
          f"{sst['ml_queue_depth_peak']}); M_L batches {st['ml_batches']} "
          f"(sync {sst['ml_batches']}), occupancy "
          f"{st['ml_batch_occupancy']:.3f}; {n_diff} M_L rows differ from "
          f"the sync run (within the width rule) on {smi}")
    print(f"[ml] 14b profiled thread run (makespan "
          f"{prof_res.stats['makespan_s']:.3f} s): kernels on "
          f"{len(streams)} streams: "
          + "; ".join(f"stream {s}: {n_kernels[s]} kernels, busy "
                      f"{busy[s] / 1e3:.2f} ms" for s in streams)
          + f"; the two busiest overlap for {overlap / 1e3:.2f} ms; device "
          f"busy {dev_busy / 1e3:.2f} ms of a {window / 1e3:.2f} ms kernel "
          f"window ({dev_busy / max(window, 1e-9):.3f}) and of "
          f"{wall_us / 1e3:.2f} ms of host wall ({dev_busy / wall_us:.3f})")
    if not (sum(between) > 0 and st["ml_queue_depth_peak"] > 0):
        raise AssertionError("14b: M_S did not step while M_L regenerated")
    if len(streams) < 2 or overlap <= 0:
        raise AssertionError("14b: M_L's kernels ran on the engine's stream "
                             "or never beside its kernels")
    return _sum_counts(counts, sock_counts), kst["ml_batches"]


def second_process_phase(torch, small, large, tau, ref, procs,
                         second_batches: int, smi) -> dict:
    """14c. M_L in a second process on the card: the `--ml-server` child
    (started by `start_ml_processes`) serves the full-width large tier;
    phase 4's requests at its tau go through `socket` to its first
    server. Every token, deferral and confidence bit-equal to phase 4's
    sync run; the engine's launches exact with no M_L generate in this
    process, the child's exact for its two servers' batches (the second
    ran `second_batches`, 14b's). Returns the run's counts and the
    child's summed."""
    import numpy as np
    from repro_torch.data.synthetic import make_ragged_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, MLBackendConfig,
                                     PagedConfig, make_requests)
    address, t_ready = ml_address(procs, "child")
    live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                 small.cfg.vocab_size)
    eng = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large, tau=tau),
        EngineConfig(n_slots=N_SLOTS, backend="paged", paged=PagedConfig(
            block_size=BLOCK, prefill_chunk=CHUNK, paged_kernel=True),
            ml=MLBackendConfig(kind=_socket_factory(address))))
    reset_counts()
    res = eng.run(make_requests(live, MAX_NEW), MAX_NEW)
    torch.cuda.synchronize()
    counts = read_counts()
    want = _expected_launches(small, large, res, n_ml=0)
    if counts != want:
        raise AssertionError(f"14c: launches {counts} != {want}")
    same = (np.array_equal(res.tokens, ref.tokens)
            and np.array_equal(res.deferred, ref.deferred)
            and np.array_equal(res.confidence, ref.confidence))
    lines = stop_ml_process(procs, "child")
    for line in lines:
        print(f"[ml] {line}")
    child = json.loads(next(line for line in reversed(lines)
                            if line.startswith("[child] {"))[8:])
    n = child["batches"]
    n_all = n + child["batches_second"]
    want_child = dict.fromkeys(KERNELS, 0)
    want_child["deferral_entropy"] = MAX_NEW * n_all
    want_child["flash_attention"] = flash_layers(large.cfg) * n_all
    print(f"[ml] 14c: M_L in a second process on the card ({address}), "
          f"listening {t_ready:.2f} s after its start (interpreter, torch, "
          f"CUDA context, {large.cfg.n_layers}-layer large tier, one "
          f"warm-up generate), peak {child['peak_gib']} GiB there; phase 4's "
          f"{N_REQUESTS} requests through socket in "
          f"{res.stats['makespan_s']:.3f} s (phase 4's sync "
          f"{ref.stats['makespan_s']:.3f} s): tokens, deferral and "
          f"confidences {'bit-equal' if same else 'NOT equal'} to phase "
          f"4's; {n} M_L generates in the child for this run and "
          f"{child['batches_second']} for 14b's, its launches "
          f"{child['launches']}, this process's {counts} (exact) on {smi}")
    if not same or child["launches"] != want_child \
            or n != res.stats["ml_batches"] \
            or child["batches_second"] != second_batches:
        raise AssertionError(f"14c: second-process run differs: tokens "
                             f"equal {same}, child launches "
                             f"{child['launches']} != {want_child}")
    return _sum_counts(counts, child["launches"])


def kill_ml_processes(procs: dict) -> None:
    """End any server process of `start_ml_processes` still running."""
    for proc, *_ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def ml_tier(torch, tfm, small, large, tau, ref, smi, procs: dict, src,
            t_start: float) -> dict:
    """Phases 14a, 14b and 14c on phase 4's models (`tau` and `ref` its
    calibrated tau and sync run); `procs` receives the server processes,
    which the caller ends. Returns their launch counts by path."""
    out = {}
    phase("14a", t_start)
    out["ml_backends"] = ml_backends_phase(torch, tfm, small, large, tau,
                                           ref, smi, procs, src)
    phase("14b", t_start)
    out["ml_overlap"], second = overlap_phase(torch, tfm, small, large,
                                              procs, smi)
    phase("14c", t_start)
    out["ml_process"] = second_process_phase(torch, small, large, tau, ref,
                                             procs, second, smi)
    return out


def ml_tier_only(torch, smi, src, t_start: float) -> int:
    """`--ml-tier`: phase 4's main path on the full-width internlm2-1.8b
    cascade (its tau and sync run are phase 14's reference), then phase
    14, with no other phase (about 3 min with the build)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    with torch.inference_mode():
        phase("4", t_start)
        small, large = serve.build_ladder(ARCH, SEED, 2, reduce=False,
                                          device=DEV)
        L = small.cfg.n_layers
        _, ref, tau = serve_main_path(
            torch, small, large,
            {"paged_flash_decode_gqa": L, "paged_write_token": L}, smi)
        procs = {}
        try:
            ml_tier(torch, tfm, small, large, tau, ref, smi, procs, src,
                    t_start)
            del small, large
            torch.cuda.empty_cache()
            phase("14d", t_start)
            reduced_ml_backends(torch, serve, procs)
        finally:
            kill_ml_processes(procs)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    return 0


def reduced_ml_backends(torch, serve, procs) -> dict:
    """14d. tests/test_serving_async.py's reduced fp32 fixture (internlm2
    reduced, M_L 3 layers with d_ff 768, 16 prompts of 8 tokens, tau at
    deferral 0.5, 8 slots, min_tokens 2, `large_batch` ML_BATCH with
    `max_wait` None), kernels on, through the legacy constructor with
    sync / thread / stub / socket / pool: tokens and masks identical.
    Then `launch.serve.main()` with --large-backend sync, thread, pool
    --ml-spawn 2, and socket to the `python -m
    repro_torch.launch.ml_server` process: tokens equal to sync's.
    Returns the engine runs' counts."""
    import warnings
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import (ContinuousCascadeEngine, ModelRunner,
                                     make_requests)
    from repro_torch.serving.remote import MLServer, ReplicaPool
    from repro_torch.serving.request import DONE
    s_cfg = reduced(get_config(ARCH))
    l_cfg = s_cfg.replace(name="large", n_layers=3, d_ff=768)
    small = ModelRunner(s_cfg, tfm.init_params(s_cfg, SEED, DEV))
    large = ModelRunner(l_cfg, tfm.init_params(l_cfg, SEED + 1, DEV))
    prompts = make_lm_stream([SEED, 2], N_REQUESTS, 8, s_cfg.vocab_size)
    servers = [MLServer(large, max_new=4, large_batch=ML_BATCH,
                        paged_kernel=True).start() for _ in range(3)]
    kinds = {"sync": "sync", "thread": "thread", "stub": "stub",
             "socket": _socket_factory(servers[0].address),
             "pool": lambda **kw: ReplicaPool(
                 [s.address for s in servers[1:]],
                 request_timeout=ML_RPC_TIMEOUT, max_new=kw["max_new"],
                 large_batch=kw["large_batch"], registry=kw["registry"])}
    outs, total = {}, dict.fromkeys(KERNELS, 0)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            tau = ContinuousCascadeEngine(
                small, large, n_slots=8, min_tokens=2,
                paged_kernel=True).calibrate(prompts, 8, 4, 0.5)
            for name, kind in kinds.items():
                eng = ContinuousCascadeEngine(
                    small, large, n_slots=8, tau=tau, min_tokens=2,
                    early_exit=True, large_batch=ML_BATCH,
                    large_backend=kind, large_max_wait=None,
                    paged_kernel=True)
                reset_counts()
                outs[name] = eng.run(make_requests(prompts, 4), 4)
                torch.cuda.synchronize()
                counts = read_counts()
                if not (counts["deferral_entropy"]
                        and counts["flash_attention"]):
                    raise AssertionError(f"14d {name}: kernels off: "
                                         f"{counts}")
                for k in KERNELS:
                    total[k] += counts[k]
    finally:
        for srv in servers:
            srv.stop(timeout=60)
    ref = outs["sync"]
    same = {name: bool(np.array_equal(r.tokens, ref.tokens)
                       and np.array_equal(r.deferred, ref.deferred)
                       and all(q.state == DONE for q in r.requests))
            for name, r in outs.items()}
    print(f"[ml] 14d: reduced fp32 fixture ({s_cfg.n_layers} + "
          f"{l_cfg.n_layers} layers), tau {tau:.5f}, "
          f"{int(ref.deferred.sum())} of {N_REQUESTS} deferred: tokens and "
          f"masks equal to sync's: {same}")
    if not all(same.values()) or not 0 < ref.deferred.sum() < N_REQUESTS:
        raise AssertionError(f"14d: backends differ: {same}")
    cli = {}
    address, t_ready = ml_address(procs, "cli")
    for name, argv in (("sync", []), ("thread", ["--large-backend",
                                                 "thread"]),
                       ("pool", ["--large-backend", "pool", "--ml-spawn",
                                 "2"]),
                       ("socket", ["--large-backend", "socket",
                                   "--ml-address", address])):
        res = serve.main(argv)
        if not all(r.state == DONE for r in res.requests):
            raise AssertionError(f"serve.main({argv}) left requests "
                                 f"unfinished")
        cli[name] = res
    lines = stop_ml_process(procs, "cli")
    cli_same = {name: bool(np.array_equal(r.tokens, cli["sync"].tokens)
                           and np.array_equal(r.deferred,
                                              cli["sync"].deferred))
                for name, r in cli.items()}
    print(f"[ml] 14d: serve.main with --large-backend sync / thread / pool "
          f"--ml-spawn 2 / socket to `python -m repro_torch.launch."
          f"ml_server` (listening {t_ready:.2f} s after its start; "
          f"{lines[-1]}): tokens and masks equal to sync's: {cli_same}, "
          f"{int(cli['sync'].deferred.sum())} of "
          f"{len(cli['sync'].requests)} deferred")
    if not all(cli_same.values()) or not cli["sync"].deferred.any():
        raise AssertionError(f"14d: CLI backends differ: {cli_same}")
    return total


# ---------------------------------------------------------------------------
# Phase 16: the N-tier ladder, recalibration, semantic agreement, obs
# ---------------------------------------------------------------------------

class CallLog:
    """Counts each runner's `generate` and `sample` calls while it is
    entered (instance attributes shadow the methods; a backend binds
    `generate` when `run` builds it, so enter before the run). Thread-safe:
    a worker backend calls from its own thread."""

    def __init__(self, runners):
        import threading
        self.runners = list(runners)
        self.calls = [dict(generate=0, sample=0) for _ in self.runners]
        self._lock = threading.Lock()

    def __enter__(self):
        for i, r in enumerate(self.runners):
            for kind in ("generate", "sample"):
                setattr(r, kind, self._wrap(getattr(r, kind), i, kind))
        return self

    def _wrap(self, fn, i: int, kind: str):
        def call(*args, **kw):
            with self._lock:
                self.calls[i][kind] += 1
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for r in self.runners:
            del r.generate, r.sample


def timed_semantic(k: int = SEMANTIC_K, temperature: float = SEMANTIC_T):
    """A `SemanticAgreementSignal` that records (rid, score, wall ms) of
    each `finalize` (its k samples end in one host copy, so the wall time
    holds the device's)."""
    from repro_torch.core.deferral import SemanticAgreementSignal

    class TimedSemantic(SemanticAgreementSignal):
        def __init__(self):
            super().__init__(k=k, temperature=temperature, seed=SEED)
            self.records = []

        def finalize(self, obs):
            t0 = time.perf_counter()
            score = super().finalize(obs)
            self.records.append((obs.rid, score,
                                 (time.perf_counter() - t0) * 1e3))
            return score
    return TimedSemantic()


def ladder_engine(runners, signals, *, recalibrate: bool = False,
                  early_exit: bool = False, thread_last: bool = False,
                  paged_kernel: bool = True):
    """The serve CLI's ladder over `runners` (costs geometric from 0.2 to
    1.0) on the paged backend at phase 4's sizes, one edge per signal;
    `thread_last` runs the last tier on a `thread` backend (a CUDA
    stream of its own); `recalibrate` holds every edge at DEFERRAL
    online."""
    from repro_torch.serving import (CascadeSpec, CascadeTier,
                                     ContinuousCascadeEngine, DeferralEdge,
                                     EngineConfig, PagedConfig,
                                     RecalibConfig)
    n = len(runners)
    costs = [0.2 * (1.0 / 0.2) ** (i / (n - 1)) for i in range(n)]
    tiers = [CascadeTier(r.cfg.name, runner=r, cost=costs[i],
                         backend=("thread" if thread_last and i == n - 1
                                  else None))
             for i, r in enumerate(runners)]
    return ContinuousCascadeEngine(
        CascadeSpec(tiers=tiers,
                    edges=[DeferralEdge(signal=s) for s in signals]),
        EngineConfig(n_slots=N_SLOTS, early_exit=early_exit,
                     backend="paged",
                     paged=PagedConfig(block_size=BLOCK, prefill_chunk=CHUNK,
                                       paged_kernel=paged_kernel),
                     recalibration=(RecalibConfig(warmup=LADDER_WARMUP)
                                    if recalibrate else None),
                     recalib_target=DEFERRAL))


def ladder_prompts(cfg):
    """Phase 4's calibration batch and 16 ragged live prompts."""
    from repro_torch.data.synthetic import (make_lm_stream,
                                            make_ragged_lm_stream)
    cal_len = sum(RAGGED) // 2
    return (make_lm_stream([SEED, 1], N_REQUESTS, cal_len, cfg.vocab_size),
            cal_len, make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                           cfg.vocab_size))


def ladder_main_path(torch, engine, runners, label: str, smi, obs=None,
                     audit=None):
    """Calibrate every edge at DEFERRAL and run phase 4's requests through
    `engine`, the kernel counters set to 0 just before and read just
    after and held to `_expected_launches` over the calls each tier's
    runner made (the calibration's and the backends' generates, a
    sampling signal's samples); every request DONE at exactly one tier,
    `tier_served`, `tier_reach`, `edge_deferrals` and `compute_cost ==
    ladder_compute_cost(reach, costs)` consistent. Returns (result, taus,
    launches)."""
    import numpy as np
    from repro_torch.core.calibration import ladder_compute_cost
    from repro_torch.serving import make_requests
    from repro_torch.serving.request import DONE
    cal, cal_len, live = ladder_prompts(runners[0].cfg)
    n = len(runners)
    reset_counts()
    t0 = time.perf_counter()
    with CallLog(runners) as cal_log:
        taus = engine.calibrate(cal, cal_len, MAX_NEW, DEFERRAL)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    with CallLog(runners) as run_log:
        res = engine.run(make_requests(live, MAX_NEW), MAX_NEW,
                         audit_path=audit, obs=obs)
    torch.cuda.synchronize()
    launches = read_counts()
    st = res.stats
    print(f"[ladder] {label}: calibrated taus "
          f"{', '.join(f'{t:.4f}' for t in taus)} for deferral {DEFERRAL} "
          f"per edge in {t_cal:.2f} s; served {N_REQUESTS} requests in "
          f"{st['makespan_s']:.3f} s ({st['throughput_tok_s']:.1f} tok/s): "
          f"tier_served {st['tier_served']}, edge_deferrals "
          f"{st['edge_deferrals']}, tier_reach "
          f"{[round(x, 4) for x in st['tier_reach']]}, compute_cost "
          f"{st['compute_cost']:.4f}, backends {st['ml_backends']} with "
          f"{st['ml_batches_per_edge']} batches, {res.steps} decode steps, "
          f"{st['prefill_dispatches']} prefill dispatches, early exits "
          f"{int(res.early_exited.sum())}; phases (host wall s) "
          + ", ".join(f"{k[6:-2]} {v:.3f}" for k, v in st.items()
                      if k.startswith("phase_"))
          + f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    tiers = [r.tier for r in res.requests]
    served = [tiers.count(i) for i in range(n)]
    deferrals = [sum(t > e for t in tiers) for e in range(n - 1)]
    reach = [1.0] + [d / N_REQUESTS for d in deferrals]
    if not all(r.state == DONE and len(r.tokens) == MAX_NEW
               and r.deferred == (r.tier > 0) for r in res.requests):
        raise AssertionError(f"{label}: a request unfinished or served "
                             f"by no single tier")
    if (st["tier_served"] != served or st["edge_deferrals"] != deferrals
            or st["tier_reach"] != reach
            or st["compute_cost"] != ladder_compute_cost(
                reach, engine.spec.costs)
            or res.tokens.shape != (N_REQUESTS, MAX_NEW)
            or not np.isfinite(res.confidence).all()):
        raise AssertionError(f"{label}: ladder stats {st['tier_served']}, "
                             f"{st['edge_deferrals']}, {st['tier_reach']}, "
                             f"{st['compute_cost']} against the requests' "
                             f"tiers {served}")
    batches = st["ml_batches_per_edge"]
    run_gen = [c["generate"] for c in run_log.calls]
    if run_gen != [0] + batches:
        raise AssertionError(f"{label}: generates per tier {run_gen}, the "
                             f"backends' batches {batches}")
    extra = [(r, c["generate"], c["sample"] + rc["sample"])
             for r, c, rc in zip(runners, cal_log.calls, run_log.calls)]
    want = _expected_launches(runners[0], runners[1:], res,
                              extra_calls=extra)
    print(f"[ladder] {label}: kernel launches {launches}, expected {want} "
          f"(calibration generates per tier "
          f"{[c['generate'] for c in cal_log.calls]}, samples per tier "
          f"{[k for _, _, k in extra]})")
    if launches != want or res.steps == 0:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    return res, taus, launches


def _by_length(reqs):
    """Requests grouped by prompt length, each group rid-sorted: how a
    backend batches a drain (`BatchPolicy`, `large_batch` None)."""
    groups = {}
    for r in reqs:
        groups.setdefault(r.prompt_len, []).append(r)
    return [sorted(g, key=lambda r: r.rid) for _, g in sorted(groups.items())]


def _generate_groups(runner, reqs) -> dict:
    import numpy as np
    out = {}
    for g in _by_length(reqs):
        toks, conf = runner.generate(np.stack([r.prompt for r in g]),
                                     g[0].prompt_len, MAX_NEW)
        for r, t, c in zip(g, toks, conf):
            out[r.rid] = (t, float(c))
    return out


def ladder_reference(torch, tfm, runners, res, taus, drift: float,
                     conf_drift: float, label: str) -> None:
    """`res` (early exit off) against the sequential reference of
    tests/test_cascade_ladder.py: tier i's `generate` over what reached
    it. Tier 0 generates every prompt (by length group, a dense cache);
    its tokens and deferral must equal the engine's paged ones, except
    under the width rule (ROADMAP.md §3): a row whose tokens differ
    passes when the reference's top-2 margin at the first difference is
    within twice `drift`, one whose deferral alone differs when its two
    confidences lie within twice `conf_drift`. Each differing row is
    printed. Tiers 1.. generate over exactly what the engine sent them,
    by length group as its backends batch: tokens, confidences and
    every gate bit for bit."""
    import numpy as np
    reqs = res.requests
    n = len(runners)
    ref0 = _generate_groups(runners[0], reqs)
    bad, n_diff, dconf = [], 0, 0.0
    for r in reqs:
        t, c = ref0[r.rid]
        ref_defer = c < taus[0]
        if np.array_equal(r.small_tokens, t) and r.deferred == ref_defer:
            dconf = max(dconf, abs(r.confidence - c))
            continue
        n_diff += 1
        diff = np.nonzero(r.small_tokens != t)[0]
        if diff.size:
            j = int(diff[0])
            margin = top2_margin(torch, tfm, runners[0], r.prompt, t[:j])
            ok = margin <= 2 * drift
            what = (f"rid {r.rid}: tier-0 token {j} {int(r.small_tokens[j])}"
                    f" vs {int(t[j])}, reference top-2 margin {margin:.4g}")
        else:
            ok = abs(r.confidence - c) <= 2 * conf_drift
            what = (f"rid {r.rid}: equal tier-0 tokens, deferred "
                    f"{r.deferred} vs {ref_defer}, confidence "
                    f"{r.confidence:.7g} vs {c:.7g} (tau {taus[0]:.7g})")
        print(f"[ladder] {label} differs from the sequential reference, "
              f"{what}: {'within' if ok else 'NOT within'} the width rule")
        if not ok:
            bad.append(what)
    for r in reqs:
        if r.deferred != (r.confidence < taus[0]):
            bad.append(f"rid {r.rid}: edge 0 deferred {r.deferred} at "
                       f"confidence {r.confidence} against tau {taus[0]}")
    reached = [r for r in reqs if r.tier >= 1]
    exact = 0
    for i in range(1, n):
        out = _generate_groups(runners[i], reached)
        nxt = []
        for r in reached:
            t, c = out[r.rid]
            if i < n - 1 and c < taus[i]:
                nxt.append(r)
                if r.tier <= i:
                    bad.append(f"rid {r.rid}: edge {i} kept it at tier "
                               f"{r.tier}, its confidence {c} < tau "
                               f"{taus[i]}")
            elif r.tier != i or not np.array_equal(r.tokens, t):
                bad.append(f"rid {r.rid}: tier {r.tier} tokens against the "
                           f"reference's tier {i}")
            else:
                exact += 1
        reached = nxt
    print(f"[ladder] {label} against the sequential reference: tier 0 "
          f"{N_REQUESTS - n_diff} of {N_REQUESTS} rows equal (tokens and "
          f"deferral; max|dconf| {dconf:.3g} on them), {n_diff} differ "
          f"(width rule: drift {drift:.4g} logit, {conf_drift:.3g} "
          f"neg-entropy); tiers 1..{n - 1}: {exact} served rows bit-equal, "
          f"every gate equal; {len(bad)} beyond the rules")
    if bad:
        raise AssertionError(f"{label}: {bad}")


def check_prng_on_card(torch, smi) -> None:
    """16c: `core.prng`'s draw on the card against its numpy version at
    one sampled step's noise shape [k, vocab]: bits and uniforms exact,
    gumbel within GUMBEL_ATOL, over seeds past 2^31 and several fold_in
    steps; then its time and kernels per sampled step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import prng
    for seed in PRNG_SEEDS:
        key = prng.prng_key(seed)
        for step in PRNG_STEPS:
            k = prng.fold_in(key, step)
            bits = prng.random_bits(k, PRNG_SHAPE, DEV).cpu().numpy()
            u = prng.uniform(k, PRNG_SHAPE, DEV).cpu().numpy()
            g = prng.gumbel(k, PRNG_SHAPE, DEV).cpu().numpy()
            ok_bits = np.array_equal(bits, prng.random_bits_np(k, PRNG_SHAPE))
            ok_u = np.array_equal(u, prng.uniform_np(k, PRNG_SHAPE))
            dg = float(np.abs(g - prng.gumbel_np(k, PRNG_SHAPE)).max())
            if not (ok_bits and ok_u and dg <= GUMBEL_ATOL):
                raise AssertionError(f"PRNG seed {seed} step {step}: bits "
                                     f"{ok_bits}, uniform {ok_u}, gumbel "
                                     f"{dg}")
    logits = torch.randn(PRNG_SHAPE, device=DEV)
    key = prng.fold_in(prng.prng_key(PRNG_SEEDS[0]), 1)
    ms = time_ms(lambda: prng.categorical(key, logits))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prng.categorical(key, logits)
        torch.cuda.synchronize()
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[ladder] 16c PRNG: uint32 bits and uniforms equal to the numpy "
          f"version, gumbel within {GUMBEL_ATOL}, at {list(PRNG_SHAPE)} "
          f"for seeds {list(PRNG_SEEDS)} x fold_in steps "
          f"{list(PRNG_STEPS)}; one categorical draw (a sampled step) "
          f"{ms:.4f} ms and {n_kernels} kernel launches on {smi}")


def ladder_obs_checks(torch, obs, trace_path: Path, smi) -> None:
    """16e: the caller-owned runtime over 16a's run: /metrics scraped
    after the run shows its 16 retirements, the profiler window's Chrome
    trace parses and names the GQA decode kernel, and the engine's own
    trace (exported at `finish`) passes `validate_chrome_trace`."""
    import urllib.request

    from repro_torch.serving.obs import validate_chrome_trace
    with urllib.request.urlopen(obs.server.url, timeout=10) as resp:
        body = resp.read().decode()
    if f"serving_requests_retired {float(N_REQUESTS)}" not in body:
        raise AssertionError(f"/metrics: no serving_requests_retired "
                             f"{N_REQUESTS} in the scrape")
    prof_path = obs.profiler.trace_path
    if prof_path is None:
        raise AssertionError("the profiler window wrote no trace")
    events = json.loads(Path(prof_path).read_text())["traceEvents"]
    gqa = [e for e in events if "gqa_decode_kernel" in str(e.get("name"))]
    kernels = _kernel_intervals({"traceEvents": events})
    if not gqa:
        raise AssertionError("the profiler window's trace names no GQA "
                             "decode kernel")
    obs.finish()
    spans = validate_chrome_trace(json.loads(trace_path.read_text()))
    print(f"[ladder] 16e obs: /metrics ({len(body)} bytes) shows "
          f"serving_requests_retired {N_REQUESTS}; the profiler window "
          f"({OBS_PROFILE_ITERS} iterations) wrote "
          f"{Path(prof_path).stat().st_size} bytes, "
          f"{sum(len(v) for v in kernels.values())} kernel events, "
          f"{len(gqa)} of them gqa_decode_kernel; the engine's trace "
          f"validates ({len(spans)} spans) on {smi}")


def ladder_cli(src) -> None:
    """16e: the serve CLI with the slice's flags at the reduced size, in
    a process of its own on the card; it must exit 0 and print its
    endpoint and profiler trace."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "repro_torch.launch.serve",
                "--tiers", "3", "--signal", "semantic_agreement",
                "--recalibrate", "--recalib-warmup", "2", "--metrics-port",
                "0", "--profile-dir", str(Path(tmp) / "prof"),
                "--requests", "8", "--max-new", "4"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=dict(os.environ, PYTHONPATH=str(src)),
                              capture_output=True, text=True,
                              timeout=LADDER_CLI_TIMEOUT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        shown = [ln for ln in lines if ln.startswith(
            ("calibrated", "metrics endpoint", "served", "tier_served",
             "online recalibration", "torch.profiler"))]
        print("[ladder] 16e CLI: " + " | ".join(shown)
              + f" (exit {proc.returncode}, {wall:.1f} s)")
        traces = list((Path(tmp) / "prof").glob("*.json"))
        if proc.returncode != 0 or len(traces) != 1:
            raise AssertionError(f"serve CLI exit {proc.returncode}, "
                                 f"{len(traces)} profiler traces: "
                                 f"{proc.stderr[-2000:]}")


def ladder_phase(torch, tfm, serve, rng, smi, src, t_start: float,
                 probe=None) -> dict:
    """Phase 16 (see the module docstring). `probe` is phase 13's width
    probe of the same M_S (tier 0 keeps phase 4's seed); run alone, the
    phase probes anew. Returns {path: launches}."""
    import gc
    import tempfile

    import numpy as np
    from repro_torch.core.recalibration import (EdgeRecalibrator,
                                                RecalibConfig)
    from repro_torch.serving.obs import ObsConfig, Observability
    t_phase = time.perf_counter()
    phase("16a", t_start)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runners = serve.build_ladder(ARCH, SEED, LADDER_TIERS, reduce=False,
                                 device=DEV)
    torch.cuda.synchronize()
    print(f"[ladder] {LADDER_TIERS}-tier ladder at published width in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"tier {i} {r.cfg.name} {r.cfg.n_layers} layers d_model "
              f"{r.cfg.d_model} {r.cfg.n_heads}/{r.cfg.n_kv_heads} heads "
              f"d_ff {r.cfg.d_ff}, "
              f"{sum(t.numel() for t in _leaves(r.params)) / 1e9:.3f} B"
              for i, r in enumerate(runners))
          + f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if probe is None:
        probe = width_probe(torch, tfm, runners[0], smi)
    step_err = decode_step_check(torch, tfm, runners[0].params,
                                 runners[0].cfg, rng)[0]
    drift = max(probe["drift"], step_err)
    print(f"[ladder] width rule: drift {drift:.4g} logit (the width "
          f"probe's {probe['drift']:.4g}, a bf16 decode step kernel vs "
          f"plain {step_err:.4g}), neg-entropy {probe['conf_drift']:.3g}")
    counts = {}
    tmp = Path(tempfile.mkdtemp(prefix="ladder_"))
    # 16a + 16e: both edges on mean_confidence under a caller-owned
    # observability runtime
    obs = Observability(ObsConfig(
        metrics_port=0, profile_dir=str(tmp / "prof"),
        profile_iters=OBS_PROFILE_ITERS, trace_path=str(tmp / "trace.json")))
    obs.start_server()
    eng = ladder_engine(runners, ["mean_confidence"] * (LADDER_TIERS - 1))
    try:
        res, taus, counts["ladder"] = ladder_main_path(
            torch, eng, runners, "16a", smi, obs=obs)
        phase("16e", t_start)
        ladder_obs_checks(torch, obs, tmp / "trace.json", smi)
    finally:
        obs.finish()
    ladder_reference(torch, tfm, runners, res, taus, drift,
                     probe["conf_drift"], "16a")
    # 16b: recalibration, the last tier on a thread backend
    phase("16b", t_start)
    eng = ladder_engine(runners, ["mean_confidence"] * (LADDER_TIERS - 1),
                        recalibrate=True, early_exit=True, thread_last=True)
    audit = tmp / "audit.jsonl"
    res, taus, counts["ladder_recal"] = ladder_main_path(
        torch, eng, runners, "16b", smi, audit=str(audit))
    rc = res.stats["recalibration"]
    replay = EdgeRecalibrator(list(taus), DEFERRAL,
                              RecalibConfig(warmup=LADDER_WARMUP))
    events = [json.loads(ln) for ln in audit.read_text().splitlines()]
    observed = [e for e in events if e["event"] == "recalibrate"]
    for e in observed:
        if replay.observe(e["edge"], e["confidence"]) != e["tau"]:
            raise AssertionError("16b: the host replay's tau differs")
    if (res.stats["edge_tau"] != rc["tau_final"] or replay.summary() != rc
            or res.stats["ml_backends"] != ["sync", "thread"]):
        raise AssertionError(f"16b: edge_tau {res.stats['edge_tau']}, "
                             f"recalibration {rc}, replay "
                             f"{replay.summary()}")
    print(f"[ladder] 16b recalibration (warmup {LADDER_WARMUP}, target "
          f"{DEFERRAL}): taus {[round(t, 4) for t in taus]} -> "
          f"{[round(t, 4) for t in rc['tau_final']]}, updates "
          f"{rc['tau_updates']}, ewma deferral {rc['ewma_ratio']}; "
          f"edge_tau == tau_final; the host replay of the audit log's "
          f"{len(observed)} observations gives the same summary; backends "
          f"{res.stats['ml_backends']}")
    # 16c: semantic agreement on edge 1
    phase("16c", t_start)
    check_prng_on_card(torch, smi)
    prompt = ladder_prompts(runners[0].cfg)[2][0]
    batch = np.tile(prompt, (SEMANTIC_K, 1))
    a, b = (runners[1].sample(batch, len(prompt), MAX_NEW, seed=2 ** 31 + 7,
                              temperature=SEMANTIC_T) for _ in range(2))
    if not np.array_equal(a, b):
        raise AssertionError("16c: two sample calls differ")
    sig = timed_semantic()
    eng = ladder_engine(runners, ["mean_confidence", sig])
    res, taus, counts["ladder_semantic"] = ladder_main_path(
        torch, eng, runners, "16c", smi)
    run_recs = sig.records[-res.stats["edge_deferrals"][0]:] \
        if res.stats["edge_deferrals"][0] else []
    ms = [m for _, _, m in sig.records]
    print(f"[ladder] 16c: two samples of [{SEMANTIC_K}, {MAX_NEW}] tokens "
          f"equal; semantic agreement (k {SEMANTIC_K}, T {SEMANTIC_T}) on "
          f"edge 1, tau {taus[1]:.4f}: {len(sig.records)} finalize calls "
          f"(calibration and run), {np.mean(ms):.1f} ms each on average "
          f"(min {min(ms):.1f}, max {max(ms):.1f}); the run's gated "
          f"requests (rid, score, ms): "
          + ", ".join(f"({rid}, {sc:.4f}, {m:.1f})"
                      for rid, sc, m in run_recs) + f" on {smi}")
    # the engines' run closures hold them in reference cycles: collect
    # before the next phase needs the card's memory
    del runners, eng, res, sig, a, b, obs
    gc.collect()
    torch.cuda.empty_cache()
    # 16d: the reduced fp32 ladder, kernels on and off
    phase("16d", t_start)
    reduced_ladder(torch, serve)
    phase("16e CLI", t_start)
    ladder_cli(src)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ladder] phase 16: {time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          f"at its end on {smi}")
    return counts


def reduced_ladder(torch, serve) -> None:
    """16d: the reduced fp32 three-tier ladder with semantic agreement on
    both edges and recalibration on, every kernel switched on and then
    off by the engine's `paged_kernel`: the same tokens, tiers,
    confidences and tau trace."""
    import numpy as np
    from repro_torch.serving import make_requests
    from repro_torch.serving.request import DONE
    runners = serve.build_ladder(ARCH, SEED, LADDER_TIERS, reduce=True,
                                 device=DEV)
    cal, cal_len, live = ladder_prompts(runners[0].cfg)
    out = {}
    for kernel in (True, False):
        eng = ladder_engine(runners, [timed_semantic(), timed_semantic()],
                            recalibrate=True, paged_kernel=kernel)
        reset_counts()
        taus = eng.calibrate(cal, cal_len, MAX_NEW, DEFERRAL)
        res = eng.run(make_requests(live, MAX_NEW), MAX_NEW)
        torch.cuda.synchronize()
        n = sum(read_counts().values())
        if kernel != (n > 0) or not all(r.state == DONE
                                        for r in res.requests):
            raise AssertionError(f"16d: kernels {kernel} launched {n}")
        out[kernel] = (taus, res)
    (ta, a), (tb, b) = out[True], out[False]
    same = (ta == tb and np.array_equal(a.tokens, b.tokens)
            and [r.tier for r in a.requests] == [r.tier for r in b.requests]
            and np.array_equal(a.confidence, b.confidence)
            and a.stats["recalibration"] == b.stats["recalibration"])
    print(f"[ladder] 16d reduced fp32 ladder, semantic agreement on both "
          f"edges and recalibration on: kernels on and off give "
          f"{'the same' if same else 'DIFFERENT'} taus, tokens, tiers "
          f"{a.stats['tier_served']}, confidences and tau trace "
          f"({a.stats['recalibration']['tau_updates']} updates)")
    if not same:
        for ra, rb in zip(a.requests, b.requests):
            if not (np.array_equal(ra.tokens, rb.tokens)
                    and ra.tier == rb.tier):
                print(f"[ladder] 16d rid {ra.rid}: tier {ra.tier} vs "
                      f"{rb.tier}, confidence {ra.confidence} vs "
                      f"{rb.confidence}")
        raise AssertionError("16d: the kernel path differs from the plain")


def profile_step(torch, label, cfg, split, params, loss) -> None:
    """CLS_PROFILE_STEPS train steps of `cfg` on a copy of `params`, on the
    host clock and under torch.profiler: wall and device-busy ms a step."""
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.models.classifier import classifier_forward
    from repro_torch.training import optim
    from repro_torch.training.loop import make_train_step
    params = {k: v.clone() for k, v in params.items()}
    it = BatchIterator({"inputs": split.x, "targets": split.y}, CLS_BATCH,
                       seed=SEED).forever()
    step = make_train_step(lambda p, b: classifier_forward(p, cfg,
                                                           b["inputs"]),
                           optim.AdamWConfig(total_steps=CLS_PROFILE_STEPS),
                           **loss)
    state = optim.adamw_init(params)

    def run():
        nonlocal state
        for _ in range(CLS_PROFILE_STEPS):
            _, state, _ = step(params, state, next(it))
        torch.cuda.synchronize()
    wall_ms, busy_ms, ranked = profile_steps(torch, run, CLS_PROFILE_STEPS)
    busy_ms = busy_ms or 0.0
    print(f"[cls] {label}, {CLS_PROFILE_STEPS} steps: host wall "
          f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), {len(ranked)} kernel names; "
          f"top: " + ", ".join(f"{name[:48]} {ms:.4f}"
                               for name, ms in ranked[:4]))


def classifier_cascade(torch, smi) -> dict:
    """Phase 10: tests/test_system.py's flow on the port's own draw and
    init. M_S and M_L trained with cross-entropy, M_S tuned with the
    Gatekeeper loss, both evaluated on the test split before and after,
    then `Cascade(signal="max_softmax")` calibrated at CLS_DEFERRAL on
    CLS_CAL_ROWS test rows and run by `predict_sparse` on the rest. The
    counters are set to 0 before the phase and checked after it: one
    `deferral_entropy` per `evaluate_classifier` batch and per model's
    logits in `calibrate_tau` / `predict_sparse`, nothing else; each such
    logits tensor's (max_prob, argmax) is held against
    `deferral_entropy_plain` on the same tensor. Returns the counts."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.core.cascade import Cascade
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.data.pipeline import BatchIterator
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels.deferral_entropy import deferral_entropy_plain
    from repro_torch.models.classifier import (MLPClassifierConfig,
                                               classifier_forward,
                                               init_classifier)
    from repro_torch.training import optim
    from repro_torch.training.loop import (evaluate_classifier,
                                           make_train_step, train)
    reset_counts()
    data = {name: make_classification(
        SEED if fold is None else [SEED, fold], n, n_classes=CLS_CLASSES,
        hard_frac=CLS_HARD_FRAC) for name, (fold, n) in CLS_SPLITS.items()}
    test = data["test"]
    d_in = test.x.shape[1]
    s_cfg = MLPClassifierConfig(d_in, CLS_CLASSES, CLS_SMALL)
    l_cfg = MLPClassifierConfig(d_in, CLS_CLASSES, CLS_LARGE)

    def fit(label, cfg, split, params, seed, steps, lr=3e-3, **loss):
        it = BatchIterator({"inputs": split.x, "targets": split.y},
                           CLS_BATCH, seed=seed)
        step = make_train_step(
            lambda p, b: classifier_forward(p, cfg, b["inputs"]),
            optim.AdamWConfig(lr=lr, total_steps=steps), **loss)
        t0 = time.perf_counter()
        res = train(params, step, it.forever(), steps, log_every=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[cls] {label}: {steps} steps of {CLS_BATCH} rows in "
              f"{wall:.3f} s ({wall / steps * 1e3:.3f} ms/step), loss "
              f"{res.history['loss'][0]:.4f} -> {res.history['loss'][-1]:.4f}")
        return res.params

    small = fit(f"fit M_S {CLS_SMALL}", s_cfg, data["train"],
                init_classifier(s_cfg, 1, DEV), 1, CLS_SMALL_STEPS)
    large = fit(f"fit M_L {CLS_LARGE}", l_cfg, data["train_large"],
                init_classifier(l_cfg, 2, DEV), 2, CLS_LARGE_STEPS)
    tuned = fit(f"tune M_S (Gatekeeper, alpha {CLS_ALPHA})", s_cfg,
                data["cal"], {k: v.clone() for k, v in small.items()}, 7,
                CLS_TUNE_STEPS, lr=5e-3, loss_kind="gatekeeper",
                gk_cfg=GatekeeperConfig(alpha=CLS_ALPHA))
    for label, cfg, split, params, loss in (
            ("M_S step (Gatekeeper)", s_cfg, data["cal"], tuned,
             dict(loss_kind="gatekeeper",
                  gk_cfg=GatekeeperConfig(alpha=CLS_ALPHA))),
            ("M_L step (ce)", l_cfg, data["train_large"], large, {})):
        profile_step(torch, label, cfg, split, params, loss)
    if read_counts()["deferral_entropy"]:
        raise AssertionError("training launched the deferral signal")

    seen = []       # every logits tensor the signal is taken of, in order

    def recorded(cfg):
        def apply(p, x):
            logits = classifier_forward(p, cfg, x)
            seen.append(logits)
            return logits
        return apply

    def hold(label, logits, conf, pred):
        """The kernel's (max_prob, argmax) against the plain version's on
        the same logits."""
        _, want_conf, want_pred = deferral_entropy_plain(logits)
        err = float(np.abs(conf - want_conf.cpu().numpy()).max())
        flips = int((pred != want_pred.cpu().numpy()).sum())
        if not (err <= SIGNAL_ATOL and flips == 0
                and np.isfinite(conf).all()):
            raise AssertionError(f"{label}: max_prob err {err}, {flips} "
                                 f"argmax differ")
        return err

    n_eval, errs = 0, []

    def evaluate(cfg, params):
        nonlocal n_eval
        seen.clear()
        pred, conf, corr = evaluate_classifier(recorded(cfg), params,
                                               test.x, test.y, CLS_EVAL_BATCH)
        n_eval += len(seen)
        errs.append(hold("evaluate_classifier", torch.cat(seen), conf, pred))
        if not (pred.shape == (len(test.y),) and corr.dtype == np.float64):
            raise AssertionError("malformed evaluate_classifier result")
        return corr, conf

    t0 = time.perf_counter()
    summ = {}
    for name, params in (("untuned", small), ("tuned", tuned)):
        scorr, sconf = evaluate(s_cfg, params)
        lcorr, _ = evaluate(l_cfg, large)
        summ[name] = metrics.summarize_deferral(sconf, scorr, lcorr)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    base, gk = summ["untuned"], summ["tuned"]
    print(f"[cls] evaluation ({n_eval} evaluate_classifier batches of the "
          f"{len(test.y)}-row test split): {eval_s:.3f} s; " + ", ".join(
              f"{k} {base[k]:.4f} -> {gk[k]:.4f}"
              for k in ("acc_small", "acc_large", "s_d", "auroc", "s_o")))

    cascade = Cascade(recorded(s_cfg), recorded(l_cfg), small, large,
                      signal="max_softmax", cost_small=0.2)
    x_cal = torch.from_numpy(test.x[:CLS_CAL_ROWS]).to(DEV)
    x_run = torch.from_numpy(test.x[CLS_CAL_ROWS:]).to(DEV)
    y_run = test.y[CLS_CAL_ROWS:]
    t0 = time.perf_counter()
    seen.clear()
    tau = cascade.calibrate_tau(x_cal, deferral_ratio=CLS_DEFERRAL)
    _, cal_conf, _ = deferral_entropy_plain(seen[0])
    tau_err = abs(tau - float(np.quantile(
        cal_conf.cpu().numpy().astype(np.float64), CLS_DEFERRAL)))
    seen.clear()
    res = cascade.predict_sparse(x_run)
    torch.cuda.synchronize()
    cascade_s = time.perf_counter() - t0
    errs.append(hold("predict_sparse M_S", seen[0], res.confidence,
                     res.small_predictions))
    n_def = int(res.deferred.sum())
    if n_def:
        errs.append(hold("predict_sparse M_L", seen[1],
                         deferral_entropy_plain(seen[1])[1].cpu().numpy(),
                         res.large_predictions))
    if tau_err > SIGNAL_ATOL or len(seen) != 1 + (n_def > 0):
        raise AssertionError(f"calibrate_tau: tau off by {tau_err}; "
                             f"{len(seen)} logits in predict_sparse")
    acc_joint = float((res.predictions == y_run).mean())
    acc_small = float((res.small_predictions == y_run).mean())
    print(f"[cls] cascade (max_softmax, untuned M_S): calibrate_tau on "
          f"{CLS_CAL_ROWS} rows at deferral {CLS_DEFERRAL} -> tau "
          f"{tau:.5f}, predict_sparse on {len(y_run)} rows: {cascade_s:.3f} "
          f"s; joint accuracy {acc_joint:.4f} against M_S {acc_small:.4f}, "
          f"deferral {res.deferral_ratio:.4f} ({n_def} rows to M_L), cost "
          f"{res.compute_cost:.4f}")
    got = read_counts()
    want = dict.fromkeys(KERNELS, 0)
    want["deferral_entropy"] = n_eval + 1 + 1 + (n_def > 0)
    print(f"[cls] launches {got['deferral_entropy']} deferral_entropy "
          f"(expected {want['deferral_entropy']}: {n_eval} evaluation "
          f"batches, 1 calibration, {1 + (n_def > 0)} predict_sparse); "
          f"kernel vs plain max|d max_prob| {max(errs):.3g} (atol "
          f"{SIGNAL_ATOL}), argmax equal on every row, tau off by "
          f"{tau_err:.3g} on {smi}")
    if got != want:
        raise AssertionError(f"classifier cascade: launches {got} != {want}")
    # the claims with wide margins in tests/test_system.py's run
    if not (base["acc_large"] > base["acc_small"] + 0.1
            and gk["s_o"] < base["s_o"] and acc_joint > acc_small
            and res.compute_cost < 1.0):
        raise AssertionError("classifier cascade: the headline's claims "
                             "do not hold")
    return got


def decoder_ladder(torch, tfm, serve, arch: str):
    """Phase 15's two tiers for `arch` at its published widths, cut as
    DECODER_TIERS says: (M_S, M_L)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ModelRunner
    cfg = get_config(arch)
    small_layers, large_kw = DECODER_TIERS[arch]
    small_cfg = cfg if small_layers is None else cfg.replace(
        n_layers=small_layers)
    if large_kw is None:
        return tuple(serve.ladder_from_config(small_cfg, SEED, DEV))
    small = serve.tier_runner(small_cfg, SEED, 0, DEV)
    lcfg = cfg.replace(name=cfg.name + "-large", **large_kw)
    return small, ModelRunner(lcfg, tfm.init_params(
        lcfg, serve._tier_seed(SEED, 1), DEV))


def decoder_phase(torch, tfm, serve, rng, smi, t_start: float) -> dict:
    """Phase 15: qwen1.5-4b, qwen1.5-32b, llama3-405b and kimi-k2-1t-a32b
    at their published widths, one after another, each freed before the
    next: the ladder and its cuts, one decode step and one paged prefill
    kernel path against plain path, a profiled decode step, then the main
    path with the launches counted exactly. Each arch's peak must leave
    DECODER_FREE_GIB of the card. Returns {arch: launches}."""
    total = torch.cuda.get_device_properties(0).total_memory
    counts = {}
    t_phase = time.perf_counter()
    for arch in DECODER_ARCHS:
        phase(f"15 {arch}", t_start)
        t_arch = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        small, large = decoder_ladder(torch, tfm, serve, arch)
        torch.cuda.synchronize()
        describe_ladder(torch, small, large, time.perf_counter() - t_arch)
        print(f"[decoders] {arch}: {DECODER_CUTS[arch]}")
        guard = DECODER_LOGIT_GUARD[arch]
        check_one_step(torch, tfm, small, rng, guard)
        check_prefill_paths(torch, tfm, small, guard)
        report_profile(torch, tfm, small, rng, smi)
        torch.cuda.synchronize()
        checks_peak = torch.cuda.max_memory_allocated()
        L = small.cfg.n_layers
        counts[arch] = serve_main_path(
            torch, small, large,
            {"paged_flash_decode_gqa": L, "paged_write_token": L}, smi)[0]
        peak = max(checks_peak, torch.cuda.max_memory_allocated())
        print(f"[decoders] {arch}: {time.perf_counter() - t_arch:.1f} s, "
              f"peak {peak / 2**30:.2f} GiB of the card's "
              f"{total / 2**30:.2f} GiB (checks {checks_peak / 2**30:.2f}, "
              f"then the main path) on {smi}")
        if total - peak < DECODER_FREE_GIB * 2**30:
            raise AssertionError(f"{arch}: peak {peak / 2**30:.2f} GiB "
                                 f"leaves under {DECODER_FREE_GIB} GiB free")
        del small, large
        torch.cuda.empty_cache()
    print(f"[decoders] phase 15: {time.perf_counter() - t_phase:.1f} s "
          f"for {len(DECODER_ARCHS)} archs")
    return counts


def reduced_fixtures(torch, serve, archs) -> None:
    """Phase 5: `reduced_fixture` for each of `archs`, then
    `launch.serve.main()` with defaults and with --arch for each but the
    default."""
    from repro_torch.serving.request import DONE
    for arch in archs:
        reduced_fixture(torch, serve, arch)
    for argv in [[]] + [["--arch", a] for a in archs if a != ARCH]:
        res = serve.main(argv)
        if not all(r.state == DONE for r in res.requests):
            raise AssertionError(f"serve.main({argv}) left requests "
                                 f"unfinished")


def reduced_fixture(torch, serve, arch) -> None:
    """Reduced fp32 `arch` on the paged engine (the slot engine for an
    RWKV6 or Mamba2 model, whose recurrent state does not page), every
    kernel of the
    path switched together by the engine's `paged_kernel` (which reaches
    the runners' generate: calibration and M_L), at a tau between the
    plain path's 4th and 5th of 8 confidences: identical deferral masks
    and greedy tokens per request. A request whose confidence lies within
    CONF_NEAR_TAU of tau is reported and held to neither."""
    import numpy as np
    from repro_torch.data.synthetic import make_ragged_lm_stream
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig,
                                     make_requests)
    small, large = serve.build_ladder(arch, SEED, 2, device=DEV)
    prompts = make_ragged_lm_stream([SEED, 3], 8, 4, 24,
                                    small.cfg.vocab_size)
    backend = "slot" if small.cfg.recurrent else "paged"
    runs, counts = {}, {}

    def run(kernel: bool, tau: float):
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large, tau=tau),
            EngineConfig(n_slots=3, early_exit=False, backend=backend,
                         paged=PagedConfig(block_size=4, prefill_chunk=4,
                                           paged_kernel=kernel)))
        reset_counts()
        res = eng.run(make_requests(prompts, 6), 6)
        torch.cuda.synchronize()
        return res, read_counts()
    conf = np.sort(run(False, -1e9)[0].confidence)
    tau = float(0.5 * (conf[3] + conf[4]))
    for kernel in (False, True):
        runs[kernel], counts[kernel] = run(kernel, tau)
    # prompts of 4-24 tokens: every prefill below wkv_scan's chunked path
    used = ["deferral_entropy"] + (["wkv_scan"] if backend == "slot" else [])
    used += ["flash_attention"] if small.cfg.family == "hybrid" else []
    if any(counts[False].values()) or not all(counts[True][k] for k in used):
        raise AssertionError(f"reduced {arch}: kernel switch leaked: "
                             f"{counts}")
    k_run, p_run = runs[True], runs[False]
    near = np.abs(p_run.confidence - tau) <= CONF_NEAR_TAU
    held = ~near
    if not np.array_equal(k_run.deferred[held], p_run.deferred[held]):
        raise AssertionError(f"reduced {arch}: deferral masks differ: "
                             f"{k_run.deferred} vs {p_run.deferred}")
    for a, b, h in zip(k_run.requests, p_run.requests, held):
        if h and not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"reduced {arch} rid {a.rid}: kernel "
                                 f"tokens {a.tokens} != plain {b.tokens}")
    conf_err = float(np.abs(k_run.confidence - p_run.confidence).max())
    mask = p_run.deferred.astype(int).tolist()
    print(f"[reduced] {small.cfg.name} fp32 fixture ({backend} backend), "
          f"every kernel vs plain path at tau {tau:.5f}: deferral masks {mask} (equal), "
          f"identical greedy tokens for "
          f"{int(held.sum())} of {len(prompts)} requests ({int(near.sum())} "
          f"within {CONF_NEAR_TAU} of tau, reported), max|dconf| "
          f"{conf_err:.3g}; kernel-path launches {counts[True]}")


def slot_prefill(torch, tfm, params, cfg, toks, paged_kernel: bool):
    """Prefill `toks` into a fresh slot cache (fp32 recurrent state, the
    rest in the compute type). Returns (last-position logits [B, V],
    cache)."""
    cache = tfm.init_cache(cfg, toks.shape[0], toks.shape[1] + 1, device=DEV)
    logits, cache = tfm.prefill(params, cfg, toks, cache, last_only=True,
                                paged_kernel=paged_kernel)
    return logits[:, -1], cache


def check_slot_paths(torch, tfm, small, tag: str, guard) -> None:
    """One full-width prefill of N_SLOTS prompts of RWKV_PROMPT tokens and
    one decode step from the prefilled state, the kernels (`wkv_scan`, and
    the hybrid's shared-block `flash_attention`) against the plain
    recurrence and attention, by logits: with fp32 activations (isolates
    the kernels) and with the config's own types, where a bf16 residual
    stream (RWKV6's layer 0, every layer of the hybrid) can flip a bf16
    rounding on a last-bit difference, which the layers after it carry
    (`guard`: one bound, or one for "prefill" and one for "decode
    step")."""
    import numpy as np
    cfg = small.cfg
    toks = torch.from_numpy(np.random.default_rng(SEED + 21).integers(
        0, cfg.vocab_size, (N_SLOTS, RWKV_PROMPT))).to(DEV)
    for label, pcfg, tol_of in (
            ("fp32 activations", cfg.replace(compute_dtype="float32"),
             STEP_LOGIT_ATOL),
            (f"{cfg.compute_dtype} activations", cfg, guard)):
        pre, caches = {}, {}
        for kernel in (True, False):
            pre[kernel], caches[kernel] = slot_prefill(
                torch, tfm, small.params, pcfg, toks, kernel)
        tok = pre[True].argmax(-1)
        step = {}
        for kernel in (True, False):
            c = {kind: {k: v.clone() for k, v in leaves.items()}
                 for kind, leaves in caches[True].items()}
            step[kernel], _ = tfm.decode_step(small.params, pcfg, tok,
                                              RWKV_PROMPT, c,
                                              paged_kernel=kernel)
        torch.cuda.synchronize()
        for what, out in (("prefill", pre), ("decode step", step)):
            tol = tol_of[what] if isinstance(tol_of, dict) else tol_of
            err = float((out[True] - out[False]).abs().max())
            agree = float((out[True].argmax(-1) == out[False].argmax(-1))
                          .float().mean())
            print(f"[{tag}] full-width {what} ({N_SLOTS} x {RWKV_PROMPT} "
                  f"prompt), kernels vs plain path, {label}: "
                  f"max|dlogit| {err:.4g} (atol {tol}; logit std "
                  f"{float(out[False].std()):.3g}), argmax agreement "
                  f"{agree:.3f}")
            if not (torch.isfinite(out[True]).all() and err <= tol
                    and out[True].shape == (N_SLOTS, cfg.vocab_size)):
                raise AssertionError(f"{tag} {what} ({label}): logits differ "
                                     f"by {err} > {tol}")
        kind = "rwkv" if "rwkv" in caches[True] else "mamba"
        s_err = float((caches[True][kind]["S"]
                       - caches[False][kind]["S"]).abs().max())
        print(f"[{tag}] prefilled state S ({label}): max|dS| {s_err:.3g}")
        del pre, caches, step


def profile_slot_decode(torch, tfm, small, smi, tag: str,
                        steps: int = 3) -> None:
    """Main-path decode steps of M_S (the kernels on, each with its
    deferral signal) on the host clock and under torch.profiler."""
    import numpy as np
    from repro_torch.kernels import ops as kernel_ops
    cfg = small.cfg
    toks = torch.from_numpy(np.random.default_rng(SEED + 22).integers(
        0, cfg.vocab_size, (N_SLOTS, RWKV_PROMPT))).to(DEV)
    logits, cache = slot_prefill(torch, tfm, small.params, cfg, toks, True)
    tok = logits.argmax(-1)

    def run():
        for i in range(steps):
            step_logits, _ = tfm.decode_step(small.params, cfg, tok,
                                             RWKV_PROMPT + i, cache,
                                             paged_kernel=True)
            kernel_ops.deferral_signal(step_logits)
        torch.cuda.synchronize()
    wall_ms, busy_ms, ranked = profile_steps(torch, run, steps)
    busy = ("not measured (profiler saw no device time)" if busy_ms is None
            else f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}, "
                 f"idle {1 - busy_ms / wall_ms:.1%})")
    print(f"[{tag}] full-width {cfg.name} decode step ({N_SLOTS} rows, "
          f"{cfg.n_layers} layers, kernels on, with its deferral signal): "
          f"host wall {wall_ms:.3f} ms, {busy} on {smi}")
    ours = r"wkv_(decode_)?kernel|de_(partial|merge|signal)_kernel"
    for name, ms in ranked[:6] + [(n, ms) for n, ms in ranked[6:]
                                  if re.search(ours, n)]:
        print(f"[{tag}]   {ms:.4f} ms/step  {name[:90]}")


def serve_slot_main_path(torch, tfm, small, large, smi, tag: str) -> dict:
    """Calibrate and run the cascade on the slot backend with the kernels
    on; every kernel's counter is set to 0 just before and read just
    after. `wkv_scan` runs once per recurrent layer of every prefill and
    decode step: n_layers per M_S seeding prefill group and decode step
    and per step of the calibration's M_S generate, M_L's n_layers per
    step of each M_L generate; every prompt is at least CHUNKED_MIN_T
    long, so each prefill takes the chunked path. `flash_attention` runs
    once per shared-block call of every prefill (the hybrid's; decode
    stays plain) and `deferral_entropy` once per step of either model.
    Returns the counts."""
    import numpy as np
    from repro_torch.data.synthetic import (make_lm_stream,
                                            make_ragged_lm_stream)
    from repro_torch.kernels.wkv_scan import CHUNKED_MIN_T
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig,
                                     make_requests)
    from repro_torch.serving.request import DONE
    cfg = small.cfg
    engine = ContinuousCascadeEngine(
        CascadeSpec.two_tier(small, large),
        EngineConfig(n_slots=N_SLOTS, backend="slot",
                     paged=PagedConfig(paged_kernel=True)))
    cal_len = sum(RAGGED) // 2
    assert RAGGED[0] >= CHUNKED_MIN_T
    cal = make_lm_stream([SEED, 1], N_REQUESTS, cal_len, cfg.vocab_size)
    live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                 cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tau = engine.calibrate(cal, cal_len, MAX_NEW, DEFERRAL)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    res = engine.run(make_requests(live, MAX_NEW), MAX_NEW)
    torch.cuda.synchronize()
    launches = read_counts()
    st = res.stats
    seeds, n_ml = st["prefill_seed_dispatches"], st["ml_batches"]
    print(f"[{tag}] calibrated tau {tau:.4f} for deferral {DEFERRAL} in "
          f"{t_cal:.2f} s; served {N_REQUESTS} requests (prompts "
          f"{RAGGED[0]}-{RAGGED[1]} tokens, max_new {MAX_NEW}) on "
          f"{N_SLOTS} slots (slot backend) in {st['makespan_s']:.3f} s: "
          f"{st['throughput_tok_s']:.1f} tok/s, M_S "
          f"{st['small_tok_s']:.1f} tok/s, deferral_ratio "
          f"{res.deferral_ratio:.3f}, early exits "
          f"{int(res.early_exited.sum())}, {res.steps} decode steps, "
          f"{seeds} prefill groups, {n_ml} M_L batches, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    print(f"[{tag}] phases (host wall s): " + ", ".join(
        f"{k[6:-2]} {v:.3f}" for k, v in st.items()
        if k.startswith("phase_")))
    if not all(r.state == DONE for r in res.requests):
        raise AssertionError(f"{tag}: not every request finished")
    if res.tokens.shape != (N_REQUESTS, MAX_NEW) or not np.isfinite(
            res.confidence).all():
        raise AssertionError(f"{tag}: malformed serving result")
    L, LL = cfg.n_layers, large.cfg.n_layers
    A, AL = tfm.shared_attn_calls(cfg), tfm.shared_attn_calls(large.cfg)
    want = dict.fromkeys(KERNELS, 0)
    # a generate call prefills once (its prompt: chunked) and decodes
    # max_new - 1 steps (T = 1); the engine prefills each group and
    # decodes its steps
    want["wkv_scan_chunked"] = L * (1 + seeds) + LL * n_ml
    want["wkv_scan"] = (L * (MAX_NEW - 1 + res.steps)
                        + LL * (MAX_NEW - 1) * n_ml)
    want["deferral_entropy"] = MAX_NEW + res.steps + seeds + MAX_NEW * n_ml
    want["flash_attention"] = A * (1 + seeds) + AL * n_ml
    print(f"[{tag}] kernel launches {launches}, expected {want} "
          f"(wkv_scan_chunked {L} x (1 calibration prefill + {seeds} "
          f"prefill groups) + {LL} x {n_ml} M_L prefills; wkv_scan {L} x "
          f"({MAX_NEW - 1} calibration steps + {res.steps} steps) + {LL} x "
          f"{MAX_NEW - 1} x {n_ml} M_L steps; flash_attention {A} x (1 + "
          f"{seeds}) + {AL} x {n_ml} shared-block calls; deferral_entropy "
          f"once per each of those steps and groups)")
    if launches != want or res.steps == 0:
        raise AssertionError(f"{tag} launch counts {launches} != {want}")
    return launches


def loss_case(torch, x_dtype, V: int, d: int, seed: int, T: int = LOSS_T):
    """Stage-2 loss inputs at a main path's shapes: x [T, d] of unit scale
    (the final rms-norm's output), table [V, d] fp32 of std 1/sqrt(d)
    like the init, targets at the argmax for half the rows."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((T, d), generator=g, device=DEV).to(x_dtype)
    table = torch.randn((V, d), generator=g, device=DEV) / math.sqrt(d)
    logits = x.float() @ table.t()
    top2 = torch.topk(logits, 2, dim=-1).values
    tgt = torch.randint(0, V, (T,), generator=g, device=DEV,
                        dtype=torch.int32)
    hit = torch.rand(T, generator=g, device=DEV) < 0.5
    tgt = torch.where(hit, logits.argmax(-1).int(), tgt).contiguous()
    return x, table, tgt, top2[:, 0] - top2[:, 1]


def check_loss_kernel(torch, gk, smi, V: int, d: int, T: int = LOSS_T,
                      rows: int = 1, invalid: int = 0,
                      label: str = "internlm2-1.8b",
                      parent_cases=None) -> dict:
    """gatekeeper_loss_tokens against its plain version (bf16 x and all
    fp32) at T tokens, twice and bit-equal, and with bf16 x bit-equal to
    the same x widened to fp32 (its two TF32 products are the three-
    product sum); times kernel, plain version and the fp32 cuBLAS GEMM of
    the logits alone, beside the bound at the kernel's TF32 rate (two
    products for bf16 x, three for fp32) and the SIMT-rate one. With
    `invalid` > 0 the T tokens are `rows` sequences whose first `invalid`
    positions leave the loss (the VLM's patches), and
    `gatekeeper_loss_fused`'s masked loss and terms are also held against
    the plain reduction. `parent_cases` (a parent tree's record's "cases")
    puts each case's parent time beside its own. Returns the bf16-x case's
    record (the main path's types) with every case under "cases"."""
    rec = None
    cases = {}
    valid = torch.ones(T, device=DEV)
    valid.view(rows, T // rows)[:, :invalid] = 0.0
    for name, x_dtype, rate in (
            ("x bf16, table fp32", torch.bfloat16, H100_TF32X2_FLOPS),
            ("all fp32", torch.float32, H100_TF32X3_FLOPS)):
        x, table, tgt, gap = loss_case(torch, x_dtype, V, d, SEED + 7, T)
        got = gk.gatekeeper_loss_tokens(x, table, tgt)
        again = gk.gatekeeper_loss_tokens(x, table, tgt)
        widened = (gk.gatekeeper_loss_tokens(x.float(), table, tgt)
                   if x_dtype == torch.bfloat16 else got)
        want = gk.gatekeeper_loss_tokens_plain(x, table, tgt)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for i, (a, b) in enumerate(zip(got, want)) if i != 2)
        clear = gap > TIE_GAP
        flips = int((got[2] != want[2]).sum())
        clear_flips = int((got[2][clear] != want[2][clear]).sum())
        ok = all(bool(torch.isfinite(t).all()) for t in got)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        same_wide = all(torch.equal(a, b) for a, b in zip(got, widened))
        print(f"[train] gatekeeper_loss_tokens {label} {name}, T {T} d {d} "
              f"V {V}: max|err| ce/kl/entropy {err:.3g} (atol {LOSS_ATOL}); "
              f"correct differs on {flips} rows, {clear_flips} of them with "
              f"a top-2 gap > {TIE_GAP} ({int((~clear).sum())} rows under "
              f"it); frac correct {float(want[2].mean()):.3f}; two calls "
              f"bit-equal {same}"
              + (f", bit-equal to x widened to fp32 {same_wide}"
                 if x_dtype == torch.bfloat16 else ""))
        if not (ok and err <= LOSS_ATOL and clear_flips == 0 and same
                and same_wide):
            raise AssertionError(f"gatekeeper_loss_tokens ({name}): err "
                                 f"{err}, {clear_flips} flips on clear "
                                 f"rows, bit-equal {same} / {same_wide}")
        if invalid:
            loss_k, aux = gk.gatekeeper_loss_fused(x, table, tgt, valid,
                                                   alpha=0.3)
            ce, kl, corr, _ = want
            denom = valid.sum()
            terms = {"l_corr": (ce * corr * valid).sum() / denom,
                     "l_incorr": (kl * (1 - corr) * valid).sum() / denom}
            terms["loss"] = 0.3 * terms["l_corr"] + 0.7 * terms["l_incorr"]
            got_terms = {"loss": loss_k, "l_corr": aux["l_corr"],
                         "l_incorr": aux["l_incorr"]}
            t_err = max(abs(float(got_terms[k]) - float(v))
                        for k, v in terms.items())
            print(f"[train] gatekeeper_loss_fused {label} {name}: "
                  f"{int(denom)} of {T} tokens valid (the first {invalid} "
                  f"of each of {rows} rows masked): max|d| loss / l_corr / "
                  f"l_incorr {t_err:.3g} (atol {LOSS_ATOL})")
            if not t_err <= LOSS_ATOL:
                raise AssertionError(f"masked loss ({label}, {name}): "
                                     f"{t_err}")
        del got, again, widened, want
        ms = time_ms(lambda: gk.gatekeeper_loss_tokens(x, table, tgt),
                     iters=5, warmup=1)
        plain_ms = time_ms(lambda: gk.gatekeeper_loss_tokens_plain(
            x, table, tgt), iters=5, warmup=1)
        x32 = x.float()
        # yardstick only, never called by the port: cuBLAS's fp32 GEMM
        # of the logits, which computes none of the reductions
        lib_ms = time_ms(lambda: x32 @ table.t(), iters=5, warmup=1)
        del x32
        n_bytes = (x.numel() * x.element_size() + table.numel() * 4
                   + tgt.numel() * 4 + 4 * T * 4)
        flops = 2 * T * V * d
        bound_ms, bound_by = bound(n_bytes, flops, rate)
        simt_ms, simt_by = bound(n_bytes, flops)
        n_prod = 2 if x_dtype == torch.bfloat16 else 3
        need = ""
        if invalid:
            n_valid = int(valid.sum())
            rows_bytes = (n_valid * d * x.element_size() + table.numel() * 4
                          + 4 * n_valid * 5)
            need = (f"; the loss reads {n_valid} of these rows, a bound of "
                    f"{bound(rows_bytes, flops * n_valid / T, rate)[0]:.4f}"
                    f" ms for them alone")
        key = f"{label} {name}"
        p_ms = (parent_cases or {}).get(key, {}).get("ms")
        versus = ""
        if parent_cases is not None:
            versus = (f"; parent {p_ms:.3f} ms ({ms / p_ms:.3f}x)" if p_ms
                      else "; parent not measured")
        print(f"[kernel] gatekeeper_loss_tokens {key}: kernel {ms:.3f} ms"
              f"{versus}, plain {plain_ms:.3f} ms, cuBLAS fp32 logits GEMM "
              f"{lib_ms:.3f} ms ({ms / lib_ms:.3f}x), bound {bound_ms:.4f} "
              f"ms ({bound_by}: {n_bytes} B, {flops} fp32 flop as "
              f"{n_prod} TF32 products at {rate / 1e12:.1f} TFLOP/s), "
              f"SIMT-rate bound {simt_ms:.4f} ms ({simt_by}){need} on {smi}")
        cases[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          bound_simt_ms=simt_ms, max_abs_err=err,
                          shape=[T, d, V])
        if parent_cases is not None:
            cases[key]["parent_ms"] = p_ms
        if rec is None:                     # the main path's types
            rec = dict(name="gatekeeper_loss_tokens", route="cuda",
                       source="src/repro_torch/kernels/csrc/gatekeeper_loss.cu",
                       replaces="src/repro/kernels/gatekeeper_loss.py:99",
                       **cases[key])
        del x, table, tgt
        torch.cuda.empty_cache()
    rec["cases"] = cases
    return rec


def check_stage2_vlm_loss(torch, gk, smi, parent_cases=None) -> dict:
    """phi-3-vision-4.2b's Stage-2 loss as `launch.steps` computes it:
    `fused_gatekeeper_loss` over 8 x (576 + 3) positions (d 3072, vocab
    32064, bf16 x, fp32 table) with the 576 patch positions of each row
    masked, forward and backward (one kernel launch), against autograd
    through the plain version over every row (the loss within LOSS_ATOL,
    dx and dtable within check_loss_gradients' tolerances); then the
    forward + backward timed (each call with its host read of the valid
    count), beside `parent_cases`' time where given, and split by kernel
    under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.launch import steps
    c = get_config(VLM_ARCH)
    P = c.vision.n_patches
    B, S = N_SLOTS, P + 3
    x, table, tgt, _ = loss_case(torch, torch.bfloat16, c.vocab_size,
                                 c.d_model, SEED + 9, B * S)
    mask = torch.ones((B, S), device=DEV)
    mask[:, :P] = 0.0
    alpha = 0.3
    gkc = GatekeeperConfig(alpha=alpha)
    xk = x.clone().requires_grad_(True)
    tk = table.clone().requires_grad_(True)

    def fwd_bwd():
        xk.grad = tk.grad = None
        loss, _ = steps.fused_gatekeeper_loss(
            xk.view(B, S, -1), tk, tgt.view(B, S), gkc, mask)
        loss.backward()
        return loss
    n = gk.gatekeeper_loss_tokens.launches
    loss_k = fwd_bwd().detach()
    torch.cuda.synchronize()
    launched = gk.gatekeeper_loss_tokens.launches - n
    grads_k = (xk.grad.float(), tk.grad.clone())
    xp = x.clone().requires_grad_(True)
    tp = table.clone().requires_grad_(True)
    ce, kl, corr, _ = gk.gatekeeper_loss_tokens_plain(xp, tp, tgt)
    valid = mask.view(-1)
    corr = corr.detach()
    loss_p = (alpha * (ce * corr * valid).sum()
              + (1 - alpha) * (kl * (1 - corr) * valid).sum()) / valid.sum()
    loss_p.backward()
    torch.cuda.synchronize()
    errs = []
    for name, gkk, gp, tol in (("dx", grads_k[0], xp.grad.float(),
                                DX_RTOL_OF_MAX),
                               ("dtable", grads_k[1], tp.grad,
                                DTABLE_RTOL_OF_MAX)):
        rel = float((gkk - gp).abs().max()) / float(gp.abs().max())
        errs.append((name, rel, tol))
    dloss = abs(float(loss_k) - float(loss_p.detach()))
    masked_dx = float(grads_k[0].view(B, S, -1)[:, :P].abs().max())
    del xp, tp, ce, kl, corr, loss_p, grads_k
    torch.cuda.empty_cache()
    ms = time_ms(fwd_bwd, iters=5, warmup=1)

    def run():
        for _ in range(5):
            fwd_bwd()
        torch.cuda.synchronize()
    wall_ms, busy_ms, ranked = profile_steps(torch, run, 5)
    key = f"{VLM_ARCH} stage-2 loss forward + backward"
    p_ms = (parent_cases or {}).get(key, {}).get("ms")
    versus = ""
    if parent_cases is not None:
        versus = (f"; parent {p_ms:.3f} ms ({ms / p_ms:.3f}x)" if p_ms
                  else "; parent not measured")
    print(f"[train] {key}, {B} x {S} positions ({int(valid.sum())} in the "
          f"loss), d {c.d_model}, V {c.vocab_size}: |dloss| {dloss:.3g} "
          f"(<= {LOSS_ATOL}), "
          + ", ".join(f"max|d{nm[1:]}| / max|{nm}| {r:.3g} (<= {t})"
                      for nm, r, t in errs)
          + f", max|dx| on the patch rows {masked_dx}; kernel launches "
          f"{launched}; {ms:.3f} ms a forward + backward{versus} on {smi}")
    busy = ("not measured (profiler saw no device time)" if busy_ms is None
            else f"device busy {busy_ms:.3f} ms")
    print(f"[train] {key}: host wall {wall_ms:.3f} ms a call, {busy}; by "
          f"kernel: " + ", ".join(f"{name[:60]} {t:.3f}"
                                  for name, t in ranked[:6]))
    if (launched != 1 or dloss > LOSS_ATOL or masked_dx != 0.0
            or any(r > t for _, r, t in errs)):
        raise AssertionError(f"{key}: {errs}, |dloss| {dloss}, patch-row dx "
                             f"{masked_dx}, {launched} launches")
    rec = dict(ms=ms, loss_rows=int(valid.sum()), rows=B * S,
               host_wall_ms=wall_ms, device_busy_ms=busy_ms)
    if parent_cases is not None:
        rec["parent_ms"] = p_ms
    del xk, tk, x, table
    torch.cuda.empty_cache()
    return {key: rec}


def check_loss_gradients(torch, gk, V: int, d: int) -> None:
    """dx (bf16) and dtable of `gatekeeper_loss_fused` against autograd
    through the plain version, at the main path's shapes; the backward
    launches no kernel."""
    x, table, tgt, _ = loss_case(torch, torch.bfloat16, V, d, SEED + 8)
    valid = (torch.arange(LOSS_T, device=DEV) % 5 != 0).float()
    alpha = 0.3
    xk, tk = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    n = gk.gatekeeper_loss_tokens.launches
    loss_k, _ = gk.gatekeeper_loss_fused(xk, tk, tgt, valid, alpha=alpha)
    loss_k.backward()
    torch.cuda.synchronize()
    launched = gk.gatekeeper_loss_tokens.launches - n
    grads_k = (xk.grad.float(), tk.grad)
    del xk, tk
    xp, tp = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
    ce, kl, corr, _ = gk.gatekeeper_loss_tokens_plain(xp, tp, tgt)
    corr = corr.detach()
    denom = valid.sum()
    loss_p = (alpha * (ce * corr * valid).sum()
              + (1 - alpha) * (kl * (1 - corr) * valid).sum()) / denom
    loss_p.backward()
    torch.cuda.synchronize()
    errs = []
    for name, gkk, gp, tol in (("dx", grads_k[0], xp.grad.float(),
                                DX_RTOL_OF_MAX),
                               ("dtable", grads_k[1], tp.grad,
                                DTABLE_RTOL_OF_MAX)):
        rel = float((gkk - gp).abs().max()) / float(gp.abs().max())
        errs.append((name, rel, tol))
    dloss = abs(float(loss_k.detach()) - float(loss_p.detach()))
    print(f"[train] gatekeeper_loss_fused gradients at T {LOSS_T} d {d} V "
          f"{V} (bf16 x, 1 in 5 tokens masked): |dloss| {dloss:.3g}, "
          + ", ".join(f"max|d{n[1:]}| / max|{n}| {r:.3g} (<= {t})"
                      for n, r, t in errs)
          + f"; kernel launches in forward+backward: {launched}")
    if launched != 1 or dloss > LOSS_ATOL or any(r > t for _, r, t in errs):
        raise AssertionError(f"fused loss gradients: {errs}, |dloss| "
                             f"{dloss}, {launched} launches")


def train_main_path(torch, gk, train, smi) -> int:
    """`launch.train.run` at full width with the loss kernel's counter
    set to 0 just before and read after every logged step. Returns the
    Stage-2 launch count."""
    args = train.build_parser().parse_args([
        "--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq-len",
        str(TRAIN_SEQ), "--task", "stream", "--stage1-steps",
        str(STAGE1_STEPS), "--stage2-steps", str(STAGE2_STEPS),
        "--log-every", "1", "--n-train", "256", "--seed", str(SEED),
        "--device", DEV])
    peaks, seen = {}, []

    def on_step(stage, rec):
        launches = gk.gatekeeper_loss_tokens.launches
        want = rec["step"] if stage == 2 else 0
        seen.append((stage, rec["step"], launches))
        if launches != want:
            raise AssertionError(f"stage {stage} step {rec['step']}: loss "
                                 f"kernel launched {launches} times, not "
                                 f"{want}")
        if rec["step"] == (STAGE1_STEPS if stage == 1 else STAGE2_STEPS):
            peaks[stage] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    gk.gatekeeper_loss_tokens.launches = 0
    params, hist = train.run(args, log_fn=on_step)
    torch.cuda.synchronize()
    launches = gk.gatekeeper_loss_tokens.launches
    for stage, log in hist.items():
        times = [r["time_s"] for r in log]
        steps = [b - a for a, b in zip([0.0] + times, times)]
        print(f"[train] stage {stage}: {len(log)} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens, step wall s "
              + ", ".join(f"{t:.3f}" for t in steps)
              + f"; peak device memory {peaks[stage]:.2f} GiB on {smi}")
        for r in log:
            if not all(math.isfinite(v) for v in r.values()):
                raise AssertionError(f"stage {stage}: non-finite {r}")
    last = hist[2][-1]
    print(f"[train] stage 2 last step: loss {last['loss']}, l_corr "
          f"{last['l_corr']}, l_incorr {last['l_incorr']}, frac_correct "
          f"{last['frac_correct']}, mean_entropy {last['mean_entropy']}, "
          f"grad_norm {last['grad_norm']}; loss kernel launches per step "
          f"{[n for st, _, n in seen if st == 2]} (cumulative)")
    if launches != STAGE2_STEPS:
        raise AssertionError(f"{launches} loss kernel launches, want "
                             f"{STAGE2_STEPS}")
    profile_train_step(torch, train, params, args, smi)
    return launches


def profile_train_step(torch, train, params, args, smi,
                       label: str = "full-width Stage-2 step") -> None:
    """One more full-width Stage-2 step on the trained parameters, timed
    on the host clock and under torch.profiler: device busy and idle
    share, and the kernels that take the step's device time."""
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.launch import steps
    from repro_torch.training import optim
    cfg = train.build_cfg(args)
    step = steps.make_train_step(cfg, GatekeeperConfig(alpha=args.alpha),
                                 optim.AdamWConfig())
    opt = optim.adamw_init(params)
    g = torch.Generator(device=DEV).manual_seed(SEED + 10)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, device=DEV)
             for k in ("tokens", "targets")}

    def run():
        step(params, opt, batch)
        torch.cuda.synchronize()
    wall_ms, busy_ms, ranked = profile_steps(torch, run, 1)
    busy = ("not measured (profiler saw no device time)" if busy_ms is None
            else f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}, "
                 f"idle {1 - busy_ms / wall_ms:.1%})")
    print(f"[train] {label} ({TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens): host wall {wall_ms:.1f} ms, {busy} on {smi}")
    for name, ms in ranked[:8]:
        print(f"[train]   {ms:.3f} ms/step  {name[:90]}")


def reduced_training_fixture(torch, train) -> None:
    """Reduced fp32 Stage-2 loss and gradients, kernel against chunked
    loss, for both architectures; then a reduced two-stage run whose
    Stage-2 checkpoint restores bit for bit."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import checkpoint, optim
    for arch in (ARCH, MLA_ARCH):
        cfg = reduced(get_config(arch))
        params = tfm.init_params(cfg, SEED, DEV)
        rng = np.random.default_rng(SEED + 9)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).to(DEV)
        with torch.no_grad():
            logits = tfm.forward(params, cfg, tok)
        top2 = torch.topk(logits, 2, dim=-1).values
        gap = float((top2[..., 0] - top2[..., 1]).min())
        tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).to(DEV)
        hit = torch.from_numpy(rng.random((4, 16)) < 0.5).to(DEV)
        tgt = torch.where(hit, logits.argmax(-1), tgt)
        batch = {"tokens": tok, "targets": tgt,
                 "loss_mask": (torch.arange(16, device=DEV) % 4 != 0)
                 .float().expand(4, 16)}
        out = {}
        for kernel in (True, False):
            fn = steps.make_loss_fn(cfg, GatekeeperConfig(alpha=0.3), 0.01,
                                    loss_kernel=kernel)
            out[kernel] = optim.value_and_grad(fn, params, batch)
        (lk, ak), gk_ = out[True]
        (lp, ap), gp = out[False]
        aux_err = max(abs(float(ak[k]) - float(ap[k])) for k in ap)
        grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                         1e-30)
                       for a, b in zip(optim.tree_leaves(gk_),
                                       optim.tree_leaves(gp)))
        print(f"[reduced] {cfg.name} Stage-2 loss, kernel vs chunked: "
              f"|dloss| {abs(float(lk) - float(lp)):.3g}, max|daux| "
              f"{aux_err:.3g} (atol 1e-5), max leaf |dgrad|/max|grad| "
              f"{grad_err:.3g} (<= {REDUCED_GRAD_RTOL_OF_MAX}); min top-2 "
              f"gap {gap:.3g}; frac_correct {float(ap['frac_correct']):.3f}")
        if not (abs(float(lk) - float(lp)) <= 1e-5 and aux_err <= 1e-5
                and grad_err <= REDUCED_GRAD_RTOL_OF_MAX):
            raise AssertionError(f"reduced {arch}: kernel loss differs")
    with tempfile.TemporaryDirectory() as tmp:
        args = train.build_parser().parse_args([
            "--reduced", "--stage1-steps", "3", "--stage2-steps", "3",
            "--n-train", "64", "--seq-len", "16", "--batch", "8",
            "--log-every", "3", "--ckpt", tmp, "--device", DEV])
        params, _ = train.run(args)
        back = checkpoint.restore_checkpoint(f"{tmp}/stage2", params)
        same = all(torch.equal(a, b) for a, b in zip(
            optim.tree_leaves(back), optim.tree_leaves(params)))
        print(f"[reduced] {args.arch} two-stage run with --ckpt: Stage-2 "
              f"checkpoint restores bit for bit: {same}")
        if not same or checkpoint.checkpoint_step(f"{tmp}/stage2") != 3:
            raise AssertionError("checkpoint round trip differs")


def steps_inputs(torch, cfg):
    """Phase 12's inputs at `cfg`'s widths: (batch, prompt positions,
    caption data or None). whisper-small: stub frames [8, n_frames, d]
    drawn from the seed (the JAX frontend is a stub too) and an
    ENC_PROMPT-token decoder prompt; phi-3-vision: 8 `make_captions` rows
    (their patches [8, n_patches, d]) and BOS."""
    import numpy as np
    from repro_torch.data.synthetic import BOS, make_captions
    if cfg.family == "encdec":
        g = torch.Generator(device=DEV).manual_seed(SEED + 40)
        frames = torch.randn((N_SLOTS, cfg.encoder.n_frames, cfg.d_model),
                             generator=g, device=DEV)
        toks = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
            0, cfg.vocab_size, (N_SLOTS, ENC_PROMPT))).to(DEV)
        return {"frames": frames, "tokens": toks}, ENC_PROMPT, None
    data = make_captions(SEED + 42, N_SLOTS, n_patches=cfg.vision.n_patches,
                         d_model=cfg.d_model)
    toks = torch.full((N_SLOTS, 1), BOS, dtype=torch.long, device=DEV)
    return ({"patches": torch.from_numpy(data.patches).to(DEV),
             "tokens": toks}, cfg.vision.n_patches + 1, data)


def steps_cache(cfg, max_len: int):
    """A zeroed cache of N_SLOTS rows for `launch.steps` (the encoder-
    decoder's with its cross K/V), in the compute type."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    init = encdec.init_cache if cfg.family == "encdec" else tfm.init_cache
    return init(cfg, N_SLOTS, max_len, device=DEV)


def steps_greedy(torch, cfg, params, batch, P0: int, kernel: bool,
                 tau=None):
    """`make_prefill`, then GREEDY_STEPS greedy `make_serve_step` steps
    at positions P0, P0 + 1, ...; tau (None: the STEPS_TAU_QUANTILE
    quantile of the prefill confidences). Returns (tau, tokens [B, 1 + n],
    confidences [B, 1 + n], defer masks [B, n])."""
    from repro_torch.launch import steps
    cache = steps_cache(cfg, P0 + GREEDY_STEPS)
    tok, conf, cache = steps.make_prefill(cfg, paged_kernel=kernel)(
        params, cache, batch)
    if tau is None:
        tau = float(torch.quantile(conf, STEPS_TAU_QUANTILE))
    step = steps.make_serve_step(cfg, tau=tau, paged_kernel=kernel)
    toks, confs, defers = [tok], [conf], []
    for i in range(GREEDY_STEPS):
        tok, conf, defer, cache = step(params, cache, tok, P0 + i)
        toks.append(tok)
        confs.append(conf)
        defers.append(defer)
    torch.cuda.synchronize()
    return (tau, torch.stack(toks, 1), torch.stack(confs, 1),
            torch.stack(defers, 1))


def steps_logits(torch, cfg, params, batch, P0: int):
    """The prefill's last-position logits [B, V] through the kernel path
    and the plain path, and one decode step's from a copy of the kernel
    path's cache each, at the kernel path's greedy token: ({True, False}:
    prefill logits, {True, False}: step logits)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    pre, caches = {}, {}
    for kernel in (True, False):
        cache = steps_cache(cfg, P0 + 1)
        if cfg.family == "encdec":
            logits, caches[kernel] = encdec.prefill(
                params, cfg, batch["frames"], batch["tokens"], cache,
                last_only=True, paged_kernel=kernel)
        else:
            logits, caches[kernel] = tfm.prefill(
                params, cfg, batch["tokens"], cache, last_only=True,
                paged_kernel=kernel, extra_embeds=batch.get("patches"))
        pre[kernel] = logits[:, -1]
    tok = pre[True].argmax(-1)
    mod = encdec if cfg.family == "encdec" else tfm
    step = {}
    for kernel in (True, False):
        c = {kind: {k: v.clone() for k, v in leaves.items()}
             for kind, leaves in caches[True].items()}
        step[kernel], _ = mod.decode_step(params, cfg, tok, P0, c,
                                          paged_kernel=kernel)
    torch.cuda.synchronize()
    return pre, step


def check_steps_paths(torch, cfg, params, batch, P0: int, tag: str) -> None:
    """Kernel path against plain path (`paged_kernel=False`), with fp32
    activations (isolates the kernels; held at STEP_LOGIT_ATOL) and with
    the config's bf16 (held under STEPS_LOGIT_GUARD): the prefill's and
    the first decode step's logits, with argmax agreement; then the
    greedy make_prefill + make_serve_step runs of both paths at the plain
    path's tau: tokens and defer masks, equal in fp32 (a request within
    CONF_NEAR_TAU of tau at a step may defer on one path only) and
    reported in bf16."""
    for label, pcfg, tol, held in (
            ("fp32 activations", cfg.replace(compute_dtype="float32"),
             STEP_LOGIT_ATOL, True),
            (f"{cfg.compute_dtype} activations", cfg, STEPS_LOGIT_GUARD,
             False)):
        pre, step = steps_logits(torch, pcfg, params, batch, P0)
        for what, out in (("prefill", pre), ("first decode step", step)):
            err = float((out[True] - out[False]).abs().max())
            agree = float((out[True].argmax(-1) == out[False].argmax(-1))
                          .float().mean())
            print(f"[{tag}] full-width {what}, kernels vs plain path, "
                  f"{label}: max|dlogit| {err:.4g} (atol {tol}; logit std "
                  f"{float(out[False].std()):.3g}), argmax agreement "
                  f"{agree:.3f}")
            if not (torch.isfinite(out[True]).all() and err <= tol
                    and out[True].shape == (N_SLOTS, cfg.vocab_size)):
                raise AssertionError(f"{tag} {what} ({label}): logits differ "
                                     f"by {err} > {tol}")
        del pre, step
        tau, p_tok, p_conf, p_def = steps_greedy(torch, pcfg, params, batch,
                                                 P0, False)
        _, k_tok, k_conf, k_def = steps_greedy(torch, pcfg, params, batch,
                                               P0, True, tau)
        near = (p_conf[:, 1:] - tau).abs() <= CONF_NEAR_TAU
        same_tok = float((k_tok == p_tok).float().mean())
        same_def = bool(torch.equal(k_def[~near], p_def[~near]))
        conf_err = float((k_conf - p_conf).abs().max())
        print(f"[{tag}] greedy make_prefill + {GREEDY_STEPS} make_serve_step,"
              f" kernels vs plain path, {label}, tau {tau:.5f}: tokens equal "
              f"{same_tok:.3f}, defer masks equal {same_def} "
              f"({int(near.sum())} (row, step) within {CONF_NEAR_TAU} of tau,"
              f" not held), max|dconf| {conf_err:.3g}, deferral "
              f"{float(p_def.float().mean()):.3f}"
              + ("" if held else " (reported, not held)"))
        if held and not (same_tok == 1.0 and same_def):
            raise AssertionError(f"{tag} greedy steps ({label}): tokens "
                                 f"{same_tok}, masks {same_def}")


def steps_main_path(torch, cfg, params, batch, P0: int, data, smi,
                    tag: str) -> dict:
    """The main path: make_prefill and GREEDY_STEPS make_serve_step steps
    with the kernels on, every kernel's counter set to 0 just before and
    read just after: `flash_attention` once per attention layer of the
    prefill (whisper: the encoder's, the decoder's self- and cross-
    attention; phi-3-vision: its decoder's) and once per cross-attention
    layer of each step (none for the VLM, whose slot decode is plain),
    `deferral_entropy` once per prefill and per step, no other. Returns
    the counts."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tau, toks, confs, defers = steps_greedy(torch, cfg, params, batch, P0,
                                            True)
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = dict.fromkeys(KERNELS, 0)
    if cfg.family == "encdec":
        per_prefill = cfg.encoder.n_layers + 2 * cfg.n_layers
        per_step = cfg.n_layers
    else:
        per_prefill, per_step = cfg.n_layers, 0
    want["flash_attention"] = per_prefill + per_step * GREEDY_STEPS
    want["deferral_entropy"] = 1 + GREEDY_STEPS
    score = ""
    if data is not None:
        from repro_torch.data.synthetic import caption_factuality
        fact = caption_factuality(toks[:, :2].cpu().numpy(), data)
        score = (f", caption_factuality of the greedy captions (random "
                 f"weights, not held) {fact.mean():.3f}")
    print(f"[{tag}] main path: make_prefill of {N_SLOTS} x {P0} positions "
          f"and {GREEDY_STEPS} make_serve_step steps in {wall:.3f} s host "
          f"wall, tau {tau:.4f} (the {STEPS_TAU_QUANTILE} quantile of the "
          f"prefill confidences), deferral {float(defers.float().mean()):.3f}"
          f"{score}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    print(f"[{tag}] kernel launches {launches}, expected {want} "
          f"(flash_attention {per_prefill} per prefill + {per_step} x "
          f"{GREEDY_STEPS} steps; deferral_entropy 1 + {GREEDY_STEPS})")
    if toks.shape != (N_SLOTS, 1 + GREEDY_STEPS) or not (
            torch.isfinite(confs).all() and (toks >= 0).all()
            and (toks < cfg.vocab_size).all()):
        raise AssertionError(f"{tag}: malformed steps result")
    if launches != want:
        raise AssertionError(f"{tag} launch counts {launches} != {want}")
    return launches


def profile_serve_step(torch, cfg, params, batch, P0: int, smi,
                       tag: str) -> None:
    """One main-path make_serve_step step (kernels on, with its deferral
    signal) on the host clock and under torch.profiler."""
    from repro_torch.launch import steps
    cache = steps_cache(cfg, P0 + GREEDY_STEPS)
    tok, _, cache = steps.make_prefill(cfg, paged_kernel=True)(params, cache,
                                                               batch)
    step = steps.make_serve_step(cfg, paged_kernel=True)

    def run():
        step(params, cache, tok, P0)
        torch.cuda.synchronize()
    wall_ms, busy_ms, ranked = profile_steps(torch, run, 1)
    busy = ("not measured (profiler saw no device time)" if busy_ms is None
            else f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}, "
                 f"idle {1 - busy_ms / wall_ms:.1%})")
    print(f"[{tag}] full-width make_serve_step ({N_SLOTS} rows, "
          f"{cfg.n_layers} decoder layers, kernels on): host wall "
          f"{wall_ms:.3f} ms, {busy} on {smi}")
    ours = r"flash_fwd|de_(partial|merge|signal)_kernel"
    for name, ms in ranked[:6] + [(n, ms) for n, ms in ranked[6:]
                                  if re.search(ours, n)]:
        print(f"[{tag}]   {ms:.4f} ms/step  {name[:90]}")


def steps_train_step(torch, cfg, batch, smi, tag: str) -> int:
    """One Stage-2 `make_train_step` step at `cfg`'s widths (fp32 weights
    and AdamW moments, the config's bf16 activations; the kernel's
    forward, a plain backward), the loss kernel's counter set to 0 just
    before: exactly one launch. Returns it."""
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.kernels import gatekeeper_loss as gk
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optim
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(cfg, SEED + 3, DEV)
    opt = optim.adamw_init(params)
    n_params = sum(t.numel() for t in _leaves(params))
    step = steps.make_train_step(cfg, GatekeeperConfig(alpha=0.3),
                                 optim.AdamWConfig())
    gk.gatekeeper_loss_tokens.launches = 0
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = gk.gatekeeper_loss_tokens.launches
    m = {k: float(v) for k, v in m.items()}
    print(f"[{tag}] Stage-2 make_train_step, {cfg.n_layers} layers "
          f"({n_params / 1e9:.3f} B parameters), batch "
          + ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())
          + f": {wall:.3f} s host wall (first call), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss "
          f"{m['loss']:.5f}, l_corr {m['l_corr']:.5f}, l_incorr "
          f"{m['l_incorr']:.5f}, frac_correct {m['frac_correct']:.4f}, "
          f"grad_norm {m['grad_norm']:.5f}; loss kernel launches {n} on "
          f"{smi}")
    if n != 1 or not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"{tag} Stage-2 step: {n} loss kernel "
                             f"launches, metrics {m}")
    del params, opt
    return n


def steps_families(torch, smi) -> tuple:
    """Phase 12: whisper-small at all 12 + 12 layers (12a) and
    phi-3-vision-4.2b at all 32 layers for serving and VLM_TRAIN_LAYERS
    for its Stage-2 step (12b) through `launch.steps`, then the reduced
    fp32 configs, kernel against plain (12c). Returns ({arch: serving
    launch counts}, {arch: Stage-2 loss kernel launches})."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    serving, stage2 = {}, {}
    for sub, arch in (("12a", WHISPER_ARCH), ("12b", VLM_ARCH)):
        tag = arch.split("-")[0]
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = tfm.init_params(cfg, SEED, DEV)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        enc = (f" + {cfg.encoder.n_layers}-layer encoder over "
               f"{cfg.encoder.n_frames} frames" if cfg.encoder else
               f", {cfg.vision.n_patches} patches prepended")
        print(f"[{tag}] phase {sub}: {cfg.name} ({cfg.family}): "
              f"{cfg.n_layers} decoder layers{enc}, d_model {cfg.d_model} "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads hd {cfg.head_dim} d_ff "
              f"{cfg.d_ff} vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
              f"params; {cfg.param_dtype} weights, {cfg.compute_dtype} "
              f"activations/cache; init {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        batch, P0, data = steps_inputs(torch, cfg)
        with torch.inference_mode():
            check_steps_paths(torch, cfg, params, batch, P0, tag)
            profile_serve_step(torch, cfg, params, batch, P0, smi, tag)
            serving[arch] = steps_main_path(torch, cfg, params, batch, P0,
                                            data, smi, tag)
        del params
        torch.cuda.empty_cache()
        tcfg = cfg
        if cfg.family == "encdec":
            g = torch.Generator(device=DEV).manual_seed(SEED + 43)
            tbatch = {"frames": batch["frames"], "tokens": batch["tokens"],
                      "targets": torch.randint(
                          0, cfg.vocab_size, batch["tokens"].shape,
                          generator=g, device=DEV)}
        else:
            tcfg = cfg.replace(n_layers=VLM_TRAIN_LAYERS)
            tbatch = {"patches": batch["patches"],
                      "tokens": torch.from_numpy(data.inputs).to(DEV),
                      "targets": torch.from_numpy(data.targets).to(DEV)}
        stage2[arch] = steps_train_step(torch, tcfg, tbatch, smi, tag)
        del batch, tbatch
        torch.cuda.empty_cache()
    # -- 12c. the reduced fp32 configs: kernel path == plain path ----------
    from repro_torch.configs import reduced
    for arch in (WHISPER_ARCH, VLM_ARCH):
        cfg = reduced(get_config(arch))
        params = tfm.init_params(cfg, SEED, DEV)
        batch, P0, _ = steps_inputs(torch, cfg)
        with torch.inference_mode():
            reset_counts()
            tau, p_tok, p_conf, p_def = steps_greedy(torch, cfg, params,
                                                     batch, P0, False)
            plain_counts = read_counts()
            _, k_tok, k_conf, k_def = steps_greedy(torch, cfg, params, batch,
                                                   P0, True, tau)
            counts = read_counts()
        near = ((p_conf[:, 1:] - tau).abs() <= CONF_NEAR_TAU).cpu().numpy()
        masks_equal = np.array_equal(k_def.cpu().numpy()[~near],
                                     p_def.cpu().numpy()[~near])
        tokens_equal = bool(torch.equal(k_tok, p_tok))
        print(f"[reduced] {cfg.name} fp32 through launch.steps, kernels vs "
              f"plain path at tau {tau:.5f}: greedy tokens equal "
              f"{tokens_equal}, defer masks equal {masks_equal} "
              f"({int(near.sum())} (row, step) within {CONF_NEAR_TAU} of tau,"
              f" not held), max|dconf| "
              f"{float((k_conf - p_conf).abs().max()):.3g}; kernel-path "
              f"launches {counts}")
        used = ("flash_attention", "deferral_entropy")
        if (any(plain_counts.values()) or not all(counts[k] for k in used)
                or not (tokens_equal and masks_equal)):
            raise AssertionError(f"reduced {arch} through launch.steps: "
                                 f"tokens {tokens_equal}, masks "
                                 f"{masks_equal}, counts {plain_counts} / "
                                 f"{counts}")
        del params, batch
    return serving, stage2


def loss_phase(torch, gk, smi, parent=None) -> dict:
    """Phase 7a: the loss kernel at internlm2-1.8b's Stage-2 shape, phase
    12's (whisper-small's 8 x 16 decoder tokens, phi-3-vision's 8 x
    (576 + 3) positions with the patches masked) and phase 17's (rwkv6-3b's
    and zamba2-1.2b's 16 x 128 tokens at d 2560 / V 65536 and d 2048 / V
    32000), phi-3-vision's Stage-2
    loss forward + backward through `launch.steps`, and the fused loss's
    gradients at internlm2's shape. `parent` is a parent tree's kernels
    record (`--parent`): every case prints its parent's time beside its
    own. Returns the kernel's record, every case under "cases". Needs
    autograd: run it outside inference mode."""
    from repro_torch.configs import get_config
    parent_cases = None
    if parent is not None:
        parent_cases = {}
        for r in parent.get("kernels", []):
            if r.get("name") == "gatekeeper_loss_tokens":
                parent_cases = r.get("cases", {})
    cfg = get_config(ARCH)
    rec = check_loss_kernel(torch, gk, smi, cfg.vocab_size, cfg.d_model,
                            parent_cases=parent_cases)
    rec["by_shape"] = {}
    for arch, T, invalid in (
            (WHISPER_ARCH, N_SLOTS * ENC_PROMPT, 0),
            (VLM_ARCH, N_SLOTS * (get_config(VLM_ARCH).vision.n_patches
                                  + 3), get_config(VLM_ARCH).vision.n_patches),
            (RWKV_ARCH, LOSS_T, 0), (ZAMBA_ARCH, LOSS_T, 0)):
        c = get_config(arch)
        r = check_loss_kernel(torch, gk, smi, c.vocab_size, c.d_model, T,
                              N_SLOTS, invalid, arch, parent_cases)
        rec["by_shape"][arch] = {k: r[k] for k in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_simt_ms", "max_abs_err")}
        rec["cases"].update(r["cases"])
        torch.cuda.empty_cache()
    rec["cases"].update(check_stage2_vlm_loss(torch, gk, smi, parent_cases))
    check_loss_gradients(torch, gk, cfg.vocab_size, cfg.d_model)
    torch.cuda.empty_cache()
    return rec


def state_gb(params) -> float:
    """GB of fp32 weights, gradients and AdamW moments for `params`."""
    from repro_torch.training import optim
    n = sum(p.numel() for p in optim.tree_leaves(params))
    return n * STATE_BYTES_PER_PARAM / 1e9


def train_recurrent(torch, train, smi, arch: str, remat: str):
    """`launch.train.run` at `arch`'s published width with --remat
    `remat`: STAGE1_STEPS Stage-1 and STAGE2_STEPS Stage-2 steps of
    TRAIN_BATCH x TRAIN_SEQ tokens, the counters set to 0 just before and
    read after every step: `wkv_scan` n_layers x (1 + the mode's
    recomputes) a step, every launch on the chunked path, and one loss
    kernel launch a Stage-2 step. Prints each stage's step walls, peak
    memory and finite metrics. Returns (params, args, {kernel: launches
    of the run})."""
    from repro_torch.kernels import gatekeeper_loss as gk
    from repro_torch.kernels import wkv_scan as wk
    args = train.build_parser().parse_args([
        "--arch", arch, "--remat", remat, "--batch", str(TRAIN_BATCH),
        "--seq-len", str(TRAIN_SEQ), "--task", "stream", "--stage1-steps",
        str(STAGE1_STEPS), "--stage2-steps", str(STAGE2_STEPS),
        "--log-every", "1", "--n-train", "256", "--seed", str(SEED),
        "--device", DEV])
    cfg = train.build_cfg(args)
    per_step = cfg.n_layers * (1 + REMAT_RECOMPUTES[remat])
    peaks, seen = {}, []

    def on_step(stage, rec):
        done = rec["step"] + (STAGE1_STEPS if stage == 2 else 0)
        want = (done * per_step, done * per_step,
                rec["step"] if stage == 2 else 0)
        got = (wk.wkv_scan.launches, wk.wkv_scan.launches_chunked,
               gk.gatekeeper_loss_tokens.launches)
        seen.append(got)
        if got != want:
            raise AssertionError(
                f"{arch} stage {stage} step {rec['step']}: (wkv_scan, "
                f"chunked, loss kernel) launches {got}, want {want}")
        if rec["step"] == (STAGE1_STEPS if stage == 1 else STAGE2_STEPS):
            peaks[stage] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wk.wkv_scan.launches = wk.wkv_scan.launches_chunked = 0
    gk.gatekeeper_loss_tokens.launches = 0
    t0 = time.perf_counter()
    params, hist = train.run(args, log_fn=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"wkv_scan_chunked": wk.wkv_scan.launches_chunked,
              "gatekeeper_loss_tokens": gk.gatekeeper_loss_tokens.launches}
    print(f"[train-recurrent] {arch}: {cfg.n_layers} layers, d {cfg.d_model}"
          f", vocab {cfg.vocab_size}, {state_gb(params):.1f} GB of weight, "
          f"gradient and moment state; remat {remat!r}: {REMAT_REASON[remat]}"
          f"; run {wall:.1f} s on {smi}")
    for stage, log in hist.items():
        times = [r["time_s"] for r in log]
        steps = [b - a for a, b in zip([0.0] + times, times)]
        print(f"[train-recurrent] {arch} stage {stage}: {len(log)} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, step wall s "
              + ", ".join(f"{t:.3f}" for t in steps)
              + f"; peak device memory {peaks[stage]:.2f} GiB on {smi}")
        for r in log:
            if not all(math.isfinite(v) for v in r.values()):
                raise AssertionError(f"{arch} stage {stage}: non-finite {r}")
    last = hist[2][-1]
    print(f"[train-recurrent] {arch} stage 2 last step: loss {last['loss']}, "
          f"frac_correct {last['frac_correct']}, grad_norm "
          f"{last['grad_norm']}; (wkv_scan, chunked, loss kernel) launches "
          f"after each step {seen} (cumulative; {per_step} wkv_scan a step "
          f"= {cfg.n_layers} layers x (1 + {REMAT_RECOMPUTES[remat]} "
          f"recompute))")
    return params, args, counts


def _grad_diff(torch, grads, ref) -> tuple:
    """(largest leaf max|d| / max|ref leaf|, leaves bit-equal, leaves)."""
    from repro_torch.training import optim
    worst, equal, n = 0.0, 0, 0
    for a, b in zip(optim.tree_leaves(grads), optim.tree_leaves(ref)):
        d = float((a.float() - b.float()).abs().max())
        worst = max(worst, d / max(float(b.float().abs().max()), 1e-30))
        equal += d == 0.0
        n += 1
    return worst, equal, n


def remat_step(torch, cfg, smi, tag: str) -> None:
    """17c: one Stage-2 loss and gradient of `cfg` (TRAIN_BATCH x
    TRAIN_SEQ tokens, the loss kernel on) under remat none, full and dots
    from the same parameters, each run twice (the first warms up the
    allocator's cache for the mode): the memory the forward leaves for
    the backward (allocated once the loss is computed, over what was
    held before), the peak of the whole call (the gradients included)
    and the host wall of the second run;
    full's and dots' gradients held leaf by leaf to none's within
    REMAT_GRAD_RTOL_OF_MAX of the leaf's largest entry, and `wkv_scan`
    (a recurrent cfg) launched n_layers x (1 + recomputes) times a run:
    a recompute launches the kernel again into a buffer it allocates."""
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.kernels import wkv_scan as wk
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optim
    params = tfm.init_params(cfg, SEED, DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 30)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=g, device=DEV)
             for k in ("tokens", "targets")}
    ref = None
    for mode in ("none", "full", "dots"):
        loss_fn = steps.make_loss_fn(cfg.replace(remat=mode),
                                     GatekeeperConfig(alpha=0.3))
        saved = {}

        def fn(p, b):
            out = loss_fn(p, b)
            torch.cuda.synchronize()
            saved["bytes"] = torch.cuda.memory_allocated() - saved["base"]
            return out
        torch.cuda.empty_cache()
        for _ in range(2):
            grads = None
            torch.cuda.synchronize()
            saved["base"] = base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            n = wk.wkv_scan.launches
            t0 = time.perf_counter()
            (loss, _), grads = optim.value_and_grad(fn, params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        launched = wk.wkv_scan.launches - n
        want = (cfg.n_layers * (1 + REMAT_RECOMPUTES[mode])
                if cfg.recurrent else 0)
        line = (f"[remat] {tag} Stage-2 step ({TRAIN_BATCH} x {TRAIN_SEQ}) "
                f"remat {mode!r}: loss {float(loss):.6f}, the forward leaves "
                f"{saved['bytes'] / 2**30:.3f} GiB for the backward, peak "
                f"{peak:.2f} GiB (gradients included) above the "
                f"{base / 2**30:.2f} GiB held before, host wall "
                f"{wall * 1e3:.1f} ms, wkv_scan launches {launched} (want "
                f"{want}) on {smi}")
        if ref is None:
            ref = (loss, grads)
            print(line)
        else:
            worst, equal, n_leaves = _grad_diff(torch, grads, ref[1])
            print(line + f"; against none: |dloss| "
                  f"{abs(float(loss) - float(ref[0])):.3g}, largest leaf "
                  f"max|dg| / max|g| {worst:.3g} (<= "
                  f"{REMAT_GRAD_RTOL_OF_MAX}), {equal} of {n_leaves} leaves "
                  f"bit-equal")
            if worst > REMAT_GRAD_RTOL_OF_MAX:
                raise AssertionError(f"{tag} remat {mode}: gradients differ "
                                     f"by {worst} of a leaf's max")
        if launched != want or not bool(torch.isfinite(loss)):
            raise AssertionError(f"{tag} remat {mode}: {launched} wkv_scan "
                                 f"launches (want {want}), loss {loss}")
        del grads
    del params, ref
    torch.cuda.empty_cache()


def attn_chunk_prefill(torch, smi) -> None:
    """17d: DeepSeek-V2's published widths, one (dense-FFN) layer, fp32
    activations, one ATTN_CHUNK_PROMPT-token prompt through
    `transformer.forward` with `attn_chunk` ATTN_CHUNK and then 0 (MLA's
    prefill is always the plain attention): each one's peak memory, and
    the logits held together within ATTN_CHUNK_LOGIT_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(MLA_ARCH).replace(n_layers=1, compute_dtype="float32")
    params = tfm.init_params(cfg, SEED, DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 31)
    tok = torch.randint(0, cfg.vocab_size, (1, ATTN_CHUNK_PROMPT),
                        generator=g, device=DEV)
    out = {}
    for chunk in (ATTN_CHUNK, 0):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out[chunk] = tfm.forward(params, cfg.replace(attn_chunk=chunk),
                                     tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"[attn-chunk] {MLA_ARCH} 1 layer, 1 x {ATTN_CHUNK_PROMPT} "
              f"tokens, attn_chunk {chunk}: peak {peak:.2f} GiB above the "
              f"{base / 2**30:.2f} GiB of weights, host wall "
              f"{wall * 1e3:.1f} ms on {smi}")
    err = float((out[ATTN_CHUNK] - out[0]).abs().max())
    print(f"[attn-chunk] logits, chunk {ATTN_CHUNK} vs unchunked: max|d| "
          f"{err:.3g} (atol {ATTN_CHUNK_LOGIT_ATOL}; logit std "
          f"{float(out[0].std()):.3g})")
    if not (bool(torch.isfinite(out[ATTN_CHUNK]).all())
            and out[ATTN_CHUNK].shape == (1, ATTN_CHUNK_PROMPT,
                                          cfg.vocab_size)
            and err <= ATTN_CHUNK_LOGIT_ATOL):
        raise AssertionError(f"attn_chunk logits differ by {err}")
    del params, out
    torch.cuda.empty_cache()


@contextlib.contextmanager
def kernel_switch(on: bool):
    """REPRO_PAGED_KERNEL set to `on` (the recurrence's kernel or its plain
    version in a training step), restored after."""
    import os
    old = os.environ.get("REPRO_PAGED_KERNEL")
    os.environ["REPRO_PAGED_KERNEL"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_PAGED_KERNEL"]
        else:
            os.environ["REPRO_PAGED_KERNEL"] = old


def kernel_vs_plain_step(torch, cfg, tag: str, tol: float, B: int,
                         T: int) -> None:
    """17e: a Stage-2 loss and gradient of `cfg` (B x T tokens, the
    chunked plain loss on both sides) with the recurrence's kernel
    forward (`wkv_scan_fused`: n_layers launches, all chunked) against the
    plain forward under autograd (none): the loss and every leaf within
    `tol` of the leaf's largest entry."""
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.kernels import wkv_scan as wk
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optim
    params = tfm.init_params(cfg, SEED, DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 32)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                              device=DEV) for k in ("tokens", "targets")}
    fn = steps.make_loss_fn(cfg, GatekeeperConfig(alpha=0.3), 0.01,
                            loss_kernel=False)
    out, launched = {}, {}
    for kernel in (True, False):
        n, nc = wk.wkv_scan.launches, wk.wkv_scan.launches_chunked
        with kernel_switch(kernel):
            out[kernel] = optim.value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
        launched[kernel] = (wk.wkv_scan.launches - n,
                            wk.wkv_scan.launches_chunked - nc)
    (lk, _), gk_ = out[True]
    (lp, _), gp = out[False]
    worst, equal, n_leaves = _grad_diff(torch, gk_, gp)
    dloss = abs(float(lk) - float(lp))
    want = (cfg.n_layers, cfg.n_layers)
    print(f"[train-recurrent] {tag} Stage-2 step ({B} x {T}), wkv_scan "
          f"kernel forward vs plain forward under autograd: |dloss| "
          f"{dloss:.3g}, largest leaf max|dg| / max|g| {worst:.3g} (<= "
          f"{tol}), {equal} of {n_leaves} leaves bit-equal; (launches, "
          f"chunked) kernel side {launched[True]} (want {want}), plain side "
          f"{launched[False]}")
    if (launched[True] != want or launched[False] != (0, 0) or worst > tol
            or dloss > tol * max(1.0, abs(float(lp)))):
        raise AssertionError(f"{tag}: kernel vs plain step: {worst}, "
                             f"{dloss}, launches {launched}")
    del params, out, gk_, gp
    torch.cuda.empty_cache()


def train_recurrent_phase(torch, smi, t_start: float) -> dict:
    """Phase 17 (autograd: outside inference mode). Returns {path:
    {kernel: launches}} of 17a and 17b's main-path runs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    by_path = {}
    for arch, remat in RECURRENT_TRAIN:
        phase(f"17{'a' if arch == RWKV_ARCH else 'b'}", t_start)
        params, args, counts = train_recurrent(torch, train, smi, arch,
                                               remat)
        by_path[f"train {arch}"] = counts
        if arch == ZAMBA_ARCH:
            profile_train_step(torch, train, params, args, smi,
                               f"{arch} Stage-2 step")
        del params
        torch.cuda.empty_cache()
    phase("17c", t_start)
    remat_step(torch, get_config(ARCH), smi, ARCH)
    remat_step(torch, get_config(RWKV_ARCH).replace(
        n_layers=REMAT_LAYERS_RWKV), smi,
        f"{RWKV_ARCH} ({REMAT_LAYERS_RWKV} layers)")
    phase("17d", t_start)
    attn_chunk_prefill(torch, smi)
    phase("17e", t_start)
    for arch in (RWKV_ARCH, ZAMBA_ARCH):
        kernel_vs_plain_step(torch, reduced(get_config(arch)),
                             f"reduced {arch}", KERNEL_GRAD_RTOL_OF_MAX, 4,
                             TRAIN_SEQ)
    kernel_vs_plain_step(torch, get_config(RWKV_ARCH).replace(n_layers=1),
                         f"{RWKV_ARCH} 1 layer, bf16 activations",
                         RWKV_LAYER_GRAD_GUARD, TRAIN_BATCH, TRAIN_SEQ)
    return by_path


KERNEL_PHASES = ("3", "3b", "3c", "3d", "3e", "7a")


def check_kernels(torch, np, rng, smi, phases, t_start,
                  parent=None) -> dict:
    """The kernel phases named in `phases` (of KERNEL_PHASES), each kernel
    against its plain version and timed (3d beside `parent`'s times, a
    parent tree's kernels record, where given). Returns their records by
    kernel name."""
    from repro_torch.kernels import deferral_entropy as de
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wkv_scan as wk
    records = {}
    # -- 3. GQA decode and paged write against their plain versions ----------
    if "3" in phases:
        phase("3", t_start)
        for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                                  ("fp32", torch.float32)):
            case = decode_case(torch, kv_dtype, rng)
            rec_d = check_decode_kernel(torch, pa, case, f"pages {kv_name}",
                                        smi)
            rec_w = check_write_kernel(torch, pa, case, kv_name, kv_dtype, smi)
            if kv_name == "bf16":                # the main path's types
                records["paged_flash_decode_gqa"] = rec_d
                records["paged_write_token"] = rec_w
            del case
        # the decode beyond the main path's shape: a long cache, group 16
        rng3 = np.random.default_rng(SEED + 30)
        for key, label, kw in (
                ("long_cache", f"pages bf16, {LONG_CACHE}-token cache",
                 dict(pos=[LONG_CACHE - 1] * N_SLOTS, copies=2)),
                ("group16", "pages bf16, llama3-405b heads (group 16)",
                 dict(H=128, KV=8)),
                ("qwen1.5-4b_mha", "pages bf16, qwen1.5-4b heads (20/20, "
                 "group 1)", dict(H=20, KV=20)),
                ("qwen1.5-32b_mha", "pages bf16, qwen1.5-32b heads (40/40, "
                 "group 1)", dict(H=40, KV=40)),
                ("kimi_hd112", "pages bf16, kimi-k2 heads (64/8 x 112)",
                 dict(H=64, KV=8, hd=112))):
            case = decode_case(torch, torch.bfloat16, rng3, **kw)
            rec = check_decode_kernel(torch, pa, case, label, smi)
            records["paged_flash_decode_gqa"][key] = {
                k: rec[k] for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err")}
            del case
        torch.cuda.empty_cache()
    # -- 3b. MLA decode against its plain version ----------------------------
    if "3b" in phases:
        phase("3b", t_start)
        for name, dtype in (("all bf16", torch.bfloat16),
                            ("all fp32", torch.float32)):
            case = mla_case(torch, dtype, rng)
            rec = check_mla_kernel(torch, pa, case, name, smi)
            if dtype == torch.bfloat16:          # the main path's types
                records["paged_flash_decode_mla"] = rec
            del case
        # beyond the main path's shape: a long cache, many splits a row
        case = mla_case(torch, torch.bfloat16,
                        np.random.default_rng(SEED + 31),
                        pos=[LONG_CACHE - 1] * N_SLOTS)
        rec = check_mla_kernel(torch, pa, case,
                               f"all bf16, {LONG_CACHE}-token cache", smi)
        records["paged_flash_decode_mla"]["long_cache"] = {
            k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err", "by_kernel_ms")}
        del case
        torch.cuda.empty_cache()
    # -- 3c. the deferral signal against its plain version -------------------
    if "3c" in phases:
        phase("3c", t_start)
        records["deferral_entropy"] = check_deferral_kernel(torch, de, smi)
    # -- 3d. prefill attention against its plain version ---------------------
    if "3d" in phases:
        phase("3d", t_start)
        records["flash_attention"] = check_flash_kernel(torch, fa, smi,
                                                        parent)
        torch.cuda.empty_cache()
    # -- 3e. the RWKV / Mamba2 recurrence against its plain version ----------
    if "3e" in phases:
        phase("3e", t_start)
        records.update(check_wkv_kernel(torch, wk, smi))
    return records


# ---------------------------------------------------------------------------
# Phase 18: logical-axis sharding and the expert- and sequence-parallel paths
# ---------------------------------------------------------------------------

SCALE_MESH, SCALE_AXES = (2, 4), ("data", "model")
SCALE_WORLD = 8
WORLD1_BACKEND = "nccl"          # 18a's world of one on the card
SCALE_LAYERS = 4                 # 18a: internlm2-1.8b's widths, depth cut
SCALE_STEPS, SCALE_B, SCALE_T = 4, 8, 128
MOE_TOKENS = (8, 128)            # 18b's scatter batch; its decode 8 x 1
KIMI_ARCH = "kimi-k2-1t-a32b"
LLAMA_ARCH = "llama3-405b"
LONG_POSITIONS = 524_288         # 18d: llama3-405b's batch-1 long decode
SHARD_POSITION_FRAC = 0.61       # 18d: the decoded position, as a share of S
MOE_BF16_GUARD = 0.05            # 18b, 18c: bf16 MoE against the local
                                 # path on the same rows: the expert GEMMs'
                                 # bf16 outputs round after another fp32
                                 # accumulation order (a batched product
                                 # over the capacity buffer against one
                                 # per expert) and, in 18c, after summing
                                 # two bf16 f-halves: a few bf16 roundings
                                 # of outputs of magnitude ~1 (ulp 2^-7)
SHARD_DECODE_ATOL = 1e-5         # 18d: fp32 activations over a bf16 cache,
                                 # the softmax sums split over 8 or 4
                                 # blocks: fp32 reordering through the
                                 # output projection; readings on an H100
                                 # 1.9e-7 and 1.58e-8, the CPU test's 1e-5
SHARD_LOGIT_ATOL = 5e-4          # 18e: kimi-k2's logits (fp32 sums over
                                 # d 7168, |logit| up to 22.6) summed from
                                 # two d-halves against one product; read
                                 # 5.72e-5 on an H100 (30 fp32 ulps at 22),
                                 # the limit ~9x that; a missing or doubled
                                 # half moves them by O(1)
SCALE_TIMEOUT = 600.0            # a threaded world's join


def _free_port() -> int:
    import socket as socket_lib
    with socket_lib.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


NCCL_PAIR_CHILD = r"""
import datetime, sys, torch, torch.distributed as dist
r, addr = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=addr, rank=r, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
t = torch.full((4,), float(r + 1), device="cuda")
try:
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"rank {r}: all_reduce gave {t.tolist()}")
except Exception as e:
    print(f"rank {r}: {type(e).__name__}: "
          + " | ".join(str(e).splitlines()[:4]))
dist.destroy_process_group()
"""


def nccl_pair_probe() -> str:
    """Two processes, one card, one NCCL all_reduce: what NCCL says."""
    addr = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PAIR_CHILD, str(r),
                               addr], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    lines = []
    for p in procs:
        try:
            out = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\n[killed after 120 s]"
        lines += [l for l in out.splitlines() if l.startswith("rank ")]
    return " / ".join(lines) or "no output"


def threaded_world(torch, fn, n: int = SCALE_WORLD) -> list:
    """`fn(rank)` in `n` threads of this process joined in torch's
    in-process "threaded" process group (registered for cuda and cpu by
    `torch.testing._internal.distributed.multi_threaded_pg`; the port
    imports none of it): each rank's tensors are on this card and every
    collective is a torch copy or reduction on it, so no byte crosses
    NVLink. Returns the ranks' results; a rank's exception is raised."""
    import threading
    import traceback
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mtp
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = mtp._install_threaded_pg()
    if not hasattr(world, "comms"):
        # torch 2.11's destroy_process_group walks `comms`, which its
        # thread-local world lacks; the threaded backend has none
        world.comms = []
    store = dist.HashStore()
    results, errors = [None] * n, []

    def run(r):
        try:
            dist.init_process_group("threaded", rank=r, world_size=n,
                                    store=store)
            try:
                results[r] = fn(r)
            finally:
                dist.destroy_process_group()
        except BaseException as e:          # reported and re-raised below
            errors.append((r, traceback.format_exc()))
            mtp.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(SCALE_TIMEOUT)
    finally:
        mtp._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mtp.ProcessLocalGroup.reset()
    if errors:
        raise RuntimeError(f"rank {errors[0][0]} of the threaded world "
                           f"failed:\n{errors[0][1]}")
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"the threaded world did not finish in "
                           f"{SCALE_TIMEOUT} s")
    return results


def _scale_ctx(rules=None):
    from repro_torch.launch.mesh import make_context
    from repro_torch.sharding import make_mesh, rules_dict
    return make_context(make_mesh(SCALE_MESH, SCALE_AXES, DEV),
                        rules_dict(rules))


def _same(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def world_of_one(torch, smi) -> dict:
    """18a: a world of one over `WORLD1_BACKEND` on a (1, 1) DeviceMesh:
    internlm2-1.8b's widths (depth cut to SCALE_LAYERS) through
    `make_serve_step` and one Stage-2 `make_train_step` with the context,
    bit-equal to ctx=None, launches exact; one all_to_all_single and one
    all_reduce on the card. Returns the main path's launch counts."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.gatekeeper import GatekeeperConfig
    from repro_torch.kernels import gatekeeper_loss as gk
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_context, make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.training import optim
    dist.init_process_group(WORLD1_BACKEND, rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        ctx = make_context(make_host_mesh(DEV))
        cfg = get_config(ARCH).replace(n_layers=SCALE_LAYERS)
        g = torch.Generator(device=DEV).manual_seed(SEED)
        tok0 = torch.randint(0, cfg.vocab_size, (SCALE_B,), generator=g,
                             device=DEV)
        with torch.inference_mode():
            params = tfm.init_params(cfg, SEED, DEV)

            def serve(c):
                step = steps.make_serve_step(cfg, tau=-1.0, ctx=c)
                cache = tfm.init_cache(cfg, SCALE_B, 2 * SCALE_STEPS,
                                       device=DEV)
                tok, outs = tok0, []
                for pos in range(SCALE_STEPS):
                    tok, conf, defer, cache = step(params, cache, tok, pos)
                    outs += [tok, conf, defer]
                return outs + [cache["dense"]["k"], cache["dense"]["v"]]

            ref = serve(None)
            reset_counts()
            got = serve(ctx)
            torch.cuda.synchronize()
            counts = read_counts()
            del params
        want = {k: (SCALE_STEPS if k == "deferral_entropy" else 0)
                for k in counts}
        same = all(_same(torch, a, b) for a, b in zip(got, ref))
        print(f"[18a] backend {dist.get_backend()}, (1, 1) DeviceMesh: "
              f"{cfg.name} at d {cfg.d_model} x {cfg.n_layers} layers, "
              f"{SCALE_STEPS} make_serve_step steps of {SCALE_B} rows with "
              f"ctx bit-equal to ctx=None: {same}; launches {counts}")
        if not same or counts != want:
            raise AssertionError(f"18a serve: bit-equal {same}, launches "
                                 f"{counts} (want {want})")
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (SCALE_B, SCALE_T), generator=g,
                                         device=DEV)}
        batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)

        def train(c):
            p = tfm.init_params(cfg, SEED + 3, DEV)
            opt = optim.adamw_init(p)
            step = steps.make_train_step(cfg, GatekeeperConfig(alpha=0.3),
                                         optim.AdamWConfig(), ctx=c)
            p, opt, m = step(p, opt, batch)
            return p, m

        p_ref, m_ref = train(None)
        gk.gatekeeper_loss_tokens.launches = 0
        p_got, m_got = train(ctx)
        torch.cuda.synchronize()
        n_loss = gk.gatekeeper_loss_tokens.launches
        same = (all(_same(torch, a, b) for a, b in
                    zip(_leaves(p_got), _leaves(p_ref)))
                and all(_same(torch, m_got[k], m_ref[k]) for k in m_ref))
        print(f"[18a] one Stage-2 make_train_step with ctx: loss "
              f"{float(m_got['loss']):.6f}, every updated parameter and "
              f"metric bit-equal to ctx=None: {same}; loss kernel launches "
              f"{n_loss}")
        if not same or n_loss != 1:
            raise AssertionError(f"18a train: bit-equal {same}, "
                                 f"{n_loss} loss kernel launches")
        del p_ref, p_got
        x = torch.arange(8, dtype=torch.float32, device=DEV)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=ctx.group("model"))
        z = x.clone()
        dist.all_reduce(z, group=ctx.group("data"))
        torch.cuda.synchronize()
        ok = torch.equal(y, x) and torch.equal(z, x)
        from repro_torch.launch import mesh
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"[18a] {dist.get_backend()} all_to_all_single over 'model' "
              f"and all_reduce over 'data' on the card: {ok}; total_memory "
              f"{total} (launch.mesh.HBM_BYTES {mesh.HBM_BYTES}) on {smi}")
        if not ok:
            raise AssertionError("18a collectives")
        counts["gatekeeper_loss_tokens"] = n_loss
        return counts
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def _moe_params(torch, mcfg, dtype, seed: int) -> dict:
    """A MoE layer's seeded weights (the router in fp32) with the port's
    initializer."""
    from repro_torch.models.common import ParamInit
    pi = ParamInit(seed, dtype, DEV)
    d, f, E = mcfg.d_model, mcfg.d_ff, mcfg.n_experts
    ex = ("experts", "expert_embed", "expert_ffn")
    p = {"router": pi.normal((d, E), d, ("embed", "experts"),
                             torch.float32),
         "w_gate": pi.normal((E, d, f), d, ex),
         "w_up": pi.normal((E, d, f), d, ex),
         "w_down": pi.normal((E, f, d), f,
                             ("experts", "expert_ffn", "expert_embed"))}
    if mcfg.n_shared_experts:
        sf = mcfg.shared_d_ff or f * mcfg.n_shared_experts
        p["shared"] = {"w_gate": pi.normal((d, sf), d, ("embed", "ffn")),
                       "w_up": pi.normal((d, sf), d, ("embed", "ffn")),
                       "w_down": pi.normal((sf, d), sf, ("ffn", "embed"))}
    return p


def _moe_oracle(torch, params, mcfg, x, blocks):
    """`_moe_local_math` plus the shared experts on x [B, T, d], one call
    per token block of the ranks' (rows, tokens) split (`blocks`: B and
    T block counts), so every router product has the shape the ranks'
    have and the same routes."""
    from repro_torch.models import ffn
    B, T, d = x.shape
    nb, nt = blocks
    y = torch.empty_like(x)
    for i in range(nb):
        for j in range(nt):
            rows = slice(i * B // nb, (i + 1) * B // nb)
            toks = slice(j * T // nt, (j + 1) * T // nt)
            xb = x[rows, toks]
            yb, _ = ffn._moe_local_math(
                xb.reshape(-1, d), params["router"], params["w_gate"],
                params["w_up"], params["w_down"], mcfg)
            y[rows, toks] = yb.reshape(xb.shape)
    if mcfg.n_shared_experts:
        y = y + ffn.mlp_forward(params["shared"], x)
    return y


def _err(torch, outs, ref) -> float:
    return max(float((o.float() - ref.float()).abs().max()) for o in outs)


def moe_deepseek(torch, smi) -> None:
    """18b: one DeepSeek-V2 MoE layer at published width in the 8-rank
    threaded world on a (2, 4) mesh: the scatter path (8 x 128 tokens)
    and the decode path (8 x 1) at capacity factor 8 against the local
    path on the same card; the scatter path's dropped share at 1.25."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.models import transformer as tfm
    cfg = get_config(MLA_ARCH)
    mcfg = dataclasses.replace(tfm.moe_config(cfg), capacity_factor=8.0)
    torch.cuda.reset_peak_memory_stats()
    params = _moe_params(torch, mcfg, cfg.pdtype(), SEED + 18)
    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    B, T = MOE_TOKENS
    xs = torch.randn((B, T, mcfg.d_model), generator=g, device=DEV,
                     dtype=torch.float32).to(cfg.cdtype())
    xd = xs[:, :1].contiguous()
    base = torch.cuda.memory_allocated()

    def rank(r):
        with torch.inference_mode():
            ctx = _scale_ctx()
            t0 = time.perf_counter()
            ys, _ = ffn.moe_forward(params, mcfg, xs, ctx, decode=False)
            yd, _ = ffn.moe_forward(params, mcfg, xd, ctx, decode=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _, _, drop = ffn.moe_scatter(
                params, tfm.moe_config(cfg), xs, ctx)
            return ys, yd, float(drop), wall, dist.get_backend()

    t0 = time.perf_counter()
    res = threaded_world(torch, rank)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.inference_mode():
        ref_s = _moe_oracle(torch, params, mcfg, xs, SCALE_MESH)
        ref_d = _moe_oracle(torch, params, mcfg, xd, (SCALE_MESH[0], 1))
    es = _err(torch, [r[0] for r in res], ref_s)
    ed = _err(torch, [r[1] for r in res], ref_d)
    print(f"[18b] backend {res[0][4]} (8 threads, one card), {cfg.name} MoE "
          f"layer d {mcfg.d_model}, {mcfg.n_experts} experts top-"
          f"{mcfg.top_k}, d_ff {mcfg.d_ff}, {mcfg.n_shared_experts} shared "
          f"of {mcfg.shared_d_ff}, {cfg.pdtype()}: scatter {B} x {T} max "
          f"|err| {es:.4g}, decode {B} x 1 {ed:.4g} against the local path "
          f"(guard {MOE_BF16_GUARD}); a rank's scatter + decode "
          f"{max(r[3] for r in res):.3f} s host wall, the world "
          f"{wall:.1f} s, peak {peak:.2f} GiB above the weights; dropped "
          f"share at capacity factor {cfg.moe.capacity_factor}: "
          f"{res[0][2]:.5f} on {smi}")
    if es > MOE_BF16_GUARD or ed > MOE_BF16_GUARD or len(
            {r[2] for r in res}) != 1:
        raise AssertionError(f"18b: scatter {es}, decode {ed}, dropped "
                             f"{[r[2] for r in res]}")
    del params, res
    torch.cuda.empty_cache()


def moe_kimi(torch, smi) -> None:
    """18c: one kimi-k2-1t-a32b MoE layer (384 experts top-8, d 7168,
    d_ff 2048, bf16, ~31.5 GiB) through the decode path under
    expert_embed -> (), expert_ffn -> data ("gather tokens, not
    weights"): each rank computes against views of its (experts,
    f-slice) blocks, and no rank allocates a gathered weight."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.models import transformer as tfm
    cfg = get_config(KIMI_ARCH)
    mcfg = tfm.moe_config(cfg)
    params = _moe_params(torch, mcfg, cfg.pdtype(), SEED + 20)
    w_gib = sum(t.numel() * t.element_size()
                for t in _leaves(params)) / 2**30
    g = torch.Generator(device=DEV).manual_seed(SEED + 21)
    x = torch.randn((MOE_TOKENS[0], 1, mcfg.d_model), generator=g,
                    device=DEV, dtype=torch.float32).to(cfg.cdtype())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rules = {"expert_embed": (), "expert_ffn": ("data",)}

    def rank(r):
        with torch.inference_mode():
            ctx = _scale_ctx(rules)
            t0 = time.perf_counter()
            y, _ = ffn.moe_forward(params, mcfg, x, ctx, decode=True)
            torch.cuda.synchronize()
            return y, time.perf_counter() - t0, dist.get_backend()

    res = threaded_world(torch, rank)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.inference_mode():
        # the ranks route the 8 gathered tokens together: one block
        ref = _moe_oracle(torch, params, mcfg, x, (1, 1))
    e = _err(torch, [r[0] for r in res], ref)
    per_rank = w_gib / SCALE_WORLD
    print(f"[18c] backend {res[0][2]}, {cfg.name} MoE layer ({mcfg.n_experts}"
          f" experts top-{mcfg.top_k}, d {mcfg.d_model}, d_ff {mcfg.d_ff}, "
          f"{w_gib:.2f} GiB of weights), decode {x.shape[0]} x 1 under "
          f"expert_ffn -> data: max |err| {e:.4g} against the local path "
          f"(guard {MOE_BF16_GUARD}); a rank's step {max(r[1] for r in res):.3f}"
          f" s host wall; peak {peak:.3f} GiB above the weights for 8 ranks "
          f"(a gathered copy of a rank's {per_rank:.2f} GiB block would add "
          f"it per rank) on {smi}")
    if e > MOE_BF16_GUARD or peak > per_rank:
        raise AssertionError(f"18c: err {e}, peak {peak} GiB")
    del params, res
    torch.cuda.empty_cache()


def _equal_outside(torch, a, b, pos: int, rows: int = 16) -> bool:
    """a and b [B, S, ...] equal at every position but `pos`, compared
    `rows` batch rows at a time."""
    return all(torch.equal(a[i:i + rows, :pos], b[i:i + rows, :pos])
               and torch.equal(a[i:i + rows, pos + 1:],
                               b[i:i + rows, pos + 1:])
               for i in range(0, a.shape[0], rows))


def seq_sharded_decode(torch, smi) -> None:
    """18d: the sequence-sharded GQA decode against the dense decode on
    the card, fp32 activations over a bf16 cache: kimi-k2's heads at
    `decode_32k` (B 128, S 32768, cache_seq -> (data, model): rows over
    data, sequence over model) and llama3-405b's at batch 1 over 524,288
    positions under the default rules (sequence over data, KV heads over
    model). The written cache is checked against the dense path's write."""
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import Spec
    shape = SHAPES["decode_32k"]
    cases = ((KIMI_ARCH, shape.global_batch, shape.seq_len,
              {"cache_seq": ("data", "model")}, Spec("data", "model", None,
                                                      None)),
             (LLAMA_ARCH, 1, LONG_POSITIONS, None,
              Spec(None, "data", "model", None)))
    for arch, B, S, rules, want in cases:
        cfg = get_config(arch).replace(param_dtype="float32")
        ac = tfm.attn_config(cfg)
        pi_params = tfm.ParamInit(SEED + 22, torch.float32, DEV)
        p = tfm._init_attn(pi_params, cfg.replace(n_layers=1), 0)
        g = torch.Generator(device=DEV).manual_seed(SEED + 23)
        kv = (B, S, cfg.n_kv_heads, cfg.head_dim)
        cache = {n: torch.randn(kv, generator=g, device=DEV,
                                dtype=torch.bfloat16) for n in ("k", "v")}
        x = torch.randn((B, 1, cfg.d_model), generator=g, device=DEV,
                        dtype=torch.float32)
        pos = int(S * SHARD_POSITION_FRAC)
        before = {n: c.clone() for n, c in cache.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def rank(r):
            with torch.inference_mode():
                ctx = _scale_ctx(rules)
                spec = attn._seq_sharded_spec(cache["k"].shape,
                                              torch.ones(1, S, dtype=torch.bool,
                                                         device=DEV), ctx)
                t0 = time.perf_counter()
                y, _ = attn.gqa_decode(p, ac, x, pos, cache, ctx=ctx)
                torch.cuda.synchronize()
                return y, spec, time.perf_counter() - t0, dist.get_backend()

        res = threaded_world(torch, rank)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        # the sharded decode wrote nothing outside slot `pos`
        kept = all(_equal_outside(torch, cache[n], before[n], pos)
                   for n in ("k", "v"))
        del before
        written = {n: cache[n][:, pos].clone() for n in ("k", "v")}
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref, _ = attn.gqa_decode(p, ac, x, pos, cache)
            torch.cuda.synchronize()
            t_dense = time.perf_counter() - t0
        e = _err(torch, [r[0] for r in res], ref)
        wrote = all(torch.equal(written[n], cache[n][:, pos])
                    for n in ("k", "v"))
        gb = 2 * math.prod(kv) * 2 / 1e9
        print(f"[18d] backend {res[0][3]}, {arch} {cfg.n_heads}/"
              f"{cfg.n_kv_heads} x {cfg.head_dim}, B {B}, S {S} ({gb:.2f} GB"
              f" of bf16 cache), position {pos}, spec {res[0][1]}: max |err|"
              f" {e:.4g} against the dense decode (atol {SHARD_DECODE_ATOL};"
              f" |output| up to {float(ref.abs().max()):.4g}), the owner "
              f"ranks' cache write equal to the dense path's: {wrote}, the "
              f"cache outside slot {pos} unchanged: {kept}; a rank {max(r[2] for r in res):.3f} s, the dense "
              f"decode {t_dense:.3f} s host wall; peak {peak:.2f} GiB above "
              f"the cache on {smi}")
        if (e > SHARD_DECODE_ATOL or not wrote or not kept
                or any(r[1] != want for r in res)):
            raise AssertionError(f"18d {arch}: err {e}, write {wrote}, "
                                 f"rest of the cache kept {kept}, spec "
                                 f"{res[0][1]}")
        del cache, res, p
        torch.cuda.empty_cache()


def _signal_sensitivity(torch, logits):
    """Per row, what a logit error of 1 can move (neg_entropy, max_prob)
    by, to first order: d(-H)/dl_j = p_j (log p_j + H) and dp_max/dl_j =
    p_max (delta_jmax - p_j), so |d(-H)| <= sum_j p_j |log p_j + H| and
    |dp_max| <= 2 p_max (1 - p_max), times max_j |dl_j|."""
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    h = -(p * logp).sum(-1, keepdim=True)
    pmax = p.amax(-1)
    return (p * (logp + h).abs()).sum(-1), 2 * pmax * (1 - pmax)


def d_sharded_signal(torch, smi) -> dict:
    """18e: kimi-k2's serve-step signal (`steps.decode_signal` on the
    kernel path) at decode_32k's 128 rows with unembed_d -> data: each
    rank's partial logits of its d-slices, summed, through one
    `deferral_entropy` launch a rank, against the unsharded signal. The
    error is split into its parts: the summed logits against the full
    product (SHARD_LOGIT_ATOL); each rank's kernel result against
    `deferral_entropy_plain` on its own summed logits, at this launch's
    128 rows (SIGNAL_ATOL; the unsharded kernel likewise); and the
    sharded signal against the unsharded one, held to what the measured
    logit error can move the signal by to first order, twice over, plus
    the two kernels' measured errors. Returns the launches."""
    import torch.distributed as dist
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.deferral_entropy import deferral_entropy_plain
    from repro_torch.launch import steps
    cfg = get_config(KIMI_ARCH)
    g = torch.Generator(device=DEV).manual_seed(SEED + 24)
    B = SHAPES["decode_32k"].global_batch
    table = (torch.randn((cfg.vocab_size, cfg.d_model), generator=g,
                         device=DEV) / math.sqrt(cfg.d_model)
             ).to(cfg.pdtype())
    x = torch.randn((B, cfg.d_model), generator=g, device=DEV
                    ).to(cfg.cdtype()) * 4
    with torch.inference_mode():
        full = steps.unembed_logits(x, table)
        ref = steps.decode_signal(x, table, True)

    def rank(r):
        with torch.inference_mode():
            ctx = _scale_ctx({"unembed_d": ("data",)})
            return (steps.decode_signal(x, table, True, ctx),
                    steps.unembed_logits(x, table, ctx), dist.get_backend())

    reset_counts()
    res = threaded_world(torch, rank)
    torch.cuda.synchronize()
    counts = read_counts()

    def gap(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a[:2], b[:2]))

    with torch.inference_mode():
        # the logits a rank returned are the ones its kernel saw
        again = all(all(torch.equal(u, v) for u, v in
                        zip(kernel_ops.deferral_signal(r[1]), r[0]))
                    for r in res)
        plain = [deferral_entropy_plain(r[1]) for r in res]
        plain_full = deferral_entropy_plain(full)
        d_row = torch.stack([(r[1] - full).abs().amax(-1) for r in res]
                            ).amax(0)
        s_ent, s_p = _signal_sensitivity(torch, full)
        est_ent = float((s_ent * d_row).max())
        est_p = float((s_p * d_row).max())
    e_logit = float(d_row.max())
    e_kern = max(gap(r[0], q) for r, q in zip(res, plain))
    e_kern_ref = gap(ref, plain_full)
    e_sum = max(gap(q, plain_full) for q in plain)
    e_ent = max(float((r[0][0] - ref[0]).abs().max()) for r in res)
    e_p = max(float((r[0][1] - ref[1]).abs().max()) for r in res)
    lim_ent = 2 * est_ent + e_kern + e_kern_ref
    lim_p = 2 * est_p + e_kern + e_kern_ref
    top2 = torch.topk(full, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TIE_GAP
    same = all(torch.equal(r[0][2], ref[2]) for r in res)
    same_plain = all(torch.equal(r[0][2][clear], q[2][clear])
                     for r, q in zip(res, plain))
    print(f"[18e] backend {res[0][2]}, {cfg.name} signal, {B} rows x V "
          f"{cfg.vocab_size}, d {cfg.d_model} split over 'data': summed "
          f"logits against the full product max |err| {e_logit:.4g} "
          f"(atol {SHARD_LOGIT_ATOL}; |logit| up to "
          f"{float(full.abs().max()):.4g}); kernel against "
          f"deferral_entropy_plain on the same logits at {B} rows: sharded "
          f"{e_kern:.4g}, unsharded {e_kern_ref:.4g} (atol {SIGNAL_ATOL}), "
          f"argmax equal on clear rows {same_plain}, the kernel's input "
          f"re-run bit-equal {again}; plain on the summed against plain on "
          f"the full logits {e_sum:.4g}; first-order bound of the logit "
          f"error: neg_entropy {est_ent:.4g} (max sum p|log p + H| "
          f"{float(s_ent.max()):.4g}), max_prob {est_p:.4g}; sharded "
          f"against unsharded kernel: neg_entropy {e_ent:.4g} (limit "
          f"{lim_ent:.4g}), max_prob {e_p:.4g} (limit {lim_p:.4g}), argmax "
          f"equal {same}; launches {counts} on {smi}")
    want = {k: (SCALE_WORLD if k == "deferral_entropy" else 0)
            for k in counts}
    if (e_logit > SHARD_LOGIT_ATOL or e_kern > SIGNAL_ATOL
            or e_kern_ref > SIGNAL_ATOL or not same_plain or not again
            or e_ent > lim_ent or e_p > lim_p or not same
            or counts != want):
        raise AssertionError(f"18e: logits {e_logit}, kernel {e_kern} / "
                             f"{e_kern_ref}, signal {e_ent} ({lim_ent}), "
                             f"{e_p} ({lim_p}), argmax {same} / "
                             f"{same_plain}, re-run {again}, launches "
                             f"{counts}")
    del table, full, res, plain
    torch.cuda.empty_cache()
    return counts


def scale_out_phase(torch, smi, t_start: float) -> dict:
    """Phase 18 (18a-18e). Returns {path: launch counts}."""
    phase("18a", t_start)
    print(f"[18] NCCL, two processes on the one card: {nccl_pair_probe()}")
    by_path = {"scale_out_world1": world_of_one(torch, smi)}
    phase("18b", t_start)
    moe_deepseek(torch, smi)
    phase("18c", t_start)
    moe_kimi(torch, smi)
    phase("18d", t_start)
    seq_sharded_decode(torch, smi)
    phase("18e", t_start)
    by_path["scale_out_signal"] = d_sharded_signal(torch, smi)
    return by_path


# phase 19: the dry-run and its roofline, held against the card
# 19a: one combo per family and shape kind (train, prefill, decode) at
# published widths and full depth, but for the recurrent families' train
# and prefill, cut to DRYRUN_CUT layers (their plain chunk loops trace at
# 5-10 s a layer: rwkv6-3b's prefill_32k alone takes over 300 s at 32);
# then llama3-405b train_4k on 2 x 16 x 16 and JAX's gather-tokens MoE
# decode. Traced in the foreground, before 19b, so that no timed phase
# shares the host with it. `python -m repro_torch.launch.dryrun --all`
# traces all 40 at full depth on any machine.
DRYRUN_COMBOS = (
    ("internlm2-1.8b", "train_4k"), ("internlm2-1.8b", "prefill_32k"),
    ("llama3-405b", "long_500k"),
    ("deepseek-v2-236b", "train_4k"), ("kimi-k2-1t-a32b", "prefill_32k"),
    ("deepseek-v2-236b", "decode_32k"),
    ("rwkv6-3b", "train_4k"), ("rwkv6-3b", "prefill_32k"),
    ("rwkv6-3b", "decode_32k"),
    ("zamba2-1.2b", "train_4k"), ("zamba2-1.2b", "prefill_32k"),
    ("zamba2-1.2b", "long_500k"),
    ("whisper-small", "train_4k"), ("whisper-small", "prefill_32k"),
    ("whisper-small", "decode_32k"),
    ("phi-3-vision-4.2b", "train_4k"), ("phi-3-vision-4.2b", "prefill_32k"),
    ("phi-3-vision-4.2b", "long_500k"))
DRYRUN_CUT = {"rwkv6-3b": 2, "zamba2-1.2b": 6}   # zamba2: one shared period
DRYRUN_MULTI_POD = ("llama3-405b", "train_4k")
DRYRUN_VARIANT = "perf: gather-tokens MoE decode"    # dryrun.PERF_VARIANTS
DRYRUN_WORKERS = 4      # processes, each tracing one combo at a time
DRYRUN_TIMEOUT = 300    # seconds 19a may take
# 19b: internlm2-1.8b at its published width on one card, three steps
# sized to fit it beside the weights: (kind, seq_len, batch). bf16 weights
# 3.8 GB; the decode's 4,096-token cache 12.9 GB; the train step's fp32
# moments 15.1 GB
ROOF_SHAPES = (("prefill", 4096, 8), ("decode", 4096, 32),
               ("train", 2048, 2))
ROOF_CALLS = 5          # timed calls of each step after one warm-up
ROOF_MIN_RATIO = 0.9    # 19b (ii): a step's time over its roofline bound
ROOF_PEAK_RTOL = 0.15   # 19b (iii): measured peak against the traced one
PREFILL_CACHE_RTOL = 0.15  # 19b (iv): the kernel prefill's K/V against the
                        # plain one's, relative at the worst (layer, row,
                        # position): bf16 flash against the plain attention,
                        # carried through the bf16 residual stream. The
                        # reading on an H100 was 0.0468; a mask one key off
                        # or a tile's V lost gave 0.86-1.5 on the CPU at 8
                        # layers, the bf16 reordering 0.023
                        # (tools/prefill_fault_probe.py)
PREFILL_LOGIT_GUARD = 0.5  # 19b (iv): the last position's logits, max |d|:
                        # about 3x the H100's reading of 0.154
EXAMPLES = (("torch_quickstart.py", ()), ("torch_lm_cascade.py", ()),
            ("torch_serve_cascade.py", ()),
            ("torch_train_100m.py", ("--stage1-steps", "20",
                                     "--stage2-steps", "10")))
EXAMPLE_TIMEOUT = 600   # seconds one example may take


def dryrun_jobs() -> list:
    """19a's combos as `lower_combo` keywords, the longest first; checks
    that DRYRUN_COMBOS holds every family at every shape kind once."""
    from repro_torch.configs import SHAPES, get_config, list_configs
    from repro_torch.launch import dryrun
    got = sorted((get_config(a).family, SHAPES[s].kind)
                 for a, s in DRYRUN_COMBOS)
    want = sorted((f, k) for f in {get_config(a).family
                                   for a in list_configs()}
                  for k in ("train", "prefill", "decode"))
    assert got == want, f"19a's combos: {got} != {want}"
    jobs = []
    for a, s in DRYRUN_COMBOS:
        job = dict(arch=a, shape_name=s, multi_pod=False)
        if a in DRYRUN_CUT and SHAPES[s].kind != "decode":
            job.update(cfg_overrides={"n_layers": DRYRUN_CUT[a]},
                       label=f"{DRYRUN_CUT[a]} layers")
        jobs.append(job)
    jobs.append(dict(arch=DRYRUN_MULTI_POD[0],
                     shape_name=DRYRUN_MULTI_POD[1], multi_pod=True))
    jobs += [dict(v, multi_pod=False) for v in dryrun.PERF_VARIANTS
             if v["label"] == DRYRUN_VARIANT]
    return sorted(jobs, key=lambda j: (SHAPES[j["shape_name"]].kind
                                       == "prefill", "label" in j),
                  reverse=True)


def _trace_combo(src: str, job: dict) -> dict:
    """One 19a combo in a fake world of this pool process's own, made and
    destroyed by `lower_combo` (a process group is global to its
    process); a failure comes back as "error"."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)        # DRYRUN_WORKERS of them share the host
    from repro_torch.launch import dryrun
    try:
        return dryrun.lower_combo(verbose=False, **job)
    except Exception as e:
        return {**job, "error": repr(e)[:300]}


def dryrun_combos(src: Path, smi: str) -> list:
    """19a: trace the combos on DRYRUN_WORKERS processes; every combo
    must trace. Prints one line per combo, writes them all to
    chiprun_out/dryrun_torch.jsonl, returns them."""
    import multiprocessing
    from repro_torch.launch import dryrun
    jobs = dryrun_jobs()
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            DRYRUN_WORKERS) as pool:        # leaving terminates the pool
        pending = [pool.apply_async(_trace_combo, (str(src), j))
                   for j in jobs]
        results = [p.get(timeout=max(t0 + DRYRUN_TIMEOUT
                                     - time.perf_counter(), 1.0))
                   for p in pending]
    wall = time.perf_counter() - t0
    for r in results:
        if "error" not in r:
            print(f"[19a] {dryrun.format_line(r)}")
    out = ROOT / "chiprun_out" / "dryrun_torch.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.write_text("".join(json.dumps(r) + "\n" for r in results))
    bad = [(r["arch"], r["shape_name"], r["error"]) for r in results
           if "error" in r]
    print(f"[19a] {len(results) - len(bad)} of {len(jobs)} combos traced "
          f"on {DRYRUN_WORKERS} processes in {wall:.1f} s wall, "
          f"{sum(r.get('t_trace_s', 0) for r in results):.1f} s of traces, "
          f"on the host of {smi}")
    if bad:
        raise AssertionError(f"19a: failed {bad}")
    return results


def _step_ms(torch, step, args_fn) -> list:
    """Wall milliseconds of ROOF_CALLS calls of `step` (CUDA events around
    each, synchronised), after one warm-up; `args_fn()` gives each call's
    arguments."""
    step(*args_fn())
    torch.cuda.synchronize()
    times = []
    for _ in range(ROOF_CALLS):
        a = args_fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def roofline_on_card(torch, smi) -> dict:
    """19b: internlm2-1.8b at its published width (24 layers, bf16 by
    `adapt_for_shape`) on a world of one, ctx None, at ROOF_SHAPES: the
    meta trace's count held against the card. Returns {path: launches}."""
    import statistics
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.steps import _decode_hidden
    from repro_torch.kernels.deferral_entropy import deferral_entropy_plain
    from repro_torch.models.common import unembed
    from repro_torch.sharding import MeshLayout
    from repro_torch.models import transformer as tfm
    mesh = MeshLayout((1, 1), ("data", "model"))
    by_path = {}

    def last_logits(args, kernel: bool):
        """The prefill's last-position logits [B, V] in fp32, its cache
        (rewritten in place with the same values)."""
        logits, _ = tfm.prefill(args[0], cfg, args[2]["tokens"], args[1],
                                last_only=True, paged_kernel=kernel)
        return logits[:, -1].float()

    def position_rel(a, b):
        """The largest relative difference of one position's K or V (its
        KV heads x head dim) over the layers, rows and positions of two
        [L, B, S, KV, hd] cache leaves."""
        a, b = a.flatten(3).float(), b.flatten(3).float()
        return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())
    for kind, S, B in ROOF_SHAPES:
        shape = InputShape(f"{kind}_{B}x{S}", S, B, kind)
        cfg = specs.adapt_for_shape(get_config(ARCH), shape)
        step, meta_args, _ = dryrun.step_and_inputs(cfg, shape, mesh)
        t0 = time.perf_counter()
        tr = dryrun.trace_step(step, meta_args)
        t_trace = time.perf_counter() - t0
        rep = rf.make_report(ARCH, shape.name, "1x1", 1,
                             {"flops": tr["flops"],
                              "bytes accessed": tr["bytes"]}, tr["events"],
                             rf.analytic_model_flops(cfg, shape),
                             tr["peak_bytes"])
        bound_s = max(rep.compute_s, rep.memory_s)

        def fresh():
            gen = torch.Generator(device=DEV).manual_seed(SEED)
            return dryrun.materialize(meta_args, DEV, gen, cfg.vocab_size)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = fresh()
        # (i) the same count on the card, kernels off
        with FlopCounterMode(display=False) as fc:
            step(*args)
        torch.cuda.synchronize()
        card_flops = int(fc.get_total_flops())
        # (iii) the peak of one plain call over what the process held
        # before its inputs (after a warm call: cuBLAS's workspaces exist)
        step(*args)
        del args
        torch.cuda.synchronize()
        args = fresh()
        torch.cuda.reset_peak_memory_stats()
        step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # (ii) the plain step's time against its bound (the train step
        # updates its state in place; the decode writes one position)
        ms = _step_ms(torch, step, lambda: args)
        med = statistics.median(ms)

        def one():
            step(*args)
            torch.cuda.synchronize()
        _, busy, ranked = profile_steps(torch, one, 1, warm=True)
        # (iv) the kernel path on the same inputs, against the plain
        # step's outputs (kept small, so that one state is live at a time)
        kstep, _, _ = dryrun.step_and_inputs(cfg, shape, mesh, kernels=True)
        del args
        args = fresh()
        if kind == "prefill":
            # the plain prefill as its step runs it, keeping its last
            # position's logits and every layer's K/V
            ref_logits = last_logits(args, False)
            neg, _, tok = deferral_entropy_plain(ref_logits)
            out = ref = (tok, neg)
            ref_cache = [t.clone() for t in _leaves(args[1])]
        else:
            out = step(*args)
        if kind == "train":
            ref = {k: float(out[2][k]) for k in (
                "loss", "l_corr", "l_incorr", "mean_entropy", "frac_correct")}
        elif kind == "decode":
            ref = (out[0].clone(), out[1].clone())
            # phase 8's check: tokens equal where the top-2 gap is clear
            x, _ = _decode_hidden(args[0], cfg, args[2], args[3], args[1],
                                  paged_kernel=False)
            top2 = torch.topk(unembed(x, args[0].get(
                "unembed", args[0]["embedding"])), 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > TIE_GAP
            del x, top2
        del args, out
        args_k = fresh()
        reset_counts()
        from repro_torch.kernels import gatekeeper_loss as gk
        gk.gatekeeper_loss_tokens.launches = 0
        out = kstep(*args_k)
        torch.cuda.synchronize()
        counts = read_counts()
        counts["gatekeeper_loss_tokens"] = gk.gatekeeper_loss_tokens.launches
        want = dict.fromkeys(counts, 0)
        if kind == "prefill":
            want.update(flash_attention=cfg.n_layers, deferral_entropy=1)
        elif kind == "decode":
            want.update(deferral_entropy=1)
        else:
            want.update(gatekeeper_loss_tokens=1)
        if kind == "train":
            err = max(abs(ref[k] - float(out[2][k]))
                      for k in ("loss", "l_corr", "l_incorr",
                                "mean_entropy"))
            agree = (f"loss terms max|d| {err:.3g} (atol {LOSS_ATOL}), "
                     f"frac_correct {ref['frac_correct']:.4f} / "
                     f"{float(out[2]['frac_correct']):.4f}")
            ok = err <= LOSS_ATOL
        elif kind == "decode":
            # phase 8's: neg_entropy within SIGNAL_ATOL on the same state
            err = float((ref[1] - out[1]).abs().max())
            flips = int((ref[0][clear] != out[0][clear]).sum())
            agree = (f"neg_entropy max|d| {err:.3g} (atol {SIGNAL_ATOL}), "
                     f"tokens equal on the {int(clear.sum())} rows of a "
                     f"clear top-2 gap ({flips} differ)")
            ok = err <= SIGNAL_ATOL and flips == 0
        else:
            # bf16 flash against the plain attention: every position's
            # K/V in every layer after the first depends on the attention
            # below it; then the last position's logits (the kernel path
            # again, after the counts were read); then the step's signal
            # against the plain one on those logits, as phase 8 holds it
            cache_rel = max(position_rel(a, b) for a, b in
                            zip(_leaves(args_k[1]), ref_cache))
            k_logits = last_logits(args_k, True)
            logit_err = float((k_logits - ref_logits).abs().max())
            neg, _, tok = deferral_entropy_plain(k_logits)
            err = float((neg - out[1]).abs().max())
            top2 = torch.topk(k_logits, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > TIE_GAP
            flips = int((tok[clear] != out[0][clear]).sum())
            agree = (f"K/V worst position's relative error {cache_rel:.3g} "
                     f"(<= {PREFILL_CACHE_RTOL}), last position's logits "
                     f"max|d| {logit_err:.3g} (guard {PREFILL_LOGIT_GUARD}"
                     f"), {int((ref[0] != out[0]).sum())} of {B} tokens "
                     f"differ from the plain prefill's (no bound); the "
                     f"signal on the kernel path's logits: neg_entropy "
                     f"max|d| {err:.3g} (atol {SIGNAL_ATOL}), tokens equal "
                     f"on the {int(clear.sum())} rows of a clear top-2 gap "
                     f"({flips} differ)")
            ok = (cache_rel <= PREFILL_CACHE_RTOL
                  and logit_err <= PREFILL_LOGIT_GUARD
                  and err <= SIGNAL_ATOL and flips == 0)
            del ref_cache, ref_logits, k_logits, top2
        del out, ref
        k_ms = statistics.median(_step_ms(torch, kstep, lambda: args_k))
        del args_k
        torch.cuda.empty_cache()
        ratio = med / 1e3 / bound_s
        peak_err = abs(peak - tr["peak_bytes"]) / tr["peak_bytes"]
        print(f"[19b] {ARCH} {shape.name} ({cfg.n_layers} layers, bf16, world of one): "
              f"FLOPs meta {tr['flops']} / card {card_flops} "
              f"({'equal' if card_flops == tr['flops'] else 'DIFFER'}); "
              f"bytes {tr['bytes']}; compute {rep.compute_s * 1e3:.4g} ms, "
              f"memory {rep.memory_s * 1e3:.4g} ms -> bound "
              f"{bound_s * 1e3:.4g} ms ({rep.dominant}); plain step median "
              f"{med:.4g} ms of {[round(t, 3) for t in ms]} = "
              f"{ratio:.3f} x the bound (>= {ROOF_MIN_RATIO}); peak traced "
              f"{tr['peak_bytes'] / 2**30:.4g} GiB / measured "
              f"{peak / 2**30:.4g} GiB ({peak_err:.1%}, <= "
              f"{ROOF_PEAK_RTOL:.0%}); traced in {t_trace:.2f} s; kernel "
              f"path {k_ms:.4g} ms ({k_ms / 1e3 / bound_s:.3f} x the plain "
              f"count's bound, no guard), launches "
              f"{ {k: v for k, v in counts.items() if v} }, {agree}; plain "
              f"step under torch.profiler: device busy "
              f"{'none recorded' if busy is None else f'{busy:.4g} ms'}, top "
              f"kernels " + ", ".join(f"{n[:60]} {t:.4g}"
                                      for n, t in ranked[:3])
              + f"; {smi}")
        if not (card_flops == tr["flops"] and ratio >= ROOF_MIN_RATIO
                and peak_err <= ROOF_PEAK_RTOL and counts == want and ok):
            raise AssertionError(f"19b {shape.name}: flops {tr['flops']} vs "
                                 f"{card_flops}, ratio {ratio}, peak error "
                                 f"{peak_err}, launches {counts} != {want}, "
                                 f"agreement {ok}")
        by_path[f"roofline_{kind}"] = counts
    return by_path


def run_examples(src: Path, smi: str) -> None:
    """19c: the examples as child processes on the card at their defaults
    (the trainer at 20 + 10 steps), all four at once (their loops are
    host-bound): each must exit 0 and print its JSON result line last.
    Each one's wall runs from their common start to its exit; their
    output goes to chiprun_out/examples/."""
    import os
    env = dict(os.environ, PYTHONPATH=str(src))
    logs = ROOT / "chiprun_out" / "examples"
    logs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, walls = {}, {}
    try:
        for name, extra in EXAMPLES:
            with open(logs / f"{name}.out", "w") as out, \
                    open(logs / f"{name}.err", "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / name), *extra],
                    stdout=out, stderr=err, env=env, cwd=ROOT)
        while len(walls) < len(procs):
            if time.perf_counter() - t0 > EXAMPLE_TIMEOUT:
                raise AssertionError(f"19c: {sorted(set(procs) - set(walls))}"
                                     f" still running after "
                                     f"{EXAMPLE_TIMEOUT} s")
            for name, p in procs.items():
                if name not in walls and p.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, extra in EXAMPLES:
        out = (logs / f"{name}.out").read_text()
        last = (out.strip().splitlines() or [""])[-1]
        try:
            rec = json.loads(last)
        except ValueError:
            rec = {}
        rc = procs[name].returncode
        print(f"[19c] {name} {' '.join(extra)}: exit {rc} after "
              f"{walls[name]:.1f} s wall (the four together) on {smi}; "
              f"{last[:400]}")
        if rc != 0 or rec.get("example") != name[:-3]:
            raise AssertionError(
                f"19c {name}: exit {rc}\n{out[-2000:]}\n"
                f"{(logs / f'{name}.err').read_text()[-3000:]}")


def dryrun_phase(torch, smi, src: Path, t_start: float) -> dict:
    """Phase 19: 19a, 19b and 19c, one after another. Returns {path:
    launch counts}."""
    phase("19a", t_start)
    dryrun_combos(src, smi)
    phase("19b", t_start)
    by_path = roofline_on_card(torch, smi)
    phase("19c", t_start)
    run_examples(src, smi)
    return by_path


def _nm_exports(lib: Path) -> set:
    """The C-linkage (unmangled) functions a shared library exports."""
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return {parts[2] for parts in (line.split() for line in
                                   out.splitlines())
            if len(parts) == 3 and parts[1] in "TWi"
            and not parts[2].startswith("_Z")}


def analysis_phase(smi: str) -> None:
    """Phase 20: the port's static analysis, run on the machine that builds
    the kernels. (a) `python -m repro_torch.analysis` over the port and this
    script, as CI runs it, must exit 0 modulo analysis_baseline_torch.json;
    (b) each csrc/*.cu through `nvcc -E -x cu` with the build's flags must
    give the same extern "C" signatures as the raw source's parse (no macro
    hides a parameter); (c) each built library's exported C-linkage
    (unmangled) functions must be exactly the parsed extern "C" set; (d) a
    kernel module copied with one argtypes entry dropped must make the CLI
    exit 1 with KC001. Any failure raises."""
    import ast
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.analysis.core import SourceModule
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = [sys.executable, "-m", "repro_torch.analysis"]

    # (a) the gate, as CI runs it
    proc = subprocess.run(cli + ["--paths", "src/repro_torch",
                                 "chip_smoke.py", "--json"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"20a: the analysis exits {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    by_rule = {}
    for f in rep["new"] + rep["baselined"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    print(f"[20a] repro_torch.analysis: rc 0, {rep['n_files']} files, "
          f"findings by rule {json.dumps(by_rule, sort_keys=True)}, "
          f"{len(rep['baselined'])} baselined, {len(rep['new'])} new, "
          f"{len(rep['stale_baseline'])} stale")

    sources = sorted(_build.CSRC.glob("*.cu"))
    raw = {cu.stem: {s.name: s.abi for s in kc.c_signatures(cu.read_text())}
           for cu in sources}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def nvcc(args):
            return subprocess.run([_build.nvcc_path(), *args],
                                  capture_output=True, text=True)
        jobs = [["-E", "-x", "cu", *_build.NVCC_FLAGS, "-o",
                 str(tmp / f"{cu.stem}.ii"), str(cu)] for cu in sources]
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            procs = list(pool.map(nvcc, jobs))
        for job, p in zip(jobs, procs):
            if p.returncode != 0:
                raise AssertionError(f"20: nvcc {' '.join(job)} exits "
                                     f"{p.returncode}:\n{p.stderr[-3000:]}")

        # (b) preprocessed signatures against the raw source's
        for cu in sources:
            own = kc.own_text((tmp / f"{cu.stem}.ii").read_text(), str(cu))
            seen = {}
            for s in kc.c_signatures(own):
                if seen.setdefault(s.name, s.abi) != s.abi:
                    raise AssertionError(
                        f"20b {cu.name}: `{s.name}` preprocesses to two "
                        f"signatures: {seen[s.name]} and {s.abi}")
            if seen != raw[cu.stem]:
                raise AssertionError(f"20b {cu.name}: preprocessed "
                                     f"{seen} != raw {raw[cu.stem]}")
            print(f"[20b] {cu.name}: nvcc -E gives the raw extern \"C\" "
                  f"signatures: " + ", ".join(
                      f"{n}({len(a[1])})" for n, a in sorted(seen.items())))

        # (c) the built libraries' exports against the parsed set
        for cu in sources:
            lib = _build.library_path(cu.stem)
            exports = _nm_exports(lib)
            if exports != set(raw[cu.stem]):
                raise AssertionError(
                    f"20c {lib.name}: exports {sorted(exports)} != "
                    f"extern \"C\" {sorted(raw[cu.stem])}")
            print(f"[20c] {lib.name}: exports {sorted(exports)}")

        # (d) a seeded drop of one argtypes entry is caught as KC001
        kdir = tmp / "seeded" / "kernels"
        (kdir / "csrc").mkdir(parents=True)
        path = _build.CSRC.parent / "deferral_entropy.py"
        text = path.read_text()
        decl = next(iter(kc.KernelModule(SourceModule(
            str(path), path.name, text)).declarations.values()))
        names = {}
        for name, kind in kc.CTYPES_KINDS.items():
            names.setdefault(kind, name)
        lines = text.splitlines()
        indent = lines[decl.node.lineno - 1][:decl.node.col_offset]
        lines[decl.node.lineno - 1:decl.node.end_lineno] = [
            f"{indent}{ast.unparse(decl.node.targets[0])} = ["
            + ", ".join(f"ctypes.{names[k]}" for k in decl.argtypes[:-1])
            + "]"]
        (kdir / path.name).write_text("\n".join(lines) + "\n")
        (kdir / "csrc" / f"{decl.lib}.cu").write_text(
            (_build.CSRC / f"{decl.lib}.cu").read_text())
        proc = subprocess.run(cli + ["--paths", "kernels", "--root",
                                     str(kdir.parent), "--baseline", "",
                                     "--json"],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        got = (json.loads(proc.stdout)["new"] if proc.stdout.strip()
               else [])
        codes = sorted(f["code"] for f in got)
        if proc.returncode != 1 or "KC001" not in codes:
            raise AssertionError(f"20d: a dropped argtypes entry of "
                                 f"`{decl.fn}` gives rc {proc.returncode}, "
                                 f"codes {codes}\n{proc.stderr[-2000:]}")
        print(f"[20d] `{decl.fn}` with {len(decl.argtypes) - 1} of "
              f"{len(decl.argtypes)} argtypes: rc 1, {codes}")
    print(f"[20] static analysis and its card-side checks in "
          f"{time.perf_counter() - t0:.1f} s on {smi}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Chip smoke test of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the source directory whose repro_torch is built "
                         "and checked (default: this checkout's src)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernel phases of "
                         f"{','.join(KERNEL_PHASES)} to run alone after the "
                         "build: prints their records, no contract line")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a file holding the last line (the kernels' JSON "
                         "record) of a --kernels run of the parent tree: "
                         "phases 3d and 7a print each case's parent time")
    ap.add_argument("--ml-tier", action="store_true",
                    help="run only phase 4's main path and phase 14 (the "
                         "M_L tier) after the build: prints their lines, "
                         "no contract line")
    ap.add_argument("--decoders", action="store_true",
                    help="run only phase 15 (the four remaining decoders at "
                         "published widths) and their phase-5 fixtures "
                         "after the build: prints their lines, no contract "
                         "line")
    ap.add_argument("--ladder", action="store_true",
                    help="run only phase 16 (the three-tier ladder, "
                         "recalibration, semantic agreement and obs) after "
                         "the build: prints its lines, no contract line")
    ap.add_argument("--train-recurrent", action="store_true",
                    help="run only phase 17 (training rwkv6-3b and "
                         "zamba2-1.2b at published widths, remat and "
                         "attn_chunk) and phase 7a's loss kernel at their "
                         "two Stage-2 shapes after the build: prints their "
                         "lines, no contract line")
    ap.add_argument("--scale-out", action="store_true",
                    help="run only phase 18 (sharding, ParallelContext and "
                         "the expert- and sequence-parallel paths) after "
                         "the build: prints its lines, no contract line")
    ap.add_argument("--dryrun", action="store_true",
                    help="run only phase 19 (the dry-run of a combo per "
                         "family and shape kind, its roofline held against "
                         "the card, the examples) "
                         "after the build: prints its lines, no contract "
                         "line")
    ap.add_argument("--analysis", action="store_true",
                    help="run only phase 20 (the static analysis, the "
                         "preprocessed signatures, the libraries' exports, "
                         "a seeded argtypes drop) after the build: prints "
                         "its lines, no contract line")
    ap.add_argument("--ml-server", action="store_true",
                    help="run as phase 14c's M_L server process (this "
                         "script starts it): the full-width large tier "
                         "behind an MLServer until a shutdown frame")
    args = ap.parse_args(argv)
    if args.kernels is not None:
        bad = set(args.kernels.split(",")) - set(KERNEL_PHASES)
        if bad:
            ap.error(f"unknown kernel phases {sorted(bad)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = (KERNEL_PHASES if args.kernels is None
              else tuple(args.kernels.split(",")))
    src = args.src.resolve()
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        _fail_early(f"no repro_torch sources under {src}: run from the "
                    f"root of a repository checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail_early("torch.cuda.is_available() is False: this script "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    if args.ml_server:
        return ml_server_child(torch)
    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(tf32 matmul {torch.backends.cuda.matmul.allow_tf32})")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"[build] {line.strip()}")

    if args.ml_tier:
        return ml_tier_only(torch, smi, src, t_start)
    if args.scale_out:
        scale_out_phase(torch, smi, t_start)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.ladder:
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tfm
        with torch.inference_mode():
            ladder_phase(torch, tfm, serve, np.random.default_rng(SEED),
                         smi, src, t_start)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.train_recurrent:
        from repro_torch.configs import get_config
        from repro_torch.kernels import gatekeeper_loss as gk
        phase("7a (phase 17's loss shapes)", t_start)
        for arch in (RWKV_ARCH, ZAMBA_ARCH):
            c = get_config(arch)
            check_loss_kernel(torch, gk, smi, c.vocab_size, c.d_model,
                              LOSS_T, N_SLOTS, 0, arch)
            torch.cuda.empty_cache()
        train_recurrent_phase(torch, smi, t_start)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.decoders:
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tfm
        with torch.inference_mode():
            decoder_phase(torch, tfm, serve, np.random.default_rng(SEED),
                          smi, t_start)
            phase("5 (phase 15's archs)", t_start)
            reduced_fixtures(torch, serve, DECODER_ARCHS)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.dryrun:
        dryrun_phase(torch, smi, src, t_start)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.analysis:
        phase("20", t_start)
        analysis_phase(smi)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        return 0
    rng = np.random.default_rng(SEED)
    with torch.inference_mode():
        parent = (json.loads(args.parent.read_text().strip()
                             .splitlines()[-1]) if args.parent else None)
        records = check_kernels(torch, np, rng, smi,
                                [p for p in phases if p != "7a"], t_start,
                                parent)
    if args.kernels is not None:
        if "7a" in phases:
            phase("7a", t_start)
            from repro_torch.kernels import gatekeeper_loss as gk
            records["gatekeeper_loss_tokens"] = loss_phase(torch, gk, smi,
                                                           parent)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": list(records.values())}))
        return 0
    with torch.inference_mode():
        from repro_torch.configs import get_config
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tfm
        by_path = {}

        # -- 4. internlm2-1.8b at full width --------------------------------
        phase("4", t_start)
        t0 = time.perf_counter()
        small, large = serve.build_ladder(ARCH, SEED, 2, reduce=False,
                                          device=DEV)
        torch.cuda.synchronize()
        describe_ladder(torch, small, large, time.perf_counter() - t0)
        check_one_step(torch, tfm, small, rng, STEP_LOGIT_GUARD)
        check_prefill_paths(torch, tfm, small)
        report_profile(torch, tfm, small, rng, smi)
        L = small.cfg.n_layers
        by_path[ARCH], main_res, main_tau = serve_main_path(
            torch, small, large,
            {"paged_flash_decode_gqa": L, "paged_write_token": L}, smi)
        torch.cuda.empty_cache()
        # -- 8. the paper's cascade evaluation on the same models -----------
        phase("8", t_start)
        by_path["evaluation"] = evaluate_cascade(torch, small, large, smi)
        torch.cuda.empty_cache()
        # -- 13. memory pressure and overload on the same models ------------
        phase("13", t_start)
        probe = width_probe(torch, tfm, small, smi)
        by_path["pressure"], by_path["overload"] = pressure_phase(
            torch, tfm, small, large, main_tau, main_res, probe, smi)
        torch.cuda.empty_cache()
        # -- 14. the asynchronous and remote M_L tier on the same models ----
        procs = {}
        try:
            by_path.update(ml_tier(torch, tfm, small, large, main_tau,
                                   main_res, smi, procs, src, t_start))
            del small, large
            torch.cuda.empty_cache()
            by_path["pressure_reduced"] = reduced_pressure(torch, serve)
            phase("14d", t_start)
            by_path["ml_reduced"] = reduced_ml_backends(torch, serve, procs)
        finally:
            kill_ml_processes(procs)

        # -- 16. the three-tier ladder, recalibration, semantic agreement ---
        by_path.update(ladder_phase(torch, tfm, serve, rng, smi, src,
                                    t_start, probe))
        torch.cuda.empty_cache()

        # -- 6. DeepSeek-V2 (MLA + MoE) at full width -----------------------
        phase("6", t_start)
        t0 = time.perf_counter()
        small, large = serve.ladder_from_config(
            get_config(MLA_ARCH).replace(n_layers=MLA_SMALL_LAYERS), SEED,
            DEV)
        torch.cuda.synchronize()
        describe_ladder(torch, small, large, time.perf_counter() - t0)
        check_one_step(torch, tfm, small, rng, MLA_STEP_LOGIT_GUARD)
        report_profile(torch, tfm, small, rng, smi)
        L = small.cfg.n_layers
        by_path[MLA_ARCH] = serve_main_path(
            torch, small, large,
            {"paged_flash_decode_mla": L, "paged_write_token": L}, smi)[0]
        del small, large
        torch.cuda.empty_cache()

        # -- 9. rwkv6-3b at full width on the slot backend ------------------
        phase("9", t_start)
        t0 = time.perf_counter()
        small, large = serve.build_ladder(RWKV_ARCH, SEED, 2, reduce=False,
                                          device=DEV)
        torch.cuda.synchronize()
        describe_ladder(torch, small, large, time.perf_counter() - t0)
        check_slot_paths(torch, tfm, small, "rwkv", RWKV_LOGIT_GUARD)
        profile_slot_decode(torch, tfm, small, smi, "rwkv")
        by_path[RWKV_ARCH] = serve_slot_main_path(torch, tfm, small, large,
                                                  smi, "rwkv")
        del small, large
        torch.cuda.empty_cache()

        # -- 11. zamba2-1.2b at full width on the slot backend --------------
        phase("11", t_start)
        t0 = time.perf_counter()
        small, large = serve.build_ladder(ZAMBA_ARCH, SEED, 2, reduce=False,
                                          device=DEV)
        torch.cuda.synchronize()
        describe_ladder(torch, small, large, time.perf_counter() - t0)
        check_slot_paths(torch, tfm, small, "zamba2", ZAMBA_LOGIT_GUARD)
        profile_slot_decode(torch, tfm, small, smi, "zamba2")
        by_path[ZAMBA_ARCH] = serve_slot_main_path(torch, tfm, small, large,
                                                   smi, "zamba2")
        del small, large
        torch.cuda.empty_cache()

        # -- 15. the four remaining decoders at published widths -----------
        by_path.update(decoder_phase(torch, tfm, serve, rng, smi, t_start))

        # -- 5. reduced fp32 fixtures: kernel paths == plain paths ----------
        phase("5", t_start)
        reduced_fixtures(torch, serve,
                         (ARCH, MLA_ARCH, RWKV_ARCH, ZAMBA_ARCH)
                         + DECODER_ARCHS)

    # -- 10. the classifier cascade (it trains: outside inference mode) -----
    phase("10", t_start)
    by_path["classifier"] = classifier_cascade(torch, smi)
    torch.cuda.empty_cache()

    # -- 12. whisper-small and phi-3-vision-4.2b through launch.steps -------
    phase("12", t_start)
    serving, stage2 = steps_families(torch, smi)
    by_path.update(serving)
    torch.cuda.empty_cache()

    missing = [k for k in KERNELS
               if not sum(counts[k] for counts in by_path.values())]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts in by_path.values())
        rec["launches_by_path"] = {arch: counts[name]
                                   for arch, counts in by_path.items()
                                   if counts[name]}

    # -- 7. training ---------------------------------------------------------
    phase("7", t_start)
    from repro_torch.kernels import gatekeeper_loss as gk
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    rec = loss_phase(torch, gk, smi)
    n = train_main_path(torch, gk, train, smi)
    rec.update(launches=n + sum(stage2.values()),
               launches_by_path={"train": n, **stage2})
    torch.cuda.empty_cache()
    reduced_training_fixture(torch, train)

    # -- 17. training RWKV6 and the Mamba2 hybrid, remat, attn_chunk --------
    by_train = train_recurrent_phase(torch, smi, t_start)
    rec["launches"] += sum(c["gatekeeper_loss_tokens"]
                           for c in by_train.values())
    chunked = records["wkv_scan_chunked"]
    chunked["launches"] += sum(c["wkv_scan_chunked"]
                               for c in by_train.values())
    for path, counts in by_train.items():
        rec["launches_by_path"][path] = counts["gatekeeper_loss_tokens"]
        chunked["launches_by_path"][path] = counts["wkv_scan_chunked"]

    # -- 18. sharding and the expert- and sequence-parallel paths -----------
    # -- 19. the dry-run, its roofline against the card, the examples ------
    for path, counts in {**scale_out_phase(torch, smi, t_start),
                         **dryrun_phase(torch, smi, src,
                                        t_start)}.items():
        for name, n in counts.items():
            r = rec if name == "gatekeeper_loss_tokens" else records[name]
            if n:
                r["launches"] += n
                r["launches_by_path"][path] = n

    # -- 20. the static analysis and its card-side checks ------------------
    phase("20", t_start)
    analysis_phase(smi)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[k] for k in KERNELS] + [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def prepare_decode(torch, tfm, params, cfg, rng, paged_kernel=None,
                   cache_dtype=None) -> dict:
    """Prefill 8 ragged full-width prompts into a paged cache (bf16 unless
    `cache_dtype` says otherwise): the state of one decode step of the
    main path (`paged_kernel` picks the prefill attention; None: the
    kernel, on the card)."""
    lens = rng.integers(RAGGED[0], RAGGED[1] + 1, size=N_SLOTS)
    per_row = math.ceil((RAGGED[1] + MAX_NEW) / BLOCK)
    tables = torch.zeros((N_SLOTS, per_row + 1), dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(N_SLOTS * per_row).astype("int32")
                            + 1)
    for b in range(N_SLOTS):
        n = math.ceil((int(lens[b]) + 1) / BLOCK)
        tables[b, :n] = perm[b * per_row:b * per_row + n]
    tables = tables.to(DEV)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(N_SLOTS, int(lens.max())))).to(DEV)
    cache = tfm.init_cache(cfg, N_SLOTS * per_row + 1, BLOCK,
                           dtype=cache_dtype or torch.bfloat16, device=DEV)
    logits, cache = tfm.prefill(params, cfg, toks, cache, pages=tables,
                                last_index=torch.from_numpy(lens - 1).to(DEV),
                                paged_kernel=paged_kernel)
    return dict(tables=tables, cache=cache, logits=logits[:, 0],
                tok=torch.argmax(logits[:, 0], -1).to(torch.int32),
                pos=torch.from_numpy(lens.astype("int32")).to(DEV))


@contextlib.contextmanager
def recorded_routes(torch):
    """Within the block, every MoE routing call appends its top-k expert
    sets ([tokens, k], sorted) to the list it yields."""
    from repro_torch.models import ffn
    route, seen = ffn._route, []

    def recording(*args):
        res = route(*args)
        seen.append(torch.sort(res[1], dim=-1).values)
        return res
    ffn._route = recording
    try:
        yield seen
    finally:
        ffn._route = route


def decode_step_check(torch, tfm, params, cfg, rng):
    """One decode step through the kernel path and through the plain path,
    on copies of one prepared cache, recording each MoE layer's top-k
    expert set per row. Returns (max |logit difference| over the rows whose
    expert sets agree in every layer, argmax agreement, logit std, the rows
    whose sets differ, max |logit difference| over those rows)."""
    d = prepare_decode(torch, tfm, params, cfg, rng)
    out, experts = {}, {}
    for kernel in (True, False):
        c = {kind: {k: v.clone() for k, v in leaves.items()}
             for kind, leaves in d["cache"].items()}
        with recorded_routes(torch) as experts[kernel]:
            out[kernel], _ = tfm.decode_step(params, cfg, d["tok"], d["pos"],
                                             c, pages=d["tables"],
                                             paged_kernel=kernel)
    torch.cuda.synchronize()
    if not torch.isfinite(out[True]).all() or out[True].shape != (
            N_SLOTS, cfg.vocab_size):
        raise AssertionError("full-width decode step: bad logits")
    same = torch.ones(N_SLOTS, dtype=torch.bool, device=DEV)
    for a, b in zip(experts[True], experts[False]):
        same &= (a == b).all(-1)
    row_err = (out[True] - out[False]).abs().amax(-1)
    err = float(row_err[same].max()) if bool(same.any()) else math.inf
    flip_err = float(row_err[~same].max()) if not bool(same.all()) else 0.0
    agree = float((out[True].argmax(-1) == out[False].argmax(-1)).float().mean())
    return (err, agree, float(out[False].std()),
            (~same).nonzero()[:, 0].tolist(), flip_err)


def profile_decode(torch, tfm, params, cfg, rng, steps: int = 5):
    """Main-path decode steps (kernels on, each with its deferral signal)
    timed on the host clock, then again under torch.profiler for the
    device-busy time. Returns (wall ms per step, device-busy ms per step
    or None, [(kernel, ms per step)])."""
    from repro_torch.kernels import ops as kernel_ops
    d = prepare_decode(torch, tfm, params, cfg, rng)

    def run():
        for _ in range(steps):
            logits, _ = tfm.decode_step(params, cfg, d["tok"], d["pos"],
                                        d["cache"], pages=d["tables"],
                                        paged_kernel=True)
            kernel_ops.deferral_signal(logits)
        torch.cuda.synchronize()
    return profile_steps(torch, run, steps)


def profile_steps(torch, run, steps: int, warm: bool = False):
    """`run()` (which runs `steps` steps and synchronises) once to warm
    up, once on the host clock, once under torch.profiler; only the last
    when `warm` (the wall is then None). Returns (wall ms per step,
    device-busy ms per step or None, [(kernel, ms per step)] from the
    largest)."""
    from torch.profiler import ProfilerActivity, profile
    wall_ms = None
    if not warm:
        run()                                         # warm-up
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    busy = sum(by_name.values()) or None
    return wall_ms, busy, sorted(by_name.items(), key=lambda kv: -kv[1])


if __name__ == "__main__":
    sys.exit(main())
