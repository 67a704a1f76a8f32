#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (deepspeed_tpu_torch) starts
on one NVIDIA GPU, trains and serves through its hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure raises and exits nonzero):

1. build   - compile every kernel from deepspeed_tpu_torch/csrc/*.cu with
             nvcc for sm_90a, one nvcc per source, all in parallel
             (ops/cuda/build.py; into build/kernels/); the build line
             gives each source's seconds, flash_fwd's on its own.
2. kernels - call each kernel's wrapper on CUDA tensors at the shapes its
             path gives it (the flash kernels at the training shape B=8,
             S=2048, the serving kernels at the serving shapes) and hold the
             result against its plain PyTorch version on the same inputs
             (the flash forward at the training shape also launched twice,
             bit-identical, with two faults aimed at its wgmma/TMA design
             that must fail the o check: the diagonal tile taken unmasked,
             and one K/V ring stage consumed before its barrier, a stale
             tile; and the host time to encode its TMA maps; for the flash
             backward, two faults planted in the kernels'
             output must fail that check, a second launch of #2 and #3
             must be bit-identical, and faults aimed at their wgmma/TMA
             design must fail it: a ring stage read before its barrier
             (dkv on Q/dO whose tile FLASH_BWD_STAGES holds tile 0's
             rows, dq on such K/V) and the diagonal tiles taken
             unmasked); the int8 KV kernels' codes and scales bit for
             bit, with .5 ties, zero rows and subnormal rows, where a
             quantizer rounding ties away from zero must
             fail, and a case where dequantizing without the bf16 rounding
             must fail); the sliding-window modes of #1-#5 at the Mistral 7B
             shapes (flash at B=1, S=8192, 32 x 128 heads over 8 KV heads;
             decode at 8 rows with ctx 100..8000) for windows 4096, 1000 and
             1, window >= S (or ctx) bit-identical to window 0, two
             flash launches at window 4096 bit-identical, and planted
             faults that must fail: a band one column wider, a decode that
             starts at column 0, and at window 4096 two faults of the flash
             output alone (a K/V tile's PV term dropped, the PV sum x1.02);
             the ALiBi modes of #1, #4 and #5: flash at BLOOM-7B1's prefill
             shape (B=1, S=512, 32 x 128 heads), at falcon-rw-1b's head_dim
             64 with its slope scale, with GQA, with 24 heads (no power of
             two) and with window 1000 (S=2048); decode in all four modes at
             8 rows with ctx ~100 to ~2,000, 32 x 128 heads, without and
             with window 1000; all-zero slopes and windows >= S (or ctx)
             bit-identical to the existing modes, and planted faults that
             must fail: the slopes rotated by one head, the flash bias with
             its sign flipped, with GQA each q head given its KV head's
             slope, the fused new column biased at position 0; the ALiBi
             modes of #2 and #3 at S=2048 (Bloom's 32 x 128 heads,
             falcon-rw-1b's 32 x 64 with its slope scale, GQA 32 / 8, 24
             heads, window 1000) against the plain backward on the kernel
             forward's o and lse, all-zero slopes and windows >= S
             bit-identical, and faults in the backward alone that must
             fail: slopes rotated, sign flipped, with GQA the KV head's
             slope, the bias dropped; the layout-bitmap modes of #4 and #5
             in all four decode modes at Llama-2-7B's shape (8 rows with ctx
             ~100 to ~4,000, 32 x 128 heads) at 128-token cache blocks and
             at 16-token ones (DeepSpeed's FixedSparsityConfig block, where
             a kernel tile spans four blocks), with the fixed layout's rows,
             a bigbird layout's and random bitmaps, an all-ones bitmap
             bit-identical to none, and planted faults that must fail: the
             kernel given all ones, the bitmap shifted by one block, at bs
             16 each group of four blocks given its first block's bit; the
             wide-group modes of #4 and #5 (all four decode modes at
             Falcon-7B's 71 query heads of 64 over one KV head and at GQA
             16 over 2, 8 rows with ctx ~100 to ~1,950) and the head_dim-80
             modes of #1, #4, #5 and #6 (flash at Phi-2's prefill shapes,
             B=1, S=512 and 2048, 32 x 80; decode in all four modes; both
             writes bit-exact), and flash at Falcon-7B's prefill shape
             (S=1920, 71 x 64 over 1), with planted faults that must fail:
             chunks c > 0 given chunk 0's query heads, the partial last
             chunk dropped, in the int8 fused mode chunks attending the
             un-rounded new column, at head_dim 80 the output's columns
             64-79 left zero and the scores taken over the first 64 dims;
             the head_dim-96 and head_dim-256 modes of #1, #4, #5 and #6
             (wide_head_checks, GPT-NeoX-20B's 64 x 96 and GPT-J-6B's 16 x
             256 heads: flash at B=1, S=512 and 2048, with window 1000,
             with ALiBi and with GQA 32 over 2; decode in all four modes
             at 8 rows with ctx ~100 to ~1,950 and at GQA 32 over 2; both
             writes bit-exact at the 1920-token prefill), two launches
             bit-identical, with planted faults that must fail: flash's O
             columns 64-95 (D 96) or 128-255 (D 256) left zero and the
             scores over the dims below, decode's output with columns
             80-95 (D 96) or 128-255 (D 256) zeroed (what dropping the last
             P V column-tile pair or the second half of the column tiles
             leaves), the int8 write at D 256 with each lane's second chunk
             unwritten and with the amax over 128 of 256 columns; and two
             faults planted in the D-256 code by a define (FAULT_BUILDS,
             built beside the kernels): flash's pv_step without its second
             wgmma (columns 128-255), and decode's per-tile Q fragments of
             the 16-row slices (GQA 32 over 2) read one k-step ahead; the
             new instantiations' ptxas registers and spills;
             the head_dim-80, -96 and -256 and wide-group modes of #2 and
             #3 at S=2048 (Phi-2's training micro-batch B=2, 32 x 80; GQA
             40 over 2 at 80; window 1000 and ALiBi slopes at 80;
             Falcon-7B's training micro-batch B=4, 71 x 64 over one KV
             head; GQA 16 over 2; GPT-NeoX-20B's B=2, 64 x 96 and
             GPT-J-6B's B=4, 16 x 256; GQA 32 over 2, window 1000 and ALiBi
             at 96 and at 256) against the plain backward on the kernel
             forward's o and lse, every launch counted in its modes, two
             launches bit-identical, with planted faults that must fail:
             the gradients' columns 64-79 (D 80), 80-95 (D 96) or 128-255
             (D 256) zeroed and the scores taken over the first 64, 64 or
             128 dims, at D 256 dkv built with its P^T hand-off losing the
             second 32 queries of each tile (FAULT_BUILDS), in a wide group
             dk and dv summed without the group's last chunk of 8 heads
             (at 71 over 1 the first 64 heads) and each q head given KV
             head (h // 8) % KV; at Falcon-7B's shape the group split of
             #3 (its plan and scratch bytes printed), two launches
             bit-identical and one chunk's partial left out of the
             combining pass, which must fail (and the same at GQA 32 over
             2 at 96 and 256); the D-96 and D-256 instantiations' ptxas
             registers and spills; the split-K design of #4/#5
             at Falcon-7B's and Mistral's decode rows in all four modes
             (decode_design_checks): two launches bit-identical, and
             planted faults that must fail: one split left out of the
             combine, the fused new column attended by every split, each
             split's last cache position dropped, one ring stage consumed
             stale; the plans, scratch bytes, ptxas registers and spills;
             the W8A16 GEMM of the int8-weight lane (int8_matmul) at every
             per-channel int8 product of the served shapes (INT8_MM_SHAPES:
             the flagship's, Llama-2-7B's, Falcon-7B's at K 4544, BLOOM-7B1's
             and Phi-2's logits, tails in K and N) at M = 1, 8, 32, 64, 512,
             768 and 4096 in both output forms, codes with both extremes and
             a zero column: its error against the exact (f64) product within
             1.5x (RMS) and 2x (max) of the plain bf16 version's, two
             launches bit-identical, timed cold (weights rotated past the
             L2) and warm beside cuBLAS bf16 on the codes as bf16 weights,
             and planted faults that must fail: each scale on the next
             column, the last 128-deep unit dropped, the K tail dropped,
             the codes read as unsigned, the tied [V, E] codes read as
             [E, V], a cut tile's partial left out, a ring stage consumed
             stale, a warpgroup given the next 64 channels, a tile stored
             untransposed, rows past M stored (M 5 and 33); its design line
             (int8_matmul_design_checks: ptxas, shared memory, stages,
             CTAs an SM, host us a call for the tensor maps);
             time kernel, plain version and (where one exists) a single
             PyTorch library call computing the same function: device time
             from torch.profiler, and the time of back-to-back calls from
             CUDA events.
3. train   - initialize() the flagship Llama (24 layers, d_model 1024, 8 x
             128 heads, vocab 32000, remat save_attn_qkv, random weights
             from a seeded torch.Generator) in bf16 with an fp32 master,
             AdamW, clipping 1.0 and loss_chunks 16, and train on a fixed
             [8, 2049] batch: one step with every launch counter at 0 (each
             flash kernel must launch once per layer), then more steps over
             which the loss must fall. Checks: finite loss and grad norm;
             per-token loss and gradients of the kernel path no further
             from the f32 plain path than the bf16 plain path is (B=1,
             S=2048). Then times steps with CUDA events (tokens/s, MFU),
             profiles where one step's time goes, and reads peak memory.
4. serve   - init_inference on the same model shape in bf16, then drive the
             serving path once with every launch counter at 0: one prefill
             put of 8 x 96-token prompts plus one 512-token prompt, a
             single-token decode put, a 2-token continuation put, and greedy
             decode_multi_fn(8, 24). Every serving kernel must have
             launched. Checks: finite logits and tokens in range; prefill
             and decode logits of the kernel path no further from the f32
             plain path than the bf16 plain path is. Then times TTFT of a
             512-token prompt and batch-8 decode throughput, and profiles
             where the time goes in each.
4b. serve_int8 - the same model and counted sequence on int8 KV pools
             (kv_cache_dtype="int8"), plus a put of the 512-token prompt's
             first 256 tokens: a full prefix hit, capped at len - 1, whose
             tail block is copied with its scale tiles. Only the three int8
             kernels and flash_fwd may launch, each at least once. Checks:
             as phase 4 against the plain int8 paths; one fused decode step
             whose pools equal the plain quantizing write of the same rows
             bit for bit in every layer (and the bf16 plain path's pools in
             layer 0); bf16 / int8 kv_bytes_per_token >= 1.8; a prefix hit
             and a COW copy. Reports the int8 - bf16 engine logit gap, TTFT
             and decode throughput.
4x. serve_graphs (run after 4b) - engine.warmup() captures the decode
             programs as CUDA graphs (inference/graphs.py) and every replay is
             held against an eager call of the same program from the same
             cache state, bit for bit (tokens, final logits). The flagship
             on bf16 and int8 pools (64 x 96-token prompts): warmup(widths
             [8, 32, 64], decode_chunks [24]) and again with bench.py's
             sampling config (T 0.9, top-k 40, top-p 0.95) at width 32;
             greedy decode_multi_fn(b, 24) at b = 8, 32, 64 and the sampled
             lane at 32 (keys _row_keys(0, arange(32)), counters from ctx)
             replayed, the sampled lane's every token equal to the CPU
             oracle's (host_oracle_token on the step's logits, replayed
             stepwise on the card). Every 7B server, Phi-2, GPT-NeoX-20B
             and GPT-J-6B (SERVED_7B at full width, GRAPH_7B_LAYERS = 8
             layers deep; bf16 and int8 pools; the long prompt and 7 x
             96): width 8, 24 steps, greedy. Planted faults that must fail the check, each
             beside its genuine case: a stale table buffer, weights kept
             stale after refresh_params, a replay without clones, keys not
             copied, the decode workspace replaced after capture. Reports
             eager and replayed decode ms, tok/s, busy ms and idle share,
             the host us to issue a replay, the warmup footprints, the
             graph counts; the launches of one eager call of each flagship
             program are the phase's.
4w. serve_int8w (run after 4x) - the per-channel int8 weight lane
             (init_inference(..., quantization={"bits": 8, "per_channel":
             True}), bench.py's _serving_bench lane and _serving_7b_bench):
             the flagship's weights from bf16 and from int8 KV pools (64 x
             96-token rows, warmup and replays at b = 8 and 64), and
             Llama-2-7B at bench.py's widths (random weights built and
             quantized layer by layer on the card, b = 1, 8, 32), with its
             bf16 engine on the same weights beside it. Counted: a wave of
             8 x 96, the 512-token prompt, one eager decode_multi_fn(b,
             24): the W8A16 GEMM launches once per quantized product of
             every forward (4 a layer + the logits), with the attention
             kernels of the pools and nothing else. Checks: resident weight
             bytes at most 0.51x the bf16 engine's; prefill and decode
             logits of the kernel path within 1.5x / 2x of the bf16 plain
             path's error against the f32 plain path on the same codes;
             replays bit-identical to eager; no library GEMM in a replayed
             call. Reports TTFT at 512 and eager and replayed tok/s at
             each width beside the bf16 engine's of this run.
4y. serve_scheduler (run after 4w) - the serving control plane
             (inference/scheduler.py ServingScheduler) on the flagship at
             full width and depth, bf16 weights and pools (SCHED_SERVE: 80
             blocks of 128 tokens, max batch 32), SCHED_CONFIG (chunked
             prefill of 256, 2048 batched tokens, fused depth 8, warmup,
             pressure governor (RED at 0.95, brownout at 0.98) with a 512
             MiB HostKvSpillStore): a greedy
             trace of 64 requests (SCHED_TRACE: 64-1536-token prompts, 16
             sharing a 512-token prefix, 32-128 new tokens; 8 arrive at
             step 0 and 4 at each step after), then a sampled trace of 16
             (bench.py's sampling config) through prefill waves. Counted,
             each run eagerly with its graphs set aside: the first wave
             (#1 and #6 once a layer), the first shared-table mixed step
             (#6 and #4 plain once a layer, #5 never) and the first fused
             step of depth 8 (#5 8 x layers times); nothing else of #1-#6
             launches, and no other decode dispatch runs eagerly. Checks:
             every request ends by length with its token count, the pool
             holds no live block at the end, preemptions, spills and
             spill resumes > 0, the counted mixed step rerun from copied
             pools on the plain path (bf16 and f32) within 1.5x RMS / 2x
             max of the plain bf16 path's error, and a chained step (a
             replay fed the previous step's device tokens) held the same
             way, where a replay that skips the token copy must fail.
             Reports TTFT p50/p99, TPOT p50, output tok/s, steps, wall ms
             a step and the idle share of a steady window of steps.
4z. kv_handoff - export_kv from engine A (8 prompts of 96-1920 tokens,
             prefilled) into engine B of the same weights and geometry,
             from bf16 and from int8 pools: decode_multi_fn(8, 24) on B
             bit-identical to A's own continuation (tokens and final
             logits), page bytes = kv_payload_nbytes(n_blocks); a payload
             with a flipped bit (corrupt_payload) refused with
             HandoffIntegrityError and an int8 payload without its scales
             with KvCacheDtypeError, each before B allocates a block and
             beside its genuine case. Reports export and import ms a
             sequence and the digest's ms in them.
4c. serve_window - Mistral 7B (MISTRAL: 32 layers, d_model 4096, 32 x 128
             query heads over 8 KV heads, d_ff 14336, vocab 32000, untied
             lm_head, sliding window 4096; random bf16 weights, seed 0) in
             init_inference on bf16 pools (SERVE_W: 512 blocks of 128
             tokens), counted: a 6144-token prompt, a wave of 7 x 96-token
             prompts, a single-token decode put, a 2-token continuation of
             the long sequence (the plain-mode decode past the window) and
             greedy decode_multi_fn(8, 24). #1, #4, #5 and #6 must launch,
             each attention launch in its window mode. Checks: finite
             logits; prefill and decode logits of all 32 layers by the
             kernel path within 1.5x / 2x of the bf16 plain path's error
             against f32 (the f32 path casts one layer's weights at a
             time); locality: every pool row of the long sequence left of
             the window set to NaN in every layer, the next decode's logits
             finite and bit-identical. Reports TTFT of a
             6144-token prompt, batch-8 decode throughput, where the time
             goes, peak memory.
4d. serve_window_int8 - the same on int8 pools and the same weights; only
             the int8 kernels and flash_fwd may launch; the checks against
             the plain int8 paths.
4e. train_window - Mistral 7B's width, 4 layers deep (the whole model's
             weights, fp32 master and Adam moments would not fit), with the
             flagship's settings on one 8192-token sequence a step: one
             counted step (#1-#3 once per layer, each in its window mode),
             the loss falling over 6 steps; per-token loss and gradients of
             2 layers at S=6144 against the plain paths. Reports step ms,
             tokens/s, MFU, peak memory, where the time goes.
4f. serve_alibi - BLOOM-7B1 (BLOOM: 30 layers, d_model 4096, 32 x 128
             heads, d_ff 16384, vocab 250880, ALiBi, LayerNorm, biases, an
             embedding LayerNorm, tied embeddings; random bf16 weights, seed
             0) in init_inference on bf16 pools (SERVE_A: 128 blocks of 128
             tokens, max_seq_len 2048), after the Mistral weights are freed;
             counted: a 1920-token prompt, a wave of 7 x 96-token prompts, a
             single-token decode put, a 2-token continuation of a wave row
             (the plain-mode decode) and greedy decode_multi_fn(8, 24), the
             long row at ctx 1921-1944. #1, #4, #5 and #6 must launch, each
             attention launch in its ALiBi mode. Checks: finite logits;
             prefill and decode logits of all 30 layers by the kernel path
             within 1.5x / 2x of the bf16 plain path's error against f32.
             Reports TTFT of fresh 512- and 1920-token prompts, batch-8
             decode throughput, where the time goes, peak memory.
4g. serve_alibi_int8 - the same on int8 pools and the same weights; only
             the int8 kernels and flash_fwd may launch; the checks against
             the plain int8 paths.
4j. serve_sparse (run after 4g) - Llama-2-7B (LLAMA2_7B: 32 layers,
             d_model 4096, 32 x 128 heads, d_ff 11008, vocab 32000, untied;
             random bf16 weights, seed 0) with a fixed block-sparse layout
             (block 128, 4 local blocks, 1 global) in init_inference on
             bf16 pools (SERVE_S: 80 blocks of 128 tokens, max_seq_len
             4096), after BLOOM's weights are freed; counted: a 3968-token
             prompt, a wave of 7 x 96-token prompts, a single-token decode
             put, a 2-token continuation of the long sequence (the
             plain-mode kernel with a bitmap at ctx ~3970), greedy
             decode_multi_fn(8, 24) and a 40-token prompt (the masked
             prefill). #4, #5 and #6 must launch and nothing else (no
             flash: the prefill is the block gather), each decode launch in
             its layout-bitmap mode. Checks: finite logits; prefill and
             decode logits of all 32 layers by the kernel path within 1.5x
             / 2x of the bf16 plain path's error against f32 (the plain
             path's decode takes the per-position mask); locality: NaN in
             every pool row of the long sequence that its layout row does
             not attend, in every layer, the next decode's logits (fused
             and plain mode) finite and bit-identical. Reports TTFT of
             fresh 512- and 3968-token prompts, batch-8 decode throughput,
             where the time goes, peak memory.
4k. serve_sparse_int8 - the same on int8 pools and the same weights; only
             the int8 kernels may launch; the checks against the plain int8
             paths.
4l. serve_falcon (run after 4k) - Falcon-7B (FALCON_7B: 32 layers, d_model
             4544, 71 query heads of 64 over one KV head, d_ff 18176, vocab
             65024, erf GELU, one LayerNorm shared by the parallel
             attention and MLP, no biases, tied; random bf16 weights, seed
             0) in init_inference on bf16 pools (SERVE_A), with BLOOM's
             counted traffic: a 1920-token prompt, 7 x 96, a decode put, a
             2-token continuation of a wave row and greedy
             decode_multi_fn(8, 24). #1, #4, #5 and #6 must launch, every
             attention launch in its wide-group mode. Checks: finite
             logits; prefill and decode logits of all 32 layers by the
             kernel path within 1.5x / 2x of the bf16 plain path's error
             against f32. Reports TTFT of fresh 512- and 1920-token
             prompts, batch-8 decode throughput, where the time goes, peak
             memory. serve_falcon_int8: the same on int8 pools, the same
             weights, all 32 layers, against the plain int8 paths.
4m. serve_phi - Phi-2 (PHI_2: 32 layers, d_model 2560, 32 heads of 80,
             partial rotary 0.4, d_ff 10240, vocab 51200, tanh GELU, one
             shared LayerNorm, biases everywhere, an untied lm_head with
             its bias; random bf16 weights, seed 0, every bias drawn too)
             as 4l, every launch of #1, #4, #5 and #6 in its head_dim-80
             mode; serve_phi_int8 likewise.
4p. serve_neox - GPT-NeoX-20B (GPT_NEOX_20B: 44 layers, d_model 6144,
             64 heads of 96, rotary on 24 of 96 dims in split halves, two
             LayerNorms and the parallel residual, biases, tanh GELU,
             untied, vocab 50432; random bf16 weights, seed 0, drawn one
             layer at a time) in init_inference on bf16 pools (SERVE_NEOX:
             64 blocks of 128), BLOOM's counted traffic; #1, #4, #5 and #6
             must launch and nothing else, every launch in its head_dim-96
             mode (the fused decode is #4's bf16 fused-write mode, as the
             JAX package routes D % 128 != 0); the three-path check of all
             44 layers; TTFT at 512 and 1920 tokens, batch-8 decode, where
             the time goes, peak memory (under 76 GiB). serve_neox_int8:
             the same on int8 pools.
4q. serve_gptj - GPT-J-6B (GPT_J_6B: 28 layers, d_model 4096, 16 heads
             of 256, interleaved rotary on 64 of 256 dims, one shared
             LayerNorm, unbiased attention, a biased MLP and lm_head) as
             4p on SERVE_A, every launch in its head_dim-256 mode (the
             fused decode is #5 there); serve_gptj_int8 likewise.
4h. train_alibi - BLOOM-7B1's width, 4 layers deep (all 30 with fp32
             master and Adam moments are 113 GB), with the flagship's
             settings on a 4 x 2048 micro-batch, as train_window: one
             counted step (#1-#3 once per layer, each in its ALiBi mode),
             the loss falling over 6 steps; per-token loss and gradients
             of 2 layers at S=2048 against the plain paths. Reports step
             ms, tokens/s, MFU, peak memory, where the time goes.
4i. train_alibi_falcon_rw - falcon-rw-1b (FALCON_RW) whole, 24 layers,
             1.31B parameters, micro-batch 8 x 2048; the same checks (the
             D=64 ALiBi backward on a training path).
4n. train_falcon - Falcon-7B's width (FALCON_7B: 71 query heads of 64
             over one KV head, parallel residual, one shared LayerNorm), 4
             layers deep (all 32 with fp32 master and Adam moments are
             ~150 GB), 1.12B parameters, micro-batch 4 x 2048, as
             train_alibi: one counted step (#1-#3 once per layer, each in
             its wide-group mode, and nothing else), the loss falling over
             6 steps, the three-path check at 2 layers and S=2048.
4o. train_phi - Phi-2 (PHI_2: 32 heads of 80, partial rotary, biases, an
             untied biased lm_head) whole, 32 layers, 2.78B parameters,
             micro-batch 2 x 2048; the same checks, every launch of #1-#3
             in its head_dim-80 mode.
4r. train_neox - GPT-NeoX-20B's width (GPT_NEOX_20B: 64 heads of 96,
             partial rotary, two LayerNorms and the parallel residual,
             biases), 4 layers deep (all 44 with fp32 master and Adam
             moments are ~411 GB), 2.43B parameters, micro-batch 2 x
             2048; the same checks, every launch of #1-#3 in its
             head_dim-96 mode; peak memory under 76 GiB.
4s. train_gptj - GPT-J-6B's width (GPT_J_6B: 16 heads of 256,
             interleaved rotary, one shared LayerNorm, an lm_head bias), 4
             layers deep (all 28: ~121 GB), 1.22B parameters, micro-batch
             4 x 2048; the same checks, every launch of #1-#3 in its
             head_dim-256 mode; peak memory under 76 GiB.
5. evoformer - DS4Sci evoformer attention (ds4sci_evoformer_attention) at
             AlphaFold 2 / OpenFold widths, bf16, three cases (EVO_CASES):
             for each, one forward and backward with every launch counter
             at 0 (each evoformer kernel must launch exactly once). Checks:
             o and the five gradients of the kernel path no further from
             the f32 plain path than the bf16 plain path is; the fwd+bwd
             peak memory (#10's f32 scratch included) under one f32
             [G, N, N] logits tensor. Then times forward and
             forward+backward, beside SDPA with the biases as a
             materialised mask. (Phase 2 holds each of the four kernels
             against its plain version at E1 and E3, with four planted
             faults in the outputs at E1 that must fail that check, and
             evo_design_checks at both: #7 and #10 launched twice,
             bit-identical, and faults aimed at their wgmma/TMA design
             that must fail it: a stale K/V ring tile, #7's bias2 band of
             the wrong head or query tile, bias1 staged one key off, a
             chunk of #10's sequence split left out of the combining
             pass; the sequence plans, #10's scratch bytes and the new
             kernels' ptxas registers and spills.)
6. report  - one JSON line with every kernel's launches (per path and in
             all), error and times beside its bound; the card's name and
             power limit; and last, {"ok": true, "device": {...}}.

Exits nonzero without a result when no CUDA device is present or when the
package is not beside this script.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FLAGSHIP = dict(vocab_size=32000, n_layers=24, n_heads=8, d_model=1024, max_seq=2048,
                variant="llama")
SERVE = dict(max_seq_len=1024, kv_block_size=128, num_kv_blocks=64,
             min_prefill_bucket=64, max_batch_size=64)
N_PROMPTS, PROMPT_LEN, LONG_LEN, DECODE_STEPS = 8, 96, 512, 24
PROMPT_BUCKET = 128  # the prefill bucket of a 96-token prompt at min_prefill_bucket 64

# the training path: bench.py's flagship train step on one GPU
TRAIN_MODEL = dict(FLAGSHIP, remat="save_attn_qkv", use_flash=True, flash_block_q=1024,
                   flash_block_k=1024)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.1}},
                "zero_optimization": {"stage": 1}, "bf16": {"enabled": True},
                "gradient_clipping": 1.0, "steps_per_print": 10**9}
TRAIN_B, TRAIN_S, LOSS_CHUNKS = 8, 2048, 16
TRAIN_STEPS, TIMED_STEPS = 8, 5  # loss must fall over TRAIN_STEPS; then time TIMED_STEPS
H100_BF16_FLOPS = 989e12

# kernel -> (source, TPU kernel it replaces: the pl.pallas_call site)
KERNELS = {
    "paged_kv_write": ("deepspeed_tpu_torch/csrc/paged_kv_write.cu",
                       "deepspeed_tpu/ops/pallas/paged_attention.py:889"),
    "paged_decode_fused": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                           "deepspeed_tpu/ops/pallas/paged_attention.py:795"),
    "paged_decode_attention": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                               "deepspeed_tpu/ops/pallas/paged_attention.py:443"),
    # the int8 modes: #6 reused as paged_scale_write (:902) with the XLA
    # quantize_kv_rows in one kernel; #4 with k_scale/v_scale, plain and fused
    "paged_kv_write_int8": ("deepspeed_tpu_torch/csrc/paged_kv_write.cu",
                            "deepspeed_tpu/ops/pallas/paged_attention.py:889"),
    "paged_decode_fused_int8": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                                "deepspeed_tpu/ops/pallas/paged_attention.py:443"),
    "paged_decode_attention_int8": ("deepspeed_tpu_torch/csrc/paged_decode.cu",
                                    "deepspeed_tpu/ops/pallas/paged_attention.py:443"),
    "flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                  "deepspeed_tpu/ops/pallas/flash_attention.py:233"),
    "flash_bwd_dq": ("deepspeed_tpu_torch/csrc/flash_bwd.cu",
                     "deepspeed_tpu/ops/pallas/flash_attention.py:438"),
    "flash_bwd_dkv": ("deepspeed_tpu_torch/csrc/flash_bwd.cu",
                      "deepspeed_tpu/ops/pallas/flash_attention.py:467"),
    "evoformer_fwd": ("deepspeed_tpu_torch/csrc/evoformer_fwd.cu",
                      "deepspeed_tpu/ops/pallas/evoformer_attention.py:139"),
    "evoformer_bwd_dq": ("deepspeed_tpu_torch/csrc/evoformer_bwd.cu",
                         "deepspeed_tpu/ops/pallas/evoformer_attention.py:310"),
    "evoformer_bwd_dkv": ("deepspeed_tpu_torch/csrc/evoformer_bwd.cu",
                          "deepspeed_tpu/ops/pallas/evoformer_attention.py:347"),
    "evoformer_bwd_db2": ("deepspeed_tpu_torch/csrc/evoformer_db2.cu",
                          "deepspeed_tpu/ops/pallas/evoformer_attention.py:394"),
    # a kernel the port adds: the per-channel int8 product the JAX package
    # leaves to XLA (_wmm; _lm_logits at :216), no pallas_call
    "int8_matmul": ("deepspeed_tpu_torch/csrc/int8_matmul.cu",
                    "deepspeed_tpu/inference/model.py:198"),
}
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SERVE_KERNELS = ("paged_kv_write", "paged_decode_fused", "paged_decode_attention", "flash_fwd")
INT8_KERNELS = ("paged_kv_write_int8", "paged_decode_fused_int8", "paged_decode_attention_int8",
                "flash_fwd")
EVO_KERNELS = ("evoformer_fwd", "evoformer_bwd_dq", "evoformer_bwd_dkv", "evoformer_bwd_db2")
# the evoformer path: DS4Sci attention at the widths of AlphaFold 2 (supp.
# Algorithm 7, MSA row attention with pair bias, 8 heads x 32; Algorithms
# 13-14, triangle attention, 4 heads x 32; Table 4, training crops), which
# are OpenFold's openfold/config.py evoformer_stack (no_heads_msa 8,
# c_hidden_msa_att 32, no_heads_pair 4, c_hidden_pair_att 32) at its
# initial-training (crop 256, 128 MSA clusters) and fine-tuning (crop 384,
# 512 clusters) sizes; q/k/v [B, S, N, H, D]
EVO_CASES = {
    "E1": dict(what="MSA row attention with pair bias, initial training",
               B=1, S=128, N=256, H=8, D=32),
    "E2": dict(what="triangle attention (starting node), initial training",
               B=1, S=256, N=256, H=4, D=32),
    "E3": dict(what="MSA row attention with pair bias, fine-tuning",
               B=1, S=512, N=384, H=8, D=32),
}
# the sliding-window path: Mistral 7B's published shape (arXiv 2310.06825,
# Table 1, = mistralai/Mistral-7B-v0.1 config.json as the JAX package's
# config_from_hf maps it, utils/hf_checkpoint.py), random weights from seed
# 0; max_seq is the paper's context_len 8192 (the config's 32768 is only a
# cap here). Served at full width and depth: 7,241,732,096 parameters,
# 14.5 GB in bf16, 131,072 KV bytes per token, 8.6 GB for 512 blocks.
MISTRAL = dict(variant="llama", vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
               n_kv_heads=8, d_ff=14336, sliding_window=4096, rope_theta=10000.0,
               norm_eps=1e-5, tie_embeddings=False, max_seq=8192)
WINDOW = MISTRAL["sliding_window"]
SERVE_W = dict(max_seq_len=8192, kv_block_size=128, num_kv_blocks=512,
               min_prefill_bucket=64, max_batch_size=64)
W_LONG, W_PROMPTS = 6144, 7  # one 6144-token prompt (the window bites in rows >= 4096)
# trained 4 layers deep (7.24B params x 16 B of bf16 weights, fp32 master
# and Adam moments is 116 GB), full width, one 8192-token sequence a step
TRAIN_W_MODEL = dict(MISTRAL, n_layers=4, remat="save_attn_qkv", use_flash=True)
TRAIN_W_S = 8192
TRAIN_LONG_STEPS, TRAIN_LONG_TIMED = 6, 3  # of every phase of TRAIN_LONG
TRAIN_PEAK_GIB = 76  # each TRAIN_LONG phase's peak device memory stays under it (of 80 GB)
TRAIN_W_PATH = (2, 6144)  # layers, S of the gradient three-path check
# the ALiBi path: BLOOM-7B1 (bigscience/bloom-7b1 config.json as the JAX
# package's config_from_hf maps it, utils/hf_checkpoint.py: ALiBi, no
# position table, an embedding LayerNorm, LayerNorm, biases everywhere, a
# tanh-GELU MLP of 4 x d_model, tied embeddings), random weights from seed
# 0, full width and depth: 7,069,016,064 parameters, 14.1 GB in bf16,
# 491,520 KV bytes per token, 8.05 GB for 128 blocks of 128 tokens
BLOOM = dict(vocab_size=250880, n_layers=30, n_heads=32, d_model=4096, d_ff=16384,
             max_seq=2048, variant="gpt2", alibi=True, embedding_layernorm=True,
             activation="gelu", norm_eps=1e-5, tie_embeddings=True)
SERVE_A = dict(max_seq_len=2048, kv_block_size=128, num_kv_blocks=128,
               min_prefill_bucket=64, max_batch_size=64)
# one 1920-token prompt (bucket 2048) and 7 x 96; decode_multi's long row
# then runs at ctx 1921-1944; TTFT of a fresh 512-token prompt
A_LONG, A_PROMPTS, A_TTFT = 1920, 7, 512
# phase 2's ALiBi cases of kernel #1: (B, S, H, KV, D, window, slope scale)
FLASH_ALIBI_CASES = {
    "bloom_prefill": dict(B=1, S=512, H=32, KV=32, D=128, window=0, scale=1.0),
    "falcon_rw_1b": dict(B=1, S=512, H=32, KV=32, D=64, window=0, scale=1.0 / 8.0),
    "gqa": dict(B=1, S=512, H=32, KV=8, D=128, window=0, scale=1.0),
    "non_pow2_heads": dict(B=1, S=512, H=24, KV=24, D=128, window=0, scale=1.0),
    "window_1000": dict(B=1, S=2048, H=32, KV=32, D=128, window=1000, scale=1.0),
}
ALIBI_WINDOW = 1000
# phase 2's ALiBi cases of kernels #2/#3, at the training length 2048
FLASH_BWD_ALIBI_CASES = {
    "bloom_train": dict(B=1, S=2048, H=32, KV=32, D=128, window=0, scale=1.0),
    "falcon_rw_1b": dict(B=1, S=2048, H=32, KV=32, D=64, window=0, scale=1.0 / 8.0),
    "gqa": dict(B=1, S=2048, H=32, KV=8, D=128, window=0, scale=1.0),
    "non_pow2_heads": dict(B=1, S=2048, H=24, KV=24, D=128, window=0, scale=1.0),
    "window_1000": dict(B=1, S=2048, H=32, KV=32, D=128, window=ALIBI_WINDOW, scale=1.0),
}
# ... and the shape they are timed at: BLOOM-7B1's training micro-batch
ALIBI_BWD_TIMED = dict(B=4, S=2048, H=32, KV=32, D=128)
# the ALiBi training path, BLOOM-7B1 at full width, 4 layers deep (30 layers
# are 7,069,016,064 parameters; bf16 weights, fp32 master and Adam moments
# at 16 B each make 113 GB): micro-batch 4 x 2048 (BLOOM's context)
TRAIN_A_MODEL = dict(BLOOM, n_layers=4, remat="save_attn_qkv", use_flash=True)
# falcon-rw-1b whole (tiiuae/falcon-rw-1b config.json as the JAX package's
# config_from_hf maps it, utils/hf_checkpoint.py: LayerNorm, erf GELU, a
# non-gated 4 x d_model MLP, biases everywhere, ALiBi with falcon's
# 1/sqrt(head_dim) slope scale, 32 x 64 heads, tied embeddings), random
# weights, full width and depth: 1,311,625,216 parameters, ~21 GB of
# training state; micro-batch 8 x 2048 as the flagship's
FALCON_RW = dict(vocab_size=50304, n_layers=24, n_heads=32, n_kv_heads=32, d_model=2048,
                 d_ff=8192, max_seq=2048, variant="llama", norm_type="layer", gated_mlp=False,
                 activation="gelu_exact", qkv_bias=True, attn_out_bias=True, mlp_bias=True,
                 rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=True, alibi=True,
                 alibi_slope_scale=1.0 / 8.0)
TRAIN_F_MODEL = dict(FALCON_RW, remat="save_attn_qkv", use_flash=True)
# the block-sparse path: Llama-2-7B (meta-llama/Llama-2-7b-hf config.json as
# the JAX package's config_from_hf maps it, utils/hf_checkpoint.py; the
# shape of bench.py's _serving_7b_bench), random weights from seed 0, full
# width and depth: 6,738,415,616 parameters, 13.5 GB in bf16, 524,288 KV
# bytes per token (64 MiB a 128-token block). Served with a fixed sparse
# layout: DeepSpeed's FixedSparsityConfig defaults (4 local blocks, 1
# global), the block raised from its 16 to the 128-token cache block, so
# that the JAX engine itself takes the kernel route
LLAMA2_7B = dict(variant="llama", vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
                 n_kv_heads=32, d_ff=11008, rope_theta=10000.0, norm_eps=1e-5,
                 tie_embeddings=False, max_seq=4096, attention_impl="sparse",
                 sparse_mode="fixed", sparse_block=128, sparse_num_local_blocks=4,
                 sparse_num_global_blocks=1)
# 80 blocks of 128 tokens, 5 GiB of bf16 pools: the counted sequence below
# holds 40, a fresh 3968-token prompt 31 more
SERVE_S = dict(max_seq_len=4096, kv_block_size=128, num_kv_blocks=80,
               min_prefill_bucket=64, max_batch_size=64)
# one 3968-token prompt (bucket 4096) and 7 x 96; its 2-token continuation
# and decode_multi's long row at ctx ~3971-3994 (layout block 31: blocks 0
# and 28-31 attended, 1-27 skipped); TTFT of fresh 512- and 3968-token
# prompts; a 40-token prompt, whose 64-token bucket is shorter than the
# 128-token layout block (the masked prefill)
S_LONG, S_PROMPTS, S_TTFT, S_SHORT = 3968, 7, 512, 40
# phase 2's ALiBi decode rows: ctx ~100 to ~2,000 (several mid-block)
DECODE_ALIBI_CTX = (100, 371, 642, 913, 1184, 1455, 1726, 1997)
# phase 2's block-sparse decode rows: ctx ~100 to ~4,000 (several
# mid-block), the longest row reading 5 of its 32 blocks under the fixed
# layout; and DeepSpeed's FixedSparsityConfig at its documented block 16 (4
# local blocks, 1 global), checked at 16-token cache blocks, where one
# 64-column tile of the kernel spans four blocks
DECODE_SPARSE_CTX = (100, 611, 1180, 1701, 2262, 2823, 3391, 3970)
SPARSE_BLOCK_16 = dict(block=16, mode="fixed", num_local_blocks=4, num_global_blocks=1)
# the parallel-residual paths, served at full width and depth from random
# weights (seed 0) as the JAX package's config_from_hf maps each published
# config.json (utils/hf_checkpoint.py). Falcon-7B (tiiuae/falcon-7b:
# multi-query, 71 query heads of 64 over one KV head, one LayerNorm shared
# by the parallel attention and MLP, erf GELU, no biases, tied, rotary):
# 6,921,720,704 parameters, 13.8 GB in bf16, 8,192 KV bytes per token
FALCON_7B = dict(vocab_size=65024, n_layers=32, n_heads=71, n_kv_heads=1, d_model=4544,
                 d_ff=18176, max_seq=2048, variant="llama", norm_type="layer", gated_mlp=False,
                 activation="gelu_exact", qkv_bias=False, attn_out_bias=False, mlp_bias=False,
                 parallel_residual=True, shared_ln=True, rope_theta=10000.0, norm_eps=1e-5,
                 tie_embeddings=True, alibi=False)
# Phi-2 (microsoft/phi-2: 32 heads of 80, partial rotary 0.4 = 32 of 80
# dims, one shared LayerNorm, tanh GELU, biases everywhere, an untied
# lm_head with its bias): 2,779,683,840 parameters, 5.6 GB in bf16, 327,680
# KV bytes per token. Both serve as BLOOM-7B1 does (SERVE_A; a 1920-token
# prompt, 7 x 96, TTFT at 512 and 1920 tokens)
PHI_2 = dict(vocab_size=51200, n_layers=32, n_heads=32, n_kv_heads=32, d_model=2560,
             d_ff=10240, max_seq=2048, variant="llama", norm_type="layer", gated_mlp=False,
             activation="gelu", qkv_bias=True, attn_out_bias=True, mlp_bias=True,
             parallel_residual=True, shared_ln=True, rotary_pct=0.4, rope_theta=10000.0,
             norm_eps=1e-5, tie_embeddings=False, lm_head_bias=True)
# the GPT-NeoX- and GPT-J-class paths, served at full width and depth from
# random weights (seed 0) as the JAX package's config_from_hf maps each
# published config.json (utils/hf_checkpoint.py). GPT-NeoX-20B
# (EleutherAI/gpt-neox-20b: 64 heads of 96, rotary on 24 of 96 dims in
# split halves, two LayerNorms and the parallel residual, biases on q/k/v,
# output and MLP, tanh GELU (gelu_fast), untied): 20,554,567,680
# parameters, 41.1 GB in bf16, 1,081,344 KV bytes per token
GPT_NEOX_20B = dict(vocab_size=50432, n_layers=44, n_heads=64, d_model=6144, d_ff=24576,
                    max_seq=2048, variant="llama", norm_type="layer", gated_mlp=False,
                    activation="gelu", qkv_bias=True, attn_out_bias=True, mlp_bias=True,
                    parallel_residual=True, rotary_pct=0.25, rope_theta=10000.0,
                    norm_eps=1e-5, tie_embeddings=False)
# GPT-J-6B (EleutherAI/gpt-j-6b: 16 heads of 256, interleaved rotary on 64
# of 256 dims, one LayerNorm shared by the parallel attention and MLP,
# unbiased attention, a biased MLP, an untied lm_head with its bias):
# 6,050,882,784 parameters, 12.1 GB in bf16, 458,752 KV bytes per token
GPT_J_6B = dict(vocab_size=50400, n_layers=28, n_heads=16, d_model=4096, d_ff=16384,
                max_seq=2048, variant="llama", norm_type="layer", gated_mlp=False,
                activation="gelu", qkv_bias=False, attn_out_bias=False, mlp_bias=True,
                parallel_residual=True, shared_ln=True, rotary_pct=0.25,
                rope_interleaved=True, norm_eps=1e-5, tie_embeddings=False,
                lm_head_bias=True)
# the parallel-residual training paths, with the flagship's settings.
# Falcon-7B's width 4 layers deep: 1,123,758,464 parameters (all 32 layers
# are 6.92B, ~150 GB of training state at ~20 B a parameter: bf16 weights,
# fp32 master, Adam moments, the fp32 accumulator and one micro-batch's
# bf16 gradients); micro-batch 4 x 2048, as BLOOM-7B1's width. Phi-2
# whole, 32 layers: ~56 GB of state, micro-batch 2 x 2048
TRAIN_FALCON_MODEL = dict(FALCON_7B, n_layers=4, remat="save_attn_qkv", use_flash=True)
TRAIN_PHI_MODEL = dict(PHI_2, remat="save_attn_qkv", use_flash=True)
# phase 2's wide-group and head_dim-80 decode rows: ctx ~100 to ~1,950 (the
# serving phases' long row decodes at 1921-1944), several mid-block
DECODE_FP_CTX = (100, 373, 646, 919, 1192, 1465, 1738, 1950)
# phase 2's wide-group decode shapes: Falcon-7B's 71 query heads of 64 over
# one KV head (8 full chunks of 8 heads and a partial one of 7), and a
# generic GQA 16 over 2 at head_dim 128 (two full chunks per KV head)
DECODE_GROUP_CASES = {"falcon_7b": dict(H=71, KV=1, D=64),
                      "gqa_16_over_2": dict(H=32, KV=2, D=128)}
# phase 2's head_dim-80 flash cases: Phi-2's prefill shapes
FLASH_D80_S = (512, 2048)
# phase 2's cases of the flash backward #2/#3 in its head_dim-80 and
# wide-group modes, at the training length 2048: Phi-2's training
# micro-batch (32 heads of 80), a GQA case at 80 (40 query heads over 2 KV
# heads: groups of 20, both modes at once), the window 1000 and ALiBi
# slopes at 80 once each (independent runtime arguments; no model of this
# script runs them together); Falcon-7B's training micro-batch (71 query
# heads of 64 over one KV head) and GQA 16 over 2 (32 heads of 64 over 2).
# "timed": the case each mode's kernels-line entry is timed at
FLASH_BWD_MODE_CASES = {
    "phi_2_train": dict(B=2, S=2048, H=32, KV=32, D=80, window=0, alibi=False, timed="d80"),
    "d80_gqa_20_over_2": dict(B=1, S=2048, H=40, KV=2, D=80, window=0, alibi=False),
    "d80_window_1000": dict(B=1, S=2048, H=32, KV=32, D=80, window=ALIBI_WINDOW, alibi=False),
    "d80_alibi": dict(B=1, S=2048, H=32, KV=32, D=80, window=0, alibi=True),
    "falcon_7b_train": dict(B=4, S=2048, H=71, KV=1, D=64, window=0, alibi=False,
                            timed="wide_group"),
    "gqa_16_over_2": dict(B=1, S=2048, H=32, KV=2, D=64, window=0, alibi=False),
    # the head_dim-96 and -256 modes: GPT-NeoX-20B's training micro-batch
    # (64 heads of 96) and GPT-J-6B's (16 heads of 256), GQA 32 over 2 at
    # each width (groups of 16: the wide-group mode and kernel #3's group
    # split at once), the window 1000 and ALiBi slopes at each width on the
    # model's heads
    "neox_20b_train": dict(B=2, S=2048, H=64, KV=64, D=96, window=0, alibi=False,
                           timed="d96"),
    "d96_gqa_32_over_2": dict(B=1, S=2048, H=32, KV=2, D=96, window=0, alibi=False),
    "d96_window_1000": dict(B=1, S=2048, H=64, KV=64, D=96, window=ALIBI_WINDOW, alibi=False),
    "d96_alibi": dict(B=1, S=2048, H=64, KV=64, D=96, window=0, alibi=True),
    "gptj_6b_train": dict(B=4, S=2048, H=16, KV=16, D=256, window=0, alibi=False,
                          timed="d256"),
    "d256_gqa_32_over_2": dict(B=1, S=2048, H=32, KV=2, D=256, window=0, alibi=False),
    "d256_window_1000": dict(B=1, S=2048, H=16, KV=16, D=256, window=ALIBI_WINDOW,
                             alibi=False),
    "d256_alibi": dict(B=1, S=2048, H=16, KV=16, D=256, window=0, alibi=True),
}
# the backward's planted faults at the head-dim modes: the gradients'
# columns from BWD_ZERO_FROM on zeroed (80-95 of 96, 128-255 of 256), the
# scores taken over the dims below HEAD_DIM_CUT (64 of 96, 128 of 256)
BWD_ZERO_FROM = {"d80": 64, "d96": 80, "d256": 128}
# window cases of phase 2 besides >= S: Mistral's 4096 (tile-aligned), 1000
# (no multiple of the 64-row tiles or the 128-token blocks) and 1
WINDOW_CASES = (4096, 1000, 1)
# phase 2's decode rows: ctx on both sides of the 4096 window (6170 starts
# it mid-block), up to 8000 of the 8192-token cap
DECODE_W_CTX = (100, 2000, 4095, 4096, 4097, 5000, 6170, 8000)
# kernel vs plain version on the card, (atol, rtol): the KV write is a copy
# (bit-exact); decode keeps its probabilities in f32 to ~16 bits (the mma
# P V of csrc/paged_decode.cu takes P as bf16(P) + bf16(P - bf16(P))), so
# only the summation order and the bf16 rounding of the output differ, at
# most one bf16 ulp (2^-7 of the value: rtol 8e-3, atol 1e-3 near zero). The flash forward also feeds bf16 probabilities to
# the tensor cores (another 2^-9 relative per term); its o is held under
# bwd_mismatch's row-scaled limit (_check_flash_o), its lse at 1e-3.
KERNEL_TOL = {"paged_kv_write": (0.0, 0.0), "paged_decode_fused": (1e-3, 8e-3),
              "paged_decode_attention": (1e-3, 8e-3),
              "paged_decode_fused_int8": (1e-3, 8e-3), "paged_decode_attention_int8": (1e-3, 8e-3)}
# (the int8 write and the codes and scales of the fused int8 decode:
# bit-exact; the int8 decode output: as the bf16 decode, the plain version
# dequantizing to bf16 where the kernel does)
# the backward kernels: against the plain backward on the same bf16 inputs
# (which rounds P and dS to bf16 where they do), under FA.bwd_mismatch's
# tolerance (one bf16 ulp of the value + 2^-5 of the row's RMS); two faults
# planted in their output must fail it (_planted_faults)
# engine logits: the kernel path and the plain path both run in bf16 and
# round at different places in each of 24 layers, so they are not compared
# with each other by a fixed tolerance; each is compared with the plain path
# in f32, and the kernel path's error must stay within these factors of
# the plain bf16 path's error (RMS and max over all logits)
PATH_RMS_FACTOR, PATH_MAX_FACTOR = 1.5, 2.0
# the 7B-class serving paths, in the order they run (mode, model): each
# from bf16 pools (phase serve_<mode>), then from int8 pools on the same
# weights (serve_<mode>_int8)
# the head_dim-96 and -256 training paths, with the flagship's settings:
# GPT-NeoX-20B's width 4 layers deep, 2,431,979,520 parameters (~49 GB of
# training state at ~20 B a parameter; all 44 layers ~411 GB), and
# GPT-J-6B's, 1,218,356,448 (~24 GB; all 28 ~121 GB)
TRAIN_NEOX_MODEL = dict(GPT_NEOX_20B, n_layers=4, remat="save_attn_qkv", use_flash=True)
TRAIN_GPTJ_MODEL = dict(GPT_J_6B, n_layers=4, remat="save_attn_qkv", use_flash=True)
SERVED_7B = (("window", MISTRAL), ("alibi", BLOOM), ("sparse", LLAMA2_7B),
             ("falcon", FALCON_7B), ("phi", PHI_2), ("neox", GPT_NEOX_20B), ("gptj", GPT_J_6B))
# GPT-NeoX-20B's pools: SERVE_A with 64 blocks (8.9 GB of bf16 pools beside
# 41.1 GB of weights; the counted sequence holds 23 blocks, a fresh
# 1920-token prompt 15 more)
SERVE_NEOX = dict(SERVE_A, num_kv_blocks=64)


def _require_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "deepspeed_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: deepspeed_tpu_torch/ is not beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))


# seconds the script has spent reading torch.profiler's events, so far
PROFILER_POST_S = [0.0]


def _device_events(prof):
    """(name, microseconds) of every kernel, copy and memset a finished
    torch.profiler profile recorded on the card, read from its kineto
    results: prof.events() first builds a Python event tree of every host
    op, which took more than half of this script's time (~10^5 host ops
    per profiled 32-layer decode_multi)."""
    from torch.autograd import DeviceType

    t = time.perf_counter()
    out = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    PROFILER_POST_S[0] += time.perf_counter() - t
    return out


def _time_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _device_ms(fn, iters, warmup=3):
    """Device time per call: the summed duration of every kernel and copy
    the call ran on the card (torch.profiler over `iters` calls), with the
    host's launch overhead left out. A profile that recorded no device
    activity at all is taken again, after a pause of a second (this
    happened once in a long run, and three times in a row in a run of the
    W8A16 checks alone); raises after six such profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(d for _, d in _device_events(prof))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time (CUPTI tracing is off)")


# the H100's L2 cache: a weight that a decode or prefill step reads once
# comes from HBM, so its product is timed cold (_cold_ms)
L2_BYTES = 50 << 20


def _weight_copies(make, nbytes):
    """Copies of a weight of `nbytes` (each from make()), enough that a
    call's weight was last read more than twice the L2's bytes before."""
    return [make() for _ in range(max(2, -(-2 * L2_BYTES // nbytes) + 1))]


def _cold_ms(fn, copies, iters):
    """Device ms a call of fn(*copy) (_device_ms), each call taking the
    next of `copies` in turn, so its weight comes cold from HBM as it does
    in a step of a served model."""
    k = [0]

    def call():
        k[0] += 1
        return fn(*copies[k[0] % len(copies)])

    return _device_ms(call, iters)


def _where_time_goes(fn, top=8):
    """Wall time of one call that ends synchronised (profiler overhead
    included), the card's busy time in it and the number of kernels and
    copies it ran (torch.profiler), the idle share, and the largest
    device-time consumers by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return _time_summary(prof, wall_ms, top)


def _time_summary(prof, wall_ms, top=8):
    """_where_time_goes' report of a finished profile over `wall_ms`."""
    by_name = {}  # by the first 80 characters of the name, as reported
    n_device = 0
    for name, us in _device_events(prof):
        n_device += 1
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + us / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy, "device_ops": n_device,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top_kernels_ms": dict(ranked)}


def _check_close(name, got, ref, atol, rtol):
    import torch

    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if bool((err > limit).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3e} beyond "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return err.max().item()


def _path_errors(name, kernel, plain, ref32):
    """Errors of the bf16 kernel path and the bf16 plain path against the
    f32 plain path; raises if the kernel path is the worse one by more
    than PATH_*_FACTOR."""
    import torch

    if not torch.isfinite(kernel).all():
        raise AssertionError(f"{name}: kernel path is not finite")
    ek, ep = (kernel - ref32).abs(), (plain - ref32).abs()
    rms = lambda e: e.square().mean().sqrt().item()
    stats = {"kernel_vs_plain_max": (kernel - plain).abs().max().item(),
             "kernel_vs_f32_max": ek.max().item(), "plain_vs_f32_max": ep.max().item(),
             "kernel_vs_f32_rms": rms(ek), "plain_vs_f32_rms": rms(ep),
             "f32_rms": rms(ref32)}
    if kernel.dim() > 1:
        stats["argmax_agree_kernel_f32"] = (kernel.argmax(-1)
                                            == ref32.argmax(-1)).float().mean().item()
    if (stats["kernel_vs_f32_rms"] > PATH_RMS_FACTOR * stats["plain_vs_f32_rms"] + 1e-4
            or stats["kernel_vs_f32_max"] > PATH_MAX_FACTOR * stats["plain_vs_f32_max"] + 1e-3):
        raise AssertionError(f"{name}: kernel path is further from the f32 reference "
                             f"than the plain bf16 path allows: {stats}")
    return stats


def _timings(kernel, plain, library, iters):
    """ms / plain_ms / library_ms: device time per call (what the card
    spends); call_ms etc.: CUDA-event time per call made back to back from
    Python, which the host's launch overhead sets when it exceeds the
    device time."""
    return {"ms": _device_ms(kernel, iters), "plain_ms": _device_ms(plain, iters),
            "library_ms": None if library is None else _device_ms(library, iters),
            "call_ms": {"kernel": _time_ms(kernel, iters), "plain": _time_ms(plain, iters),
                        "library": None if library is None else _time_ms(library, iters)}}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at its path's shapes
# ---------------------------------------------------------------------------

def _check_flash_o(FA, name, o, ro):
    """Flash forward o against its plain version under FA.bwd_mismatch, a
    limit that follows each output row: a row that averages n V rows has
    |o| ~ n^-1/2, far below any fixed tolerance once n is in the
    thousands. Returns the mismatch stats."""
    st = FA.bwd_mismatch(o, ro)
    if st["n_over"]:
        raise AssertionError(f"{name}: beyond the tolerance of the plain forward: {st}")
    return st


def _flash_case(FA, randn, bound_ms, B, S, H, KV, D):
    """Kernel #1 against its plain version on one causal case (o under
    bwd_mismatch, lse at 1e-3). Returns (q, k, v, o, plain o, the o stats,
    the timing entry beside SDPA)."""
    import torch.nn.functional as F

    q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
    o, lse = FA.flash_fwd(q, k, v)
    ro, rlse = FA.flash_attention_plain(q, k, v)
    shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal"
    st = _check_flash_o(FA, f"flash_fwd {shape} o", o, ro)
    _check_close(f"flash_fwd {shape} lse", lse, rlse, 1e-3, 1e-3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def timed():
        return dict(
            max_abs_err=st["max_abs_err"],
            **_timings(lambda: FA.flash_fwd(q, k, v), lambda: FA.flash_attention_plain(q, k, v),
                       lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=KV != H), 10),
            shape=shape,
            bound=bound_ms(B * S * (H * 2 + KV * 2) * D * 2 + B * H * S * 4,
                           4.0 * B * H * D * S * (S + 1) / 2))

    return q, k, v, o, ro, st, timed


def _flash_fwd_check(FA, randn, B, S, H, KV, D, bound_ms):
    """Kernel #1 against its plain version at one causal shape, timed
    beside SDPA (_flash_case)."""
    return _flash_case(FA, randn, bound_ms, B, S, H, KV, D)[-1]()


# kernel #1's tiles at the training shape: 128-row CTAs (two consumer
# warpgroups of 64 rows) over 128-key tiles in a two-stage TMA ring
FLASH_BM, FLASH_BN, FLASH_STAGES = 128, 128, 2


def _diag_tile_unmasked(FA, q, k, v):
    """What a kernel #1 that took its diagonal tiles unmasked would output:
    dense f32 attention where row r also sees every column of its own
    FLASH_BM x FLASH_BN diagonal tile (future keys included), P rounded
    to bf16 as the kernel rounds it."""
    import torch

    B, S, H, D = q.shape
    kf = FA._repeat_kv(k, H // k.shape[2]).float()
    vf = FA._repeat_kv(v, H // k.shape[2]).float()
    pos = torch.arange(S, device=q.device)
    seen = (pos[None, :] <= pos[:, None]) | (pos[None, :] // FLASH_BN == pos[:, None] // FLASH_BM)
    out = torch.empty_like(q)
    for b in range(B):  # one batch row at a time: [H, S, S] f32 each
        logits = torch.einsum("qhd,khd->hqk", q[b].float(), kf[b]) / D ** 0.5
        p = torch.softmax(logits.masked_fill(~seen, float("-inf")), -1)
        out[b] = torch.einsum("hqk,khd->qhd", p.to(q.dtype).float(), vf[b]).to(q.dtype)
    return out


def _stale_stage(FA, q, k, v):
    """What a kernel #1 that consumed one K/V ring stage before its full
    barrier had landed would output: the third tile of each CTA's walk read
    in place of the tile the ring held before it (FLASH_STAGES back). Made
    by running the kernel itself on K and V whose key tile FLASH_STAGES
    holds the rows of tile 0."""
    j, n = FLASH_STAGES, FLASH_BN
    k2, v2 = k.clone(), v.clone()
    k2[:, j * n:(j + 1) * n] = k[:, :n]
    v2[:, j * n:(j + 1) * n] = v[:, :n]
    return FA.flash_fwd(q, k2, v2)[0]


def _flash_fwd_design_checks(FA, q, k, v, o, ro):
    """Checks aimed at kernel #1's wgmma/TMA design, at the training shape:
    a second launch on the same inputs bit-identical to the first (no
    atomics, a fixed order), and two planted faults that the o check
    (bwd_mismatch against the plain forward) must fail: the diagonal tile
    taken unmasked, and one K/V ring stage consumed before its barrier (a
    stale tile). Also the host time to encode a call's three TMA maps."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import build

    (o1, lse1), (o2, lse2) = FA.flash_fwd(q, k, v), FA.flash_fwd(q, k, v)
    torch.cuda.synchronize()
    same = torch.equal(o1, o) and torch.equal(o2, o) and torch.equal(lse1, lse2)
    del o1, o2
    faults = {"diagonal_tile_unmasked": FA.bwd_mismatch(_diag_tile_unmasked(FA, q, k, v), ro)[
                  "n_over"],
              "stale_ring_stage": FA.bwd_mismatch(_stale_stage(FA, q, k, v), ro)["n_over"]}
    B, S, H, D = q.shape
    iters = 1000
    ns = build.load("flash_fwd").flash_fwd_encode_ns(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                      B, S, H, k.shape[2], D, iters)
    report = {"two_launches_bit_identical": same, "planted_faults_o_elements_over": faults,
              "tma_map_encode_us_per_call": ns / iters / 1e3 if ns >= 0 else None}
    print(json.dumps({"flash_fwd_design_checks": report}))
    if not same:
        raise AssertionError("flash_fwd: two launches on the same inputs differ")
    if not all(faults.values()):
        raise AssertionError(f"flash_fwd: the o check passes a planted fault: {faults}")
    if ns < 0:
        raise AssertionError("flash_fwd: encoding the TMA maps failed")
    return report


def _planted_faults(FA, got, ref, q, k, v, do, lse, delta, tile=64):
    """Proof that the backward tolerance catches a wrong kernel: two faults
    planted in the kernels' own output, each of which must fail
    FA.bwd_mismatch against the plain backward. "scale_1.02": every
    gradient 2% too large. "skip_last_diag_tile": the causal block of the
    last `tile` queries and keys left out (a dq block that stops one K/V
    tile short, a dkv block that stops one q tile short), i.e. the
    contribution of that block (the plain backward on it, with the full
    rows' lse and delta) taken off. Returns {name: {fault: elements
    beyond the tolerance}}."""
    import torch

    t = q.shape[1] - tile
    last = lambda x: x[:, t:].contiguous()
    part = FA._bwd_plain(last(q), last(k), last(v), lse[:, :, t:].contiguous(),
                         delta[:, :, t:].contiguous(), last(do))
    out = {}
    for (name, g), p in zip(got.items(), part):
        skipped = g.to(torch.float32, copy=True)
        skipped[:, t:] -= p.float()
        out[name] = {
            "scale_1.02": FA.bwd_mismatch((g.float() * 1.02).to(torch.bfloat16),
                                          ref[name])["n_over"],
            "skip_last_diag_tile": FA.bwd_mismatch(skipped.to(torch.bfloat16),
                                                   ref[name])["n_over"]}
        if not all(out[name].values()):
            raise AssertionError(f"flash_bwd {name}: the tolerance passes a planted fault: "
                                 f"{out[name]}")
    return out


# kernels #2 and #3 with two warpgroups (the training shapes): a ring of
# FLASH_BWD_STAGES stages of 64-row tiles (Q/dO for dkv, K/V for dq)
FLASH_BWD_TILE, FLASH_BWD_STAGES = 64, 3


def _stale_bwd_tile(x, dim):
    """x with its 64-row tile FLASH_BWD_STAGES along `dim` holding tile 0's
    rows: the tile a kernel #2 or #3 that read a ring stage before its
    full barrier landed would see (the stage's previous contents)."""
    n, j = FLASH_BWD_TILE, FLASH_BWD_STAGES
    y = x.clone()
    y.narrow(dim, j * n, n).copy_(x.narrow(dim, 0, n))
    return y


def _bwd_diag_tile_unmasked(FA, q, k, v, lse, delta, do):
    """What kernels #2 and #3 would output if they took their diagonal
    64 x 64 tiles unmasked: the plain backward's math, one batch row at a
    time, with each row also seeing the later keys of its own diagonal
    tile (P and dS rounded to bf16 as the kernels round them)."""
    import torch

    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    n = FLASH_BWD_TILE
    pos = torch.arange(S, device=q.device)
    seen = (pos[None, :] <= pos[:, None]) | (pos[None, :] // n == pos[:, None] // n)
    out = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    for b in range(B):
        kf, vf = FA._repeat_kv(k[b:b + 1], G).float(), FA._repeat_kv(v[b:b + 1], G).float()
        qf, dof = q[b:b + 1].float(), do[b:b + 1].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / D ** 0.5
        p = torch.exp(logits.masked_fill(~seen, float("-inf")) - lse[b:b + 1, ..., None])
        del logits
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = (p * (dp - delta[b:b + 1, ..., None]) / D ** 0.5).to(q.dtype).float()
        del dp
        p = p.to(q.dtype).float()
        out[0][b] = torch.einsum("bhqk,bkhd->bqhd", ds, kf)[0].to(q.dtype)
        out[1][b] = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(S, KV, G, D).sum(2).to(
            k.dtype)
        out[2][b] = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(S, KV, G, D).sum(2).to(
            v.dtype)
        del p, ds
    return tuple(out)


def _flash_bwd_design_checks(FA, q, k, v, do, lse, delta, got, ref):
    """Checks aimed at the wgmma/TMA design of kernels #2 and #3 at the
    training shape: a second launch on the same inputs bit-identical in
    dq, dk and dv, and planted faults that bwd_mismatch against the plain
    backward must fail in every gradient each touches: a ring stage read
    before its barrier (dkv: Q, dO, lse and delta whose tile
    FLASH_BWD_STAGES holds tile 0's rows; dq: K and V), and the diagonal
    tiles taken unmasked."""
    import torch

    again = (FA.flash_bwd_dq(q, k, v, do, lse, delta),) + FA.flash_bwd_dkv(q, k, v, do, lse,
                                                                         delta)
    torch.cuda.synchronize()
    same = all(torch.equal(a, got[n]) for a, n in zip(again, ("dq", "dk", "dv")))
    del again
    faults = {
        "dkv_stale_ring_stage": (("dk", "dv"), (None,) + FA.flash_bwd_dkv(
            _stale_bwd_tile(q, 1), k, v, _stale_bwd_tile(do, 1), _stale_bwd_tile(lse, 2),
            _stale_bwd_tile(delta, 2))),
        "dq_stale_ring_stage": (("dq",), (FA.flash_bwd_dq(
            q, _stale_bwd_tile(k, 1), _stale_bwd_tile(v, 1), do, lse, delta),)),
        "diagonal_tile_unmasked": (("dq", "dk", "dv"), _bwd_diag_tile_unmasked(
            FA, q, k, v, lse, delta, do))}
    over = {f: {n: FA.bwd_mismatch(g[i], ref[n])["n_over"]
                for i, n in enumerate(("dq", "dk", "dv")) if n in hit}
            for f, (hit, g) in faults.items()}
    report = {"two_launches_bit_identical": same, "planted_faults_elements_over": over}
    print(json.dumps({"flash_bwd_design_checks": report}))
    if not same:
        raise AssertionError("flash_bwd: two launches on the same inputs differ")
    if not all(v for f in over.values() for v in f.values()):
        raise AssertionError(f"flash_bwd: the check passes a planted fault: {over}")
    return report


def _flash_train_checks(FA, randn, B, S, H, KV, D, bound_ms):
    """Kernel #1 at the training shape (with _flash_fwd_design_checks),
    and kernels #2 (dq) and #3 (dk, dv) against the plain backward on the
    forward kernel's o and lse.
    library_ms of both backward kernels is the device time of the
    backward of F.scaled_dot_product_attention, which computes dq, dk and
    dv in one call; plain_ms is that of the dense plain backward, which
    also computes all three."""
    import torch
    import torch.nn.functional as F

    q, k, v, o, ro, _, timed = _flash_case(FA, randn, bound_ms, B, S, H, KV, D)
    _flash_fwd_design_checks(FA, q, k, v, o, ro)
    out = {"flash_fwd": timed()}
    del q, k, v, o, ro
    q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
    o, lse = FA.flash_fwd(q, k, v)
    delta = FA._delta(o, do)
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta)
    got = {"dq": dq, "dk": dk, "dv": dv}
    ref = dict(zip(got, FA.flash_attention_bwd_plain(q, k, v, o, lse, do)))
    # for the record: the same math with nothing rounded to bf16
    f32 = dict(zip(got, FA.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                                     o.float(), lse, do.float())))
    planted = _planted_faults(FA, got, ref, q, k, v, do, lse, delta)
    _flash_bwd_design_checks(FA, q, k, v, do, lse, delta, got, ref)
    report = {}
    for name in got:
        stats = FA.bwd_mismatch(got[name], ref[name])
        if stats["n_over"]:
            raise AssertionError(f"flash_bwd {name}: kernel beyond the tolerance of the "
                                 f"plain backward: {stats}")
        report[name] = {"vs_plain": stats,
                        "vs_plain_f32": FA.bwd_mismatch(got[name], f32[name]),
                        "planted_faults_n_over": planted[name]}
    del ref, f32
    print(json.dumps({"flash_bwd_tolerance": {
        "rtol": FA.BWD_RTOL, "row_rms_atol": FA.BWD_ROW_ATOL, "floor": FA.BWD_FLOOR,
        **report}}))
    errs = {name: r["vs_plain"]["max_abs_err"] for name, r in report.items()}
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=KV != H)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    pairs = B * H * S * (S + 1) / 2  # causal (query, key) pairs
    io_in = B * S * (2 * H + 2 * KV) * D * 2 + 2 * B * H * S * 4  # q, k, v, dO, lse, delta
    shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal"
    out["flash_bwd_dq"] = dict(
        max_abs_err=errs["dq"],
        **_timings(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta),
                   lambda: FA._bwd_plain(q, k, v, lse, delta, do)[0], sdpa_bwd, 5),
        shape=shape, bound=bound_ms(io_in + B * S * H * D * 2, 3 * 2.0 * pairs * D))
    out["flash_bwd_dkv"] = dict(
        max_abs_err=max(errs["dk"], errs["dv"]),
        **_timings(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta),
                   lambda: FA._bwd_plain(q, k, v, lse, delta, do)[1:], sdpa_bwd, 5),
        shape=shape, bound=bound_ms(io_in + 2 * B * S * KV * D * 2, 4 * 2.0 * pairs * D))
    both = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    print(json.dumps({"flash_backward_vs_sdpa": {
        "dq_plus_dkv_ms": both, "sdpa_backward_ms": out["flash_bwd_dq"]["library_ms"],
        "ratio": both / out["flash_bwd_dq"]["library_ms"], "shape": shape}}))
    return out


def _evo_inputs(case, dev, seed):
    """bf16 q, k, v, dO [B, S, N, H, D] and the two biases of one evoformer
    case from a seeded torch.Generator: bias1 is OpenFold's mask bias
    1e9 * (mask - 1) with ~10% of each row's keys masked (key 0 never, so
    no row is masked whole), bias2 a pair bias normal * 0.5."""
    import torch

    B, S, N, H, D = (case[x] for x in "BSNHD")
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q, k, v, do = (randn(B, S, N, H, D).to(torch.bfloat16) for _ in range(4))
    mask = torch.rand((B, S, 1, 1, N), generator=g, device=dev) >= 0.1
    mask[..., 0] = True
    b1 = (1e9 * (mask.float() - 1)).to(torch.bfloat16)
    b2 = (0.5 * randn(B, 1, H, N, N)).to(torch.bfloat16)
    return q, k, v, b1, b2, do


def _evo_bounds(case, bound_ms):
    """Each evoformer kernel's bound at a case's shapes: every input read
    once and every output written once (a [G, N, D] bf16 tensor is `t`
    bytes, a [G, N] f32 row vector `row`), and its N x N x D products."""
    B, S, N, H, D = (case[x] for x in "BSNHD")
    G = B * S * H
    t, row = G * N * D * 2, G * N * 4
    bias = B * S * N * 2 + B * H * N * N * 2
    mm = 2.0 * G * N * N * D
    bwd_in = 4 * t + 2 * row + bias  # q, k, v, dO, lse, delta, both biases
    return {"evoformer_fwd": bound_ms(3 * t + bias + t + row, 2 * mm),
            "evoformer_bwd_dq": bound_ms(bwd_in + t, 3 * mm),
            "evoformer_bwd_dkv": bound_ms(bwd_in + 2 * t + row, 4 * mm),
            "evoformer_bwd_db2": bound_ms(bwd_in + B * H * N * N * 2, 2 * mm)}


def _evo_planted_faults(EV, got, ref, args, tile=64):
    """Proof that the evoformer tolerance catches a wrong kernel: faults
    planted in the kernels' own output, each of which must fail
    EV.bwd_mismatch against the plain version. "scale_1.02": every
    gradient 2% too large. "drop_tile": the (last query tile, last key
    tile) block left out of dq, dk and dv (a kernel whose loop stops one
    tile short). "drop_last_sequence": db2 without the contribution of
    sequence S-1. "drop_last_head": db1 without head H-1. Returns
    {tensor: {fault: elements beyond the tolerance}}."""
    import torch

    q, k, v, b1, b2, do, lse, delta = args
    B, S, N, H, _ = q.shape
    t = N - tile
    rows = lambda x: x.reshape(B, S, H, N)
    part = EV._bwd_plain(q[:, :, t:], k[:, :, t:], v[:, :, t:], b1[..., t:], b2[..., t:, t:],
                         rows(lse)[..., t:].reshape(-1, tile),
                         rows(delta)[..., t:].reshape(-1, tile), do[:, :, t:])
    last = EV._bwd_plain(q[:, -1:], k[:, -1:], v[:, -1:], b1[:, -1:], b2,
                         rows(lse)[:, -1].reshape(-1, N), rows(delta)[:, -1].reshape(-1, N),
                         do[:, -1:])
    faults = {}
    for name in ("dq", "dk", "dv", "db1", "db2"):
        g = got[name]
        faults[name] = {"scale_1.02": (g.float() * 1.02).to(g.dtype)}
        if name in ("dq", "dk", "dv"):
            dropped = g.to(torch.float32, copy=True)
            dropped[:, :, t:] -= part[("dq", "dk", "dv").index(name)].float()
            faults[name]["drop_tile"] = dropped.to(g.dtype)
    faults["db2"]["drop_last_sequence"] = (got["db2"].float() - last[4].float()).to(b2.dtype)
    last_head = got["dsum"].reshape(B, S, H, N)[:, :, -1].reshape(B, S, 1, 1, N)
    faults["db1"]["drop_last_head"] = (got["db1"].float() - last_head).to(b1.dtype)
    out = {}
    for name, fs in faults.items():
        out[name] = {f: EV.bwd_mismatch(x, ref[name])["n_over"] for f, x in fs.items()}
        if not all(out[name].values()):
            raise AssertionError(f"evoformer {name}: the tolerance passes a planted fault: "
                                 f"{out[name]}")
    return out


def _sdpa_evo(q, k, v, b1, b2, do):
    """F.scaled_dot_product_attention on the same problem, as a yardstick
    only (the port never calls it): q/k/v as [B*S, H, N, D] views, the two
    biases added into one materialised [B*S, H, N, N] mask. Returns the
    forward, and the backward (dq, dk, dv and the mask's gradient in one
    call) of one retained forward."""
    import torch
    import torch.nn.functional as F

    B, S, N, H, D = q.shape
    heads_first = lambda x: x.reshape(B * S, N, H, D).transpose(1, 2)
    qt, kt, vt, dot = (heads_first(x) for x in (q, k, v, do))
    mask = (b1 + b2).reshape(B * S, H, N, N)
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt, mask)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3])
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True))


# the key tile of #7 and #8 at head dim 32 (csrc/evoformer_fwd.cu Cfg<32, 128, 3>,
# csrc/evoformer_bwd.cu DqCfg<32, 128, 3>)
EVO_FWD_KEY_TILE = 128
# the evoformer backward wrappers' arguments, in order
EVO_BWD_ARGS = ("q", "k", "v", "b1", "b2", "do", "lse", "delta")


def _ptxas_registers(build, source, kernels):
    """{kernel<template ints>: registers, spill stores and loads} of the
    entry functions of `source` whose names hold one of `kernels`, read
    from the compiler's -Xptxas -v report of this run's build."""
    import re

    out, current = {}, None
    for line in (build.build_log(source) or "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            ints = re.findall(r"L[ib](\d+)E", m.group(1))  # ints and bools, in order
            current = f"{name}<{','.join(ints)}>" if name and ints else name
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def _stale_tile(x, tile):
    """x [B, S, N, H, D] with rows tile .. 2 tile - 1 of every sequence
    holding rows 0 .. tile - 1: the input a kernel would see if it read
    ring tile 1 before its load landed (tile 0's rows still there)."""
    import torch

    return torch.cat([x[:, :, :tile], x[:, :, :tile], x[:, :, 2 * tile:]], 2)


def _previous_sequence_left(x, runs):
    """x [B, S, ...] with every sequence that is not the first of its run
    given the previous sequence's values added: the output of a kernel
    that did not reset its accumulators between the sequences of a run."""
    out = x.float()
    for first, end in runs:
        out[:, first + 1:end] += x[:, first:end - 1].float()
    return out.to(x.dtype)


def _evo_design_checks(EV, name, args, o, got, ref):
    """Checks aimed at the wgmma/TMA designs of kernels #7-#10 at one
    evoformer case: second launches bit-identical to the first (no atomics,
    a fixed order, #10's chunks added in chunk order), and #8's and #9's
    outputs the same bits in one run as in the plan's runs; planted faults,
    each made by running the kernel on altered inputs or by altering its
    output, that the check against the plain version on the true inputs
    must fail: a K/V ring tile of #7 or #8 consumed before its barrier (key
    tile 1 holding tile 0's rows), a Q/dO ring tile of #9 (query tile 1
    holding tile 0's), the bias2 band of the wrong head or of the other
    128-row tile (#7 and #8: query rows; #9: keys), bias1 staged one key
    off, a sequence's dq, dk and dv with the previous sequence of its run
    left in the accumulators, one chunk of #10's sequence split left out of
    the combining pass; the plans (#7's and #8/#9's runs, #10's chunks and
    scratch bytes); the ptxas registers and spills of the kernels; and the
    floor the exponentials set at D 32, G N^2 ex2 (each of #7-#10 takes one
    per (query, key) pair) at 16 a clock an SM (compute capability 9.0)
    and the card's maximum SM clock."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import build

    q, k, v, b1, b2, do, lse, delta = args
    B, S, N, H, D = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    fplan, dplan = EV.fwd_run_plan(B, S, N, H, sms), EV.db2_split_plan(B, S, N, H, D, sms)
    bplan = EV.bwd_run_plan(B, S, N, H, D, sms)
    o2, lse2 = EV.evoformer_fwd(q, k, v, b1, b2)
    d2 = EV.evoformer_bwd_db2(*args)
    dq2, dkv2 = EV.evoformer_bwd_dq(*args), EV.evoformer_bwd_dkv(*args)
    torch.cuda.synchronize()
    same = {"evoformer_fwd": torch.equal(o2, o) and torch.equal(lse2, lse),
            "evoformer_bwd_dq": torch.equal(dq2, got["dq"]),
            "evoformer_bwd_dkv": all(torch.equal(a, got[t])
                                     for a, t in zip(dkv2, ("dk", "dv", "dsum"))),
            "evoformer_bwd_db2": torch.equal(d2, got["db2"])}
    dq1, dkv1 = EV.evoformer_bwd_dq(*args, n_runs=1), EV.evoformer_bwd_dkv(*args, n_runs=1)
    torch.cuda.synchronize()
    one_run = {"evoformer_bwd_dq": torch.equal(dq1, got["dq"]),
               "evoformer_bwd_dkv": all(torch.equal(a, got[t])
                                        for a, t in zip(dkv1, ("dk", "dv", "dsum")))}
    del o2, lse2, d2, dq2, dkv2, dq1, dkv1
    bn = EVO_FWD_KEY_TILE
    stale = lambda x: _stale_tile(x, bn)
    bwd = (q, k, v, b1, b2, do, lse, delta)
    dq_on = lambda **a: EV.evoformer_bwd_dq(*[a.get(n, x) for n, x in zip(EVO_BWD_ARGS, bwd)])
    dk_on = lambda **a: EV.evoformer_bwd_dkv(*[a.get(n, x) for n, x in zip(EVO_BWD_ARGS, bwd)])[0]
    faults = {
        "fwd_stale_ring_tile": (lambda: EV.evoformer_fwd(q, stale(k), stale(v), b1, b2)[0], "o"),
        "fwd_band_of_the_wrong_head": (lambda: EV.evoformer_fwd(q, k, v, b1, b2.roll(1, 2))[0],
                                       "o"),
        "fwd_band_of_the_other_query_tile": (
            lambda: EV.evoformer_fwd(q, k, v, b1, b2.roll(128, 3))[0], "o"),
        "fwd_bias1_one_key_off": (lambda: EV.evoformer_fwd(q, k, v, b1.roll(1, -1), b2)[0], "o"),
        "dq_stale_ring_tile": (lambda: dq_on(k=stale(k), v=stale(v)), "dq"),
        "dq_band_of_the_wrong_head": (lambda: dq_on(b2=b2.roll(1, 2)), "dq"),
        "dq_band_of_the_other_query_tile": (lambda: dq_on(b2=b2.roll(128, 3)), "dq"),
        "dq_bias1_one_key_off": (lambda: dq_on(b1=b1.roll(1, -1)), "dq"),
        "dkv_stale_ring_tile": (lambda: dk_on(q=_stale_tile(q, 64), do=_stale_tile(do, 64)),
                                "dk"),
        "dkv_band_of_the_wrong_head": (lambda: dk_on(b2=b2.roll(1, 2)), "dk"),
        "dkv_band_of_the_other_key_tile": (lambda: dk_on(b2=b2.roll(128, 4)), "dk"),
        "dkv_bias1_one_key_off": (lambda: dk_on(b1=b1.roll(1, -1)), "dk")}
    for t in ("dq", "dk", "dv"):
        faults[f"{t}_previous_sequence_left_in_the_accumulators"] = (
            lambda t=t: _previous_sequence_left(got[t], bplan.runs), t)
    over = {f: EV.bwd_mismatch(run(), ref[t])["n_over"] for f, (run, t) in faults.items()}
    first, end = dplan.runs[1]
    keep = torch.tensor([s for s in range(S) if not first <= s < end], device=q.device)
    pick = lambda t: t.index_select(1, keep).contiguous()
    rows = lambda x: x.reshape(B, S, H, N).index_select(1, keep).reshape(-1, N).contiguous()
    over["db2_chunk_left_out"] = EV.bwd_mismatch(
        EV.evoformer_bwd_db2(pick(q), pick(k), pick(v), pick(b1), b2, pick(do), rows(lse),
                             rows(delta)), ref["db2"])["n_over"]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60, check=True)
    mhz = float(clock.stdout.strip().splitlines()[0])
    report = {"case": name, "two_launches_bit_identical": same,
              "one_run_bit_identical_to_the_plans": one_run,
              "exp2_floor_ms": B * S * H * N * N / (16 * sms * mhz * 1e6) * 1e3,
              "sm_clock_max_mhz": mhz,
              "planted_faults_elements_over": over,
              "fwd_runs": {"n": fplan.n, "sequences_each": fplan.runs[0][1], "ctas": fplan.ctas},
              "bwd_runs": {"n": bplan.n, "sequences_each": bplan.runs[0][1], "ctas": bplan.ctas},
              "db2_split": {"n": dplan.n, "sequences_each": dplan.runs[0][1], "ctas": dplan.ctas,
                            "scratch_bytes": dplan.scratch_bytes,
                            "logits_f32_bytes": 4 * B * S * H * N * N},
              "ptxas": {**_ptxas_registers(build, "evoformer_fwd", ("evo_fwd_kernel",)),
                        **_ptxas_registers(build, "evoformer_bwd",
                                           ("evo_bwd_dq_kernel", "evo_bwd_dkv_kernel")),
                        **_ptxas_registers(build, "evoformer_db2",
                                           ("evo_db2_kernel", "evo_db2_combine"))}}
    print(json.dumps({"evo_design_checks": report}))
    if not all(same.values()):
        raise AssertionError(f"evoformer {name}: two launches on the same inputs differ: {same}")
    if not all(one_run.values()):
        raise AssertionError(f"evoformer {name}: one run and the plan's differ: {one_run}")
    if bplan.n < 2:
        raise AssertionError(f"evoformer {name}: #8/#9 walk one run, so no run boundary is "
                             f"checked")
    if not all(over.values()):
        raise AssertionError(f"evoformer {name}: a check passes a planted fault: {over}")
    if dplan.n < 2:
        raise AssertionError(f"evoformer {name}: #10 is not split, so no chunk can be left out")
    return report


def _evo_kernel_checks(dev, bound_ms):
    """Kernels #7-#10 at E1 and E3 against their plain versions on the same
    bf16 inputs (the backward ones on the forward kernel's o and lse),
    under bwd_mismatch, #7's lse at 1e-4; at E1 also the planted faults of
    _evo_planted_faults, and at both the design checks of
    _evo_design_checks. library_ms: SDPA's forward for #7, SDPA's backward
    for #8-#10; plain_ms of the backward kernels is the dense plain
    backward, which also computes all of their outputs. The E3 rows are
    named "<kernel>@E3"."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import evoformer_attention as EV

    out = {}
    for name in ("E3", "E1"):
        case = EVO_CASES[name]
        at = "" if name == "E1" else "@E3"
        q, k, v, b1, b2, do = _evo_inputs(case, dev, seed=2)
        bounds = _evo_bounds(case, bound_ms)
        shape = "B={B}, S={S}, N={N}, H={H}, D={D}, bf16, both biases".format(**case)
        o, lse = EV.evoformer_fwd(q, k, v, b1, b2)
        ro, rlse = EV.evoformer_fwd_plain(q, k, v, b1, b2)
        stats = EV.bwd_mismatch(o, ro)
        if stats["n_over"]:
            raise AssertionError(f"evoformer_fwd {name}: o beyond the tolerance: {stats}")
        _check_close(f"evoformer_fwd {name} lse", lse, rlse, 1e-4, 1e-4)
        sdpa_fwd, sdpa_bwd = _sdpa_evo(q, k, v, b1, b2, do)
        out["evoformer_fwd" + at] = dict(
            max_abs_err=stats["max_abs_err"], shape=shape, bound=bounds["evoformer_fwd"],
            **_timings(lambda: EV.evoformer_fwd(q, k, v, b1, b2),
                       lambda: EV.evoformer_fwd_plain(q, k, v, b1, b2), sdpa_fwd, 5))

        delta = EV._delta(o, do)
        args = (q, k, v, b1, b2, do, lse, delta)
        got = {"o": o, "dq": EV.evoformer_bwd_dq(*args)}
        got["dk"], got["dv"], got["dsum"] = EV.evoformer_bwd_dkv(*args)
        got["db1"], got["db2"] = EV._db1(got["dsum"], b1), EV.evoformer_bwd_db2(*args)
        ref = dict(zip(("dq", "dk", "dv", "dsum", "db2"),
                       EV._bwd_plain(q, k, v, b1, b2, lse, delta, do)), o=ro)
        ref["db1"] = EV._db1(ref["dsum"], b1)
        planted = _evo_planted_faults(EV, got, ref, args) if name == "E1" else {}
        report = {}
        for t, g in got.items():
            stats = EV.bwd_mismatch(g, ref[t])
            if stats["n_over"]:
                raise AssertionError(f"evoformer {t} {name}: kernel beyond the tolerance of the "
                                     f"plain version: {stats}")
            report[t] = {"worst_ratio": stats["worst_ratio"], "max_abs_err": stats["max_abs_err"],
                         "err_rms_over_ref_rms": stats["err_rms"] / stats["ref_rms"],
                         "planted_faults_n_over": planted.get(t)}
        print(json.dumps({"evoformer_tolerance": {"case": name, "shape": shape, **report}}))
        _evo_design_checks(EV, name, args, o, got, ref)
        plain_bwd = lambda: EV._bwd_plain(q, k, v, b1, b2, lse, delta, do)
        for kname, run, tensors in (
                ("evoformer_bwd_dq", lambda: EV.evoformer_bwd_dq(*args), ("dq",)),
                ("evoformer_bwd_dkv", lambda: EV.evoformer_bwd_dkv(*args), ("dk", "dv", "dsum")),
                ("evoformer_bwd_db2", lambda: EV.evoformer_bwd_db2(*args), ("db2",))):
            out[kname + at] = dict(max_abs_err=max(report[t]["max_abs_err"] for t in tensors),
                                   shape=shape, bound=bounds[kname],
                                   **_timings(run, plain_bwd, sdpa_bwd, 5))
        if name == "E1":
            print(json.dumps({"evoformer_sdpa_kernels": {
                "forward": list(_where_time_goes(sdpa_fwd, top=3)["top_kernels_ms"]),
                "backward": list(_where_time_goes(sdpa_bwd, top=3)["top_kernels_ms"])}}))
        del q, k, v, b1, b2, do, o, lse, ro, rlse, delta, args, got, ref, sdpa_fwd, sdpa_bwd
        del plain_bwd
        torch.cuda.empty_cache()
    return out


def _int8_rows(randn, T, KV, D, built):
    """bf16 rows [T, KV, D], unit normal, with rows `built[0]`, `built[1]`,
    `built[2]` (each a list of row ids) made into .5 ties (absmax 127, so
    the scale is exactly 1 and each other element is k + 0.5), zeros, and
    a subnormal absmax (3e-39 and -5e-39)."""
    import torch

    x = randn(T, KV, D).float()
    ties, zeros, subnormal = built
    n = len(ties)
    half = torch.randint(-126, 126, (n, KV, D), device=x.device).float() + 0.5
    half[..., 0] = 127.0
    x[ties] = half
    x[zeros] = 0.0
    sub = torch.full((len(subnormal), KV, D), 3e-39, device=x.device)
    sub[..., ::3] = -5e-39
    x[subnormal] = sub
    return x.to(torch.bfloat16)


def _int8_kernel_checks(PA, randn, dev, H, KV, D, bs, nblk, NB, slots, ctx, tables, q,
                        bound_ms):
    """The int8 kernels against their plain versions on the same card
    inputs, at the serving shapes of the bf16 rows: codes and scales
    bit-exact (the in-kernel quantizer repeats quantize_kv_rows, ties and
    subnormals included), attention output at the bf16 decode's tolerance.
    Plus two cases with teeth: the quantizer with ties rounded away from
    zero must fail the bit-exact check, and the dequantization's rounding
    to bf16 must show (q = 0, see below)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    def pools():
        k, v = randn(nblk * bs, KV, D), randn(nblk * bs, KV, D)
        qk, ks, qv, vs = PA.quantize_kv_rows(k, v)
        return [qk.reshape(nblk, bs, KV, D), qv.reshape(nblk, bs, KV, D),
                ks.reshape(nblk, bs, KV), vs.reshape(nblk, bs, KV)]

    # -- paged_kv_write_int8: the prefill wave's 1024 rows, 768 live; live
    #    rows 0-15 built as ties, 16-19 zeros, 20-23 subnormal
    T = slots.shape[0]
    live = torch.nonzero(slots >= 0)[:, 0]
    built = (live[:16], live[16:20], live[20:24])
    kn, vn = _int8_rows(randn, T, KV, D, built), _int8_rows(randn, T, KV, D, built)
    got = pools()
    want = [p.clone() for p in got]
    PA.paged_kv_write_int8(*got, kn, vn, slots)
    PA.paged_kv_write_quant_plain(*want, kn, vn, slots)
    for name, a, b in zip(("k codes", "v codes", "k scales", "v scales"), got, want):
        _check_close(f"paged_kv_write_int8 {name}", a, b, 0.0, 0.0)
    idx = slots[live].long()
    codes = got[0].view(-1, KV, D)[idx]
    fault = _quant_fault(kn[live], "ties_away_from_zero")[0]
    n_fault = int((fault != codes).sum())
    if n_fault == 0:
        raise AssertionError("paged_kv_write_int8: the quantizer with ties rounded away from "
                             "zero passes the bit-exact check")
    sub_scale = got[2].view(-1, KV)[idx[20:24]]
    if not (sub_scale > 0).all() or not (sub_scale < torch.finfo(f32).tiny).all():
        raise AssertionError(f"paged_kv_write_int8: subnormal rows lost their scale: {sub_scale}")
    n_live = int(live.numel())
    out["paged_kv_write_int8"] = dict(
        max_abs_err=0.0,
        **_timings(lambda: PA.paged_kv_write_int8(*got, kn, vn, slots),
                   lambda: PA.paged_kv_write_quant_plain(*want, kn, vn, slots), None, 50),
        shape=f"T={T} rows ({n_live} live), pools [{nblk},{bs},{KV},{D}] int8 + "
              f"[{nblk},{bs},{KV}] f32",
        bound=bound_ms(n_live * KV * D * 2 * 2 + n_live * KV * (D + 4) * 2 + 4 * T, 0.0),
        planted_fault_ties_away_n_codes=n_fault)

    # -- int8 decode, both modes, at the bf16 decode rows' shapes
    S = q.shape[0]
    k_new, v_new = randn(S, KV, D), randn(S, KV, D)
    slots_d = (tables[:, 0] * bs + (ctx - 1) % bs).to(torch.int32)
    ctx_sum = int(ctx.sum())
    io = S * H * D * 2 * 2 + S * NB * 4 + S * 4  # q in, out, tables, ctx
    pos_bytes = KV * (D + 4) * 2  # one position's K and V codes and scales
    for name, fused in (("paged_decode_fused_int8", True), ("paged_decode_attention_int8", False)):
        got = pools()
        want = [p.clone() for p in got]
        if fused:
            run = lambda: PA.paged_decode_fused_int8(q, got[0], got[1], tables, ctx, k_new,
                                                     v_new, slots_d, got[2], got[3])
            plain = lambda: PA.paged_decode_fused_plain(q, want[0], want[1], tables, ctx, k_new,
                                                        v_new, slots_d, want[2], want[3])
            o, ref = run()[0], plain()[0]
            for pname, a, b in zip(("k codes", "v codes", "k scales", "v scales"), got, want):
                _check_close(f"{name} {pname}", a, b, 0.0, 0.0)
            n_bytes = (io + (ctx_sum - S) * pos_bytes + S * KV * D * 2 * 2 + S * pos_bytes
                       + S * 4)
        else:
            run = lambda: PA.paged_decode_attention_int8(q, got[0], got[1], tables, ctx, got[2],
                                                         got[3])
            plain = lambda: PA.paged_decode_attention_plain(q, want[0], want[1], tables, ctx,
                                                            want[2], want[3])
            o, ref = run(), plain()
            n_bytes = io + ctx_sum * pos_bytes
        atol, rtol = KERNEL_TOL[name]
        out[name] = dict(
            max_abs_err=_check_close(name, o, ref, atol, rtol),
            **_timings(run, plain, None, 50),
            shape=f"S={S}, ctx {int(ctx.min())}..{int(ctx.max())}, H={H}, KV={KV}, D={D}, "
                  f"bs={bs}, int8 pools of {nblk} blocks, bf16 q",
            bound=bound_ms(n_bytes, 4 * ctx_sum * H * D))

    # -- the dequantization rounds to bf16: q = 0 gives every live column
    #    P = 1/64 exactly, so the output is the exact mean of 64 dequantized
    #    V rows rounded once to bf16, in any order; codes 64..127 with scale
    #    1 + 2^-9 dequantize to code + code/512, which bf16 rounds to code.
    #    Kernel and plain version must agree bit for bit; the plain version
    #    without the rounding (its f32 mode) must not.
    kc = torch.randint(-127, 128, (nblk, bs, KV, D), device=dev, dtype=torch.int8)
    vc = torch.randint(64, 128, (nblk, bs, KV, D), device=dev, dtype=torch.int8)
    ks = torch.rand((nblk, bs, KV), device=dev) + 0.01
    vs = torch.full((nblk, bs, KV), 1 + 2.0 ** -9, device=dev)
    ctx64 = torch.full((S,), 64, dtype=torch.int32, device=dev)
    q0 = torch.zeros_like(q)
    o = PA.paged_decode_attention_int8(q0, kc, vc, tables, ctx64, ks, vs)
    _check_close("int8 dequant rounding", o, PA.paged_decode_attention_plain(
        q0, kc, vc, tables, ctx64, ks, vs), 0.0, 0.0)
    unrounded = PA.paged_decode_attention_plain(q0.float(), kc, vc, tables, ctx64, ks, vs)
    n_off = int((unrounded.to(bf16) != o).sum())
    if n_off == 0:
        raise AssertionError("int8 decode: dequantizing without the bf16 rounding passes")
    out["paged_decode_attention_int8"]["planted_fault_unrounded_dequant_n_elements"] = n_off
    print(json.dumps({"int8_planted_faults": {
        "ties_away_from_zero_codes_off": n_fault, "unrounded_dequant_outputs_off": n_off,
        "subnormal_rows_scales": sub_scale.flatten().tolist()[:4]}}))
    return out


def _live_pairs(S, window):
    """(query, key) pairs one head attends to at sequence length S:
    sum over rows r of min(r + 1, window)."""
    if window <= 0 or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def _plain_fwd_grouped(FA, q, k, v, window):
    """flash_attention_plain one KV head's group of query heads at a time
    (the same arithmetic per head, in a quarter of the memory at GQA 4):
    [1, 32, 8192, 8192] f32 logits would be 8.6 GB a tensor."""
    G = q.shape[2] // k.shape[2]
    parts = [FA.flash_attention_plain(q[:, :, g * G:(g + 1) * G], k[:, :, g:g + 1],
                                      v[:, :, g:g + 1], window) for g in range(k.shape[2])]
    import torch

    return torch.cat([o for o, _ in parts], 2), torch.cat([lse for _, lse in parts], 1)


def _plain_bwd_grouped(FA, q, k, v, lse, delta, do, window):
    """FA._bwd_plain one KV head's group at a time (as _plain_fwd_grouped)."""
    import torch

    G = q.shape[2] // k.shape[2]
    parts = []
    for g in range(k.shape[2]):
        h = slice(g * G, (g + 1) * G)
        parts.append(FA._bwd_plain(q[:, :, h], k[:, :, g:g + 1], v[:, :, g:g + 1], lse[:, h],
                                   delta[:, h], do[:, :, h], window))
    return tuple(torch.cat(x, 2) for x in zip(*parts))


def _flash_window_checks(FA, randn, B, S, H, KV, D, bound_ms):
    """The window modes of kernels #1-#3 at the Mistral training shape
    against their plain versions (run per KV group) on the same bf16 inputs:
    windows WINDOW_CASES; window S and 2S bit-identical to window 0; the
    planted fault "one wider" (the kernels at window 2 where 1 was asked)
    caught. o is held by _check_flash_o: at window 4096 a row averages
    ~4096 V rows, |o| ~ 0.02, and a fixed 2e-2 would pass a spoiled PV sum.
    Two faults of the output alone (lse unchanged) must fail it at WINDOW:
    one 64-row K/V tile's PV term dropped (its V rows zeroed) and the PV
    sum scaled by 1.02. Window 1 leaves each
    row only itself: o = v, and dq, dk are zero up to rounding (P = 1 makes
    dP - delta the difference of two f32 sums of the same product), held
    below 2^-10 of dv's RMS. Times at window 4096, beside SDPA with the band
    as a boolean mask (K/V repeated to H heads outside the timed call)."""
    import torch
    import torch.nn.functional as F

    q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
    rms = lambda x: x.float().square().mean().sqrt().item()

    def kernels(window, lse=None, delta=None):
        o, lse_k = FA.flash_fwd(q, k, v, window)
        lse = lse_k if lse is None else lse
        delta = FA._delta(o, do) if delta is None else delta
        return (o, lse_k) + (FA.flash_bwd_dq(q, k, v, do, lse, delta, window),) + \
            FA.flash_bwd_dkv(q, k, v, do, lse, delta, window)

    # window >= S: the same kernels' causal result, bit for bit (the backward
    # on the causal forward's lse and delta)
    base = kernels(0)
    delta0 = FA._delta(base[0], do)
    for w in (S, 2 * S):
        got = kernels(w, base[1], delta0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, base)):
            raise AssertionError(f"flash window {w} >= S differs from the causal kernels")
    del base, delta0, got

    cases, errs = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for w in WINDOW_CASES:
        o, lse, dq, dk, dv = kernels(w)
        ro, rlse = _plain_fwd_grouped(FA, q, k, v, w)
        st = _check_flash_o(FA, f"flash_fwd window {w} o", o, ro)
        err = st["max_abs_err"]
        _check_close(f"flash_fwd window {w} lse", lse, rlse, 1e-3, 1e-3)
        if w == WINDOW:  # two launches bit-identical; faults of the output alone, lse untouched
            o2, lse2 = FA.flash_fwd(q, k, v, w)
            torch.cuda.synchronize()
            if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
                raise AssertionError(f"flash_fwd window {w}: two launches on the same inputs "
                                     f"differ")
            cases[f"two_launches_bit_identical_at_{w}"] = True
            del o2, lse2
            dropped = v.clone()
            dropped[:, w:w + 64] = 0
            fo, flse = FA.flash_fwd(q, k, dropped, w)
            torch.cuda.synchronize()
            if not torch.equal(flse, lse):
                raise AssertionError("flash_fwd: zeroing V rows changed lse")
            fault = {"tile_dropped_o_elements_over": FA.bwd_mismatch(fo, ro)["n_over"],
                     "pv_x1.02_o_elements_over": FA.bwd_mismatch(
                         (o.float() * 1.02).to(o.dtype), ro)["n_over"]}
            if not all(fault.values()):
                raise AssertionError(f"flash window {w}: the o check passes a fault of the "
                                     f"output alone: {fault}")
            cases[f"planted_output_faults_at_{w}"] = fault
            del dropped, fo, flse
        ref = dict(zip(("dq", "dk", "dv"), _plain_bwd_grouped(FA, q, k, v, lse,
                                                              FA._delta(o, do), do, w)))
        got = {"dq": dq, "dk": dk, "dv": dv}
        case = {"o_max_abs_err": err, "o_worst_ratio": st["worst_ratio"]}
        for name in got:
            if w == 1 and name != "dv":  # zero up to rounding
                m, limit = got[name].float().abs().max().item(), 2.0 ** -10 * rms(dv)
                if not m <= limit:
                    raise AssertionError(f"flash_bwd {name} window 1: max {m} above the "
                                         f"rounding bound {limit}")
                case[name] = {"max_abs": m, "zero_bound": limit}
            else:
                st = FA.bwd_mismatch(got[name], ref[name])
                if st["n_over"]:
                    raise AssertionError(f"flash_bwd {name} window {w}: beyond the tolerance "
                                         f"of the plain backward: {st}")
                case[name] = {"worst_ratio": st["worst_ratio"], "max_abs": st["max_abs_err"]}
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], case[name]["max_abs"])
        errs["fwd"] = max(errs["fwd"], err)
        cases[w] = case
        if w == 1:  # the planted fault: a band one column wider
            fo, _, fdq, _, fdv = kernels(2)
            fault = {"o_elements_over": FA.bwd_mismatch(fo, ro)["n_over"],
                     "dq_max_over_zero_bound": fdq.float().abs().max().item()
                     / (2.0 ** -10 * rms(dv)),
                     "dv_n_over": FA.bwd_mismatch(fdv, ref["dv"])["n_over"]}
            if not (fault["o_elements_over"] and fault["dq_max_over_zero_bound"] > 1
                    and fault["dv_n_over"]):
                raise AssertionError(f"flash window: the checks pass a band one column "
                                     f"wider: {fault}")
            cases["planted_one_wider_at_1"] = fault
            del fo, fdq, fdv
        del o, lse, dq, dk, dv, ro, rlse, ref, got
        torch.cuda.empty_cache()
    print(json.dumps({"flash_window_checks": {str(k): v for k, v in cases.items()}}))

    # timings at Mistral's window
    w = WINDOW
    o, lse = FA.flash_fwd(q, k, v, w)
    delta = FA._delta(o, do)
    band = torch.ones(S, S, dtype=torch.bool, device=q.device).tril().triu(1 - w)
    G = H // KV
    qt, dot = q.transpose(1, 2), do.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    ot = F.scaled_dot_product_attention(*leaves, attn_mask=band)
    sdpa_bwd = lambda: torch.autograd.grad(ot, leaves, dot, retain_graph=True)
    pairs = B * H * _live_pairs(S, w)
    io_in = B * S * (2 * H + 2 * KV) * D * 2 + 2 * B * H * S * 4  # q, k, v, dO, lse, delta
    shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, window {w}"
    out = {}
    out["flash_fwd[window]"] = dict(
        max_abs_err=errs["fwd"], shape=shape,
        **_timings(lambda: FA.flash_fwd(q, k, v, w), lambda: _plain_fwd_grouped(FA, q, k, v, w),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band), 5),
        bound=bound_ms(B * S * (H * 2 + KV * 2) * D * 2 + B * H * S * 4, 4.0 * pairs * D))
    plain_bwd = lambda: _plain_bwd_grouped(FA, q, k, v, lse, delta, do, w)
    out["flash_bwd_dq[window]"] = dict(
        max_abs_err=errs["dq"], shape=shape,
        **_timings(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, w), plain_bwd, sdpa_bwd, 5),
        bound=bound_ms(io_in + B * S * H * D * 2, 3 * 2.0 * pairs * D))
    out["flash_bwd_dkv[window]"] = dict(
        max_abs_err=errs["dkv"], shape=shape,
        **_timings(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, w), plain_bwd, sdpa_bwd,
                   5),
        bound=bound_ms(io_in + 2 * B * S * KV * D * 2, 4 * 2.0 * pairs * D))
    print(json.dumps({"flash_window_vs_sdpa": {
        "window": w, "live_pairs_per_head": _live_pairs(S, w),
        "causal_pairs_per_head": _live_pairs(S, 0),
        "fwd_ms": out["flash_fwd[window]"]["ms"],
        "sdpa_fwd_ms": out["flash_fwd[window]"]["library_ms"],
        "dq_plus_dkv_ms": out["flash_bwd_dq[window]"]["ms"] + out["flash_bwd_dkv[window]"]["ms"],
        "sdpa_bwd_ms": out["flash_bwd_dq[window]"]["library_ms"], "shape": shape}}))
    del ot, leaves, band
    torch.cuda.empty_cache()
    return out


DECODE_MODES = ("paged_decode_fused", "paged_decode_attention", "paged_decode_fused_int8",
                "paged_decode_attention_int8")


def _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, seed):
    """Decode rows with contexts `ctx_list`, each row's blocks scattered
    over an arena of just enough blocks (a scratch block last), bf16 and
    int8 pools of the same rows, and new K/V rows with their slots.
    Returns (inputs dict, call, run): call(name, window, pools, kernel=True,
    alibi=None, allowed=None, q=None) is the output of one decode mode (the
    kernel, or its plain version) on `pools`, which the fused modes write
    in place; run(name, window, kernel=True, alibi=None, allowed=None,
    q=None) is (output, written pools) on copies of the mode's pools.
    `allowed` is the layout bitmap [S, NB] int32; `q` replaces the
    fixture's queries."""
    import torch

    S = len(ctx_list)
    per_row = -(-max(ctx_list) // bs)
    nblk = S * per_row + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(nblk - 1, generator=g, device=dev).to(torch.int32)
    tables = torch.full((S, NB), nblk - 1, dtype=torch.int32, device=dev)
    tables[:, :per_row] = perm.reshape(S, per_row)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
    queries = randn(S, H, D)
    k_new, v_new = randn(S, KV, D), randn(S, KV, D)
    pos = (ctx - 1).long()
    slots = (tables[torch.arange(S, device=dev), pos // bs].long() * bs + pos % bs).to(torch.int32)
    bf16_pools = [randn(nblk, bs, KV, D), randn(nblk, bs, KV, D)]
    qk, ks, qv, vs = PA.quantize_kv_rows(randn(nblk * bs, KV, D), randn(nblk * bs, KV, D))
    int8_pools = [qk.reshape(nblk, bs, KV, D), qv.reshape(nblk, bs, KV, D),
                  ks.reshape(nblk, bs, KV), vs.reshape(nblk, bs, KV)]
    kernels = {name: getattr(PA, name) for name in DECODE_MODES}

    def call(name, window, pools, kernel=True, alibi=None, allowed=None, q=None):
        fused = "fused" in name
        if kernel:
            fn = kernels[name]
        else:
            fn = PA.paged_decode_fused_plain if fused else PA.paged_decode_attention_plain
        extra = (k_new, v_new, slots) if fused else ()
        out = fn(queries if q is None else q, pools[0], pools[1], tables, ctx, *extra,
                 *pools[2:], window=window, alibi_slopes=alibi, allowed_slots=allowed)
        return out[0] if fused else out

    def run(name, window, kernel=True, alibi=None, allowed=None, q=None):
        pools = [p.clone() for p in (int8_pools if "int8" in name else bf16_pools)]
        return call(name, window, pools, kernel, alibi, allowed, q), pools

    inputs = dict(S=S, nblk=nblk, tables=tables, ctx=ctx, q=queries, k_new=k_new,
                  v_new=v_new, slots=slots)
    return inputs, call, run


def _decode_bytes(name, S, H, KV, D, NB, live_positions):
    """Bytes a decode mode must move: q in and out, tables, ctx, each live
    position's K and V (codes and scales on int8) once; the fused modes
    also read the new rows and write their slot."""
    quant = "int8" in name
    pos_bytes = KV * (D + 4) * 2 if quant else 2 * KV * D * 2
    io = S * H * D * 2 * 2 + S * NB * 4 + S * 4
    if "fused" in name:
        return io + (live_positions - S) * pos_bytes + S * (KV * D * 2 * 2 + pos_bytes + 4)
    return io + live_positions * pos_bytes


def _decode_window_checks(PA, randn, dev, bound_ms):
    """The window modes of kernels #4 and #5 (bf16 plain and fused, int8
    plain and fused) at the Mistral serving shape, 8 rows with ctx on both
    sides of the window (100 ... 8000; ctx 6170 starts the 4096 window in
    mid-block), each row's 63 blocks scattered over the arena, against the
    plain versions (windows WINDOW_CASES; window >= every ctx bit-identical
    to window 0; the fused modes' written pools bit-exact) and two planted
    faults: window 1 run as 2 (one column wider) and window 1000 run as 0
    (the column loop started at 0). Times at window 4096; the bound counts
    the bytes of min(ctx, window) positions of each row."""
    import torch

    mid = WINDOW_CASES[1]  # 1000
    cfg_w = MISTRAL
    H, KV = cfg_w["n_heads"], cfg_w["n_kv_heads"]
    D = cfg_w["d_model"] // H
    bs = SERVE_W["kv_block_size"]
    NB = SERVE_W["max_seq_len"] // bs
    ctx_list = list(DECODE_W_CTX)
    x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 5)
    S, nblk = x["S"], x["nblk"]

    results, report = {}, {}
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    live = [min(c, WINDOW) for c in ctx_list]
    for name in DECODE_MODES:
        base, _ = run(name, 0)
        for w in (max(ctx_list), 10 ** 6):
            o, _ = run(name, w)
            torch.cuda.synchronize()
            if not torch.equal(o, base):
                raise AssertionError(f"{name} window {w} >= ctx differs from window 0")
        errs, plain = {}, {}
        for w in WINDOW_CASES:
            (o, pk), (ref, pr) = run(name, w), run(name, w, kernel=False)
            errs[w] = _check_close(f"{name} window {w}", o, ref, atol, rtol)
            if "fused" in name:
                for a, b in zip(pk, pr):
                    _check_close(f"{name} window {w} pools", a, b, 0.0, 0.0)
            plain[w] = ref
        faults = {"one_wider_at_1": _n_over(run(name, 2)[0], plain[1], atol, rtol),
                  f"start_at_0_at_{mid}": _n_over(run(name, 0)[0], plain[mid], atol, rtol)}
        if not all(faults.values()):
            raise AssertionError(f"{name}: the window check passes a planted fault: {faults}")
        report[name] = {"max_abs_err": errs, "planted_faults_elements_over": faults}
        quant = "int8" in name
        pools, ref_pools = run(name, 0)[1], run(name, 0)[1]
        results[f"{name}[window]"] = dict(
            max_abs_err=max(errs.values()),
            **_timings(lambda: call(name, WINDOW, pools),
                       lambda: call(name, WINDOW, ref_pools, kernel=False), None, 20),
            shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, window {WINDOW}, H={H}, "
                  f"KV={KV}, D={D}, bs={bs}, {'int8' if quant else 'bf16'} pools "
                  f"of {nblk} blocks",
            bound=bound_ms(_decode_bytes(name, S, H, KV, D, NB, sum(live)),
                           4 * sum(live) * H * D))
        del plain, pools, ref_pools
    print(json.dumps({"decode_window_checks": {"ctx": ctx_list, **report}}))
    return results


def _n_over(got, ref, atol, rtol):
    """Elements of `got` beyond atol + rtol * |ref| (non-finite ones too)."""
    import torch

    err = (got.float() - ref.float()).abs()
    return int(((err > atol + rtol * ref.float().abs()) | ~torch.isfinite(got.float())).sum())


# ---------------------------------------------------------------------------
# phase 2, the ALiBi modes: flash #1 and decode #4/#5 with slopes
# ---------------------------------------------------------------------------

def _slopes(H, scale, dev):
    from deepspeed_tpu_torch.ops.attention import alibi_slopes

    return (alibi_slopes(H) * scale).to(dev)


def _sdpa_alibi_mask(slopes, S, dtype):
    """SDPA's additive mask for causal ALiBi, [1, H, S, S] in q's dtype:
    slope_h * (c - r) on and below the diagonal, -inf above it."""
    import torch

    pos = torch.arange(S, device=slopes.device)
    rel = (pos[None, :] - pos[:, None]).float()
    bias = slopes[:, None, None] * rel
    return bias.masked_fill(rel > 0, float("-inf"))[None].to(dtype)


def _flash_alibi_checks(FA, randn, dev, bound_ms):
    """Kernel #1's ALiBi mode against its plain version on the same bf16
    inputs (o under bwd_mismatch, lse at 1e-3) in the cases of
    FLASH_ALIBI_CASES: Bloom's prefill shape, falcon-rw-1b's head_dim 64
    with its 1/sqrt(64) slope scale, GQA, a head count that is no power of
    two, and ALiBi with window 1000. All-zero slopes and a window >= S give
    the causal (ALiBi) result bit for bit. Planted faults that must fail:
    the slopes rotated by one head, the bias with its sign flipped, and,
    with GQA, each q head given its KV head's slope. Times at Bloom's
    prefill shape, beside SDPA with the bias as an additive float mask."""
    import torch
    import torch.nn.functional as F

    report, timed = {}, None
    for case, c in FLASH_ALIBI_CASES.items():
        B, S, H, KV, D, w = (c[x] for x in ("B", "S", "H", "KV", "D", "window"))
        q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
        sl = _slopes(H, c["scale"], dev)
        o, lse = FA.flash_fwd(q, k, v, w, sl)
        ro, rlse = FA.flash_attention_plain(q, k, v, w, sl)
        st = _check_flash_o(FA, f"flash_fwd[alibi] {case} o", o, ro)
        _check_close(f"flash_fwd[alibi] {case} lse", lse, rlse, 1e-3, 1e-3)
        G = H // KV
        faults = {"slopes_rotated_by_one_head": torch.roll(sl, 1)}
        if case == "bloom_prefill":
            faults["bias_sign_flipped"] = -sl
        if G > 1:
            faults["kv_head_slope_for_q_head"] = sl[torch.arange(H, device=dev) // G * G]
        over = {f: FA.bwd_mismatch(FA.flash_fwd(q, k, v, w, fs)[0], ro)["n_over"]
                for f, fs in faults.items()}
        if not all(over.values()):
            raise AssertionError(f"flash_fwd[alibi] {case}: the o check passes a planted "
                                 f"fault: {over}")
        same = {"zero_slopes_vs_no_alibi": torch.equal(
            FA.flash_fwd(q, k, v, w, torch.zeros_like(sl))[0], FA.flash_fwd(q, k, v, w)[0])}
        if w == 0:
            same["window_ge_s_vs_causal"] = all(
                torch.equal(a, b) for a, b in zip(FA.flash_fwd(q, k, v, S, sl), (o, lse)))
        if not all(same.values()):
            raise AssertionError(f"flash_fwd[alibi] {case}: not bit-identical: {same}")
        report[case] = {"shape": c, "o_worst_ratio": st["worst_ratio"],
                        "o_max_abs_err": st["max_abs_err"],
                        "planted_faults_o_elements_over": over, "bit_identical": same}
        if case == "bloom_prefill":
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = _sdpa_alibi_mask(sl, S, q.dtype)
            timed = dict(
                max_abs_err=st["max_abs_err"],
                **_timings(lambda: FA.flash_fwd(q, k, v, 0, sl),
                           lambda: FA.flash_attention_plain(q, k, v, 0, sl),
                           lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                           10),
                shape=f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal ALiBi",
                bound=bound_ms(B * S * (H * 2 + KV * 2) * D * 2 + B * H * S * 4 + H * 4,
                               4.0 * B * H * D * S * (S + 1) / 2),
                causal_ms=_device_ms(lambda: FA.flash_fwd(q, k, v), 10))
            del qt, kt, vt, mask
        else:
            timed["max_abs_err"] = max(timed["max_abs_err"], st["max_abs_err"])
        del q, k, v, o, lse, ro, rlse
        torch.cuda.empty_cache()
    print(json.dumps({"flash_alibi_checks": report}))
    print(json.dumps({"flash_alibi_vs_sdpa": {
        "fwd_ms": timed["ms"], "sdpa_float_mask_ms": timed["library_ms"],
        "ratio": timed["ms"] / timed["library_ms"], "causal_same_shape_ms": timed["causal_ms"],
        "shape": timed["shape"]}}))
    return {"flash_fwd[alibi]": timed}


def _flash_bwd_alibi_checks(FA, randn, dev, bound_ms):
    """Kernels #2 (dq) and #3 (dk, dv) in their ALiBi mode against the
    plain backward on the kernel forward's o and lse, on the same bf16
    inputs, under bwd_mismatch, in the cases of FLASH_BWD_ALIBI_CASES
    (S=2048): Bloom's training heads, falcon-rw-1b's head_dim 64 with its
    1/8 slope scale, GQA 32 / 8, 24 heads and ALiBi with window 1000.
    All-zero slopes give the backward without ALiBi bit for bit, and a
    window >= S the causal ALiBi backward (both on the same lse and
    delta). Planted faults in the backward alone (the forward's lse kept)
    must fail: the slopes rotated by one head, the bias's sign flipped,
    with GQA each q head given its KV head's slope (dk, dv), and the bias
    dropped. Then times both kernels at BLOOM's training micro-batch
    (ALIBI_BWD_TIMED) beside the causal mode, the plain backward and
    SDPA's backward with the bias as an additive bf16 mask."""
    import torch
    import torch.nn.functional as F

    names = ("dq", "dk", "dv")

    def bwd(q, k, v, do, lse, delta, w, sl):
        return dict(zip(names, (FA.flash_bwd_dq(q, k, v, do, lse, delta, w, sl),)
                        + FA.flash_bwd_dkv(q, k, v, do, lse, delta, w, sl)))

    report, errs = {}, {"dq": 0.0, "dkv": 0.0}
    for case, c in FLASH_BWD_ALIBI_CASES.items():
        B, S, H, KV, D, w = (c[x] for x in ("B", "S", "H", "KV", "D", "window"))
        q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
        sl = _slopes(H, c["scale"], dev)
        o, lse = FA.flash_fwd(q, k, v, w, sl)
        delta = FA._delta(o, do)
        got = bwd(q, k, v, do, lse, delta, w, sl)
        ref = dict(zip(names, FA._bwd_plain(q, k, v, lse, delta, do, w, sl)))
        case_report = {"shape": c}
        for name in names:
            st = FA.bwd_mismatch(got[name], ref[name])
            if st["n_over"]:
                raise AssertionError(f"flash_bwd[alibi] {case} {name}: beyond the tolerance of "
                                     f"the plain backward: {st}")
            case_report[name] = {"worst_ratio": st["worst_ratio"], "max_abs": st["max_abs_err"]}
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs[key], st["max_abs_err"])
        G = H // KV
        faults = {"slopes_rotated_by_one_head": (torch.roll(sl, 1), names),
                  "bias_sign_flipped": (-sl, names),
                  "bias_dropped_from_the_backward": (None, names)}
        if G > 1:
            faults["kv_head_slope_for_q_head"] = (sl[torch.arange(H, device=dev) // G],
                                                  ("dk", "dv"))
        over = {}
        for f, (fs, hit) in faults.items():
            spoiled = bwd(q, k, v, do, lse, delta, w, fs)
            over[f] = {n: FA.bwd_mismatch(spoiled[n], ref[n])["n_over"] for n in hit}
            if not all(over[f].values()):
                raise AssertionError(f"flash_bwd[alibi] {case}: the check passes a planted "
                                     f"fault: {f} {over[f]}")
        zero = bwd(q, k, v, do, lse, delta, w, torch.zeros_like(sl))
        plain_mode = bwd(q, k, v, do, lse, delta, w, None)
        same = {"zero_slopes_vs_no_alibi": all(torch.equal(zero[n], plain_mode[n])
                                               for n in names)}
        if w == 0:
            wide = bwd(q, k, v, do, lse, delta, S, sl)
            same["window_ge_s_vs_causal"] = all(torch.equal(wide[n], got[n]) for n in names)
        if not all(same.values()):
            raise AssertionError(f"flash_bwd[alibi] {case}: not bit-identical: {same}")
        case_report.update({"planted_faults_elements_over": over, "bit_identical": same})
        report[case] = case_report
        del q, k, v, do, o, lse, delta, got, ref, zero, plain_mode
        torch.cuda.empty_cache()
    print(json.dumps({"flash_bwd_alibi_checks": {
        "rtol": FA.BWD_RTOL, "row_rms_atol": FA.BWD_ROW_ATOL, "floor": FA.BWD_FLOOR,
        **report}}))

    # timings at BLOOM's training micro-batch
    B, S, H, KV, D = (ALIBI_BWD_TIMED[x] for x in ("B", "S", "H", "KV", "D"))
    q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
    sl = _slopes(H, 1.0, dev)
    o, lse = FA.flash_fwd(q, k, v, 0, sl)
    delta = FA._delta(o, do)
    o0, lse0 = FA.flash_fwd(q, k, v)
    delta0 = FA._delta(o0, do)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=_sdpa_alibi_mask(sl, S, q.dtype))
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
    plain_bwd = lambda: FA._bwd_plain(q, k, v, lse, delta, do, 0, sl)
    pairs = B * H * S * (S + 1) / 2
    io_in = B * S * (2 * H + 2 * KV) * D * 2 + 2 * B * H * S * 4 + H * 4  # + the slopes
    shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal ALiBi"
    out = {
        "flash_bwd_dq[alibi]": dict(
            max_abs_err=errs["dq"], shape=shape,
            **_timings(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta, 0, sl), plain_bwd,
                       sdpa_bwd, 5),
            bound=bound_ms(io_in + B * S * H * D * 2, 3 * 2.0 * pairs * D),
            causal_ms=_device_ms(lambda: FA.flash_bwd_dq(q, k, v, do, lse0, delta0), 5)),
        "flash_bwd_dkv[alibi]": dict(
            max_abs_err=errs["dkv"], shape=shape,
            **_timings(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta, 0, sl), plain_bwd,
                       sdpa_bwd, 5),
            bound=bound_ms(io_in + 2 * B * S * KV * D * 2, 4 * 2.0 * pairs * D),
            causal_ms=_device_ms(lambda: FA.flash_bwd_dkv(q, k, v, do, lse0, delta0), 5))}
    dq_, dkv_ = out["flash_bwd_dq[alibi]"], out["flash_bwd_dkv[alibi]"]
    print(json.dumps({"flash_bwd_alibi_vs_sdpa": {
        "dq_ms": dq_["ms"], "dkv_ms": dkv_["ms"], "dq_causal_ms": dq_["causal_ms"],
        "dkv_causal_ms": dkv_["causal_ms"], "plain_bwd_ms": dq_["plain_ms"],
        "sdpa_bwd_bf16_bias_mask_ms": dq_["library_ms"],
        "ratio": (dq_["ms"] + dkv_["ms"]) / dq_["library_ms"], "shape": shape}}))
    del q, k, v, do, o, lse, delta, o0, lse0, delta0, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return out


def _decode_new_col_at(PA, q, pools, tables, ctx, slopes, at=None):
    """Dense f32 decode over already-written pools with the ALiBi bias at
    absolute positions, except that, given `at`, each row's new token
    (position ctx - 1) is biased as if at position `at`: what a fused
    kernel that biased its new column there would output (the planted
    fault at 0)."""
    import torch

    S, H, D = q.shape
    KV = pools[0].shape[2]
    tbl = tables.long()
    k = pools[0][tbl].reshape(S, -1, KV, D)
    v = pools[1][tbl].reshape(S, -1, KV, D)
    if len(pools) > 2:
        k = PA.dequantize(k, pools[2][tbl].reshape(S, -1, KV), q.dtype)
        v = PA.dequantize(v, pools[3][tbl].reshape(S, -1, KV), q.dtype)
    k, v = (x.float().repeat_interleave(H // KV, 2) for x in (k, v))
    pos = torch.arange(k.shape[1], device=q.device)
    bias = (slopes[None, :, None] * pos.float()).expand(S, H, -1).clone()
    if at is not None:
        bias[torch.arange(S, device=q.device), :, (ctx - 1).long()] = slopes * float(at)
    logits = torch.einsum("shd,skhd->shk", q.float(), k) / D ** 0.5 + bias
    logits = logits.masked_fill(~(pos[None, :] < ctx[:, None])[:, None, :], float("-inf"))
    return torch.einsum("shk,skhd->shd", logits.softmax(-1), v).to(q.dtype)


def _decode_alibi_checks(PA, randn, dev, bound_ms):
    """The ALiBi modes of kernels #4 and #5 (bf16 plain and fused, int8
    plain and fused) at BLOOM-7B1's decode shape (32 x 128 heads, no GQA),
    8 rows with ctx DECODE_ALIBI_CTX (~100 to ~2,000, where the bias reaches
    ~1,700), against the plain versions at one bf16 ulp, without and with
    window ALIBI_WINDOW; the fused modes' written pools bit-exact; all-zero
    slopes bit-identical to no ALiBi and a window >= every ctx to window 0.
    Planted faults that must fail: the slopes rotated by one head, and (the
    fused modes) the new column biased at position 0 instead of ctx - 1.
    Times without the window; the bound counts each row's ctx positions."""
    import torch

    H = KV = BLOOM["n_heads"]  # no GQA
    D = BLOOM["d_model"] // H
    bs = SERVE_A["kv_block_size"]
    NB = SERVE_A["max_seq_len"] // bs
    ctx_list = list(DECODE_ALIBI_CTX)
    x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 6)
    S, nblk, ctx = x["S"], x["nblk"], x["ctx"]
    sl = _slopes(H, 1.0, dev)
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    results, report = {}, {}
    for name in DECODE_MODES:
        fused = "fused" in name
        same = {"zero_slopes_vs_no_alibi": torch.equal(
            run(name, 0, alibi=torch.zeros_like(sl))[0], run(name, 0)[0])}
        base, _ = run(name, 0, alibi=sl)
        same["window_ge_ctx_vs_window_0"] = all(
            torch.equal(run(name, w, alibi=sl)[0], base) for w in (max(ctx_list), 10 ** 6))
        if not all(same.values()):
            raise AssertionError(f"{name}[alibi]: not bit-identical: {same}")
        errs, plain = {}, {}
        for w in (0, ALIBI_WINDOW):
            (o, pk), (ref, pr) = run(name, w, alibi=sl), run(name, w, kernel=False, alibi=sl)
            errs[w] = _check_close(f"{name}[alibi] window {w}", o, ref, atol, rtol)
            if fused:
                for a, b in zip(pk, pr):
                    _check_close(f"{name}[alibi] window {w} pools", a, b, 0.0, 0.0)
            plain[w] = (ref, pr)
        faults = {"slopes_rotated_by_one_head": _n_over(
            run(name, 0, alibi=torch.roll(sl, 1))[0], plain[0][0], atol, rtol)}
        if fused:
            # over the plain version's written pools; without its fault the
            # emulation must agree with the plain version
            args = (PA, x["q"], plain[0][1], x["tables"], ctx, sl)
            _check_close(f"{name}[alibi] dense emulation", _decode_new_col_at(*args),
                         plain[0][0], atol, rtol)
            faults["new_column_at_position_0"] = _n_over(_decode_new_col_at(*args, at=0),
                                                         plain[0][0], atol, rtol)
        if not all(faults.values()):
            raise AssertionError(f"{name}[alibi]: the check passes a planted fault: {faults}")
        pools, ref_pools = run(name, 0)[1], run(name, 0)[1]
        report[name] = {"max_abs_err": errs, "planted_faults_elements_over": faults,
                        "bit_identical": same,
                        "no_alibi_same_rows_ms": _device_ms(lambda: call(name, 0, pools), 20)}
        results[f"{name}[alibi]"] = dict(
            max_abs_err=max(errs.values()),
            **_timings(lambda: call(name, 0, pools, alibi=sl),
                       lambda: call(name, 0, ref_pools, kernel=False, alibi=sl), None, 20),
            shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, H={H}, KV={KV}, D={D}, "
                  f"bs={bs}, {'int8' if 'int8' in name else 'bf16'} pools of {nblk} blocks, "
                  "ALiBi",
            bound=bound_ms(_decode_bytes(name, S, H, KV, D, NB, sum(ctx_list)) + H * 4,
                           4 * sum(ctx_list) * H * D))
        del plain, pools, ref_pools
    print(json.dumps({"decode_alibi_checks": {"ctx": ctx_list, "window": ALIBI_WINDOW,
                                              **report}}))
    return results


# ---------------------------------------------------------------------------
# phase 2, the block-sparse modes: decode #4/#5 with a layout bitmap
# ---------------------------------------------------------------------------

def _decode_sparse_checks(PA, randn, dev, bound_ms):
    """The layout-bitmap modes of kernels #4 and #5 (bf16 plain and fused,
    int8 plain and fused) at Llama-2-7B's decode shape (32 x 128 heads, no
    GQA), 8 rows with ctx DECODE_SPARSE_CTX (~100 to ~4,000), against the
    plain versions at one bf16 ulp, at 128-token cache blocks (table width
    32) and at 16-token blocks (width 256: a kernel tile spans four
    blocks). Bitmaps: the rows of the serving layout (LLAMA2_7B's fixed
    layout at bs 128; SPARSE_BLOCK_16 at bs 16), of a bigbird layout with
    the same block, and random ones that keep each row's own block; the
    fused modes' written pools bit-exact; an all-ones bitmap bit-identical
    to none. Planted faults that must fail against the plain version with
    the fixed layout: the kernel given all ones (the layout would not
    bite), the bitmap shifted by one block and, at bs 16, each group of
    four blocks given its first block's bit (a per-tile decision). Times at
    bs 128 with the fixed layout, beside the same kernel without a bitmap
    at the same shape; the bound counts the allowed live positions only."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    from deepspeed_tpu_torch.ops.sparse_attention import SparsityConfig

    ml = TransformerConfig(**LLAMA2_7B)
    H, KV, D = ml.n_heads, ml.kv_heads, ml.head_dim
    ctx_list = list(DECODE_SPARSE_CTX)
    S = len(ctx_list)
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    results, report = {}, {}
    serve_bs = SERVE_S["kv_block_size"]
    for bs, fixed in ((serve_bs, ml.sparsity_config()), (16, SparsityConfig(**SPARSE_BLOCK_16))):
        NB = SERVE_S["max_seq_len"] // bs
        x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 7 + bs)
        pos = x["ctx"] - 1
        g = torch.Generator(device=dev).manual_seed(bs)
        rand = (torch.rand(S, NB, generator=g, device=dev) < 0.5).to(torch.int32)
        rand[torch.arange(S, device=dev), pos // bs] = 1
        bigbird = dataclasses.replace(fixed, mode="bigbird", num_random_blocks=2)
        lay = M._sparse_decode_allowed_slots(fixed, pos, NB, bs)
        bitmaps = {"fixed": lay, "bigbird": M._sparse_decode_allowed_slots(bigbird, pos, NB, bs),
                   "random": rand}
        ones = torch.ones_like(lay)
        faulty = {"all_ones": ones, "shifted_by_one_block": torch.roll(lay, 1, dims=1)}
        if bs < 64:
            per_tile = 64 // bs
            faulty["tile_takes_its_first_block"] = lay.view(S, -1, per_tile)[:, :, :1].expand(
                S, NB // per_tile, per_tile).reshape(S, NB).contiguous()
        cols = torch.arange(NB * bs, device=dev)
        allowed_cols = lay.bool().repeat_interleave(bs, 1)
        for name in DECODE_MODES:
            fused = "fused" in name
            same = torch.equal(run(name, 0, allowed=ones)[0], run(name, 0)[0])
            if not same:
                raise AssertionError(f"{name}[sparse] bs {bs}: an all-ones bitmap is not "
                                     "bit-identical to none")
            errs, plain = {}, {}
            for b, bm in bitmaps.items():
                (o, pk), (ref, pr) = run(name, 0, allowed=bm), run(name, 0, kernel=False,
                                                                   allowed=bm)
                errs[b] = _check_close(f"{name}[sparse] bs {bs} {b}", o, ref, atol, rtol)
                if fused:
                    for a, c in zip(pk, pr):
                        _check_close(f"{name}[sparse] bs {bs} {b} pools", a, c, 0.0, 0.0)
                plain[b] = ref
            faults = {f: _n_over(run(name, 0, allowed=bm)[0], plain["fixed"], atol, rtol)
                      for f, bm in faulty.items()}
            if not all(faults.values()):
                raise AssertionError(f"{name}[sparse] bs {bs}: the check passes a planted "
                                     f"fault: {faults}")
            entry = {"max_abs_err": errs, "planted_faults_elements_over": faults,
                     "all_ones_bit_identical_to_none": same}
            report[f"{name}@bs{bs}"] = entry
            if bs != serve_bs:
                continue
            pools, ref_pools, null_pools = (run(name, 0)[1] for _ in range(3))
            null_ms = _device_ms(lambda: call(name, 0, null_pools), 20)
            live = int(((cols[None] < x["ctx"][:, None] - int(fused)) & allowed_cols).sum())
            live += S if fused else 0
            timed = _timings(lambda: call(name, 0, pools, allowed=lay),
                             lambda: call(name, 0, ref_pools, kernel=False, allowed=lay), None,
                             20)
            entry.update(null_bitmap_ms=null_ms, skip_speedup=null_ms / timed["ms"],
                         live_positions=live, ctx_positions=sum(ctx_list))
            results[f"{name}[sparse]"] = dict(
                max_abs_err=max(errs.values()), **timed, null_bitmap_ms=null_ms,
                shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, H={H}, KV={KV}, D={D}, "
                      f"bs={bs}, {'int8' if 'int8' in name else 'bf16'} pools of "
                      f"{x['nblk']} blocks, fixed layout (block {fixed.block}, "
                      f"{live} of {sum(ctx_list)} positions)",
                bound=bound_ms(_decode_bytes(name, S, H, KV, D, NB, live) + S * NB * 4,
                               4 * live * H * D))
            del pools, ref_pools, null_pools
        del x, call, run, plain
        torch.cuda.empty_cache()
    print(json.dumps({"decode_sparse_checks": {"ctx": ctx_list, **report}}))
    return results


# ---------------------------------------------------------------------------
# phase 2, the wide-group and head_dim-80 modes (Falcon-7B, Phi-2)
# ---------------------------------------------------------------------------

def _chunk0_heads(q, KV):
    """q [S, H, D] with each query head of chunk c > 0 of every KV head's
    group given the query of the same head of chunk 0 (head g -> g % 8):
    what a kernel whose chunks c > 0 read chunk 0's heads attends with."""
    import torch

    S, H, D = q.shape
    G = H // KV
    idx = torch.arange(G, device=q.device) % 8
    return q.view(S, KV, G, D)[:, :, idx].reshape(S, H, D).contiguous()


def _unrounded_new_column(PA, q, pools, tables, ctx, k_new, v_new, slots):
    """What a fused int8 decode outputs if it attends each row's new token
    with the raw bf16 k_new/v_new instead of their dequantized codes: the
    plain decode over the written int8 pools dequantized to bf16, each
    row's new slot holding the raw row."""
    KV, D = pools[0].shape[2:]
    k = PA.dequantize(pools[0], pools[2], q.dtype)
    v = PA.dequantize(pools[1], pools[3], q.dtype)
    k.view(-1, KV, D)[slots.long()] = k_new
    v.view(-1, KV, D)[slots.long()] = v_new
    return PA.paged_decode_attention_plain(q, k, v, tables, ctx)


def _unrounded_column_fault(PA, x, run, name, KV, G):
    """The int8 fused wide-group fault. Every q head is made 4 x its KV
    head's new key, so the new column dominates each softmax (a score of
    ~32 against ~±4 for the others) and its rounding reaches the output.
    There the kernel must still pass against the plain version, and the
    output whose chunks c > 0 attended the un-rounded new column must not.
    Returns the elements of that output beyond the tolerance."""
    S, H, D = x["q"].shape
    q = (4.0 * x["k_new"].float()).repeat_interleave(G, dim=1).to(x["q"].dtype).contiguous()
    (o, pk), (ref, _) = run(name, 0, q=q), run(name, 0, kernel=False, q=q)
    _check_close(f"{name}[wide_group] dominant new column", o, ref, *KERNEL_TOL[name])
    bad = _unrounded_new_column(PA, q, pk, x["tables"], x["ctx"], x["k_new"], x["v_new"],
                                x["slots"])
    fault = o.clone()
    fault.view(S, KV, G, D)[:, :, 8:] = bad.view(S, KV, G, D)[:, :, 8:]
    return _n_over(fault, ref, *KERNEL_TOL[name])


def _decode_group_checks(PA, randn, dev, bound_ms):
    """The wide-group mode of kernels #4 and #5 (bf16 plain and fused, int8
    plain and fused: one CTA holds a KV head's whole group, in 16-row
    slices of the mma products) in the cases of DECODE_GROUP_CASES
    (Falcon-7B's 71 query heads of 64 over one KV head, a generic GQA 16
    over 2 at 128), 8 rows with ctx DECODE_FP_CTX (~100 to ~1,950) at
    128-token blocks, against the plain versions at one bf16 ulp; the fused
    modes' written pools bit-exact. Planted faults that must fail against
    the plain version (named for the chunks of 8 heads of the kernel
    before split-K; what they guard now): query heads 8 and up given the
    query of head g % 8 (the kernel run on _chunk0_heads: each 16-row
    slice, and each half of one, must read its own heads), at Falcon-7B's
    shape heads 64-70
    dropped (the partial last slice, 7 live rows of 16), and in the int8
    fused mode heads 8 and up attending the un-rounded new column
    (_unrounded_column_fault: every slice must attend the dequantized new
    row). Times at Falcon-7B's shape; the bound counts each row's ctx
    positions once."""
    import torch

    bs = SERVE_A["kv_block_size"]
    NB = SERVE_A["max_seq_len"] // bs
    ctx_list = list(DECODE_FP_CTX)
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    results, report = {}, {}
    for seed, (case, c) in enumerate(DECODE_GROUP_CASES.items()):
        H, KV, D = c["H"], c["KV"], c["D"]
        G = H // KV
        x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 11 + seed)
        S, nblk = x["S"], x["nblk"]
        q_bad = _chunk0_heads(x["q"], KV)
        for name in DECODE_MODES:
            (o, pk), (ref, pr) = run(name, 0), run(name, 0, kernel=False)
            err = _check_close(f"{name}[wide_group] {case}", o, ref, atol, rtol)
            if "fused" in name:
                for a, b in zip(pk, pr):
                    _check_close(f"{name}[wide_group] {case} pools", a, b, 0.0, 0.0)
            faults = {"chunk_c_given_chunk_0_heads": _n_over(run(name, 0, q=q_bad)[0], ref,
                                                             atol, rtol)}
            if G % 8:
                dropped = o.clone()
                dropped.view(S, KV, G, D)[:, :, G // 8 * 8:] = 0
                faults[f"last_chunk_heads_{G // 8 * 8}_{G - 1}_dropped"] = _n_over(
                    dropped, ref, atol, rtol)
            if name == "paged_decode_fused_int8":
                faults["chunk_uses_unrounded_new_column"] = _unrounded_column_fault(
                    PA, x, run, name, KV, G)
            if not all(faults.values()):
                raise AssertionError(f"{name}[wide_group] {case}: the check passes a planted "
                                     f"fault: {faults}")
            report[f"{name}@{case}"] = {"max_abs_err": err,
                                        "planted_faults_elements_over": faults}
            if case != "falcon_7b":
                continue
            pools, ref_pools = run(name, 0)[1], run(name, 0)[1]
            results[f"{name}[wide_group]"] = dict(
                max_abs_err=err,
                **_timings(lambda: call(name, 0, pools),
                           lambda: call(name, 0, ref_pools, kernel=False), None, 20),
                shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, H={H}, KV={KV}, D={D}, "
                      f"bs={bs}, {'int8' if 'int8' in name else 'bf16'} pools of {nblk} "
                      f"blocks, the group in {-(-G // 16)} slices of 16 rows",
                bound=bound_ms(_decode_bytes(name, S, H, KV, D, NB, sum(ctx_list)),
                               4 * sum(ctx_list) * H * D))
            del pools, ref_pools
        del x, call, run
        torch.cuda.empty_cache()
    print(json.dumps({"decode_group_checks": {"ctx": ctx_list, **report}}))
    return results


# phase 2's split-K design checks of #4/#5: the cases (the
# phase-2 fixtures of Falcon-7B's wide group and Mistral's window), the
# ring depth of csrc/paged_decode.cu and its tile
DECODE_DESIGN_CASES = {"falcon_7b": dict(H=71, KV=1, D=64, serve=SERVE_A, ctx=DECODE_FP_CTX,
                                         window=0),
                       "mistral_window": dict(H=32, KV=8, D=128, serve=SERVE_W,
                                              ctx=DECODE_W_CTX, window=WINDOW)}
DECODE_RING_STAGES, DECODE_TILE = 3, 64

# #6's int8 write at the shapes that bound it (csrc/paged_kv_write.cu): the
# flagship's prefill wave (8 prompts of 96 tokens in 128-row buckets: 768
# of 1024 rows live), Phi-2's and Falcon-7B's 1920-token prompts in the
# 2048 bucket (32 KV heads of 80; one of 64) and Mistral 7B's 6144-token
# prompt in the 8192 bucket (8 KV heads of 128): T rows in buckets of
# `bucket`, the first `live` of each live; H query heads and the decode
# rows' ctx of the fused int8 decode checked beside it
KV_WRITE_CASES = {
    "flagship_wave": dict(H=8, KV=8, D=128, T=N_PROMPTS * PROMPT_BUCKET, bucket=PROMPT_BUCKET,
                          live=PROMPT_LEN, serve=SERVE,
                          ctx=tuple(PROMPT_LEN + 1 + 3 * i for i in range(N_PROMPTS))),
    "phi_2_prefill": dict(H=32, KV=32, D=80, T=2048, bucket=2048, live=A_LONG, serve=SERVE_A,
                          ctx=DECODE_FP_CTX),
    "mistral_prefill": dict(H=32, KV=8, D=128, T=8192, bucket=8192, live=W_LONG, serve=SERVE_W,
                            ctx=DECODE_W_CTX),
    "falcon_7b_prefill": dict(H=71, KV=1, D=64, T=2048, bucket=2048, live=A_LONG,
                              serve=SERVE_A, ctx=DECODE_FP_CTX),
}


def _dense_decode(PA, q, pools, tables, ctx, live, bias=None):
    """f32 decode over already-written pools: row s attends to the
    positions where live [S, NB * bs] holds, each score plus bias [S, NB *
    bs] when given (a planted fault's emulation). Returns q's dtype."""
    import torch

    S, H, D = q.shape
    KV = pools[0].shape[2]
    tbl = tables.long()
    k = pools[0][tbl].reshape(S, -1, KV, D)
    v = pools[1][tbl].reshape(S, -1, KV, D)
    if len(pools) > 2:
        k = PA.dequantize(k, pools[2][tbl].reshape(S, -1, KV), q.dtype)
        v = PA.dequantize(v, pools[3][tbl].reshape(S, -1, KV), q.dtype)
    k, v = (x.float().masked_fill(~live[:, :, None, None], 0.0).repeat_interleave(H // KV, 2)
            for x in (k, v))
    logits = torch.einsum("shd,skhd->shk", q.float(), k) / D ** 0.5
    if bias is not None:
        logits = logits + bias[:, None, :]
    logits = logits.masked_fill(~live[:, None, :], float("-inf"))
    probs = torch.nan_to_num(logits.softmax(-1))
    return torch.einsum("shk,skhd->shd", probs, v).to(q.dtype)


def _stale_ring_pools(pools, tables, ctx, window, fused, split_len, bs):
    """Copies of `pools` in which, for every row and split, the fourth tile
    the split's CTA computes holds its first tile's K/V rows (codes and
    scales on int8): what a kernel that consumed a ring stage
    (DECODE_RING_STAGES deep) before its copies landed would read. The
    CTA's tiles: the 64-aligned tiles of [max(split start, ctx - window),
    min(split end, ctx - fused)). Returns (pools, rows changed)."""
    out = [p.clone() for p in pools]
    span = tables.shape[1] * bs
    tbl = tables.tolist()
    n_changed = 0
    src_slots, dst_slots = [], []
    for s, c_ in enumerate(ctx.tolist()):
        wlo = max(c_ - window, 0) if window > 0 else 0
        hi_all = min(c_ - int(fused), span)
        for sp0 in range(0, span, split_len):
            lo, hi = max(sp0, wlo), min(sp0 + split_len, hi_all)
            first = lo // DECODE_TILE * DECODE_TILE
            stale = first + DECODE_RING_STAGES * DECODE_TILE
            for r in range(DECODE_TILE):
                src, dst = first + r, stale + r
                if lo >= hi or dst >= hi:
                    break
                src_slots.append(tbl[s][src // bs] * bs + src % bs)
                dst_slots.append(tbl[s][dst // bs] * bs + dst % bs)
                n_changed += 1
    if n_changed:
        import torch

        dev = pools[0].device
        fs, fd = (torch.tensor(x, device=dev) for x in (src_slots, dst_slots))
        for p in out:
            flat = p.view(-1, *p.shape[2:])
            flat[fd] = flat[fs]
    return out, n_changed


def _decode_design_checks(PA, randn, dev):
    """Checks aimed at the split-K design of kernels #4/#5 at
    DECODE_DESIGN_CASES, in all four modes: a second launch bit-identical
    to the first; planted faults, each an
    output the check against the plain version must fail: one split left
    out of the combine (split 1's positions taken out: _dense_decode), the
    fused new column attended by every split (its weight x n: the score +
    ln n), each split's last cache position dropped, and one ring stage
    consumed stale (the kernel run on _stale_ring_pools, where a CTA
    computes four tiles or more); without a fault the emulation must pass.
    Also the plans (splits, CTAs, scratch bytes) and the ptxas registers
    and spills of every instantiation."""
    import math

    import torch

    from deepspeed_tpu_torch.ops.cuda import build

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    report = {}
    for seed, (case, c) in enumerate(DECODE_DESIGN_CASES.items()):
        H, KV, D, window = c["H"], c["KV"], c["D"], c["window"]
        bs = c["serve"]["kv_block_size"]
        NB = c["serve"]["max_seq_len"] // bs
        ctx_list = list(c["ctx"])
        x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 21 + seed)
        S, ctx = x["S"], x["ctx"]
        plan = PA.decode_split_plan(S, KV, H // KV, D, NB * bs, sms)
        L, n = plan.split_len, plan.n
        if n < 2:
            raise AssertionError(f"decode {case}: not split, so no split can be left out")
        pos = torch.arange(NB * bs, device=dev)[None, :]
        live = pos < ctx[:, None]
        if window:
            live &= pos >= ctx[:, None] - window
        entry = {"plan": {"splits": n, "split_len": L, "ctas": plan.ctas,
                          "scratch_bytes": plan.scratch_bytes}, "modes": {}}
        for name in DECODE_MODES:
            fused = "fused" in name
            (o, pools), (ref, _) = run(name, window), run(name, window, kernel=False)
            _check_close(f"{name} design {case}", o, ref, atol, rtol)
            o2, _ = run(name, window)
            torch.cuda.synchronize()
            same = {"two_launches": torch.equal(o2, o)}
            emulate = lambda keep, bias=None: _dense_decode(PA, x["q"], pools, x["tables"], ctx,
                                                            keep, bias)
            if _n_over(emulate(live), ref, atol, rtol):
                raise AssertionError(f"{name} {case}: the dense emulation fails without a fault")
            last = torch.zeros_like(live)  # each split's last cache position
            limit = ctx.long() - int(fused)
            first_live = (ctx.long() - window).clamp(min=0) if window else torch.zeros_like(limit)
            for c_ in range(n):
                end = limit.clamp(max=(c_ + 1) * L) - 1
                ok = end >= first_live.clamp(min=c_ * L)
                last[torch.arange(S, device=dev)[ok], end[ok]] = True
            faults = {"split_1_left_out": _n_over(emulate(live & ((pos < L) | (pos >= 2 * L))),
                                                  ref, atol, rtol),
                      "each_split_last_position_dropped": _n_over(emulate(live & ~last), ref,
                                                                  atol, rtol)}
            if fused:
                bias = torch.zeros(S, NB * bs, device=dev)
                bias[torch.arange(S, device=dev), (ctx - 1).long()] = math.log(n)
                faults["new_column_in_every_split"] = _n_over(emulate(live, bias), ref, atol,
                                                              rtol)
            stale, changed = _stale_ring_pools(run(name, window)[1], x["tables"], ctx, window,
                                               fused, L, bs)
            if changed:
                faults["stale_ring_stage"] = _n_over(call(name, window, stale), ref, atol, rtol)
            elif case == "mistral_window":
                raise AssertionError(f"{name} {case}: no CTA computes four tiles; the stale "
                                     "ring stage cannot be planted")
            entry["modes"][name] = {"bit_identical": same, "planted_faults_elements_over": faults,
                                    "stale_ring_rows_changed": changed}
            if not all(same.values()):
                raise AssertionError(f"{name} {case}: launches differ: {same}")
            if not all(faults.values()):
                raise AssertionError(f"{name} {case}: the check passes a planted fault: {faults}")
            del stale, pools, o, o2, ref
        report[case] = entry
        del x, call, run
        torch.cuda.empty_cache()
    report["ptxas"] = _ptxas_registers(build, "paged_decode", ("decode_kernel",))
    print(json.dumps({"decode_design_checks": report}))
    return {}


def _nonfinite_rows(x, rows):
    """x [T, KV, D] with the four rows `rows` made non-finite in every head,
    in place: a NaN (head 0 of the first row holds 0.5, -3, NaN, 1.25, 2,
    -0.75, 0, 7 and zeros), +inf, -inf (in the last column), and a NaN
    beside a +inf. Returns x."""
    import torch

    D = x.shape[-1]
    nan, inf = float("nan"), float("inf")
    a, b, c, d = (int(r) for r in rows)
    x[a, :, 5] = nan
    x[a, 0] = 0.0
    x[a, 0, :8] = torch.tensor([0.5, -3.0, nan, 1.25, 2.0, -0.75, 0.0, 7.0], dtype=x.dtype)
    x[b, :, 3] = inf
    x[c, :, D - 1] = -inf
    x[d, :, 0] = nan
    x[d, :, D // 2] = inf
    return x


def _kv_write_fixture(PA, randn, dev, case):
    """Inputs of #6's int8 write at one KV_WRITE_CASES shape: int8 code and
    f32 scale pools of num_kv_blocks + 1 blocks, filled by the plain
    quantizer; new rows [T, KV, D] with live rows built as .5 ties, zeros,
    subnormals (_int8_rows) and non-finite rows (_nonfinite_rows); the
    path's slots (bucket b's row p at slot b * bucket + p, -1 past the
    live rows). Returns a dict: pools, kn, vn, slots, n_live, and `bytes`,
    what the write must move (each live row read, its codes and scales
    written, the slots read)."""
    import torch

    KV, D, T, bucket = case["KV"], case["D"], case["T"], case["bucket"]
    bs = case["serve"]["kv_block_size"]
    nblk = case["serve"]["num_kv_blocks"] + 1
    row = torch.arange(T, device=dev)
    slots = torch.where(row % bucket < case["live"], row, -1).to(torch.int32)
    live = torch.nonzero(slots >= 0)[:, 0]
    built = (live[:16], live[16:20], live[20:24])
    kn, vn = _int8_rows(randn, T, KV, D, built), _int8_rows(randn, T, KV, D, built)
    _nonfinite_rows(kn, live[24:28])
    _nonfinite_rows(vn, live[28:32])
    qk, ks, qv, vs = PA.quantize_kv_rows(randn(nblk * bs, KV, D), randn(nblk * bs, KV, D))
    pools = [qk.reshape(nblk, bs, KV, D), qv.reshape(nblk, bs, KV, D),
             ks.reshape(nblk, bs, KV), vs.reshape(nblk, bs, KV)]
    n_live = int(live.numel())
    return dict(pools=pools, kn=kn, vn=vn, slots=slots, n_live=n_live,
                bytes=n_live * KV * D * 2 * 2 + n_live * KV * (D + 4) * 2 + 4 * T)


def _pools_off(a, b):
    """Elements of four pools (codes, codes, scales, scales) whose bits
    differ between a and b."""
    import torch

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))


def _quant_fault(x, fault=None):
    """quantize_kv_rows's rule on rows [..., D] -> (codes, scales), with one
    planted fault: "amax_first_<n>_columns" (a slice scaled by its first n
    columns: 64 of head_dim 80 or 96, 128 of 256), "ties_away_from_zero"
    (C's roundf), or
    "nan_dropping_absmax" (fmaxf's max, which drops a NaN, and a clamp
    by fmaxf/fminf, which takes a NaN quotient to -127: the quantizer
    before the NaN repair)."""
    import torch

    xf = x.float()
    a = xf.abs()
    if fault and fault.startswith("amax_first_"):
        a = a[..., :int(fault.split("_")[2])]
    if fault == "nan_dropping_absmax":
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    scale = a.amax(-1) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    r = xf / scale[..., None]
    r = torch.sign(r) * torch.floor(r.abs() + 0.5) if fault == "ties_away_from_zero" else r.round()
    r = torch.where(torch.isnan(r), torch.full_like(r, -127.0 if fault == "nan_dropping_absmax"
                                                    else 0.0), r)
    return r.clamp(-127, 127).to(torch.int8), scale


def _emulated_write(PA, pools, kn, vn, slots, fault=None, scale_shift=False, skip_from=None):
    """The int8 write in the plain math on copies of `pools`: rows quantized
    by _quant_fault(fault) and scattered with the plain write's drop and
    clamp rules; scale_shift: each slice's scale written to the next slice
    of its row (head h's to head h + 1, the last K head's to V head 0,
    the last V head's to K head 0); skip_from: the slices from this one on
    (the int8 kernel's flat order: a row's K heads, then its V heads) left
    unwritten. Returns the four pools."""
    import torch

    out = [p.clone() for p in pools]
    (qk, ks), (qv, vs) = _quant_fault(kn, fault), _quant_fault(vn, fault)
    if scale_shift:
        ks, vs = torch.cat([ks, vs], -1).roll(1, -1).split(ks.shape[-1], -1)
    for arena, rows in zip(out, (qk, qv, ks, vs)):
        PA._scatter_rows(arena, rows.contiguous(), slots)
    if skip_from is not None:
        nblk, bs, KV, D = pools[0].shape
        j = torch.arange(skip_from, 2 * kn.shape[0] * KV, device=kn.device)
        slot = slots[j // (2 * KV)].long()
        j, slot = j[slot >= 0], slot[slot >= 0]
        at = (slot // bs).clamp(max=nblk - 1) * bs + slot % bs
        half, h = j % (2 * KV) // KV, j % KV
        for x in (0, 1):
            m = half == x
            for i in (x, x + 2):
                flat = out[i].view(nblk * bs, KV, -1)
                flat[at[m], h[m]] = pools[i].view(nblk * bs, KV, -1)[at[m], h[m]]
    return out


def _stale_tile_rows(kn, vn, tile):
    """K and V rows [T, KV, D] whose head slices (the int8 kernel's flat
    order) from `tile` on each hold the slice `tile` before it: what a CTA
    that quantized the tile before its own would write."""
    import torch

    T, KV, D = kn.shape
    x = torch.stack([kn, vn], 1).reshape(T * 2 * KV, D)
    j = torch.arange(T * 2 * KV, device=kn.device)
    x = x[torch.where(j >= tile, j - tile, j)].view(T, 2, KV, D)
    return x[:, 0].contiguous(), x[:, 1].contiguous()


def _kv_write_design_checks(PA, randn, dev, bound_ms):
    """Checks aimed at the tiled design of #6's int8 write
    (csrc/paged_kv_write.cu) at KV_WRITE_CASES: codes and scales bit-exact
    against the plain write, rows of .5 ties, zeros, subnormals, NaN and
    inf included; a second launch bit-identical; then a ragged write (T - 3
    rows, scattered slots, every 7th row dropped, one past the arena)
    bit-exact, and planted faults, each an output the check must fail: a
    tile given the previous tile's slices, each slice's
    scale written to the next head, the last tile (partial where the
    slices do not fill it) left unwritten, at head_dim 80 the amax of the
    first 64 columns, ties rounded away from zero, and the NaN-dropping
    absmax of the quantizer before the NaN repair. Beside it, #4's fused
    int8 write with non-finite new rows (pools bit-exact). Also the
    quantizer's exhaustive check of its two division routes (every (x,
    amax) pair: no code may differ), the grids and the ptxas registers and
    spills (a spill fails). Returns the timing rows of the cases phase 2
    times nowhere else (Mistral's and Falcon-7B's prefills)."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import build

    atol, rtol = KERNEL_TOL["paged_decode_attention_int8"]
    tile = PA.KV8_TILE
    report, out = {"division_routes": PA.quantizer_route_check(dev)}, {}
    if report["division_routes"]["codes_off"] or report["division_routes"]["pairs"] < 2**30:
        raise AssertionError(f"the quantizer's division routes differ: {report}")
    for seed, (case, c) in enumerate(KV_WRITE_CASES.items()):
        KV, D, T = c["KV"], c["D"], c["T"]
        x = _kv_write_fixture(PA, randn, dev, c)
        pools, kn, vn, slots = x["pools"], x["kn"], x["vn"], x["slots"]
        got = [p.clone() for p in pools]
        PA.paged_kv_write_int8(*got, kn, vn, slots)
        want = _emulated_write(PA, pools, kn, vn, slots)
        plain = [p.clone() for p in pools]
        PA.paged_kv_write_quant_plain(*plain, kn, vn, slots)
        again = [p.clone() for p in pools]
        PA.paged_kv_write_int8(*again, kn, vn, slots)
        torch.cuda.synchronize()
        off = {"kernel_vs_plain": _pools_off(got, plain), "two_launches": _pools_off(got, again),
               "emulation_vs_plain": _pools_off(want, plain)}
        if any(off.values()):
            raise AssertionError(f"paged_kv_write_int8 {case}: bits differ: {off}")
        # the ragged write: its slots a permutation of the arena's blocks
        # but the last, which only the past-arena row reaches
        Tr = T - 3
        g = torch.Generator(device=dev).manual_seed(60 + seed)
        nblk, bs = pools[0].shape[:2]
        sr = torch.randperm((nblk - 1) * bs, generator=g, device=dev)[:Tr].to(torch.int32)
        sr[2:-1:7] = -1  # the last row, in the last tile, stays live
        sr[1] = nblk * bs + 5
        kr, vr = kn[:Tr].contiguous(), vn[:Tr].contiguous()
        ctas = -(-2 * Tr * KV // tile)
        got = [p.clone() for p in pools]
        PA.paged_kv_write_int8(*got, kr, vr, sr)
        plain = [p.clone() for p in pools]
        PA.paged_kv_write_quant_plain(*plain, kr, vr, sr)
        torch.cuda.synchronize()
        if _pools_off(got, plain):
            raise AssertionError(f"paged_kv_write_int8 {case} ragged: {_pools_off(got, plain)} "
                                 f"elements differ (T {Tr})")
        faults = {
            "stale_tile": _emulated_write(PA, pools, *_stale_tile_rows(kr, vr, tile), sr),
            "scale_to_the_next_head": _emulated_write(PA, pools, kr, vr, sr, scale_shift=True),
            "last_tile_left_unwritten": _emulated_write(PA, pools, kr, vr, sr,
                                                        skip_from=(ctas - 1) * tile),
            "ties_away_from_zero": _emulated_write(PA, pools, kr, vr, sr, "ties_away_from_zero"),
            "nan_dropping_absmax": _emulated_write(PA, pools, kr, vr, sr, "nan_dropping_absmax")}
        if D == 80:
            faults["amax_first_64_columns"] = _emulated_write(PA, pools, kr, vr, sr,
                                                              "amax_first_64_columns")
        faults = {name: _pools_off(got, f) for name, f in faults.items()}
        if not all(faults.values()):
            raise AssertionError(f"paged_kv_write_int8 {case}: the check passes a planted "
                                 f"fault: {faults}")
        # #4's fused int8 write with non-finite new rows
        NB = c["serve"]["max_seq_len"] // bs
        d, _, run = _decode_fixture(PA, randn, dev, c["H"], KV, D, bs, NB, list(c["ctx"]),
                                    70 + seed)
        _nonfinite_rows(d["k_new"], range(4))
        _nonfinite_rows(d["v_new"], range(3, -1, -1))
        (o, fused), (ref, fused_plain) = (run("paged_decode_fused_int8", 0),
                                         run("paged_decode_fused_int8", 0, kernel=False))
        torch.cuda.synchronize()
        fused_off = _pools_off(fused, fused_plain)
        finite = torch.isfinite(ref.float()).flatten(1).all(1)
        if fused_off or int(finite.sum()) == 0:
            raise AssertionError(f"paged_decode_fused_int8 {case}: {fused_off} pool elements "
                                 f"differ with non-finite new rows")
        _check_close(f"paged_decode_fused_int8 {case} finite rows", o[finite], ref[finite],
                     atol, rtol)
        report[case] = {"ctas": -(-2 * T * KV // tile), "lane_chunk_bf16": PA.KV8_CHUNK[D],
                        "ragged_last_tile_slices": 2 * Tr * KV - (ctas - 1) * tile,
                        "bits_off": off, "planted_faults_elements_off": faults,
                        "fused_int8_pools_off_nonfinite_rows": fused_off}
        if case in ("mistral_prefill", "falcon_7b_prefill"):
            out[f"paged_kv_write_int8@{case}"] = dict(
                max_abs_err=0.0,
                **_timings(lambda: PA.paged_kv_write_int8(*got, kn, vn, slots),
                           lambda: PA.paged_kv_write_quant_plain(*plain, kn, vn, slots),
                           None, 50),
                shape=f"T={T} rows ({x['n_live']} live), pools [{nblk},{bs},{KV},{D}] int8 + "
                      f"[{nblk},{bs},{KV}] f32",
                bound=bound_ms(x["bytes"], 0.0))
        del x, pools, kn, vn, got, want, plain, again, faults, d, run, fused, fused_plain
        torch.cuda.empty_cache()
    report["ptxas"] = _ptxas_registers(build, "paged_kv_write", ("kv_write_int8_kernel",))
    spills = {k: v for k, v in report["ptxas"].items() if v.get("spill_stores")}
    if spills or not report["ptxas"]:
        raise AssertionError(f"kv_write_int8_kernel spills or was not found: {report['ptxas']}")
    print(json.dumps({"kv_write_design_checks": report}))
    return out


def _zero_from(t, c):
    """A copy of t with its last axis's entries c and up set to zero."""
    t = t.clone()
    t[..., c:] = 0
    return t


def _d80_checks(FA, PA, randn, dev, bound_ms):
    """The head_dim-80 modes (Phi-2: 32 heads of 80): flash #1 at Phi-2's
    prefill shapes (B=1, S in FLASH_D80_S) against its plain version;
    decode #4/#5 in all four modes at 8 rows with ctx DECODE_FP_CTX at one
    bf16 ulp (the fused modes' pools bit-exact); the writes
    (_head_dim_write_checks). Planted faults that must fail: the output's
    columns 64-79 left zero, and the scores taken over the first 64 dims
    only (the kernel run on q with dims 64-79 zeroed). Also kernel #1 at
    Falcon-7B's prefill shape (B=1, S=1920, 71 query heads of 64 over one
    KV head), its wide-group mode. Times flash at S=2048 and at Falcon's
    shape beside SDPA, decode at the rows above."""
    import torch

    H = PHI_2["n_heads"]
    D = PHI_2["d_model"] // H
    results, report = {}, {}
    for S in FLASH_D80_S:
        q, k, v, o, ro, st, timed = _flash_case(FA, randn, bound_ms, 1, S, H, H, D)
        faults = {"columns_64_79_zero": FA.bwd_mismatch(_zero_from(o, 64), ro)["n_over"],
                  "scores_over_first_64_dims": FA.bwd_mismatch(
                      FA.flash_fwd(_zero_from(q, 64), k, v)[0], ro)["n_over"]}
        if not all(faults.values()):
            raise AssertionError(f"flash_fwd[d80] S={S}: the o check passes a planted fault: "
                                 f"{faults}")
        report[f"flash_fwd@S{S}"] = {"o_worst_ratio": st["worst_ratio"],
                                     "o_max_abs_err": st["max_abs_err"],
                                     "planted_faults_o_elements_over": faults}
        if S == max(FLASH_D80_S):
            results["flash_fwd[d80]"] = timed()
        del q, k, v, o, ro, timed
        torch.cuda.empty_cache()
    results["flash_fwd[d80]"]["max_abs_err"] = max(
        r["o_max_abs_err"] for r in report.values())

    from deepspeed_tpu_torch.models.transformer import TransformerConfig

    mf = TransformerConfig(**FALCON_7B)
    q, k, v, o, ro, st, timed = _flash_case(FA, randn, bound_ms, 1, A_LONG, mf.n_heads,
                                            mf.kv_heads, mf.head_dim)
    report["flash_fwd@falcon_7b"] = {"o_worst_ratio": st["worst_ratio"],
                                     "o_max_abs_err": st["max_abs_err"]}
    results["flash_fwd[wide_group]"] = timed()
    del q, k, v, o, ro, timed
    torch.cuda.empty_cache()

    bs = SERVE_A["kv_block_size"]
    NB = SERVE_A["max_seq_len"] // bs
    ctx_list = list(DECODE_FP_CTX)
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    x, call, run = _decode_fixture(PA, randn, dev, H, H, D, bs, NB, ctx_list, 17)
    S, nblk = x["S"], x["nblk"]
    q64 = _zero_from(x["q"], 64)
    for name in DECODE_MODES:
        (o, pk), (ref, pr) = run(name, 0), run(name, 0, kernel=False)
        err = _check_close(f"{name}[d80]", o, ref, atol, rtol)
        if "fused" in name:
            for a, b in zip(pk, pr):
                _check_close(f"{name}[d80] pools", a, b, 0.0, 0.0)
        faults = {"columns_64_79_zero": _n_over(_zero_from(o, 64), ref, atol, rtol),
                  "scores_over_first_64_dims": _n_over(run(name, 0, q=q64)[0], ref, atol,
                                                       rtol)}
        if not all(faults.values()):
            raise AssertionError(f"{name}[d80]: the check passes a planted fault: {faults}")
        report[name] = {"max_abs_err": err, "planted_faults_elements_over": faults}
        pools, ref_pools = run(name, 0)[1], run(name, 0)[1]
        results[f"{name}[d80]"] = dict(
            max_abs_err=err,
            **_timings(lambda: call(name, 0, pools),
                       lambda: call(name, 0, ref_pools, kernel=False), None, 20),
            shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, H={H}, KV={H}, D={D}, "
                  f"bs={bs}, {'int8' if 'int8' in name else 'bf16'} pools of {nblk} blocks",
            bound=bound_ms(_decode_bytes(name, S, H, H, D, NB, sum(ctx_list)),
                           4 * sum(ctx_list) * H * D))
        del pools, ref_pools
    del x, call, run
    torch.cuda.empty_cache()
    results.update(_head_dim_write_checks(PA, randn, dev, bound_ms, "d80", H, D))
    report["writes"] = "bit-exact, two launches bit-identical"
    report["write_int8_planted_faults_elements_off"] = results[
        "paged_kv_write_int8[d80]"]["planted_faults_elements_off"]
    print(json.dumps({"d80_checks": {"decode_ctx": ctx_list, **report}}))
    return results


# phase 2's head_dim-96 and head_dim-256 modes: GPT-NeoX-20B's 64 heads of
# 96 and GPT-J-6B's 16 heads of 256 (one query head per KV head: the decode
# kernel's transposed NARROW products), and a GQA group of 16 at each width
# (32 query heads over 2 KV heads: its 16-row slices, at D 256 with the Q
# fragments read per tile)
WIDE_HEAD_MODELS = {"d96": GPT_NEOX_20B, "d256": GPT_J_6B}
WIDE_HEAD_GQA = dict(H=32, KV=2)
# the planted faults' column split at each head-dim mode: the flash
# output's columns from it left zero, the scores taken over the dims below
# it, the int8 write's amax over the columns below it
HEAD_DIM_CUT = {"d80": 64, "d96": 64, "d256": 128}
# decode's: the columns the dropped P V column tiles leave out (the last
# 16-column pair at D 96, the second half at D 256)
WIDE_HEAD_DECODE_CUT = {"d96": 80, "d256": 128}
# builds of the head_dim-256 code with a fault planted by a define (built
# beside the kernels, all at once), each run in place of its source's
# library at D 256 and required to fail: flash's pv_step without its second
# (columns 128-255) wgmma, decode's per-tile Q fragments (q_frag, the
# 16-row slices at D 256) read for k-step ks + 1 at k-step ks, and the
# backward's dkv hand-off losing the second 32 queries of each P^T tile on
# its way to the dK warpgroup
FAULT_BUILDS = {"pv_hi_product_skipped": "flash_fwd+DS_FAULT_PV_HI_SKIPPED",
                "q_frag_of_the_next_k_step": "paged_decode+DS_FAULT_Q_FRAG_NEXT_KSTEP",
                "handoff_second_half_lost": "flash_bwd+DS_FAULT_HANDOFF_HALF"}


def _head_dim_write_checks(PA, randn, dev, bound_ms, mode, KV, D):
    """The writes at head_dim D (mode "d80", "d96" or "d256") at the
    prefill of the 1920-token prompt (bucket 2048: 2048 rows, 1920 live,
    KV heads of D): the bf16 write and the quantizing int8 write bit-exact
    against their plain versions, live rows built as .5 ties, zeros and
    subnormals (_int8_rows), a second launch of each bit-identical, and
    planted faults in the int8 write that must fail: ties rounded away
    from zero, the amax over the first HEAD_DIM_CUT columns (64 of 80 or
    96, 128 of 256), at D 256 each lane's second chunk (columns 128-255)
    left unwritten."""
    import torch

    bs = SERVE_A["kv_block_size"]
    nblk = SERVE_A["num_kv_blocks"] + 1
    T = SERVE_A["max_seq_len"]
    slots = torch.arange(T, device=dev, dtype=torch.int32)
    slots[A_LONG:] = -1
    live = torch.nonzero(slots >= 0)[:, 0]
    n_live = int(live.numel())
    built = (live[:16], live[16:20], live[20:24])
    kn, vn = _int8_rows(randn, T, KV, D, built), _int8_rows(randn, T, KV, D, built)
    out = {}
    ka, va = randn(nblk, bs, KV, D), randn(nblk, bs, KV, D)
    kb, vb, kc, vc = ka.clone(), va.clone(), ka.clone(), va.clone()
    PA.paged_kv_write(ka, va, kn, vn, slots)
    PA.paged_kv_write(kc, vc, kn, vn, slots)
    PA.paged_kv_write_plain(kb, vb, kn, vn, slots)
    for name, a, b in (("k", ka, kb), ("v", va, vb), ("k second launch", kc, kb),
                       ("v second launch", vc, vb)):
        _check_close(f"paged_kv_write[{mode}] {name}", a, b, 0.0, 0.0)
    idx, k_live, v_live = slots[live].long(), kn[live], vn[live]
    out[f"paged_kv_write[{mode}]"] = dict(
        max_abs_err=0.0,
        **_timings(lambda: PA.paged_kv_write(ka, va, kn, vn, slots),
                   lambda: PA.paged_kv_write_plain(kb, vb, kn, vn, slots),
                   lambda: (kb.view(-1, KV, D).index_copy_(0, idx, k_live),
                            vb.view(-1, KV, D).index_copy_(0, idx, v_live)), 50),
        shape=f"T={T} rows ({n_live} live), arena [{nblk},{bs},{KV},{D}] bf16",
        bound=bound_ms(4 * n_live * KV * D * 2 + 4 * T, 0.0))
    del ka, va, kb, vb, kc, vc
    qk, ks, qv, vs = PA.quantize_kv_rows(randn(nblk * bs, KV, D), randn(nblk * bs, KV, D))
    pools = [qk.reshape(nblk, bs, KV, D), qv.reshape(nblk, bs, KV, D),
             ks.reshape(nblk, bs, KV), vs.reshape(nblk, bs, KV)]
    got, again, want = ([p.clone() for p in pools] for _ in range(3))
    PA.paged_kv_write_int8(*got, kn, vn, slots)
    PA.paged_kv_write_int8(*again, kn, vn, slots)
    PA.paged_kv_write_quant_plain(*want, kn, vn, slots)
    torch.cuda.synchronize()
    off = {"kernel_vs_plain": _pools_off(got, want), "two_launches": _pools_off(got, again)}
    if any(off.values()):
        raise AssertionError(f"paged_kv_write_int8[{mode}]: bits differ: {off}")
    cut = HEAD_DIM_CUT[mode]
    faults = {"ties_away_from_zero": _emulated_write(PA, pools, kn, vn, slots,
                                                     "ties_away_from_zero"),
              f"amax_first_{cut}_columns": _emulated_write(PA, pools, kn, vn, slots,
                                                           f"amax_first_{cut}_columns")}
    if D == 256:
        unwritten = _emulated_write(PA, pools, kn, vn, slots)
        for i in (0, 1):
            unwritten[i][..., 128:] = pools[i][..., 128:]
        faults["second_chunk_unwritten"] = unwritten
    faults = {name: _pools_off(got, f) for name, f in faults.items()}
    if not all(faults.values()):
        raise AssertionError(f"paged_kv_write_int8[{mode}]: the check passes a planted fault: "
                             f"{faults}")
    out[f"paged_kv_write_int8[{mode}]"] = dict(
        max_abs_err=0.0,
        **_timings(lambda: PA.paged_kv_write_int8(*got, kn, vn, slots),
                   lambda: PA.paged_kv_write_quant_plain(*want, kn, vn, slots), None, 50),
        shape=f"T={T} rows ({n_live} live), pools [{nblk},{bs},{KV},{D}] int8 + "
              f"[{nblk},{bs},{KV}] f32",
        bound=bound_ms(n_live * KV * D * 2 * 2 + n_live * KV * (D + 4) * 2 + 4 * T, 0.0),
        planted_faults_elements_off=faults)
    return out


def _wide_head_checks(FA, PA, randn, dev, bound_ms):
    """The head_dim-96 and head_dim-256 modes (WIDE_HEAD_MODELS:
    GPT-NeoX-20B's 64 heads of 96, GPT-J-6B's 16 heads of 256): flash #1
    at their prefill shapes (B=1, S in FLASH_D80_S), with the window 1000
    (S=2048), with ALiBi slopes (S=512) and with GQA 32 over 2 (S=512),
    against its plain version (o under bwd_mismatch, lse at 1e-3); decode
    #4/#5 in all four modes at 8 rows with ctx DECODE_FP_CTX at the
    models' heads and at GQA 32 over 2, at one bf16 ulp (the fused modes'
    pools bit-exact); the writes (_head_dim_write_checks). A second launch
    of each kernel at the models' shapes bit-identical. Planted faults
    that must fail: flash with the output's columns from HEAD_DIM_CUT on
    left zero and the scores taken over the dims below it; decode's
    output with the columns from WIDE_HEAD_DECODE_CUT on zeroed (what
    dropping D 96's last P V column-tile pair, or D 256's second half,
    leaves) and the scores over the dims below HEAD_DIM_CUT; at D 256 the
    FAULT_BUILDS, run through the wrappers by build.routed: flash at
    S 512 and 2048, decode in all four modes at GQA 32 over 2. Times flash at S=2048
    beside SDPA, decode at the rows above; reports the ptxas registers
    and spills of the new instantiations."""
    import torch

    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    from deepspeed_tpu_torch.ops.cuda import build

    results, report = {}, {}
    bs = SERVE_A["kv_block_size"]
    NB = SERVE_A["max_seq_len"] // bs
    ctx_list = list(DECODE_FP_CTX)
    atol, rtol = KERNEL_TOL["paged_decode_attention"]
    for seed, (mode, model) in enumerate(WIDE_HEAD_MODELS.items()):
        mc = TransformerConfig(**model)
        H, KV, D = mc.n_heads, mc.kv_heads, mc.head_dim
        cut, dcut = HEAD_DIM_CUT[mode], WIDE_HEAD_DECODE_CUT[mode]
        rep = report[mode] = {}
        for S in FLASH_D80_S:
            q, k, v, o, ro, st, timed = _flash_case(FA, randn, bound_ms, 1, S, H, KV, D)
            o2, _ = FA.flash_fwd(q, k, v)
            faults = {f"columns_{cut}_{D - 1}_zero": FA.bwd_mismatch(_zero_from(o, cut),
                                                                     ro)["n_over"],
                      f"scores_over_first_{cut}_dims": FA.bwd_mismatch(
                          FA.flash_fwd(_zero_from(q, cut), k, v)[0], ro)["n_over"]}
            if D == 256:
                with build.routed("flash_fwd", FAULT_BUILDS["pv_hi_product_skipped"]):
                    faults["pv_hi_product_skipped"] = FA.bwd_mismatch(
                        FA.flash_fwd(q, k, v)[0], ro)["n_over"]
            if not torch.equal(o, o2):
                raise AssertionError(f"flash_fwd[{mode}] S={S}: two launches differ")
            if not all(faults.values()):
                raise AssertionError(f"flash_fwd[{mode}] S={S}: the o check passes a planted "
                                     f"fault: {faults}")
            rep[f"flash_fwd@S{S}"] = {"o_worst_ratio": st["worst_ratio"],
                                      "o_max_abs_err": st["max_abs_err"],
                                      "two_launches": "bit-identical",
                                      "planted_faults_o_elements_over": faults}
            if S == max(FLASH_D80_S):
                results[f"flash_fwd[{mode}]"] = timed()
            del q, k, v, o, o2, ro, timed
            torch.cuda.empty_cache()
        flash_cases = (("window_1000", 2048, H, KV, ALIBI_WINDOW, False),
                       ("alibi", 512, H, KV, 0, True),
                       ("gqa_32_over_2", 512, WIDE_HEAD_GQA["H"], WIDE_HEAD_GQA["KV"], 0, False))
        for label, S, h, kv, window, alibi in flash_cases:
            slopes = _slopes(h, 1.0, dev) if alibi else None
            q, k, v = randn(1, S, h, D), randn(1, S, kv, D), randn(1, S, kv, D)
            o, lse = FA.flash_fwd(q, k, v, window, slopes)
            ro, rlse = FA.flash_attention_plain(q, k, v, window, slopes)
            name = f"flash_fwd[{mode}] {label}"
            st = _check_flash_o(FA, name + " o", o, ro)
            _check_close(name + " lse", lse, rlse, 1e-3, 1e-3)
            rep[f"flash_fwd@{label}"] = {"o_worst_ratio": st["worst_ratio"],
                                         "o_max_abs_err": st["max_abs_err"]}
            del q, k, v, o, lse, ro, rlse
        results[f"flash_fwd[{mode}]"]["max_abs_err"] = max(
            r["o_max_abs_err"] for n, r in rep.items() if n.startswith("flash_fwd"))
        torch.cuda.empty_cache()

        x, call, run = _decode_fixture(PA, randn, dev, H, KV, D, bs, NB, ctx_list, 90 + seed)
        S, nblk = x["S"], x["nblk"]
        q_cut = _zero_from(x["q"], cut)
        for name in DECODE_MODES:
            (o, pk), (ref, pr) = run(name, 0), run(name, 0, kernel=False)
            o2, pk2 = run(name, 0)
            err = _check_close(f"{name}[{mode}]", o, ref, atol, rtol)
            if "fused" in name:
                for a, b in zip(pk, pr):
                    _check_close(f"{name}[{mode}] pools", a, b, 0.0, 0.0)
            if not torch.equal(o, o2) or _pools_off(pk, pk2):
                raise AssertionError(f"{name}[{mode}]: two launches differ")
            faults = {f"columns_{dcut}_{D - 1}_zeroed": _n_over(_zero_from(o, dcut), ref, atol,
                                                                rtol),
                      f"scores_over_first_{cut}_dims": _n_over(run(name, 0, q=q_cut)[0], ref,
                                                               atol, rtol)}
            if not all(faults.values()):
                raise AssertionError(f"{name}[{mode}]: the check passes a planted fault: "
                                     f"{faults}")
            rep[name] = {"max_abs_err": err, "two_launches": "bit-identical",
                         "planted_faults_elements_over": faults}
            pools, ref_pools = run(name, 0)[1], run(name, 0)[1]
            results[f"{name}[{mode}]"] = dict(
                max_abs_err=err,
                **_timings(lambda: call(name, 0, pools),
                           lambda: call(name, 0, ref_pools, kernel=False), None, 20),
                shape=f"S={S}, ctx {min(ctx_list)}..{max(ctx_list)}, H={H}, KV={KV}, D={D}, "
                      f"bs={bs}, {'int8' if 'int8' in name else 'bf16'} pools of {nblk} blocks",
                bound=bound_ms(_decode_bytes(name, S, H, KV, D, NB, sum(ctx_list)),
                               4 * sum(ctx_list) * H * D))
            del pools, ref_pools
        del x, call, run
        h, kv = WIDE_HEAD_GQA["H"], WIDE_HEAD_GQA["KV"]
        x, call, run = _decode_fixture(PA, randn, dev, h, kv, D, bs, NB, ctx_list, 95 + seed)
        for name in DECODE_MODES:
            (o, pk), (ref, pr) = run(name, 0), run(name, 0, kernel=False)
            err = _check_close(f"{name}[{mode}] gqa {h} over {kv}", o, ref, atol, rtol)
            if "fused" in name:
                for a, b in zip(pk, pr):
                    _check_close(f"{name}[{mode}] gqa pools", a, b, 0.0, 0.0)
            rep[f"{name}@gqa_{h}_over_{kv}"] = {"max_abs_err": err}
            if D == 256:
                fault = "q_frag_of_the_next_k_step"
                with build.routed("paged_decode", FAULT_BUILDS[fault]):
                    n_over = _n_over(run(name, 0)[0], ref, atol, rtol)
                if not n_over:
                    raise AssertionError(f"{name}[{mode}] gqa: the check passes the planted "
                                         f"fault {fault}")
                rep[f"{name}@gqa_{h}_over_{kv}"]["planted_faults_elements_over"] = {
                    fault: n_over}
        del x, call, run
        torch.cuda.empty_cache()
        results.update(_head_dim_write_checks(PA, randn, dev, bound_ms, mode, KV, D))
        rep["write_int8_planted_faults_elements_off"] = results[
            f"paged_kv_write_int8[{mode}]"]["planted_faults_elements_off"]
        rep["writes"] = "bit-exact, two launches bit-identical"
    ptxas = {}
    for source, kernels in (("flash_fwd", ("flash_fwd_kernel",)),
                            ("paged_decode", ("decode_kernel",)),
                            ("paged_kv_write", ("kv_write_int8_kernel",))):
        ptxas.update({k: v for k, v in _ptxas_registers(build, source, kernels).items()
                      if "<96," in k or "<256," in k or k.endswith("<96>")
                      or k.endswith("<256>")})
    report["ptxas"] = ptxas
    report["flash_fwd_d256_spills"] = {k: v for k, v in ptxas.items()
                                       if k.startswith("flash_fwd_kernel<256")
                                       and (v.get("spill_stores") or v.get("spill_loads"))}
    print(json.dumps({"wide_head_checks": {"decode_ctx": ctx_list, **report}}))
    return results


def _plain_bwd_by_batch(FA, q, k, v, lse, delta, do, window=0, alibi=None):
    """The plain backward one batch row at a time (the rows are
    independent): a [1, H, S, S] f32 tensor at Falcon-7B's 71 heads is
    1.2 GB, the whole micro-batch's 4.8 GB, several of them at once."""
    import torch

    rows = [FA._bwd_plain(*(t[b:b + 1] for t in (q, k, v, lse, delta)), do[b:b + 1], window,
                          alibi) for b in range(q.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def _bwd_mode_faults(FA, q, k, v, do, lse, delta, window, alibi, ref):
    """Planted faults of the head-dim and wide-group modes, each what a
    wrong kernel would output, made by running the kernels themselves on
    spoiled inputs from the same forward's lse and delta (or, at D 256, a
    kernel built with a fault); each must fail bwd_mismatch against the
    plain backward `ref` in every gradient it touches. D 80, 96, 256: the
    gradients' columns from BWD_ZERO_FROM on zeroed (64-79, 80-95,
    128-255); the scores taken over the dims below HEAD_DIM_CUT (q's dims
    from 64, 64, 128 zeroed). D 256: dkv built with the hand-off fault
    (FAULT_BUILDS: dK from P^T whose second 32 queries of each tile are
    lost). G > 8: dk and dv summed without each group's last chunk of 8
    heads (at 71 over 1, over the first 64 heads: the partial chunk
    dropped); with several KV heads and H a multiple of 8 KV, each q head
    given KV head (h // 8) % KV (a group capped at 8). Returns {fault:
    {tensor: elements over}}."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import build

    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    names = ("dq", "dk", "dv")

    def bwd(q_, k_, v_, lse_, delta_, do_):
        return (FA.flash_bwd_dq(q_, k_, v_, do_, lse_, delta_, window, alibi),) + \
            FA.flash_bwd_dkv(q_, k_, v_, do_, lse_, delta_, window, alibi)

    faults = {}
    mode = {80: "d80", 96: "d96", 256: "d256"}.get(D)
    if mode is not None:
        good = bwd(q, k, v, lse, delta, do)
        zero, cut = BWD_ZERO_FROM[mode], HEAD_DIM_CUT[mode]
        faults[f"columns_{zero}_{D - 1}_zeroed"] = (names, tuple(_zero_from(g, zero)
                                                                 for g in good))
        del good
        faults[f"scores_over_first_{cut}_dims"] = (names, bwd(_zero_from(q, cut), k, v, lse,
                                                              delta, do))
    if D == 256:
        fault = "handoff_second_half_lost"
        with build.routed("flash_bwd", FAULT_BUILDS[fault]):
            faults[fault] = (("dk",), (None,) + FA.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                                 window, alibi))
    if G > 8 and alibi is None:
        keep = torch.arange(H, device=q.device).view(KV, G)[:, :8 * ((G - 1) // 8)].flatten()
        pick = lambda t, dim: t.index_select(dim, keep).contiguous()
        dk, dv = FA.flash_bwd_dkv(pick(q, 2), k, v, pick(do, 2), pick(lse, 1), pick(delta, 1),
                                  window)
        faults["last_chunk_of_8_dropped"] = (("dk", "dv"), (None, dk, dv))
    if G > 8 and KV > 1 and H % (8 * KV) == 0 and alibi is None:
        idx = torch.arange(H // 8, device=q.device) % KV
        k8, v8 = k[:, :, idx].contiguous(), v[:, :, idx].contiguous()
        dq, dk8, dv8 = bwd(q, k8, v8, lse, delta, do)
        fold = lambda t: t.float().view(B, S, H // 8 // KV, KV, D).sum(2).to(t.dtype)
        faults["q_head_given_kv_head_h_div_8"] = (names, (dq, fold(dk8), fold(dv8)))
    out = {}
    for fault, (hit, grads) in faults.items():
        out[fault] = {n: FA.bwd_mismatch(grads[i], ref[i])["n_over"]
                      for i, n in enumerate(names) if n in hit}
        if not all(out[fault].values()):
            raise AssertionError(f"the backward check passes a planted fault: {fault} "
                                 f"{out[fault]}")
    return out


def _bwd_split_checks(FA, q, k, v, do, lse, delta, got, ref):
    """The group split of kernel #3 at a wide-group shape: the plan
    (dkv_split_plan: chunk count, each chunk's q heads, the f32 scratch
    and its bytes), a second launch of #2 and #3 bit-identical (the split
    and its combining pass included), and a planted fault that must fail
    bwd_mismatch in dk and dv: one chunk's partial left out of the
    combining pass (the kernel run on the group without that chunk's q
    heads)."""
    import torch

    B, S, H, D = q.shape
    KV = k.shape[2]
    plan = FA.dkv_split_plan(B, S, H, KV, D,
                             torch.cuda.get_device_properties(q.device).multi_processor_count)
    again = (FA.flash_bwd_dq(q, k, v, do, lse, delta),) + FA.flash_bwd_dkv(q, k, v, do, lse,
                                                                         delta)
    torch.cuda.synchronize()
    same = all(torch.equal(a, g) for a, g in zip(again, got))
    del again
    G = H // KV
    first, end = plan.chunks[min(1, plan.n_chunks - 1)]
    keep = torch.tensor([h for h in range(H) if not first <= h % G < end], device=q.device)
    pick = lambda t, dim: t.index_select(dim, keep).contiguous()
    dk, dv = FA.flash_bwd_dkv(pick(q, 2), k, v, pick(do, 2), pick(lse, 1), pick(delta, 1))
    left_out = {"dk": FA.bwd_mismatch(dk, ref[1])["n_over"],
                "dv": FA.bwd_mismatch(dv, ref[2])["n_over"]}
    report = {"n_chunks": plan.n_chunks, "chunk_heads": [list(c) for c in plan.chunks],
              "scratch_shape": list(plan.scratch_shape), "scratch_bytes": plan.scratch_bytes,
              "two_launches_bit_identical": same,
              "planted_fault_chunk_left_out_elements_over": left_out}
    print(json.dumps({"flash_bwd_group_split": {"shape": [B, S, H, KV, D], **report}}))
    if plan.n_chunks < 2:
        raise AssertionError(f"flash_bwd_dkv: no group split at {[B, S, H, KV, D]}")
    if not same:
        raise AssertionError("flash_bwd: two launches with the group split differ")
    if not all(left_out.values()):
        raise AssertionError(f"flash_bwd_dkv: the check passes a chunk left out: {left_out}")
    return report


BWD_MODES = ("d80", "d96", "d256", "wide_group")


def _flash_bwd_mode_checks(FA, randn, dev, bound_ms):
    """Kernels #2 (dq) and #3 (dk, dv) in their head_dim-80, -96 and -256
    and wide-group modes against the plain backward on the kernel forward's
    o and lse, on the same bf16 inputs, under bwd_mismatch, in the cases of
    FLASH_BWD_MODE_CASES (S=2048): Phi-2's training micro-batch, GQA 40
    over 2 at 80, window 1000 and ALiBi at 80, Falcon-7B's training
    micro-batch (71 query heads of 64 over one KV head), GQA 16 over 2,
    GPT-NeoX-20B's and GPT-J-6B's training micro-batches, and GQA 32 over
    2, window 1000 and ALiBi at 96 and at 256. Every launch must count in
    the case's modes; a second launch of both kernels must give the same
    bits. Planted faults must fail (_bwd_mode_faults). Then times both
    kernels at each mode's timed case beside the plain backward and SDPA's
    backward at the same shape, and reports the ptxas registers and spills
    of the head_dim-96 and -256 instantiations."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.ops.cuda import build

    names = ("dq", "dk", "dv")
    report, out = {}, {}
    errs = {m: {"dq": 0.0, "dkv": 0.0} for m in BWD_MODES}
    for case, c in FLASH_BWD_MODE_CASES.items():
        B, S, H, KV, D, w = (c[x] for x in ("B", "S", "H", "KV", "D", "window"))
        modes = [m for m, hit in (("d80", D == 80), ("d96", D == 96), ("d256", D == 256),
                                  ("wide_group", H // KV > 8)) if hit]
        q, k, v, do = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D), randn(B, S, H, D)
        sl = _slopes(H, 1.0, dev) if c["alibi"] else None
        o, lse = FA.flash_fwd(q, k, v, w, sl)
        delta = FA._delta(o, do)
        K.reset_launch_counts()
        got = (FA.flash_bwd_dq(q, k, v, do, lse, delta, w, sl),) + \
            FA.flash_bwd_dkv(q, k, v, do, lse, delta, w, sl)
        counts = K.all_launch_counts()
        want = {f"{n}[{m}]": int(m in modes) for n in ("flash_bwd_dq", "flash_bwd_dkv")
                for m in BWD_MODES}
        if {n: counts[n] for n in want} != want:
            raise AssertionError(f"flash_bwd {case}: not counted in its modes {modes}: "
                                 f"{counts}")
        again = (FA.flash_bwd_dq(q, k, v, do, lse, delta, w, sl),) + \
            FA.flash_bwd_dkv(q, k, v, do, lse, delta, w, sl)
        torch.cuda.synchronize()
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"flash_bwd {case}: two launches differ")
        del again
        ref = _plain_bwd_by_batch(FA, q, k, v, lse, delta, do, w, sl)
        case_report = {"shape": c, "modes": modes, "two_launches": "bit-identical"}
        for i, name in enumerate(names):
            st = FA.bwd_mismatch(got[i], ref[i])
            if st["n_over"]:
                raise AssertionError(f"flash_bwd {case} {name}: beyond the tolerance of the "
                                     f"plain backward: {st}")
            case_report[name] = {"worst_ratio": st["worst_ratio"], "max_abs": st["max_abs_err"]}
            for m in modes:
                key = "dq" if name == "dq" else "dkv"
                errs[m][key] = max(errs[m][key], st["max_abs_err"])
        case_report["planted_faults_elements_over"] = _bwd_mode_faults(
            FA, q, k, v, do, lse, delta, w, sl, ref)
        if H // KV > 8 and not c["alibi"]:
            case_report["group_split"] = _bwd_split_checks(FA, q, k, v, do, lse, delta, got,
                                                           ref)
        report[case] = case_report
        del got, ref
        torch.cuda.empty_cache()
        mode = c.get("timed")
        if mode is not None:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=KV != H)
            dot = do.transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
            plain_bwd = lambda: _plain_bwd_by_batch(FA, q, k, v, lse, delta, do)
            pairs = B * H * S * (S + 1) / 2
            io_in = B * S * (2 * H + 2 * KV) * D * 2 + 2 * B * H * S * 4
            shape = f"B={B}, S={S}, H={H}, KV={KV}, D={D}, bf16, causal"
            out[f"flash_bwd_dq[{mode}]"] = dict(
                max_abs_err=0.0, shape=shape,
                **_timings(lambda: FA.flash_bwd_dq(q, k, v, do, lse, delta), plain_bwd,
                           sdpa_bwd, 5),
                bound=bound_ms(io_in + B * S * H * D * 2, 3 * 2.0 * pairs * D))
            out[f"flash_bwd_dkv[{mode}]"] = dict(
                max_abs_err=0.0, shape=shape,
                **_timings(lambda: FA.flash_bwd_dkv(q, k, v, do, lse, delta), plain_bwd,
                           sdpa_bwd, 5),
                bound=bound_ms(io_in + 2 * B * S * KV * D * 2, 4 * 2.0 * pairs * D))
            del qt, kt, vt, ot, dot
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    for m, e in errs.items():
        out[f"flash_bwd_dq[{m}]"]["max_abs_err"] = e["dq"]
        out[f"flash_bwd_dkv[{m}]"]["max_abs_err"] = e["dkv"]
    ptxas = {k: r for k, r in _ptxas_registers(
        build, "flash_bwd", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                             "flash_bwd_dkv_wide_kernel")).items()
        if "<96," in k or "<256" in k}
    print(json.dumps({"flash_bwd_mode_checks": {
        "rtol": FA.BWD_RTOL, "row_rms_atol": FA.BWD_ROW_ATOL, "floor": FA.BWD_FLOOR,
        "ptxas_d96_d256": ptxas, **report}}))
    print(json.dumps({"flash_bwd_modes_vs_sdpa": {
        m: {"dq_ms": out[f"flash_bwd_dq[{m}]"]["ms"], "dkv_ms": out[f"flash_bwd_dkv[{m}]"]["ms"],
            "sdpa_bwd_ms": out[f"flash_bwd_dq[{m}]"]["library_ms"],
            "shape": out[f"flash_bwd_dq[{m}]"]["shape"]} for m in errs}}))
    return out


# ---------------------------------------------------------------------------
# phase 2: the W8A16 GEMM of the per-channel int8 weight lane
# ---------------------------------------------------------------------------

# [M, K] x [N, K]^T at every per-channel int8 product of the served
# shapes: name -> (N, K, f32 output: the logits form). The flagship's
# (d 1024, 8 x 128 heads over 8, gated MLP 2816, tied vocab 32000),
# Llama-2-7B's at bench.py:3614-3616 (tied vocab 32000), Falcon-7B's
# (K 4544 = 71 x 64; q/k/v N 73 x 64; its MLP), BLOOM-7B1's tied vocab,
# Phi-2's untied lm_head, and tails past the kernel's tiles: N 4673 (odd,
# 65 past a 128-column tile), K 4560 (80 past a 128-deep unit, 16 past a
# 64-deep half)
INT8_MM_SHAPES = {
    "flagship_qkv": (3072, 1024, False), "flagship_wo": (1024, 1024, False),
    "flagship_gate_up": (5632, 1024, False), "flagship_down": (1024, 2816, False),
    "flagship_logits": (32000, 1024, True),
    "llama2_7b_qkv": (12288, 4096, False), "llama2_7b_wo": (4096, 4096, False),
    "llama2_7b_gate_up": (22016, 4096, False), "llama2_7b_down": (4096, 11008, False),
    "llama2_7b_logits": (32000, 4096, True),
    "falcon_7b_qkv": (4672, 4544, False), "falcon_7b_wo": (4544, 4544, False),
    "falcon_7b_mlp_in": (18176, 4544, False), "falcon_7b_mlp_out": (4544, 18176, False),
    "bloom_7b1_logits": (250880, 4096, True), "phi_2_lm_head": (51200, 2560, True),
    "tails": (4673, 4560, False),
}
# decode rows, a 512-token prompt, _serving_bench's prefill wave (8 x 96)
# and a long prefill
INT8_MM_M = (1, 8, 32, 64, 512, 768, 4096)
# the rows of the kernel_check lines: the kernels line's row (Llama-2-7B's
# q/k/v product in decode at batch 8) first
INT8_MM_ROWS = {"int8_matmul": ("llama2_7b_qkv", 8), "int8_matmul@flagship_qkv_b8": (
    "flagship_qkv", 8), "int8_matmul@7b_logits_b8": ("llama2_7b_logits", 8),
    "int8_matmul@7b_qkv_prefill_512": ("llama2_7b_qkv", 512)}
INT8_MM_COLS = 16384  # columns of the f64 reference at a time


def _int8_mm_inputs(N, K, M_max, dev, seed):
    """Codes [N, K] uniform in [-127, 127] with both extremes in column 1
    and column N // 2 all zero (its scale 1), scales ~1e-3 (a weight's
    absmax / 127 at the served widths), x [M_max, K] bf16 normal."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
    q[1, 0], q[1, 1] = 127, -127
    s = torch.rand((N,), generator=g, device=dev) * 2e-3 + 2e-4
    q[N // 2] = 0
    s[N // 2] = 1.0
    x = torch.randn((M_max, K), generator=g, device=dev).to(torch.bfloat16)
    return x, q, s


def _int8_mm_errors(x, q, s, got, plain):
    """RMS and max of |got - exact| and |plain - exact|, exact = (x q^T) s
    in f64 (column chunks of INT8_MM_COLS)."""
    import torch

    xd = x.double()
    acc = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}
    for c in range(0, q.shape[0], INT8_MM_COLS):
        ref = (xd @ q[c:c + INT8_MM_COLS].double().t()) * s[c:c + INT8_MM_COLS].double()
        for name, y in (("kernel", got), ("plain", plain)):
            e = (y[:, c:c + INT8_MM_COLS].double() - ref).abs()
            if not torch.isfinite(e).all():
                acc[name][1] = float("inf")
            acc[name][0] += e.square().sum().item()
            acc[name][1] = max(acc[name][1], e.max().item())
        del ref
    n = got.numel()
    return {"kernel_rms": (acc["kernel"][0] / n) ** 0.5, "kernel_max": acc["kernel"][1],
            "plain_rms": (acc["plain"][0] / n) ** 0.5, "plain_max": acc["plain"][1]}


def _int8_mm_within(st):
    """The kernel's error against the exact product within PATH_RMS_FACTOR
    (RMS) and PATH_MAX_FACTOR (max) of the plain bf16 version's."""
    return (st["kernel_rms"] <= PATH_RMS_FACTOR * st["plain_rms"]
            and st["kernel_max"] <= PATH_MAX_FACTOR * st["plain_max"])


def _int8_mm_faults(IM, dev):
    """Planted faults that the tolerance must catch, each beside its
    genuine case: every column's scale on the next column; the last
    128-deep unit dropped (Llama-2-7B's K 4096) and the K tail dropped
    (K 4560: its last 16); the codes read as unsigned (the plain math on
    code mod 256); the tied [V, E] codes read as [E, V]; a cut tile's
    partial left out (x zeroed over the units of the first CTA's first
    segment). Faults of the wgmma design, emulated on its inputs or
    output: a ring stage consumed before its full barrier (the unit
    STAGES into a tile reading the stage's previous unit, the tile's
    first); a warpgroup given the next 64 channels' codes; the epilogue
    storing a tile [channel][token] where Y[token, channel] belongs; the
    token rows past M stored (M 5 and 33: the rows of the output buffer
    past M must keep their NaN, _int8_mm_rows_past_m). The codes and x keep
    their natural k order, so no permutation fault applies."""
    import torch

    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(name, shape, M, fault):
        N, K, f32 = INT8_MM_SHAPES[shape]
        x, q, s = _int8_mm_inputs(N, K, M, dev, seed=7)
        plain = IM.int8_matmul_plain(x, q, s, f32)
        genuine = _int8_mm_errors(x, q, s, IM.int8_matmul(x, q, s, f32), plain)
        bad = _int8_mm_errors(x, q, s, fault(x, q, s, f32), plain)
        if not _int8_mm_within(genuine) or _int8_mm_within(bad):
            raise AssertionError(f"int8_matmul planted fault {name}: genuine {genuine}, "
                                 f"fault {bad}; the fault must fail and the genuine pass")
        out[name] = {"kernel_rms_over_plain": bad["kernel_rms"] / bad["plain_rms"],
                     "kernel_max_over_plain": bad["kernel_max"] / bad["plain_max"]}

    def drop_k(n):  # the kernel given all but the last n of K
        return lambda x, q, s, f32: IM.int8_matmul(x[:, :-n].contiguous(),
                                                   q[:, :-n].contiguous(), s, f32)

    def partial_left_out(x, q, s, f32):
        plan = IM.matmul_split_plan(x.shape[0], q.shape[0], q.shape[1], sms)
        cut = [seg for seg in IM.segments(plan) if seg[4] is not None]
        if not cut:
            raise AssertionError(f"the partial fault needs a plan that cuts tiles: {plan}")
        _, tile, u0, u1, _ = cut[0]
        k0 = (u0 - tile * plan.chunks) * IM.UK
        x = x.clone()
        x[:, k0:(u1 - tile * plan.chunks) * IM.UK] = 0  # that segment's K range
        return IM.int8_matmul(x, q, s, f32)

    def stale_stage(x, q, s, f32):
        st = IM.matmul_split_plan(x.shape[0], q.shape[0], q.shape[1], sms).stages
        k = slice(st * IM.UK, (st + 1) * IM.UK)
        x, q = x.clone(), q.clone()
        x[:, k], q[:, k] = x[:, :IM.UK], q[:, :IM.UK]
        return IM.int8_matmul(x, q, s, f32)

    def next_channels(x, q, s, f32):  # warpgroup 0 of each tile given warpgroup 1's codes
        qt = q.clone().view(-1, 2, 64, q.shape[1])
        qt[:, 0] = qt[:, 1]
        return IM.int8_matmul(x, qt.view_as(q), s, f32)

    def untransposed(x, q, s, f32):  # each [tn, 128] tile written as its [128, tn] transpose
        y = IM.int8_matmul(x, q, s, f32)
        tn = IM.matmul_split_plan(x.shape[0], q.shape[0], q.shape[1], sms).tn
        M, N = y.shape
        t = y.view(M // tn, tn, N // IM.CH, IM.CH).permute(0, 2, 3, 1)
        return t.reshape(M // tn, N // IM.CH, tn, IM.CH).permute(0, 2, 1, 3).reshape(M, N)

    case("scale_on_the_next_column", "llama2_7b_qkv", 8,
         lambda x, q, s, f32: IM.int8_matmul(x, q, torch.roll(s, -1), f32))
    case("last_k_unit_dropped", "llama2_7b_qkv", 8, drop_k(IM.UK))
    case("k_tail_dropped", "tails", 8, drop_k(INT8_MM_SHAPES["tails"][1] % 64))
    case("codes_read_as_unsigned", "llama2_7b_qkv", 8,
         lambda x, q, s, f32: IM.int8_matmul_plain(x, q.view(torch.uint8), s, f32))
    case("tied_codes_read_as_e_by_v", "llama2_7b_logits", 8,
         lambda x, q, s, f32: IM.int8_matmul(x, q.view(q.shape[1], q.shape[0]).t()
                                             .contiguous(), s, f32))
    case("split_left_out", "llama2_7b_wo", 8, partial_left_out)
    case("stale_ring_stage", "llama2_7b_qkv", 8, stale_stage)
    case("warpgroup_given_the_next_64_channels", "llama2_7b_qkv", 64, next_channels)
    case("tile_stored_untransposed", "llama2_7b_qkv", 8, untransposed)
    for M in (5, 33):
        out[f"rows_past_m_stored_m{M}"] = _int8_mm_rows_past_m(IM, dev, M)
    return out


def _int8_mm_rows_past_m(IM, dev, M):
    """The kernel (its C entry, on an output buffer with NaN rows past M)
    at M rows stores rows 0..M-1 within the tolerance and leaves the rest
    NaN; the fault, the kernel run over the tile's token width with rows
    past M in x, must write some of them."""
    import math

    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda._common import ptr, stream_of
    from deepspeed_tpu_torch.ops.cuda.paged_attention import _sm_count, _workspace

    N, K, _ = INT8_MM_SHAPES["tails"]
    tn = IM.token_width(M)
    x, q, s = _int8_mm_inputs(N, K, tn, dev, seed=9)
    lib = build.load("int8_matmul")

    def run(rows):
        buf = torch.full((tn + 8, N), float("nan"), dtype=torch.bfloat16, device=dev)
        plan = IM.matmul_split_plan(rows, N, K, _sm_count(dev.index or 0))
        part = counters = None
        if plan.splits:
            part, counters = _workspace(dev, stream_of(x), math.prod(plan.scratch_shape),
                                        plan.tiles)
        opt = lambda t: None if t is None else ptr(t)
        build.check(lib, lib.int8_matmul(ptr(buf), ptr(x), ptr(q), ptr(s), opt(part),
                                         opt(counters), rows, N, K, plan.tn, plan.ctas, 0,
                                         stream_of(x)), "int8_matmul")
        torch.cuda.synchronize()
        return buf

    genuine, fault = run(M), run(tn)
    st = _int8_mm_errors(x[:M], q, s, genuine[:M], IM.int8_matmul_plain(x[:M], q, s))
    kept = bool(torch.isnan(genuine[M:]).all())
    caught = not bool(torch.isnan(fault[M:]).all())
    if not (_int8_mm_within(st) and kept and caught):
        raise AssertionError(f"int8_matmul rows past M={M}: genuine within {_int8_mm_within(st)}, "
                             f"rows past M left NaN {kept}; the fault wrote them {caught}")
    return {"genuine_rows_past_m_untouched": kept,
            "fault_rows_past_m_written": int((~torch.isnan(fault[M:])).any(1).sum())}


def _int8_mm_checks(dev, bound_ms):
    """The W8A16 GEMM (csrc/int8_matmul.cu) against its plain version at
    every INT8_MM_SHAPES shape and M in INT8_MM_M, in both output forms:
    the kernel's error against the exact product (f64) within 1.5x (RMS)
    and 2x (max) of the plain bf16 version's; two launches bit-identical;
    the planted faults (_int8_mm_faults). Timed in the form its path uses
    (device ms, torch.profiler): the kernel and cuBLAS bf16 on the codes as
    bf16 weights (the yardstick) cold (_cold_ms: as a step finds its
    weights) and warm, the plain version warm, beside the bound. One line
    a shape (int8_matmul_checks), each M naming the design and the plan it
    ran; the INT8_MM_ROWS rows go to the kernel_check lines with their
    cold times as ms and library_ms."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # the plain version's bf16 GEMM sums in f32 throughout: a tighter bar
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    try:
        for si, (shape, (N, K, f32_path)) in enumerate(INT8_MM_SHAPES.items()):
            x_all, q, s = _int8_mm_inputs(N, K, max(INT8_MM_M), dev, seed=100 + si)
            w16 = q.to(torch.bfloat16)  # the yardstick's bf16 weights
            copies = _weight_copies(lambda: (q.clone(), s.clone()), N * K)
            w16s = _weight_copies(lambda: (w16.clone(),), 2 * N * K)
            line = {}
            for M in INT8_MM_M:
                x = x_all[:M].contiguous()
                plan = IM.matmul_split_plan(M, N, K, sms)
                row = {"design": "wgmma", "plan": {"tn": plan.tn, "ctas": plan.ctas,
                                                   "tiles": plan.tiles, "stages": plan.stages,
                                                   "cuts_tiles": plan.splits}}
                for f32 in (False, True):
                    got = IM.int8_matmul(x, q, s, f32)
                    again = IM.int8_matmul(x, q, s, f32)
                    plain = IM.int8_matmul_plain(x, q, s, f32)
                    st = _int8_mm_errors(x, q, s, got, plain)
                    form = "f32" if f32 else "bf16"
                    if not _same_bits(got, again):
                        raise AssertionError(f"int8_matmul {shape} M={M} {form}: two launches "
                                             "differ")
                    if not _int8_mm_within(st):
                        raise AssertionError(f"int8_matmul {shape} M={M} {form}: beyond the "
                                             f"tolerance of the plain version: {st}")
                    st["max_abs_err_vs_plain"] = (got.float() - plain.float()).abs().max().item()
                    row[form] = st
                    del got, again, plain
                f32 = f32_path
                iters = 20 if M <= 64 else 5
                out_bytes = 4 if f32 else 2
                kern = lambda q_, s_: IM.int8_matmul(x, q_, s_, f32)
                cublas = lambda w: x @ w.t()
                row.update(
                    cold_ms=_cold_ms(kern, copies, iters),
                    ms=_device_ms(lambda: kern(q, s), iters),
                    plain_ms=_device_ms(lambda: IM.int8_matmul_plain(x, q, s, f32), iters),
                    cublas_bf16_cold_ms=_cold_ms(cublas, w16s, iters),
                    cublas_bf16_ms=_device_ms(lambda: cublas(w16), iters),
                    bound=bound_ms(M * K * 2 + N * K + N * 4 + M * N * out_bytes,
                                   2.0 * M * N * K))
                row["bound_over_cold"] = row["bound"][0] / row["cold_ms"]
                line[M] = row
                for name, (rs, rm) in INT8_MM_ROWS.items():
                    if (rs, rm) == (shape, M):
                        timed = _timings(lambda: kern(q, s),
                                         lambda: IM.int8_matmul_plain(x, q, s, f32),
                                         lambda: cublas(w16), iters)
                        timed.update(warm_ms=timed["ms"], ms=row["cold_ms"],
                                     library_warm_ms=timed["library_ms"],
                                     library_ms=row["cublas_bf16_cold_ms"])
                        results[name] = dict(
                            max_abs_err=row["f32" if f32 else "bf16"]["max_abs_err_vs_plain"],
                            **timed, bound=row["bound"],
                            shape=f"M={M}, N={N}, K={K}, {'f32' if f32 else 'bf16'} out, "
                                  f"wgmma plan {row['plan']}, cold (weights rotated past the "
                                  "L2), library = cuBLAS bf16 x @ W^T, cold")
            print(json.dumps({"int8_matmul_checks": shape, "N": N, "K": K,
                              "path_form": "f32" if f32_path else "bf16", "by_M": line}))
            del x_all, q, s, w16, copies, w16s
            torch.cuda.empty_cache()
        faults = _int8_mm_faults(IM, dev)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    print(json.dumps({"int8_matmul_planted_faults": faults}))
    return results


def _int8_mm_design_checks(dev):
    """One line (int8_matmul_design_checks): for each token width of the
    kernel (Cfg<TN>), ptxas registers and spills (any spill fails), the
    dynamic shared memory a CTA, its ring stages, the CTAs an SM holds
    (by shared memory and by 384 threads' registers), and the host us a
    call spends on its two tensor maps at Llama-2-7B's q/k/v (the codes'
    found in the table, x's encoded; the mean of 1000)."""
    import torch

    from deepspeed_tpu_torch.ops.cuda import build
    from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

    ptxas = _ptxas_registers(build, "int8_matmul", ["w8a16_wgmma_kernel"])
    N, K, _ = INT8_MM_SHAPES["llama2_7b_qkv"]
    _, q, _ = _int8_mm_inputs(N, K, 1, dev, seed=5)
    out = {}
    for tn in IM.TOKEN_WIDTHS:
        x = torch.randn((min(tn, 128), K), device=dev).to(torch.bfloat16)
        rep = ptxas.get(f"w8a16_wgmma_kernel<{tn}>", {})
        if rep.get("spill_stores", 1) or rep.get("spill_loads", 1):
            raise AssertionError(f"int8_matmul Cfg<{tn}>: ptxas {rep} (spills or no report)")
        out[tn] = {"ptxas": rep, "smem_bytes": IM.wgmma_smem(tn), "stages": IM.wgmma_stages(tn),
                   "ctas_per_sm": min(IM.SM_SHARED_BYTES // IM.wgmma_smem(tn),
                                      65536 // (384 * rep["registers"])),
                   "host_us_maps_a_call": IM.encode_ns(x, q) / 1e3}
    print(json.dumps({"int8_matmul_design_checks": out}))
    return {}


def check_kernels(cfg, dev):
    import torch

    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    from deepspeed_tpu_torch.ops.cuda import flash_attention as FA
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA
    from deepspeed_tpu_torch.platform.accelerator import bound_ms

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    bs, nblk = SERVE["kv_block_size"], SERVE["num_kv_blocks"] + 1
    NB = -(-SERVE["max_seq_len"] // bs)
    results = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf16)

    def arena():
        return randn(nblk, bs, KV, D), randn(nblk, bs, KV, D)

    # -- paged_kv_write: one prefill wave of 8 prompts of 96 tokens in the
    #    128-token bucket -> 8 x 128 rows, 8 x 96 live, 256 dropped (-1)
    Tp = PROMPT_BUCKET
    T = N_PROMPTS * Tp
    kn, vn = randn(T, KV, D), randn(T, KV, D)
    pos = torch.arange(Tp, device=dev)
    slots = (torch.arange(N_PROMPTS, device=dev)[:, None] * bs + pos[None, :])
    slots = torch.where(pos[None, :] < PROMPT_LEN, slots, -1).reshape(T).to(torch.int32)
    ka, va = arena()
    kb, vb = ka.clone(), va.clone()
    PA.paged_kv_write(ka, va, kn, vn, slots)
    PA.paged_kv_write_plain(kb, vb, kn, vn, slots)
    err = max(_check_close("paged_kv_write k", ka, kb, 0.0, 0.0),
              _check_close("paged_kv_write v", va, vb, 0.0, 0.0))
    live = slots >= 0
    idx, k_live, v_live = slots[live].long(), kn[live], vn[live]
    n_live = int(live.sum())
    row = KV * D * 2
    results["paged_kv_write"] = dict(
        max_abs_err=err,
        **_timings(lambda: PA.paged_kv_write(ka, va, kn, vn, slots),
                   lambda: PA.paged_kv_write_plain(kb, vb, kn, vn, slots),
                   lambda: (kb.view(-1, KV, D).index_copy_(0, idx, k_live),
                            vb.view(-1, KV, D).index_copy_(0, idx, v_live)), 50),
        shape=f"T={T} rows ({n_live} live), arena [{nblk},{bs},{KV},{D}] bf16",
        bound=bound_ms(4 * n_live * row + 4 * T, 0.0))

    # -- paged decode, both modes: S = 8 distinct sequences, ctx 97..118,
    #    each sequence in its own block of the flagship arena
    S = N_PROMPTS
    ctx = torch.arange(S, device=dev, dtype=torch.int32) * 3 + PROMPT_LEN + 1
    tables = torch.full((S, NB), nblk - 1, dtype=torch.int32, device=dev)
    tables[:, 0] = torch.arange(S, dtype=torch.int32, device=dev)
    q = randn(S, H, D)
    k_new, v_new = randn(S, KV, D), randn(S, KV, D)
    slots_d = (tables[:, 0] * bs + (ctx - 1) % bs).to(torch.int32)
    ctx_sum = int(ctx.sum())
    io = S * H * D * 2 * 2 + S * NB * 4 + S * 4  # q in, out, tables, ctx
    ops = 4 * ctx_sum * H * D

    for name, fused in (("paged_decode_fused", True), ("paged_decode_attention", False)):
        ka, va = arena()
        kb, vb = ka.clone(), va.clone()
        if fused:
            run = lambda: PA.paged_decode_fused(q, ka, va, tables, ctx, k_new, v_new, slots_d)
            plain = lambda: PA.paged_decode_fused_plain(q, kb, vb, tables, ctx, k_new, v_new,
                                                        slots_d)
            out, ref = run()[0], plain()[0]
            _check_close(f"{name} cache k", ka, kb, 0.0, 0.0)
            _check_close(f"{name} cache v", va, vb, 0.0, 0.0)
            n_bytes = io + (ctx_sum - S) * row * 2 + S * row * 2 * 2 + S * 4
        else:
            run = lambda: PA.paged_decode_attention(q, ka, va, tables, ctx)
            plain = lambda: PA.paged_decode_attention_plain(q, kb, vb, tables, ctx)
            out, ref = run(), plain()
            n_bytes = io + ctx_sum * row * 2
        atol, rtol = KERNEL_TOL[name]
        results[name] = dict(
            max_abs_err=_check_close(name, out, ref, atol, rtol),
            **_timings(run, plain, None, 50),
            shape=f"S={S}, ctx {int(ctx.min())}..{int(ctx.max())}, H={H}, KV={KV}, D={D}, "
                  f"bs={bs}, arena {nblk} blocks, bf16",
            bound=bound_ms(n_bytes, ops))
    mw = TransformerConfig(**MISTRAL)
    # each further check, and the seconds it takes (kernel_check_seconds)
    checks = {
        "int8": lambda: _int8_kernel_checks(PA, randn, dev, H, KV, D, bs, nblk, NB, slots, ctx,
                                            tables, q, bound_ms),
        # flash forward: the 512-token prefill wave of the serving path (B=1)
        # and the training shape; the kernels line carries the training one
        "flash_serve": lambda: {"flash_fwd@serve": _flash_fwd_check(FA, randn, 1, LONG_LEN, H,
                                                                    KV, D, bound_ms)},
        "flash_train": lambda: _flash_train_checks(FA, randn, TRAIN_B, TRAIN_S, H, KV, D,
                                                   bound_ms),
        # the window modes at the Mistral shapes: training (B=1, S=8192) and serving
        "flash_window": lambda: _flash_window_checks(FA, randn, 1, TRAIN_W_S, mw.n_heads,
                                                     mw.kv_heads, mw.head_dim, bound_ms),
        "decode_window": lambda: _decode_window_checks(PA, randn, dev, bound_ms),
        # the ALiBi modes at BLOOM-7B1's shapes (and falcon-rw-1b's, GQA, 24 heads)
        "flash_alibi": lambda: _flash_alibi_checks(FA, randn, dev, bound_ms),
        "flash_bwd_alibi": lambda: _flash_bwd_alibi_checks(FA, randn, dev, bound_ms),
        "decode_alibi": lambda: _decode_alibi_checks(PA, randn, dev, bound_ms),
        # the layout-bitmap modes at Llama-2-7B's shape, bs 128 and 16
        "decode_sparse": lambda: _decode_sparse_checks(PA, randn, dev, bound_ms),
        # the wide-group and head_dim-80 modes at Falcon-7B's and Phi-2's shapes
        "decode_group": lambda: _decode_group_checks(PA, randn, dev, bound_ms),
        # the split-K design of #4/#5 at Falcon-7B's and Mistral's shapes
        "decode_design": lambda: _decode_design_checks(PA, randn, dev),
        # the tiled design of #6's int8 write at its four bounding shapes
        "kv_write_design": lambda: _kv_write_design_checks(PA, randn, dev, bound_ms),
        "d80": lambda: _d80_checks(FA, PA, randn, dev, bound_ms),
        # the head_dim-96 and head_dim-256 modes at GPT-NeoX-20B's and GPT-J-6B's shapes
        "wide_head": lambda: _wide_head_checks(FA, PA, randn, dev, bound_ms),
        # the backward's head_dim-80 and wide-group modes at Phi-2's and
        # Falcon-7B's training shapes
        "flash_bwd_modes": lambda: _flash_bwd_mode_checks(FA, randn, dev, bound_ms),
        "evoformer": lambda: _evo_kernel_checks(dev, bound_ms),
        # the W8A16 GEMM of the per-channel int8 weight lane at every served shape
        "int8_matmul": lambda: _int8_mm_checks(dev, bound_ms),
        "int8_matmul_design": lambda: _int8_mm_design_checks(dev),
    }
    seconds = {"flagship_serving": time.perf_counter() - t0}
    for label, check in checks.items():
        t = time.perf_counter()
        results.update(check())
        seconds[label] = time.perf_counter() - t
    print(json.dumps({"kernel_check_seconds": seconds,
                      "profiler_events_s_so_far": PROFILER_POST_S[0]}))
    for name, r in results.items():
        print(json.dumps({"kernel_check": name, "max_err": r["max_abs_err"],
                          "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                          "library_ms": r["library_ms"], "call_ms": r["call_ms"],
                          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                          "shape": r["shape"]}))
    return results


# ---------------------------------------------------------------------------
# phase 3: the training path at full flagship width and depth
# ---------------------------------------------------------------------------

def _grads_three_paths(T, master, cfg, tokens, device):
    """Per-token loss [S] and the flattened gradient of the mean loss on
    one sequence, by three paths from the fp32 weights `master`: the
    kernel path in bf16 (what training runs), the plain path in bf16 and
    the plain path in f32 (the reference for both)."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.utils.tree import leaves, tree_map

    tokens = torch.as_tensor(tokens, device=device).long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    out = []
    for use_kernel, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                              (False, torch.float32)):
        live = tree_map(lambda m: m.detach().to(dtype, copy=True).requires_grad_(), master)
        logits = T.forward(live, inputs, cfg, use_kernel=use_kernel).float()
        nll = F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="none")
        grads = torch.autograd.grad(nll.mean(), leaves(live))
        out.append((nll.detach(), torch.cat([g.float().flatten() for g in grads])))
        del live, logits, grads
    return out


def run_train(mcfg, dev):
    import numpy as np
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = initialize(dict(TRAIN_CONFIG), loss_fn=T.make_loss_fn(mcfg, loss_chunks=LOSS_CHUNKS),
                     param_init_fn=lambda g: T.init(mcfg, g, device=dev),
                     param_logical_specs=T.logical_specs(mcfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": np.random.default_rng(0).integers(
        0, mcfg.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int32)}

    # -- the main path, counted: one train step --------------------------------
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first = eng.train_batch(batch)
    first_step_s = time.perf_counter() - t0
    launches = K.launch_counts()
    # ---------------------------------------------------------------------------

    want = {n: (mcfg.n_layers if n in TRAIN_KERNELS else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"a train step should launch each flash kernel once per layer "
                             f"and nothing else: {launches}, expected {want}")
    history = [first] + [eng.train_batch(batch) for _ in range(TRAIN_STEPS - 1)]
    losses = [m["loss"] for m in history]
    if not all(np.isfinite(losses + [m["grad_norm"] for m in history])):
        raise AssertionError(f"non-finite loss or grad_norm: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {TRAIN_STEPS} steps on a fixed "
                             f"batch: {losses}")

    # -- timing: TIMED_STEPS async steps between two CUDA events ---------------
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_STEPS):
        eng.train_batch_async(batch)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / TIMED_STEPS
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    breakdown = _where_time_goes(lambda: eng.train_batch(batch), top=10)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    # -- kernel path vs plain paths on one sequence -----------------------------
    r = np.random.default_rng(1)
    one = r.integers(0, mcfg.vocab_size, (1, TRAIN_S + 1)).astype(np.int32)
    (nk, gk), (npl, gp), (n32, g32) = _grads_three_paths(T, eng.state.master, mcfg, one,
                                                         eng.device)
    loss_stats = _path_errors("per-token loss", nk, npl, n32)
    # gradients in units of the f32 gradient's RMS, so the fixed slack of
    # _path_errors is relative to the gradient's scale
    unit = g32.square().mean().sqrt()
    grad_stats = _path_errors("gradients", gk / unit, gp / unit, g32 / unit)
    grad_stats["f32_grad_rms"] = unit.item()
    loss_stats["mean_loss"] = {"kernel": nk.mean().item(), "plain_bf16": npl.mean().item(),
                               "plain_f32": n32.mean().item()}
    del gk, gp, g32, eng
    torch.cuda.empty_cache()
    return {
        "init_s": init_s,
        "first_step_s": first_step_s,
        "launches": launches,
        "losses": losses,
        "grad_norms": [m["grad_norm"] for m in history],
        "step_ms": step_ms,
        "tokens_per_s": tok_s,
        "mfu": tok_s * mcfg.flops_per_token(TRAIN_S) / H100_BF16_FLOPS,
        "flops_per_token": mcfg.flops_per_token(TRAIN_S),
        "peak_mem_gib": peak_gib,
        "where_time_goes": breakdown,
        "path_loss": loss_stats,
        "path_grads": grad_stats,
    }


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full flagship width
# ---------------------------------------------------------------------------

def _pool_copies(cache, dtype=None):
    """A copy of a PagedCache; bf16/f32 pools cast to `dtype`, int8 code
    pools and their f32 scale pools copied as they are."""
    from deepspeed_tpu_torch.inference import model as M

    if cache.quantized:
        cp = lambda xs: [x.clone() for x in xs]
        return M.PagedCache(k=cp(cache.k), v=cp(cache.v), k_scale=cp(cache.k_scale),
                            v_scale=cp(cache.v_scale))
    return M.PagedCache(k=[x.to(dtype, copy=True) for x in cache.k],
                        v=[x.to(dtype, copy=True) for x in cache.v])


def _int8_step_pools(eng, cfg, dec):
    """One counted fused decode step of the int8 engine (kernel path, bf16)
    on copies of its live pools, held against the plain quantizing write:
    the k/v rows each layer handed paged_decode_fused_int8 (recorded on the
    way in), quantized and scattered by paged_kv_write_quant_plain into
    copies of the pre-step pools, must give the kernel's pools bit for
    bit. Also the bf16 plain path's own step (use_kernel=False: the
    separate quantizing write, then plain attention): its layer-0 pools
    must equal the kernel's bit for bit (layer 0's rows are the same
    computation on both paths); later layers' rows differ by the two
    paths' attention rounding, so for them the share of equal codes and the
    largest code gap are reported."""
    import torch

    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    before = _pool_copies(eng.cache)
    kern, plain = _pool_copies(before), _pool_copies(before)
    rows, real = [], M.paged_decode_fused_int8

    def record(q, kc, vc, tbl, ctx, k_new, v_new, slots, ks, vs, **kw):
        rows.append((k_new.clone(), v_new.clone(), slots.clone()))
        return real(q, kc, vc, tbl, ctx, k_new, v_new, slots, ks, vs, **kw)

    M.paged_decode_fused_int8 = record
    try:
        K.reset_launch_counts()
        M.decode_step(eng.params, kern, *dec, cfg, use_kernel=True, unique_rows=True)
        torch.cuda.synchronize()
        launches = K.launch_counts()
    finally:
        M.paged_decode_fused_int8 = real
    if launches["paged_decode_fused_int8"] != cfg.n_layers or len(rows) != cfg.n_layers:
        raise AssertionError(f"a fused int8 decode step should launch the fused int8 kernel "
                             f"once per layer: {launches}")
    for li, (k_new, v_new, slots) in enumerate(rows):
        ref = [before.k[li].clone(), before.v[li].clone(), before.k_scale[li].clone(),
               before.v_scale[li].clone()]
        PA.paged_kv_write_quant_plain(*ref, k_new, v_new, slots)
        got = (kern.k[li], kern.v[li], kern.k_scale[li], kern.v_scale[li])
        for name, x, y in zip(("k codes", "v codes", "k scales", "v scales"), got, ref):
            if not torch.equal(x, y):
                raise AssertionError(f"layer {li} {name}: the fused int8 kernel's pools differ "
                                     "from the plain quantizing write of the same rows")
    M.decode_step(eng.params, plain, *dec, cfg, use_kernel=False, unique_rows=True)
    torch.cuda.synchronize()
    same, worst_gap, layers_equal = [], 0, 0
    for li in range(cfg.n_layers):
        pairs = ((kern.k[li], plain.k[li]), (kern.v[li], plain.v[li]),
                 (kern.k_scale[li], plain.k_scale[li]), (kern.v_scale[li], plain.v_scale[li]))
        equal = all(torch.equal(x, y) for x, y in pairs)
        layers_equal += equal
        if li == 0 and not equal:
            raise AssertionError("layer 0: the kernel path's pools differ from the bf16 plain "
                                 "path's after one fused decode step")
        gap = max((x.int() - y.int()).abs().max().item() for x, y in pairs[:2])
        worst_gap = max(worst_gap, gap)
        n_rows = 2 * dec[0].shape[0] * cfg.kv_heads * cfg.head_dim  # codes this step wrote
        n_diff = sum(int((x != y).sum()) for x, y in pairs[:2])
        same.append(1.0 - n_diff / n_rows)
    return {"kernel_vs_plain_write_of_same_rows": "bit-identical, every layer",
            "layers_bit_identical_to_bf16_plain_path": layers_equal,
            "bf16_plain_path_min_share_equal_codes": min(same),
            "bf16_plain_path_max_code_gap": worst_gap,
            "launches": {n: c for n, c in launches.items() if c}}


def run_serving(cfg, dev, int8=False, bf16=None):
    """The serving path, counted, on bf16 KV pools (phase 4) or, with
    int8=True, on int8 pools (kv_cache_dtype="int8", phase "serve_int8"),
    which adds a prefix-hit put whose tail block is copied with its scale
    tiles, the pool check of _int8_step_pools, and, against the bf16
    engine's results `bf16`, the bytes-per-token ratio and logit gaps.
    Returns (the phase's report, what a later phase compares with)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    # bf16 on the GPU by default
    eng = init_inference(params, cfg, dict(SERVE, kv_cache_dtype="int8" if int8 else "auto"))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    V = cfg.vocab_size
    r = np.random.default_rng(0)
    prompts = [r.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(N_PROMPTS)]
    long_prompt = r.integers(0, V, LONG_LEN).astype(np.int32)
    uids = list(range(N_PROMPTS))

    # -- the main path, counted -------------------------------------------
    K.reset_launch_counts()
    prefill = eng.put(uids + [N_PROMPTS], prompts + [long_prompt])
    nxt = prefill.argmax(-1).astype(np.int32)
    decode = eng.put([0], [nxt[:1]])
    chunk = eng.put([1], [np.array([nxt[1], 1], np.int32)])
    tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
    toks = nxt[:N_PROMPTS].copy()
    toks[0], toks[1] = decode[0].argmax(), chunk[0].argmax()
    fn = eng.decode_multi_fn(N_PROMPTS, DECODE_STEPS)
    gen, last, eng.cache, _ = fn(eng.params, eng.cache, toks, tables, ctx)
    if int8:
        # the long prompt's first two blocks match in full: a hit capped at
        # len - 1, its tail block copied (COW) with its scale tiles
        hit = eng.put([N_PROMPTS + 1], [long_prompt[:2 * SERVE["kv_block_size"]].copy()])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    # -----------------------------------------------------------------------

    if int8:
        want = set(INT8_KERNELS)
        wrong = {n: c for n, c in launches.items() if (c == 0) == (n in want)}
        if wrong:
            raise AssertionError(f"the int8 serving path must launch each of {sorted(want)} "
                                 f"and nothing else; wrong counts: {wrong}")
    else:
        missing = [n for n in SERVE_KERNELS if launches[n] == 0]
        if missing:
            raise AssertionError(f"the serving path launched no {missing} kernel: {launches}")
    logits = [("prefill", prefill), ("decode", decode), ("chunk", chunk),
              ("decode_multi", last.float().cpu().numpy())] + ([("prefix_hit", hit)] if int8
                                                              else [])
    for name, x in logits:
        if not np.isfinite(x).all():
            raise AssertionError(f"{name} logits are not finite")
    g = gen.cpu().numpy()
    if g.shape != (DECODE_STEPS, N_PROMPTS) or g.min() < 0 or g.max() >= V:
        raise AssertionError(f"decode_multi tokens out of range: {g.shape}")
    prefix = {k: v for k, v in eng.prefix_cache_stats().items()
              if k in ("lookup_hits", "lookup_misses", "cow_copies")}
    if int8 and (prefix["lookup_hits"] < 1 or prefix["cow_copies"] < 1):
        raise AssertionError(f"the prefix put took no hit or copied no tail block: {prefix}")

    # -- kernel path vs plain versions, same engine weights, on the card ----
    # three runs of the same math: kernel path in bf16 (what put() served),
    # plain path in bf16, plain path in f32 (the reference for both)
    p32 = {k: ([{n: w.float() for n, w in lp.items()} for lp in v] if k == "layers"
               else v.float()) for k, v in eng.params.items()}
    bs = SERVE["kv_block_size"]
    NBt = eng.config.blocks_per_seq
    toks_b = np.zeros((N_PROMPTS, PROMPT_BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks_b[i, :PROMPT_LEN] = p
    tb = np.zeros((N_PROMPTS, NBt), np.int32)
    tb[:, 0] = np.arange(N_PROMPTS)
    tl = np.zeros((1, NBt), np.int32)
    tl[0, :LONG_LEN // bs] = np.arange(LONG_LEN // bs) + N_PROMPTS
    waves = [(toks_b, np.full((N_PROMPTS,), PROMPT_LEN, np.int32), tb),
             (long_prompt[None], np.array([LONG_LEN], np.int32), tl)]
    plain = {}
    for dtype, prm in ((torch.bfloat16, eng.params), (torch.float32, p32)):
        scratch = M.init_cache(cfg, N_PROMPTS + LONG_LEN // bs + 1, bs, dtype, dev,
                               kv_quant=int8)
        plain[dtype] = torch.cat([
            M.prefill_batch(prm, scratch, *(torch.as_tensor(a, device=dev) for a in w),
                            cfg, use_kernel=False)[0] for w in waves]).cpu()
        del scratch
    prefill_stats = _path_errors("prefill logits", torch.from_numpy(prefill),
                                 plain[torch.bfloat16], plain[torch.float32])
    # one decode step (fused kernel) on copies of the live cache
    dec = (torch.as_tensor(g[-1], device=dev), torch.as_tensor(tables, device=dev),
           torch.as_tensor(ctx + DECODE_STEPS, device=dev))
    outs = []
    for use_kernel, dtype, prm in ((True, torch.bfloat16, eng.params),
                                   (False, torch.bfloat16, eng.params),
                                   (False, torch.float32, p32)):
        cache = _pool_copies(eng.cache, dtype)
        outs.append(M.decode_step(prm, cache, *dec, cfg, use_kernel=use_kernel,
                                  unique_rows=True)[0].cpu())
        del cache
    decode_stats = _path_errors("decode logits", *outs)
    del p32
    report = {"init_s": init_s, "launches": launches, "prefill_logits": prefill_stats,
              "decode_logits": decode_stats}
    if int8:
        report["pools_after_fused_step"] = _int8_step_pools(eng, cfg, dec)
        ratio = bf16["kv_bytes_per_token"] / eng.kv_bytes_per_token()
        if ratio < 1.8:
            raise AssertionError(f"bf16 / int8 kv_bytes_per_token {ratio} under the 1.8 pin")
        report["kv_bytes_per_token"] = {"bf16": bf16["kv_bytes_per_token"],
                                        "int8": eng.kv_bytes_per_token(), "ratio": ratio}
        # reported, not asserted: the int8 pools' effect on the logits of
        # the same decode and continuation puts of the bf16 engine
        report["int8_vs_bf16_engine_logits"] = {
            name: {"max_abs": float(np.abs(x - bf16[name]).max()),
                   "argmax_agree": float((x.argmax(-1) == bf16[name].argmax(-1)).mean())}
            for name, x in (("decode", decode), ("chunk", chunk))}

    # -- timings (after the counted run) ------------------------------------
    times = _serving_times(eng, fn, toks, tables, ctx, r, V, LONG_LEN)
    report.update(times)
    report["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    report["prefix_cache"] = prefix
    return report, {"decode": decode, "chunk": chunk,
                    "kv_bytes_per_token": eng.kv_bytes_per_token()}


def _ttft(eng, r, V, prompt_len):
    """TTFT (ms) of fresh prompts of `prompt_len` tokens: CUDA events around
    put(), 5 after 2 warm-ups."""
    import numpy as np
    import torch

    ttft = []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for i in range(7):  # the first two are warm-up
        p = r.integers(0, V, prompt_len).astype(np.int32)
        uid = 1000 + i
        torch.cuda.synchronize()
        start.record()
        eng.put([uid], [p])  # returns host logits, so the host waits for the card
        stop.record()
        torch.cuda.synchronize()
        eng.flush(uid)
        if i >= 2:
            ttft.append(start.elapsed_time(stop))
    return ttft


def _serving_times(eng, fn, toks, tables, ctx, r, V, prompt_len):
    """TTFT of fresh prompts of `prompt_len` tokens (CUDA events around
    put(); median of 5 after 2 warm-ups), the time of the batch-8 greedy
    decode_multi `fn` over the rows `toks`, and where the time goes in each
    (torch.profiler)."""
    import numpy as np
    import torch

    ttft = _ttft(eng, r, V, prompt_len)
    step_ms = _time_ms(lambda: fn(eng.params, eng.cache, toks, tables, ctx), 3, warmup=1)
    p = r.integers(0, V, prompt_len).astype(np.int32)
    breakdown = {
        "decode_multi_b8_24steps": _where_time_goes(
            lambda: fn(eng.params, eng.cache, toks, tables, ctx)),
        f"prefill_put_{prompt_len}": _where_time_goes(lambda: eng.put([2000], [p])),
    }
    eng.flush(2000)
    n = prompt_len
    return {f"ttft_ms_{n}_p50": statistics.median(ttft), f"ttft_ms_{n}_all": ttft,
            "decode_multi_ms_b8_24steps": step_ms,
            "decode_tok_s_b8": len(toks) * DECODE_STEPS / (step_ms / 1e3),
            "where_time_goes": breakdown}


# ---------------------------------------------------------------------------
# phase serve_graphs: warmup() captures decode as CUDA graphs; every replay
# held against an eager call of the same program, bit for bit
# ---------------------------------------------------------------------------

# the flagship's rows: 64 prompts of 96 tokens, one 128-token block each
# (ctx 97-120 over the 24 steps); greedy decode_multi at bench.py's serving
# batches and its sampled lane at batch 32 (bench.py _serving_bench)
GRAPH_WIDTHS, SAMPLED_WIDTH, GRAPH_PROMPTS = (8, 32, 64), 32, 64
SAMPLED_LANE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)
SERVE_G = dict(SERVE, num_kv_blocks=96)  # 64 rows, and free blocks to move 8 of them to
# the workspace fault's rows: ctx 601-624 spans the flagship decode's two
# 512-position splits (decode_split_plan at 8 rows over 1024 positions)
SPLIT_PROMPT = 600
# the depth of the SERVED_7B servers here: their replay-vs-eager checks run
# at full width, 8 layers deep (the flagship's stay at full depth), which
# keeps the whole script inside its time limit
GRAPH_7B_LAYERS = 8


def _same_bits(a, b):
    """Bit identity of two tensors (f32 compared as their bits) or Nones."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def _replay_vs_eager(eng, fn, args):
    """One replayed call of the decode_multi step `fn` and one eager call
    of the same program from the same cache state (the eager call is given
    a copy of the weights dict, which the engine does not replay; the two
    write the same positions, which no earlier step reads). Returns (bit
    identity of tokens, final logits and presence; the replay's result;
    the gaps)."""
    import torch

    r0, e0 = eng.graphs.replays, eng.graphs.eager_runs
    got = fn(eng.params, eng.cache, *args)
    want = fn(dict(eng.params), eng.cache, *args)
    torch.cuda.synchronize()  # a replay's launch error surfaces here
    if (eng.graphs.replays, eng.graphs.eager_runs) != (r0 + 1, e0 + 1):
        raise AssertionError(f"expected one replay and one eager run: replays {r0} -> "
                             f"{eng.graphs.replays}, eager {e0} -> {eng.graphs.eager_runs}")
    same = all(_same_bits(x, y) for x, y in ((got[0], want[0]), (got[1], want[1]),
                                             (got[3], want[3])))
    gap = {"tokens_off": int((got[0] != want[0]).sum()),
           "logits_max_abs": float((got[1] - want[1]).abs().nan_to_num(1e30).max())}
    return same, got, gap


def _decode_call_stats(call, n_rows, runs=3):
    """One decode_multi call of n_rows x DECODE_STEPS tokens: the median and
    the least of `runs` CUDA-event timings (after a warm-up), tok/s from
    the median, the host's time to issue the call (until it returns, the
    card still working) and where its time goes (_where_time_goes)."""
    import torch

    call()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms, issue_ms = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        call()
        stop.record()
        issue_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    step = statistics.median(ms)
    return {"ms": step, "runs_ms": ms, "least_ms": min(ms),
            "issue_ms": statistics.median(issue_ms), "issue_runs_ms": issue_ms,
            "tok_s": n_rows * DECODE_STEPS / (step / 1e3),
            "where_time_goes": _where_time_goes(call)}


def _graph_times(eng, fn, args, n_rows):
    """_decode_call_stats of the program eagerly (a copy of the weights
    dict, which the engine never replays) and replayed, with each one's
    idle share also taken of the CUDA-event time (the profiled busy time
    over the unprofiled call: the profiler's own host cost left out)."""
    out = {}
    for how, params in (("eager", dict(eng.params)), ("replayed", eng.params)):
        st = _decode_call_stats(lambda: fn(params, eng.cache, *args), n_rows)
        where = st.pop("where_time_goes")
        st.update(device_busy_ms=where["device_busy_ms"], device_ops=where["device_ops"],
                  idle_share=where["idle_share"],
                  idle_share_of_event_ms=1.0 - where["device_busy_ms"] / st["ms"])
        out[how] = st
    out["speedup"] = out["eager"]["ms"] / out["replayed"]["ms"]
    return out


def _sampled_oracle(eng, scfg, toks, tables, ctx, keys, step0, replay):
    """The sampled lane stepwise on the card (decode_step, then
    sample_tokens: decode_multi's loop body, one call each), keeping every
    step's logits. Its tokens and final logits must equal the replay's bit
    for bit, and every token the CPU oracle's (host_oracle_token on that
    step's logits row, the row's key and draw counter); a disagreement
    prints the oracle's two best candidates and their margin."""
    import torch

    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.inference import sampling as S

    dev = eng.device
    t = torch.as_tensor(toks, device=dev)
    tb, cx = torch.as_tensor(tables, device=dev), torch.as_tensor(ctx, device=dev)
    s0 = torch.as_tensor(step0, device=dev)
    logits, gen = [], []
    for i in range(DECODE_STEPS):
        lg = M.decode_step(eng.params, eng.cache, t, tb, cx + i, eng.cfg, unique_rows=True,
                           alibi=eng._alibi, layout=eng._layout)[0]
        t = S.sample_tokens(lg, scfg, keys, s0 + i)
        logits.append(lg)
        gen.append(t)
    gen = torch.stack(gen)
    if not (_same_bits(gen, replay[0]) and _same_bits(logits[-1], replay[1])):
        raise AssertionError("the stepwise sampled decode differs from the replayed one: "
                             f"{int((gen != replay[0]).sum())} tokens off")
    keys_h = keys.cpu().numpy()
    gen_h = gen.cpu().numpy()
    t0 = time.perf_counter()
    off = []
    for i, lg in enumerate(logits):
        lg = lg.cpu().numpy()
        for s in range(gen_h.shape[1]):
            pos = int(step0[s]) + i
            want = S.host_oracle_token(lg[s], scfg, keys_h[s], pos)
            if want != gen_h[i, s]:
                off.append({"step": i, "row": s, "card": int(gen_h[i, s]), "oracle": want,
                            **S.oracle_margin(lg[s], scfg, keys_h[s], pos)})
    if off:
        print(json.dumps({"sampled_oracle_mismatches": off}))
        raise AssertionError(f"{len(off)} sampled tokens differ from the CPU oracle's")
    return {"tokens_checked": int(gen_h.size), "distinct_tokens": int(len(set(gen_h.ravel()))),
            "oracle_s": time.perf_counter() - t0}


def _graph_checks(eng, widths, sampled_width, rows, step0_of):
    """warmup() over `widths` (greedy, 24 steps) and, with `sampled_width`,
    again with the bench's sampling config at that width; then each
    width's greedy decode_multi_fn(b, 24) and the sampled lane replayed
    against eager (bit identity), the sampled tokens against the CPU
    oracle, and the times. rows: the uids, their tokens; step0_of: the
    draw counters of the sampled rows. Returns the report and the
    per-program arguments."""
    import numpy as np

    from deepspeed_tpu_torch.inference.sampling import SamplingConfig

    uids, toks = rows
    rep = {"warmup": eng.warmup(widths=list(widths), decode_chunks=[DECODE_STEPS])}
    want = len(widths) * 3  # two single steps and one decode_multi a width
    if rep["warmup"]["graphs"] != want:
        raise AssertionError(f"warmup captured {rep['warmup']['graphs']} graphs, not {want}")
    scfg = None
    if sampled_width:
        scfg = SamplingConfig(**SAMPLED_LANE)
        rep["warmup_sampled"] = eng.warmup(sampling=SAMPLED_LANE, widths=[sampled_width],
                                           decode_chunks=[DECODE_STEPS])
        if rep["warmup_sampled"]["graphs"] != 1:  # its single steps: captured above
            raise AssertionError(f"the sampled warmup captured {rep['warmup_sampled']}")
    rep["footprints"] = dict(eng.warmup_footprints)
    args = {}
    for b in widths:
        tables = eng.state.block_table(uids[:b], eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids[:b]], np.int32)
        args[b] = (eng.decode_multi_fn(b, DECODE_STEPS), (toks[:b].copy(), tables, ctx))
    if sampled_width:
        b = sampled_width
        _, (t, tables, ctx) = args[b]
        keys = eng._row_keys(0, np.arange(b))
        args["sampled"] = (eng.decode_multi_fn(b, DECODE_STEPS, sampling=scfg),
                           (t, tables, ctx, keys, step0_of(ctx)))
    for name, (fn, a) in args.items():
        same, got, gap = _replay_vs_eager(eng, fn, a)
        if not same:
            raise AssertionError(f"{name}: the replayed decode differs from eager: {gap}")
        entry = {"bit_identical": True}
        if name == "sampled":
            entry["oracle"] = _sampled_oracle(eng, scfg, *a, got)
        entry["times"] = _graph_times(eng, fn, a, len(a[0]))
        rep[f"b{name}" if name != "sampled" else f"sampled_b{sampled_width}"] = entry
    return rep, args


def _free_blocks(eng, n):
    """n blocks no live sequence holds (the allocator's range, without the
    scratch block)."""
    used = {b for u in eng.state.tracked_uids for b in eng.state.get(u).blocks}
    free = [b for b in range(eng.config.num_kv_blocks) if b not in used]
    if len(free) < n:
        raise AssertionError(f"{n} free blocks wanted, {len(free)} free")
    return free[:n]


def _planted_graph_faults(eng, args):
    """Faults that must fail the replay check, each beside its genuine
    case, which must pass (the flagship's bf16 engine, width 8 greedy and
    the sampled lane):
    - stale_table_buffer: the rows' pages moved to free blocks and the old
      blocks overwritten; the replay with the new tables must equal eager,
      a replay whose table copy is skipped reads the old blocks;
    - output_without_clone: a second replay with other tokens must leave
      the first replay's result as it was; returning the static outputs
      lets it change;
    - keys_not_copied: the sampled lane with seed 1's keys after seed 0's
      must equal eager and change the tokens; with the key copy skipped it
      keeps seed 0's draws;
    - stale_weights_after_refresh_params: new weights (every float leaf
      halved) drop the graphs; the width-8 graph put back reads the old
      weights and differs from eager; warmup() again captures one that
      matches;
    - workspace_replaced_after_capture: 8 rows of SPLIT_PROMPT tokens,
      whose decode adds two splits through the workspace, replayed against
      eager; then the capture stream's decode workspace replaced, and the
      old one's memory given another tensor's data in place (NaN partials,
      arrival counters at 2^20), as a freed block reused by the allocator
      would hold it: the width-8 replay then combines no split and must
      differ from eager. (Freeing the block and allocating again does not
      reliably hand the same block back.) Last, since it leaves the
      engine's graphs broken: they are dropped."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.graphs import CapturedProgram
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    out = {}
    fn8, (toks, tables, ctx) = args[8]
    prog8 = next(p for k, p in eng.graphs.programs.items() if k.width == 8 and k.n_steps)
    V = eng.cfg.vocab_size

    def verdict(name, genuine, planted):
        out[name] = {"genuine_passes": genuine[0], "planted_fails": not planted[0],
                     "genuine": genuine[1], "planted": planted[1]}
        if not genuine[0] or planted[0]:
            raise AssertionError(f"planted fault {name}: {out[name]}")

    def skip_copy(prog, index):
        """The fault: prog's next loads leave static input `index` as it is."""
        prog.load = lambda ins: CapturedProgram.load(
            prog, [prog.static[i] if i == index else x for i, x in enumerate(ins)])

    # stale table buffer
    moved = tables.copy()
    moved[:, 0] = _free_blocks(eng, len(tables))
    old, new = (torch.as_tensor(x[:, 0], dtype=torch.long, device=eng.device)
                for x in (tables, moved))
    pools = eng._pools()
    saved = [(p[old].clone(), p[new].clone()) for p in pools]
    for s, d in zip(old, new):
        eng._copy_block(int(s), int(d))
    for p in pools:  # each old block overwritten by its neighbour's page
        p[old] = p[new].roll(1, dims=0)
    res = []
    for fault in (False, True):
        fn8(eng.params, eng.cache, toks, tables, ctx)  # the static tables: the old blocks
        if fault:
            skip_copy(prog8, 1)
        same, _, gap = _replay_vs_eager(eng, fn8, (toks, moved, ctx))
        res.append((same, gap))
        prog8.__dict__.pop("load", None)
    for p, (a, b) in zip(pools, saved):
        p[old], p[new] = a, b
    verdict("stale_table_buffer", *res)

    # output without clone
    toks2 = (toks + 1) % V
    res = []
    for fault in (False, True):
        if fault:
            prog8.results = lambda: prog8.outputs
        first = fn8(eng.params, eng.cache, toks, tables, ctx)
        kept = [first[0].clone(), first[1].clone()]
        fn8(eng.params, eng.cache, toks2, tables, ctx)
        torch.cuda.synchronize()
        res.append((_same_bits(first[0], kept[0]) and _same_bits(first[1], kept[1]),
                    {"tokens_changed": int((first[0] != kept[0]).sum())}))
        prog8.__dict__.pop("results", None)
    verdict("output_without_clone", *res)

    # keys not copied into the static buffer
    fns, (t, tb, cx, keys0, step0) = args["sampled"]
    progs = next(p for k, p in eng.graphs.programs.items() if k.sampling is not None
                 and k.n_steps)
    keys1 = eng._row_keys(1, np.arange(len(t)))
    res = []
    for fault in (False, True):
        base = fns(eng.params, eng.cache, t, tb, cx, keys0, step0)[0]
        if fault:
            skip_copy(progs, 3)
        same, got, gap = _replay_vs_eager(eng, fns, (t, tb, cx, keys1, step0))
        changed = int((got[0] != base).sum())
        res.append((same and changed > 0, dict(gap, tokens_changed_with_seed=changed)))
        progs.__dict__.pop("load", None)
    verdict("keys_not_copied", *res)

    # stale weights after refresh_params
    old_params = eng.params
    half = lambda x: x * 0.5 if x.is_floating_point() else x
    eng.refresh_params({k: ([{n: half(w) for n, w in lp.items()} for lp in v]
                            if k == "layers" else half(v)) for k, v in old_params.items()})
    dropped = len(eng.graphs) == 0
    r0 = eng.graphs.replays
    fn8(eng.params, eng.cache, toks, tables, ctx)
    ran_eager = eng.graphs.replays == r0
    eng.warmup(widths=[8], decode_chunks=[DECODE_STEPS], footprint=False)
    genuine = _replay_vs_eager(eng, fn8, (toks, tables, ctx))
    key8 = next(k for k in eng.graphs.programs if k.width == 8 and k.n_steps)
    fresh = eng.graphs.programs[key8]
    eng.graphs.programs[key8] = prog8  # the fault: the graph of the old weights kept
    planted = _replay_vs_eager(eng, fn8, (toks, tables, ctx))
    eng.graphs.programs[key8] = fresh
    del old_params
    verdict("stale_weights_after_refresh_params",
            (genuine[0] and dropped and ran_eager, dict(genuine[2], graphs_dropped=dropped,
                                                        eager_until_warmup=ran_eager)),
            planted[::2])

    # workspace replaced after capture (the fresh width-8 graph), on rows
    # whose context spans two of the decode's 512-position splits (the 96-
    # token rows above have one live split, which writes its output without
    # the workspace)
    for u in eng.state.tracked_uids:
        eng.flush(u)
    rr = np.random.default_rng(1)
    long_rows = list(range(1000, 1000 + len(toks)))
    toks = eng.put(long_rows, [rr.integers(0, V, SPLIT_PROMPT).astype(np.int32)
                               for _ in long_rows]).argmax(-1).astype(np.int32)
    tables = eng.state.block_table(long_rows, eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in long_rows], np.int32)
    genuine = _replay_vs_eager(eng, fn8, (toks, tables, ctx))
    fn8(eng.params, eng.cache, (toks + 1) % V, tables, ctx)  # stale outputs: another input's
    wkey = (eng.cache.k[0].device.index, eng.graphs.stream.cuda_stream)
    part, counters = PA._WORKSPACE[wkey]
    with torch.cuda.stream(eng.graphs.stream):  # the replacement, as a larger plan makes it
        PA._WORKSPACE[wkey] = (torch.empty_like(part), torch.zeros_like(counters))
    # had the old blocks been freed, the allocator could hand them to any
    # tensor; stand in for that tensor, which the graph's launches now share
    part.fill_(float("nan"))
    counters.fill_(1 << 20)
    planted = _replay_vs_eager(eng, fn8, (toks, tables, ctx))
    verdict("workspace_replaced_after_capture", genuine[::2], planted[::2])
    eng.graphs.clear()
    return out


def _graph_model_done(report, name, rep):
    """Print one engine's whole report on its own line, and keep its times
    in the phase's report: per program, eager and replayed tok/s and idle
    share, and the replay's host us to issue."""
    print(json.dumps({"serve_graphs_model": name, **rep}))
    report["models"][name] = {
        prog: {"eager_tok_s": e["times"]["eager"]["tok_s"],
               "replayed_tok_s": e["times"]["replayed"]["tok_s"],
               "eager_idle": e["times"]["eager"]["idle_share"],
               "replayed_idle": e["times"]["replayed"]["idle_share"],
               "replayed_idle_of_event_ms": e["times"]["replayed"]["idle_share_of_event_ms"],
               "replay_issue_ms": e["times"]["replayed"]["issue_ms"]}
        for prog, e in rep.items() if isinstance(e, dict) and "times" in e}


def run_serve_graphs(cfg, dev):
    """Phase serve_graphs: the flagship (bf16 and int8 pools) at batches
    8, 32 and 64 greedy and the sampled lane at 32, and every 7B server,
    Phi-2, GPT-NeoX-20B and GPT-J-6B (SERVED_7B at their widths, cut to
    GRAPH_7B_LAYERS layers; bf16 and int8 pools) at batch 8 greedy, each
    replayed from the graphs warmup() captured against eager, bit for
    bit; the sampled tokens against the CPU oracle; the planted faults
    (_planted_graph_faults) on the flagship's bf16 engine; decode tok/s
    and idle share eager and replayed. The counted launches are those of
    one eager call of each of the flagship's programs (a replay launches
    what its capture counted, uncounted)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.ops.cuda import paged_attention as PA

    t0 = time.perf_counter()
    report = {"models": {}}
    launches = {}
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
               for _ in range(GRAPH_PROMPTS)]
    uids = list(range(GRAPH_PROMPTS))
    for int8 in (False, True):
        eng = init_inference(params, cfg, dict(SERVE_G, kv_cache_dtype="int8" if int8 else "auto"))
        params = eng.params
        toks = eng.put(uids, [p.copy() for p in prompts]).argmax(-1).astype(np.int32)
        retired = len(PA._RETIRED)
        rep, args = _graph_checks(eng, GRAPH_WIDTHS, SAMPLED_WIDTH, (uids, toks),
                                  lambda ctx: ctx.copy())
        rep["workspaces_retired"] = len(PA._RETIRED) - retired
        K.reset_launch_counts()
        for fn, a in args.values():
            fn(dict(eng.params), eng.cache, *a)
        torch.cuda.synchronize()
        for n, c in K.all_launch_counts().items():
            launches[n] = launches.get(n, 0) + c
        if not int8:
            rep["planted_faults"] = _planted_graph_faults(eng, args)
        rep["graph_counts"] = {"replays": eng.graphs.replays, "eager_runs": eng.graphs.eager_runs,
                               "captures": eng.graphs.captures}
        _graph_model_done(report, "flagship/" + ("int8" if int8 else "bf16"), rep)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    report["flagship_s"] = time.perf_counter() - t0
    for mode, model in SERVED_7B:
        mc = T.TransformerConfig(**dict(model, n_layers=GRAPH_7B_LAYERS))
        serve, n_long, n_wave, seed, _ = SERVE_LONG[mode]
        params = _init_served(T, mc, dev)
        for int8 in (False, True):
            eng = init_inference(params, mc, dict(serve, kv_cache_dtype="int8" if int8 else "auto"))
            params = eng.params
            rr = np.random.default_rng(seed)
            last = eng.put([100], [rr.integers(0, mc.vocab_size, n_long).astype(np.int32)])
            wave = eng.put(list(range(n_wave)), [rr.integers(0, mc.vocab_size, PROMPT_LEN)
                                                 .astype(np.int32) for _ in range(n_wave)])
            rows = [100] + list(range(n_wave))
            toks = np.concatenate([last, wave]).argmax(-1).astype(np.int32)
            rep, _ = _graph_checks(eng, (len(rows),), 0, (rows, toks), None)
            rep["graph_counts"] = {"replays": eng.graphs.replays,
                                   "eager_runs": eng.graphs.eager_runs,
                                   "captures": eng.graphs.captures}
            _graph_model_done(report, f"{mode}/{'int8' if int8 else 'bf16'}", rep)
            del eng
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    want = ("paged_decode_fused", "paged_decode_fused_int8")  # decode_multi's rows are distinct
    wrong = {n: c for n, c in launches.items() if "[" not in n and (c == 0) == (n in want)}
    if wrong:
        raise AssertionError(f"the eager decode_multi calls must launch each of {want} and "
                             f"nothing else: {wrong}")
    report["launches"] = {n: c for n, c in launches.items() if c}
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# phase serve_int8w: the per-channel int8 weight lane (bench.py
# _serving_bench's int8 lane, bench.py:3553-3561, and _serving_7b_bench's
# Llama-2-7B, bench.py:3584-3680), every weight product on the W8A16 GEMM
# ---------------------------------------------------------------------------

INT8W = {"bits": 8, "per_channel": True}
# the flagship's lane: its weights per-channel int8, greedy
# decode_multi_fn(b, 24) at the bench's b = 8 and 64, from bf16 and int8
# KV pools (SERVE_G: 64 rows of 96 tokens)
INT8W_FLAGSHIP_WIDTHS = (8, 64)
# Llama-2-7B at bench.py:3614-3616 (tied embeddings, as there), random
# weights built and quantized layer by layer on the card; TTFT at 512 and
# decode at batches 1, 8 and 32; a pool of 32 rows of one block, the
# 512-token prompts and the pad block
LLAMA2_7B_BENCH = dict(vocab_size=32000, n_layers=32, n_heads=32, d_model=4096, d_ff=11008,
                       max_seq=4096, variant="llama")
INT8W_7B_WIDTHS = (1, 8, 32)
SERVE_7B_INT8W = dict(max_seq_len=1024, kv_block_size=128, num_kv_blocks=48,
                      min_prefill_bucket=128, max_batch_size=32)
# names of the library GEMMs none of which may run in a replayed int8 step
GEMM_NAMES = ("gemm", "cublas", "cutlass", "xmma")
# resident weight bytes of the int8 lane over the bf16 engine's, at most
INT8W_BYTES_RATIO = 0.51


def _f32(w):
    """A serving-tree leaf for the f32 plain path: a tensor cast to f32; a
    per-channel int8 weight keeps its codes and f32 scales (the same
    codes), its embedding rows in f32."""
    import dataclasses

    return (dataclasses.replace(w, dtype_name="float32") if hasattr(w, "dtype_name")
            else w.float())


def _device_kernel_names(fn):
    """The names of the kernels one call of fn ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({name for name, _ in _device_events(prof)})


def _int8w_7b_weights(T, M, mc, dev):
    """Random bf16 weights of `mc` built layer by layer on the card, as
    _serving_7b_bench builds them (normal x 0.5 / sqrt(fan_in), norm scales
    1, embedding normal x 0.02), each layer prepared (fused q/k/v and
    gate/up) and per-channel quantized as it is made. Returns the bf16 and
    the int8 prepared trees (the int8 one's embedding still bf16: the
    engine quantizes it per row)."""
    import torch

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    bf16_layers, int8_layers = [], []
    for _ in range(mc.n_layers):
        lp = {}
        for name, (shape, _) in sorted(T._layer_shapes(mc).items()):
            if "ln" in name:
                lp[name] = torch.ones(shape, dtype=bf16, device=dev)
            else:
                lp[name] = (torch.randn(shape, generator=g, device=dev)
                            * (0.5 / shape[0] ** 0.5)).to(bf16)
        lp = M.prepare_layer(lp, mc)
        bf16_layers.append(lp)
        int8_layers.append(M.quantize_layer(lp, mc))
    top = {"embed": (torch.randn((mc.vocab_size, mc.d_model), generator=g, device=dev)
                     * 0.02).to(bf16),
           "ln_f_scale": torch.ones((mc.d_model,), dtype=bf16, device=dev)}
    return dict(top, layers=bf16_layers), dict(top, layers=int8_layers)


def _int8w_lane(eng, mc, widths, n_rows, dev, seed, bf16_bytes):
    """One per-channel int8 engine: the counted main path (a wave of 8
    96-token prompts, the 512-token prompt, one eager greedy
    decode_multi_fn(widths[0], 24)), each call launching the W8A16 GEMM
    once per quantized product of every forward (the layers' ChannelQuant
    leaves + the logits), with the attention kernels of its pools and
    nothing else; resident weight bytes over the bf16 engine's
    (`bf16_bytes`); the three-path logit check (_serve_three_paths on the
    same codes); warmup() and every width's replay against eager, bit for
    bit, with eager and replayed times (_graph_checks); no library GEMM in
    a replayed call; TTFT at 512."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.inference.quantization import ChannelQuantWeight, quantized_nbytes
    from deepspeed_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    V = mc.vocab_size
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(n_rows)]
    long_prompt = r.integers(0, V, LONG_LEN).astype(np.int32)
    uids = list(range(n_rows))
    per_call = 1 + sum(isinstance(w, ChannelQuantWeight)
                       for lp in eng.params["layers"] for w in lp.values())
    int8_pools = eng.cache.quantized
    want = {"int8_matmul", "flash_fwd"} | ({"paged_kv_write_int8", "paged_decode_fused_int8"}
                                           if int8_pools else
                                           {"paged_kv_write", "paged_decode_fused"})

    # -- the main path, counted -------------------------------------------
    launches, toks = {}, []

    def counted(what, n_forward, call):
        K.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
        got = K.launch_counts()
        if got["int8_matmul"] != per_call * n_forward:
            raise AssertionError(f"{what}: {got['int8_matmul']} W8A16 launches, not "
                                 f"{per_call} products x {n_forward} forwards")
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        return out

    wave = counted("the 8-prompt wave", 1, lambda: eng.put(uids[:N_PROMPTS],
                                                          prompts[:N_PROMPTS]))
    toks.append(wave.argmax(-1))
    for w0 in range(N_PROMPTS, n_rows, N_PROMPTS):
        toks.append(eng.put(uids[w0:w0 + N_PROMPTS], prompts[w0:w0 + N_PROMPTS]).argmax(-1))
    long = counted("the 512-token prompt", 1, lambda: eng.put([n_rows], [long_prompt]))
    toks = np.concatenate(toks).astype(np.int32)
    b = widths[0]
    tables = eng.state.block_table(uids[:b], eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids[:b]], np.int32)
    fn = eng.decode_multi_fn(b, DECODE_STEPS)
    gen, final, _, _ = counted(f"decode_multi_fn({b}, {DECODE_STEPS})", DECODE_STEPS,
                               lambda: fn(dict(eng.params), eng.cache, toks[:b].copy(),
                                          tables, ctx))
    wrong = {n: c for n, c in launches.items() if (c == 0) == (n in want)}
    if wrong:
        raise AssertionError(f"the int8-weight path must launch each of {sorted(want)} and "
                             f"nothing else: {wrong}")
    for name, x in (("wave", wave), ("long", long), ("decode_multi", final.float().cpu().numpy())):
        if not np.isfinite(x).all():
            raise AssertionError(f"{name} logits are not finite")
    eng.flush(n_rows)
    g = gen.cpu().numpy()
    if g.shape != (DECODE_STEPS, b) or g.min() < 0 or g.max() >= V:
        raise AssertionError(f"decode_multi tokens out of range: {g.shape}")
    rep = {"products_a_forward": per_call, "launches": {n: c for n, c in launches.items() if c}}
    int8_bytes = quantized_nbytes(eng.params)
    rep["weights"] = {"int8_lane_bytes": int8_bytes, "bf16_engine_bytes": bf16_bytes,
                      "ratio": int8_bytes / bf16_bytes}
    if rep["weights"]["ratio"] > INT8W_BYTES_RATIO:
        raise AssertionError(f"resident weights {rep['weights']} above {INT8W_BYTES_RATIO}x "
                             "the bf16 engine's")
    t1 = time.perf_counter()
    rep["path"] = _serve_three_paths(M, eng, mc, int8_pools, long_prompt,
                                     prompts[:N_PROMPTS], dev)
    rep["path_s"] = time.perf_counter() - t1

    # -- graphs: replays against eager, and the times ------------------------
    rep["graphs"], args = _graph_checks(eng, widths, 0, (uids, toks), None)
    gfn, a = args[widths[-1]]
    names = _device_kernel_names(lambda: gfn(eng.params, eng.cache, *a))
    gemms = [n for n in names if any(s in n.lower() for s in GEMM_NAMES)]
    if gemms or not any("w8a16" in n for n in names):
        raise AssertionError(f"a replayed int8 decode ran library GEMMs {gemms} or no W8A16 "
                             f"kernel: {names}")
    rep["replayed_call_kernels"] = {"distinct": len(names),
                                    "w8a16": [n[:80] for n in names if "w8a16" in n]}
    ttft = _ttft(eng, r, V, LONG_LEN)
    rep.update({f"ttft_ms_{LONG_LEN}_p50": statistics.median(ttft),
                f"ttft_ms_{LONG_LEN}_all": ttft, "seconds": time.perf_counter() - t0})
    return rep


def _lane_summary(rep, widths):
    """TTFT and each width's eager and replayed decode tok/s of a lane."""
    out = {f"ttft_ms_{LONG_LEN}_p50": rep.get(f"ttft_ms_{LONG_LEN}_p50")}
    for b in widths:
        t = rep["graphs"][f"b{b}"]["times"]
        out[f"b{b}"] = {"eager_tok_s": t["eager"]["tok_s"], "replayed_tok_s": t["replayed"]["tok_s"],
                        "replayed_idle_of_event_ms": t["replayed"]["idle_share_of_event_ms"]}
    return out


def run_serve_int8w(cfg, dev, bf16_serve, bf16_graphs):
    """Phase serve_int8w. The flagship's int8-weight lane (the weights of
    phases serve and serve_graphs, seed 0) from bf16 and from int8 KV pools
    (_int8w_lane at INT8W_FLAGSHIP_WIDTHS), its bf16 engine's TTFT and
    replayed tok/s beside it (phases serve and serve_graphs of this run);
    then Llama-2-7B (LLAMA2_7B_BENCH, _int8w_7b_weights) per-channel int8
    at INT8W_7B_WIDTHS, and its bf16 engine on the same bf16 weights (TTFT,
    replay against eager, times) beside it."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.models import transformer as T

    t0 = time.perf_counter()
    report = {"lanes": {}}
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    for int8_pools in (False, True):
        kv = "int8" if int8_pools else "auto"
        eng = init_inference(params, cfg, dict(SERVE_G, kv_cache_dtype=kv), quantization=INT8W)
        rep = _int8w_lane(eng, cfg, INT8W_FLAGSHIP_WIDTHS, GRAPH_PROMPTS, dev, seed=0,
                          bf16_bytes=2 * T.param_count(cfg))
        name = f"flagship/{'int8' if int8_pools else 'bf16'}_pools"
        print(json.dumps({"serve_int8w_lane": name, **rep}))
        report["lanes"][name] = _lane_summary(rep, INT8W_FLAGSHIP_WIDTHS)
        report["lanes"][name].update(path=rep["path"], weights=rep["weights"],
                                     launches=rep["launches"])
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    bf16_replayed = bf16_graphs["models"]["flagship/bf16"]
    report["flagship_bf16_engine_this_run"] = {
        f"ttft_ms_{LONG_LEN}_p50": bf16_serve.get(f"ttft_ms_{LONG_LEN}_p50"),
        **{f"b{b}": {"eager_tok_s": bf16_replayed[f"b{b}"]["eager_tok_s"],
                     "replayed_tok_s": bf16_replayed[f"b{b}"]["replayed_tok_s"]}
           for b in INT8W_FLAGSHIP_WIDTHS}}
    report["flagship_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    mc = T.TransformerConfig(**LLAMA2_7B_BENCH)
    bf16_tree, int8_tree = _int8w_7b_weights(T, M, mc, dev)
    report["llama2_7b_build_s"] = time.perf_counter() - t1
    eng = init_inference(int8_tree, mc, dict(SERVE_7B_INT8W), quantization=INT8W)
    del int8_tree
    rep = _int8w_lane(eng, mc, INT8W_7B_WIDTHS, max(INT8W_7B_WIDTHS), dev, seed=1,
                      bf16_bytes=2 * T.param_count(mc))
    print(json.dumps({"serve_int8w_lane": "llama2_7b/bf16_pools", **rep}))
    report["lanes"]["llama2_7b/bf16_pools"] = _lane_summary(rep, INT8W_7B_WIDTHS)
    report["lanes"]["llama2_7b/bf16_pools"].update(path=rep["path"], weights=rep["weights"],
                                                   launches=rep["launches"])
    del eng
    torch.cuda.empty_cache()
    # the bf16 engine on the same bf16 weights, timed in the same call
    import numpy as np

    eng = init_inference(bf16_tree, mc, dict(SERVE_7B_INT8W))
    r = np.random.default_rng(1)
    n = max(INT8W_7B_WIDTHS)
    uids = list(range(n))
    toks = np.concatenate([eng.put(uids[w0:w0 + N_PROMPTS], [
        r.integers(0, mc.vocab_size, PROMPT_LEN).astype(np.int32) for _ in range(N_PROMPTS)])
        .argmax(-1) for w0 in range(0, n, N_PROMPTS)]).astype(np.int32)
    graphs, _ = _graph_checks(eng, INT8W_7B_WIDTHS, 0, (uids, toks), None)
    ttft = _ttft(eng, r, mc.vocab_size, LONG_LEN)
    report["llama2_7b_bf16_engine_this_run"] = _lane_summary(
        {"graphs": graphs, f"ttft_ms_{LONG_LEN}_p50": statistics.median(ttft)}, INT8W_7B_WIDTHS)
    del eng, bf16_tree
    torch.cuda.empty_cache()
    report["llama2_7b_s"] = time.perf_counter() - t1
    report["launches"] = {}
    for lane in report["lanes"].values():
        for k, c in lane["launches"].items():
            report["launches"][k] = report["launches"].get(k, 0) + c
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# phases serve_scheduler and kv_handoff: the single-replica serving control
# plane (inference/scheduler.py, pressure.py, offload_store.py) and the
# engine's KV export/import on the flagship at full width and depth
# ---------------------------------------------------------------------------

# the flagship's scheduler engine: 80 blocks of 128 tokens (10,240 token
# slots, 0.94 GiB of bf16 pools at 96 KiB a token) against 64 requests of up
# to 1,664 tokens, with fresh admissions paused at 95% live occupancy (RED)
# and brownout at 98%, so that RED pressure, preemption, spill and resume
# fire. (A victim spills only with KV written, seen_tokens >= 1; at 96
# blocks, or with the default watermarks 0.85/0.95, every victim of this
# trace is a prompt admitted in the same iteration, with none.)
SCHED_SERVE = dict(max_seq_len=2048, kv_block_size=128, num_kv_blocks=80,
                   min_prefill_bucket=64, max_batch_size=32)
SCHED_CONFIG = dict(prefill_mode="chunked", prefill_chunk=256, max_num_batched_tokens=2048,
                    decode_chunk=8, warmup=True,
                    pressure=dict(enabled=True, red=0.95, brownout=0.98, spill_host_mb=512.0))
# the greedy trace: prompt and new-token lengths drawn uniformly from seed
# 0, every 4th request shares one 512-token prefix; 8 requests arrive at
# step 0 and 4 at each step after
SCHED_TRACE = dict(requests=64, prompt=(64, 1536), shared=16, prefix=512, new=(32, 128),
                   first=8, per_step=4, seed=0)
# the sampled trace (bench.py's sampling config), whole prompts in waves
SCHED_SAMPLED = dict(requests=16, prompt=(64, 1536), shared=0, prefix=0, new=(32, 128),
                     first=16, per_step=0, seed=1)
# the steps of the greedy trace profiled for the idle share: after the
# last arrival and its first chunks, before the trace drains
SCHED_WINDOW = (400, 64)
# the chained-step check: 8 sampled requests decoding one step a dispatch
SCHED_CHAINED = dict(requests=8, prompt=(96, 96), shared=0, prefix=0, new=(24, 24), first=8,
                     per_step=0, seed=2)
# kv_handoff: 8 prompts of 96-1920 tokens on engines of the scheduler's
# geometry with room for all of them and their 24 decode steps
HANDOFF_SERVE = dict(SCHED_SERVE, num_kv_blocks=160)
HANDOFF_PROMPTS = (8, 96, 1920)


def _sched_trace(V, requests, prompt, shared, prefix, new, seed, **_):
    """[(prompt tokens, max_new_tokens)] of a trace: lengths uniform in
    `prompt` and `new`; every 4th of the first 4 * shared requests starts
    with one shared `prefix`-token prefix."""
    import numpy as np

    r = np.random.default_rng(seed)
    pre = r.integers(0, V, prefix)
    out = []
    for i in range(requests):
        share = i % 4 == 0 and i // 4 < shared
        lo = max(prompt[0], prefix + 64) if share else prompt[0]
        n = int(r.integers(lo, prompt[1] + 1))
        toks = r.integers(0, V, n)
        if share:
            toks[:prefix] = pre
        out.append(([int(t) for t in toks], int(r.integers(new[0], new[1] + 1))))
    return out


def _arrivals(trace, first, per_step, **_):
    """A run() tick that submits the trace's requests (stream = index):
    `first` at step 0, then `per_step` a step. Returns (tick, rids)."""
    rids = []

    def tick(s):
        due = first + per_step * s.counters["steps"]
        while len(rids) < min(due, len(trace)):
            p, n = trace[len(rids)]
            rids.append(s.submit(p, n, stream=len(rids)))

    return tick, rids


def _probe_steps(eng, K, depth):
    """Set on `eng` wrappers of its three program makers under which the
    first prefill wave, the first shared-table mixed step and the first
    fused step of `depth` run eagerly, their graphs set aside, with the
    kernel launches read around each ('wave', 'mixed_shared', 'fused').
    The shared-table step also keeps its inputs, logits and the pools
    before it. rec['forced_eager'] counts the eager decode runs this
    caused. `del` the three attributes to restore the engine."""
    import numpy as np
    import torch

    rec = {"forced_eager": 0}
    orig = {n: getattr(eng, n) for n in ("_decode_fn", "decode_multi_fn", "_prefill_batch_fn")}

    def counted(kind, call, keep=None):
        torch.cuda.synchronize()
        before = K.launch_counts()
        pools = _pool_copies(eng.cache, torch.bfloat16) if keep is not None else None
        progs, eng.graphs.programs = eng.graphs.programs, {}
        e0 = eng.graphs.eager_runs
        try:
            out = call()
            torch.cuda.synchronize()
        finally:
            eng.graphs.programs = progs
        rec["forced_eager"] += eng.graphs.eager_runs - e0
        after = K.launch_counts()
        rec[kind] = {"launches": {n: after[n] - before[n] for n in after
                                  if after[n] != before[n]}}
        if keep is not None:
            rec[kind].update(inputs=keep, pools=pools, logits=out[0].float().cpu())
        return out

    def decode_fn(s, unique_rows=False):
        step = orig["_decode_fn"](s, unique_rows)
        if unique_rows or "mixed_shared" in rec:
            return step
        return lambda p, c, t, tb, cx: counted(
            "mixed_shared", lambda: step(p, c, t, tb, cx),
            keep=tuple(np.array(x) for x in (t, tb, cx)))

    def multi_fn(s, n_steps, sampling=None, with_presence=False):
        step = orig["decode_multi_fn"](s, n_steps, sampling, with_presence)
        if n_steps != depth or "fused" in rec:
            return step
        return lambda *a: counted("fused", lambda: step(*a))

    def prefill_fn(bp, tp):
        step = orig["_prefill_batch_fn"](bp, tp)
        if "wave" in rec:
            return step
        return lambda *a: counted("wave", lambda: step(*a))

    eng._decode_fn, eng.decode_multi_fn, eng._prefill_batch_fn = decode_fn, multi_fn, prefill_fn
    return rec


def _plain_step_check(eng, name, p32, pools, toks, tables, ctx, kernel_logits, unique):
    """One decode step's kernel-path logits held against the plain path
    rerun from copies of the pools before it, in bf16 and in f32
    (_path_errors), over the step's real rows (ctx > 0)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference import model as M

    real = torch.from_numpy(np.asarray(ctx) > 0)
    dev = eng.device
    ins = [torch.as_tensor(np.asarray(x), device=dev) for x in (toks, tables, ctx)]
    plain = []
    for dtype, prm in ((torch.bfloat16, eng.params), (torch.float32, p32)):
        cache = _pool_copies(pools, dtype)
        plain.append(M.decode_step(prm, cache, *ins, eng.cfg, use_kernel=False,
                                   unique_rows=unique, alibi=eng._alibi,
                                   layout=eng._layout)[0].float().cpu()[real])
        del cache
    return _path_errors(name, kernel_logits[real], *plain)


def _chained_check(eng, p32, planted):
    """SCHED_CHAINED through a scheduler of decode depth 1, so that decode
    steps chain: the first chained step whose device tokens differ from
    what its graph's static token buffer holds is replayed with the pools
    before it kept, and its logits held against the plain path fed those
    device tokens (_plain_step_check). planted: the replay skips copying
    the tokens into the static buffer (it reads the last step's). Returns
    the check's stats, or raises AssertionError when it fails."""
    import torch

    from deepspeed_tpu_torch.inference import ServingScheduler
    from deepspeed_tpu_torch.inference.graphs import CapturedProgram, GraphKey

    NB = eng.config.blocks_per_seq
    seen = {}
    orig = eng._decode_fn

    def decode_fn(s, unique_rows=False):
        step = orig(s, unique_rows)

        def run(params, cache, toks, tables, ctx):
            prog = eng.graphs.get(GraphKey(s, 0, True, NB, None, False))
            if "stats" in seen or not isinstance(toks, torch.Tensor) or prog is None:
                return step(params, cache, toks, tables, ctx)
            real = torch.as_tensor(ctx > 0, device=toks.device)
            if not bool((prog.static[0] != toks)[real].any()):
                return step(params, cache, toks, tables, ctx)  # the fault would not show
            pools = _pool_copies(eng.cache, torch.bfloat16)
            kept = toks.clone()
            if planted:
                prog.load = lambda ins: CapturedProgram.load(prog, [prog.static[0]] + list(ins[1:]))
            try:
                r0 = eng.graphs.replays
                out = step(params, cache, toks, tables, ctx)
                torch.cuda.synchronize()
            finally:
                prog.__dict__.pop("load", None)
            if eng.graphs.replays != r0 + 1:
                raise AssertionError("the chained step did not replay its graph")
            seen["stats"] = None
            seen["stats"] = _plain_step_check(eng, "chained step logits", p32, pools,
                                              kept.cpu().numpy(), tables, ctx,
                                              out[0].float().cpu(), True)
            return out
        return run

    sched = ServingScheduler(eng, dict(prefill_chunk=256, max_num_batched_tokens=2048,
                                       decode_chunk=1, warmup=False),
                             sampling=SAMPLED_LANE, seed=2)
    trace = _sched_trace(eng.cfg.vocab_size, **SCHED_CHAINED)
    tick, rids = _arrivals(trace, **SCHED_CHAINED)
    eng._decode_fn = decode_fn
    try:
        sched.run(tick=tick)
    finally:
        del eng._decode_fn
    if "stats" not in seen or sched.counters["chained_steps"] == 0:
        raise AssertionError(f"no chained step changed its tokens: {sched.counters}")
    return dict(seen["stats"], chained_steps=sched.counters["chained_steps"])


def _trace_checks(eng, sched, trace, rids):
    """Every request ended by length (or EOS) with its token count, in the
    vocabulary; the pool holds no live block."""
    bad = []
    for (prompt, n), rid in zip(trace, rids):
        req = sched.finished.get(rid)
        if req is None or req.finish_reason not in ("length", "eos") or (
                req.finish_reason == "length" and len(req.output) != n) or not all(
                0 <= t < eng.cfg.vocab_size for t in req.output):
            bad.append((rid, None if req is None else (req.finish_reason, len(req.output), n)))
    if bad or len(rids) != len(trace):
        raise AssertionError(f"requests that did not end with their tokens: {bad[:8]}")
    live = eng.config.num_kv_blocks - eng.state.allocator.available_blocks
    if live or eng.state.tracked_uids:
        raise AssertionError(f"{live} blocks still live, {len(eng.state.tracked_uids)} "
                             "sequences tracked after the trace")


def _run_trace(eng, K, sched, trace, spec, window=None):
    """Drive `sched` through `trace` under its arrivals (`spec`), with the
    first wave, shared-table mixed step and fused step counted
    (_probe_steps), optionally profiling the steps of `window`. Returns
    (rids, probe record, wall s, eager decode runs outside the probes,
    window summary or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tick, rids = _arrivals(trace, **spec)
    win = {}

    def ticked(s):
        tick(s)
        if window is None:
            return
        st = s.counters["steps"]
        if "prof" not in win and st >= window[0]:
            torch.cuda.synchronize()
            win.update(prof=profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                       s0=st)
            win["prof"].start()
            win["t"] = time.perf_counter()
        elif "prof" in win and "summary" not in win and st >= win["s0"] + window[1]:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - win["t"]) * 1e3
            win["prof"].stop()
            win["summary"] = dict(_time_summary(win["prof"], wall), steps=st - win["s0"],
                                  first_step=win["s0"])

    rec = _probe_steps(eng, K, sched.cfg.decode_chunk)
    e0 = eng.graphs.eager_runs
    t0 = time.perf_counter()
    try:
        sched.run(tick=ticked)
        torch.cuda.synchronize()
    finally:
        del eng._decode_fn, eng.decode_multi_fn, eng._prefill_batch_fn
    wall = time.perf_counter() - t0
    if "prof" in win and "summary" not in win:
        win["prof"].stop()
    eager = eng.graphs.eager_runs - e0 - rec["forced_eager"]
    return rids, rec, wall, eager, win.get("summary")


def _counted_step(rec, kind, want):
    """The counted step `kind` launched exactly `want` of #1-#6."""
    if kind not in rec:
        raise AssertionError(f"the trace ran no {kind} step to count")
    got = {n: c for n, c in rec[kind]["launches"].items() if "[" not in n}
    if got != want:
        raise AssertionError(f"a counted {kind} step should launch {want}, launched {got}")
    return got


def _trace_times(sched, trace, rids, wall):
    """Host-wall serving metrics of a finished trace: TTFT p50/p99 and
    TPOT p50 (ms, as ServingScheduler.metrics computes them), output
    tok/s over the trace's wall time, steps, wall ms a step."""
    import numpy as np

    m = sched.metrics()
    n_out = sum(len(sched.finished[r].output) for r in rids)
    return {"ttft_p50_ms": m["ttft_p50_ms"],
            "ttft_p99_ms": float(np.percentile(np.asarray(sched._ttft), 99) * 1e3),
            "tpot_p50_ms": m["tpot_p50_ms"], "output_tokens": n_out,
            "prompt_tokens": sum(len(p) for p, _ in trace),
            "output_tok_s": n_out / wall, "wall_s": wall, "steps": sched.counters["steps"],
            "wall_ms_per_step": wall * 1e3 / sched.counters["steps"]}


def run_serve_scheduler(cfg, dev):
    """Phase serve_scheduler: the flagship served by ServingScheduler
    under arriving traffic (SCHED_TRACE greedy, SCHED_SAMPLED sampled), the
    counted steps and checks of the module docstring (4y), the chained
    step's check with its planted fault."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import ServingScheduler
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    t0 = time.perf_counter()
    L = cfg.n_layers
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    eng = init_inference(params, cfg, dict(SCHED_SERVE))
    del params
    sched = ServingScheduler(eng, dict(SCHED_CONFIG))
    warm = {"graphs": eng.graphs.captures, "s": time.perf_counter() - t0,
            "footprints_mib": {w: f["peak_hbm_bytes"] / 2**20
                               for w, f in eng.warmup_footprints.items()}}
    sampled = ServingScheduler(eng, dict(SCHED_CONFIG, prefill_mode="wave"),
                               sampling=SAMPLED_LANE, seed=1)
    warm.update(graphs=eng.graphs.captures, s=time.perf_counter() - t0)
    V = cfg.vocab_size
    trace = _sched_trace(V, **SCHED_TRACE)
    strace = _sched_trace(V, **SCHED_SAMPLED)

    # -- the main path, counted -------------------------------------------
    K.reset_launch_counts()
    rids, rec, wall, eager, window = _run_trace(eng, K, sched, trace, SCHED_TRACE,
                                                SCHED_WINDOW)
    _trace_checks(eng, sched, trace, rids)
    srids, srec, swall, seager, _ = _run_trace(eng, K, sampled, strace, SCHED_SAMPLED)
    _trace_checks(eng, sampled, strace, srids)
    torch.cuda.synchronize()
    launches = {n: c for n, c in K.launch_counts().items() if c}
    # -----------------------------------------------------------------------

    if window is None:
        raise AssertionError(f"the trace ran {sched.counters['steps']} steps, fewer than the "
                             f"window {SCHED_WINDOW} needs")
    counted = {"wave": _counted_step(srec, "wave", {"flash_fwd": L, "paged_kv_write": L}),
               "mixed_shared": _counted_step(rec, "mixed_shared", {"paged_kv_write": L,
                                                                   "paged_decode_attention": L}),
               "fused": _counted_step(rec, "fused",
                                      {"paged_decode_fused": SCHED_CONFIG["decode_chunk"] * L})}
    want = {"flash_fwd", "paged_kv_write", "paged_decode_attention", "paged_decode_fused"}
    if set(launches) != want:
        raise AssertionError(f"the scheduler's path must launch each of {sorted(want)} and "
                             f"nothing else: {launches}")
    if eager or seager:
        raise AssertionError(f"{eager} greedy and {seager} sampled decode dispatches ran "
                             "eagerly after warmup")
    c = sched.counters
    gov = sched.governor.metrics()
    fired = {"red_steps": gov["pressure_steps_red"], "preemptions": c["preemptions"],
             "spills": c["spills"], "spill_resumes": c["spill_resumes"]}
    if not all(fired.values()):
        raise AssertionError(f"the greedy trace must reach RED pressure, preempt, spill and "
                             f"resume: {fired}")

    # -- kernel path vs plain, and the chained step with its planted fault ---
    p32 = {k: ([{n: w.float() for n, w in lp.items()} for lp in v] if k == "layers"
               else v.float()) for k, v in eng.params.items()}
    ms = rec["mixed_shared"]
    mixed = _plain_step_check(eng, "mixed step logits", p32, ms["pools"], *ms["inputs"],
                              ms["logits"], False)
    del rec["mixed_shared"]["pools"]
    chained = _chained_check(eng, p32, planted=False)
    try:
        planted = _chained_check(eng, p32, planted=True)
        planted_fails = False
    except AssertionError as e:
        planted, planted_fails = str(e)[:300], True
    if not planted_fails:
        raise AssertionError(f"a chained replay without its token copy passed: {planted}")
    del p32

    report = {"launches": launches, "warmup": warm,
              "counted_steps": counted, "counters": dict(c),
              "pressure": gov, "spill": sched.spill_store.stats(),
              "greedy": dict(_trace_times(sched, trace, rids, wall), idle_window=window),
              "sampled": dict(_trace_times(sampled, strace, srids, swall),
                              counters=dict(sampled.counters)),
              "graph_counts": {"replays": eng.graphs.replays, "captures": eng.graphs.captures,
                               "eager_runs_outside_counted_steps": eager + seager},
              "mixed_step_logits": mixed, "chained_step_logits": chained,
              "planted_chained_without_token_copy": {"fails": True, "error": planted}}
    print(json.dumps({"serve_scheduler_metrics": {
        k: report["greedy"][k] for k in ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                                          "output_tok_s", "steps", "wall_ms_per_step")},
        "idle_share_window": window["idle_share"]}))
    del sched, sampled, eng
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    return report


def run_kv_handoff(cfg, dev):
    """Phase kv_handoff (4z): A's export_kv payloads into B, from bf16 and
    int8 pools, checked as the module docstring says."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import HandoffIntegrityError, KvCacheDtypeError
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.resilience.integrity import corrupt_payload, payload_digest

    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                    dtype=torch.bfloat16)
    n, lo, hi = HANDOFF_PROMPTS
    r = np.random.default_rng(3)
    prompts = [r.integers(0, cfg.vocab_size, int(k)).astype(np.int32)
               for k in r.integers(lo, hi + 1, n)]
    uids = list(range(n))
    report = {"prompt_lens": [len(p) for p in prompts]}
    K.reset_launch_counts()
    for kind in ("bf16", "int8"):
        serve = dict(HANDOFF_SERVE, kv_cache_dtype="int8" if kind == "int8" else "auto")
        a = init_inference(params, cfg, serve)
        params = a.params
        b = init_inference(params, cfg, serve)
        first = a.put(uids, [p.copy() for p in prompts]).argmax(-1).astype(np.int32)
        a.warmup_kv_transfer()
        b.warmup_kv_transfer()
        exp_ms, imp_ms, digest_ms, payloads = [], [], [], []
        for u in uids:
            torch.cuda.synchronize()
            t = time.perf_counter()
            payloads.append(a.export_kv(u))
            exp_ms.append((time.perf_counter() - t) * 1e3)
            p = payloads[-1]
            t = time.perf_counter()  # the envelope's share of export (and of import)
            payload_digest(p)
            digest_ms.append((time.perf_counter() - t) * 1e3)
            pages = sum(p[f].nbytes for f in ("k", "v", "k_scale", "v_scale") if f in p)
            if pages != a.kv_payload_nbytes(p["n_blocks"]):
                raise AssertionError(f"{kind} payload of uid {u}: {pages} page bytes, "
                                     f"kv_payload_nbytes says {a.kv_payload_nbytes(p['n_blocks'])}")
        for u, p in zip(uids, payloads):
            torch.cuda.synchronize()
            t = time.perf_counter()
            b.import_kv(u, p)
            torch.cuda.synchronize()
            imp_ms.append((time.perf_counter() - t) * 1e3)
        outs = []
        for eng in (a, b):
            tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
            ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
            gen, last, _, _ = eng.decode_multi_fn(n, 24)(eng.params, eng.cache, first, tables,
                                                         ctx)
            torch.cuda.synchronize()
            outs.append((gen, last))
        if not (_same_bits(outs[0][0], outs[1][0]) and _same_bits(outs[0][1], outs[1][1])):
            raise AssertionError(f"{kind}: B's continuation from the imported pages differs "
                                 f"from A's: {int((outs[0][0] != outs[1][0]).sum())} tokens off")

        def refused(bad, err, name):
            """bad must raise err before B allocates; the genuine payload
            it was made from then lands on the same uid."""
            free = b.state.free_blocks
            try:
                b.import_kv(100, bad)
            except err:
                pass
            else:
                raise AssertionError(f"{kind}: the {name} payload was imported")
            if b.state.free_blocks != free or b.state.get(100) is not None:
                raise AssertionError(f"{kind}: the {name} payload allocated blocks")
            b.import_kv(100, payloads[0])
            if b.state.get(100).seen_tokens != payloads[0]["seen_tokens"]:
                raise AssertionError(f"{kind}: the genuine payload beside {name} did not land")
            b.flush(100)
            return {"refused_with": err.__name__, "genuine_lands": True}

        checks = {"corrupt": refused(corrupt_payload(payloads[0], 7, 1)[0],
                                     HandoffIntegrityError, "corrupt")}
        if kind == "int8":
            bare = {k: v for k, v in payloads[0].items()
                    if k not in ("k_scale", "v_scale", "digest")}
            bare["digest"] = payload_digest(bare)
            checks["no_scales"] = refused(bare, KvCacheDtypeError, "scaleless")
        report[kind] = {"export_ms": exp_ms, "import_ms": imp_ms, "digest_ms": digest_ms,
                        "export_ms_median": statistics.median(exp_ms),
                        "import_ms_median": statistics.median(imp_ms),
                        "digest_ms_median": statistics.median(digest_ms),
                        "n_blocks": [p["n_blocks"] for p in payloads],
                        "page_mib": [a.kv_payload_nbytes(p["n_blocks"]) / 2**20
                                     for p in payloads],
                        "continuation_bit_identical": True,
                        "distinct_tokens": int(len(torch.unique(outs[0][0]))),
                        "refusals": checks}
        del a, b, payloads, outs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    report["launches"] = {k: c for k, c in K.launch_counts().items() if c}
    del params
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# phases serve_window, serve_window_int8, train_window (Mistral 7B) and
# serve_alibi, serve_alibi_int8 (BLOOM-7B1)
# ---------------------------------------------------------------------------

def _dead_positions(cfg, mode, ctx, dev):
    """The context positions a decode at `ctx` must not read: left of the
    window (mode "window"), or outside its layout row (mode "sparse": the
    positions < ctx - 1 of the layout blocks its query's block does not
    attend)."""
    import torch

    if mode == "window":
        return torch.arange(ctx - WINDOW, device=dev)
    scfg = cfg.sparsity_config()
    nb = -(-ctx // scfg.block)
    row = torch.from_numpy(scfg.layout(nb * scfg.block)[(ctx - 1) // scfg.block]).to(dev)
    p = torch.arange(ctx - 1, device=dev)
    return p[~row[p // scfg.block]]


def _locality(M, eng, cfg, uid, dev, mode):
    """Every pool row of sequence `uid` at a position its next decode must
    not read (_dead_positions), in every layer, overwritten with NaN (on
    int8 pools: its scales): the next decode's logits, through the fused
    kernel and through the write + plain-mode kernel, must stay finite and
    bit-identical to the same step on the untouched pools. The rows are
    restored afterwards."""
    import torch

    bs = eng.config.kv_block_size
    seen = eng.state.get(uid).seen_tokens
    ctx = seen + 1
    table = eng.state.block_table([uid], eng.config.blocks_per_seq, eng.pad_block)
    tables = torch.as_tensor(table, device=dev)
    dead = _dead_positions(cfg, mode, ctx, dev)
    flat = tables[0, dead // bs].long() * bs + dead % bs
    c = eng.cache
    pools = (c.k_scale + c.v_scale) if c.quantized else (c.k + c.v)
    saved = [p.view(-1, *p.shape[2:])[flat].clone() for p in pools]
    step = (torch.tensor([7], dtype=torch.int32, device=dev), tables,
            torch.tensor([ctx], dtype=torch.int32, device=dev))
    out = {"ctx": ctx, "positions_overwritten": int(dead.numel())}
    try:
        for unique in (True, False):
            clean = M.decode_step(eng.params, c, *step, cfg, unique_rows=unique)[0]
            for p in pools:
                p.view(-1, *p.shape[2:])[flat] = float("nan")
            got = M.decode_step(eng.params, c, *step, cfg, unique_rows=unique)[0]
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or not torch.equal(got, clean):
                raise AssertionError(f"{mode} locality (unique_rows={unique}): NaN rows the "
                                     "decode must not read reached its logits")
            for p, x in zip(pools, saved):
                p.view(-1, *p.shape[2:])[flat] = x
            out["fused" if unique else "plain_mode"] = "bit-identical, finite"
    finally:
        for p, x in zip(pools, saved):
            p.view(-1, *p.shape[2:])[flat] = x
    return out


class _F32Layers(tuple):
    """The serving layers of a param tree (a tuple, as the serving layout
    expects), each cast to f32 only when the layer loop reaches it: an f32
    path at full depth without an f32 copy of the whole model (29 GB for
    Mistral 7B) beside the engine."""

    def __iter__(self):
        return ({n: _f32(w) for n, w in lp.items()} for lp in super().__iter__())


def _serve_three_paths(M, eng, cfg, int8, long_prompt, prompts, dev):
    """Prefill (the long prompt and the wave of 96-token prompts) and two
    decode steps (fused, then the write + plain-mode kernel at the next
    position) of the whole model on the engine's weights, by three paths:
    the kernel path in bf16, the plain path in bf16 and the plain path in
    f32 (the reference of both; _F32Layers), each from an empty cache of
    its own (int8 pools on an int8 phase). Returns the _path_errors stats."""
    import numpy as np
    import torch

    p16 = eng.params
    p32 = dict({k: _f32(v) for k, v in p16.items() if k != "layers"},
               layers=_F32Layers(p16["layers"]))
    bs = eng.config.kv_block_size
    NBt = eng.config.blocks_per_seq
    n_w, n_l = len(prompts), len(long_prompt)
    n_long = n_l // bs + 1
    nblk = n_long + n_w + 2
    tl = np.full((1, NBt), nblk - 1, np.int32)
    tl[0, :n_long] = np.arange(n_long)
    tb = np.full((n_w, NBt), nblk - 1, np.int32)
    tb[:, 0] = n_long + np.arange(n_w)
    toks_b = np.zeros((n_w, PROMPT_BUCKET), np.int32)
    for i, p in enumerate(prompts):
        toks_b[i, :PROMPT_LEN] = p
    waves = [(long_prompt[None], np.array([n_l], np.int32), tl),
             (toks_b, np.full((n_w,), PROMPT_LEN, np.int32), tb)]
    tables = torch.as_tensor(np.concatenate([tl, tb]), device=dev)
    ctx = torch.as_tensor([n_l + 1] + [PROMPT_LEN + 1] * n_w, dtype=torch.int32, device=dev)
    outs = {"prefill": [], "decode_fused": [], "decode_plain_mode": []}
    for use_kernel, dtype, prm in ((True, torch.bfloat16, p16), (False, torch.bfloat16, p16),
                                   (False, torch.float32, p32)):
        cache = M.init_cache(cfg, nblk, bs, dtype, dev, kv_quant=int8)
        pre = torch.cat([M.prefill_batch(prm, cache, *(torch.as_tensor(a, device=dev)
                                                       for a in w), cfg,
                                         use_kernel=use_kernel)[0] for w in waves])
        toks = pre.argmax(-1).to(torch.int32) if use_kernel else outs["toks"]
        outs.setdefault("toks", toks)
        d1 = M.decode_step(prm, cache, toks, tables, ctx, cfg, use_kernel=use_kernel,
                           unique_rows=True)[0]
        d2 = M.decode_step(prm, cache, toks, tables, ctx + 1, cfg, use_kernel=use_kernel,
                           unique_rows=False)[0]
        for name, x in (("prefill", pre), ("decode_fused", d1), ("decode_plain_mode", d2)):
            outs[name].append(x.float().cpu())
        del cache
        torch.cuda.empty_cache()
    del p32
    return {name: _path_errors(f"{name} logits", *outs[name])
            for name in ("prefill", "decode_fused", "decode_plain_mode")}


# mode -> (serving config, long prompt's tokens, wave of 96-token prompts,
# prompt seed, the sequence the 2-token continuation extends: "long" or
# the wave's second row)
SERVE_LONG = {"window": (SERVE_W, W_LONG, W_PROMPTS, 3, "long"),
              "alibi": (SERVE_A, A_LONG, A_PROMPTS, 4, "wave"),
              "sparse": (SERVE_S, S_LONG, S_PROMPTS, 5, "long"),
              "falcon": (SERVE_A, A_LONG, A_PROMPTS, 8, "wave"),
              "phi": (SERVE_A, A_LONG, A_PROMPTS, 9, "wave"),
              "neox": (SERVE_NEOX, A_LONG, A_PROMPTS, 10, "wave"),
              "gptj": (SERVE_A, A_LONG, A_PROMPTS, 11, "wave")}
# serving mode -> the kernel mode (ops.cuda.MODES) every attention launch of
# its path must run in
KERNEL_MODE = {"window": "window", "alibi": "alibi", "sparse": "sparse",
               "falcon": "wide_group", "phi": "d80", "neox": "d96", "gptj": "d256"}


def run_serve_long(cfg, dev, params, mode, int8=False):
    """A 7B model served at full width and depth with a long prompt, on
    the weights `params` (the training layout, or the serving layout of an
    earlier engine), from bf16 pools or (int8) int8 pools. mode "window":
    Mistral 7B (phases serve_window, serve_window_int8); mode "alibi":
    BLOOM-7B1 (serve_alibi, serve_alibi_int8); mode "sparse": Llama-2-7B
    with a fixed block-sparse layout (serve_sparse, serve_sparse_int8);
    mode "falcon": Falcon-7B (serve_falcon, serve_falcon_int8); mode "phi":
    Phi-2 (serve_phi, serve_phi_int8); mode "neox": GPT-NeoX-20B
    (serve_neox, serve_neox_int8); mode "gptj": GPT-J-6B (serve_gptj,
    serve_gptj_int8). The counted sequence: one put of the
    long prompt, a wave of 96-token prompts, a single-token decode put of
    the wave's first row, a 2-token continuation (the plain-mode kernel; of
    the long sequence at ctx > 4096 for the window and at ctx ~3970 for
    the layout, else of the wave's second row, so the long row enters
    decode_multi right after its prompt), greedy decode_multi_fn(8, 24)
    and, for the layout, a S_SHORT-token prompt (the masked prefill). The
    mode's kernels must launch and nothing else (the layout's prefill is
    the block gather: no flash), every launch of a wrapper with the mode's
    counter in that mode (KERNEL_MODE: Falcon's attention in the
    wide-group mode, all of Phi-2's in the head_dim-80 mode, GPT-NeoX-20B's
    in the head_dim-96 one, GPT-J-6B's in the head_dim-256 one). Then the
    three-path check (_serve_three_paths), for the window and the layout
    the locality check (_locality), TTFT (of the long prompt for the
    window, else of fresh short and long prompts) and batch-8 decode
    throughput. Returns (report, the engine's serving-layout weights)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import model as M
    from deepspeed_tpu_torch.ops import cuda as K

    serve, n_long, n_wave, seed, chunked = SERVE_LONG[mode]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = init_inference(params, cfg, dict(serve, kv_cache_dtype="int8" if int8 else "auto"))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    V = cfg.vocab_size
    r = np.random.default_rng(seed)
    long_prompt = r.integers(0, V, n_long).astype(np.int32)
    prompts = [r.integers(0, V, PROMPT_LEN).astype(np.int32) for _ in range(n_wave)]
    L = 100  # the long sequence's uid
    uids = list(range(n_wave))
    chunk_uid = L if chunked == "long" else 1

    # -- the main path, counted -------------------------------------------
    K.reset_launch_counts()
    long_logits = eng.put([L], [long_prompt])
    wave = eng.put(uids, prompts)
    last = {L: long_logits[0], **{u: wave[u] for u in uids}}
    decode = eng.put([0], [last[0][None].argmax(-1).astype(np.int32)])
    last[0] = decode[0]
    chunk = eng.put([chunk_uid], [np.array([last[chunk_uid].argmax(), 1], np.int32)])
    last[chunk_uid] = chunk[0]
    rows = [L] + uids
    tables = eng.state.block_table(rows, eng.config.blocks_per_seq, eng.pad_block)
    ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in rows], np.int32)
    toks = np.array([last[u].argmax() for u in rows], np.int32)
    fn = eng.decode_multi_fn(len(rows), DECODE_STEPS)
    gen, final, eng.cache, _ = fn(eng.params, eng.cache, toks, tables, ctx)
    short = None
    if mode == "sparse":
        short = eng.put([L + 1], [r.integers(0, V, S_SHORT).astype(np.int32)])
    torch.cuda.synchronize()
    launches = K.all_launch_counts()
    # -----------------------------------------------------------------------

    kmode = KERNEL_MODE[mode]
    modes = K.MODES[kmode]
    kern = INT8_KERNELS if int8 else SERVE_KERNELS
    if mode == "sparse":  # the prefill is the block gather (or the masked one)
        kern = tuple(n for n in kern if n != "flash_fwd")
    wrong = {n: c for n, c in launches.items() if "[" not in n and (c == 0) == (n in kern)}
    if wrong:
        raise AssertionError(f"the {'int8 ' if int8 else ''}{mode} path must launch each of "
                             f"{sorted(kern)} and nothing else; wrong counts: {wrong}")
    outside = [n for n in kern if n in modes and launches[n] != launches[f"{n}[{kmode}]"]]
    if outside:  # every layer has the window or ALiBi, every decode row a layout row, ...
        raise AssertionError(f"launches of {outside} outside the {kmode} mode: {launches}")
    outputs = [("prefill", long_logits), ("wave", wave), ("decode", decode), ("chunk", chunk),
               ("decode_multi", final.float().cpu().numpy())]
    if short is not None:
        outputs.append(("short_prefill", short))
    for name, x in outputs:
        if not np.isfinite(x).all():
            raise AssertionError(f"{name} logits are not finite")
    g = gen.cpu().numpy()
    if g.shape != (DECODE_STEPS, len(rows)) or g.min() < 0 or g.max() >= V:
        raise AssertionError(f"decode_multi tokens out of range: {g.shape}")

    report = {"init_s": init_s, "launches": {n: c for n, c in launches.items() if c},
              "long_row_decode_ctx": [int(ctx[0]), int(ctx[0]) + DECODE_STEPS - 1]}
    steps_s = {"counted_path": time.perf_counter() - t0 - init_s}
    t1 = time.perf_counter()
    if mode in ("window", "sparse"):
        report["locality"] = _locality(M, eng, cfg, L, dev, mode)
    report["path"] = _serve_three_paths(M, eng, cfg, int8, long_prompt, prompts, dev)
    steps_s["checks"] = time.perf_counter() - t1
    t1 = time.perf_counter()

    # -- timings (after the counted run) ------------------------------------
    if mode == "window":
        report.update(_serving_times(eng, fn, toks, tables, ctx, r, V, W_LONG))
    else:
        n_short, n_long = (S_TTFT, S_LONG) if mode == "sparse" else (A_TTFT, A_LONG)
        report.update(_serving_times(eng, fn, toks, tables, ctx, r, V, n_short))
        ttft = _ttft(eng, r, V, n_long)
        report.update({f"ttft_ms_{n_long}_p50": statistics.median(ttft),
                       f"ttft_ms_{n_long}_all": ttft})
        p = r.integers(0, V, n_long).astype(np.int32)
        report["where_time_goes"][f"prefill_put_{n_long}"] = _where_time_goes(
            lambda: eng.put([2001], [p]))
        eng.flush(2001)
    steps_s["timings"] = time.perf_counter() - t1
    report.update({"kv_bytes_per_token": eng.kv_bytes_per_token(),
                   "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "steps_s": steps_s})
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    return report, params


# phase -> (model, micro-batch, S, (layers, S) of the three-path check, mode):
# Mistral 7B's width with its window, BLOOM-7B1's width and falcon-rw-1b
# whole with ALiBi, Falcon-7B's width in the wide-group mode (71 query
# heads over one KV head), Phi-2 whole in the head_dim-80 mode, and
# GPT-NeoX-20B's and GPT-J-6B's widths in the head_dim-96 and -256 modes
TRAIN_LONG = {"train_window": (TRAIN_W_MODEL, 1, TRAIN_W_S, TRAIN_W_PATH, "window"),
              "train_alibi": (TRAIN_A_MODEL, 4, 2048, (2, 2048), "alibi"),
              "train_alibi_falcon_rw": (TRAIN_F_MODEL, 8, 2048, (2, 2048), "alibi"),
              "train_falcon": (TRAIN_FALCON_MODEL, 4, 2048, (2, 2048), "wide_group"),
              "train_phi": (TRAIN_PHI_MODEL, 2, 2048, (2, 2048), "d80"),
              "train_neox": (TRAIN_NEOX_MODEL, 2, 2048, (2, 2048), "d96"),
              "train_gptj": (TRAIN_GPTJ_MODEL, 4, 2048, (2, 2048), "d256")}


def run_train_long(dev, phase):
    """A 7B-class model's width (or falcon-rw-1b or Phi-2 whole) trained
    with the flagship's settings on the micro-batch of TRAIN_LONG[phase]:
    one step with every launch counter at 0 (each flash kernel once per
    layer, each in the phase's window, ALiBi, wide-group, head_dim-80, -96
    or -256 mode, and nothing else), the loss falling over
    TRAIN_LONG_STEPS steps on the fixed batch, the time of TRAIN_LONG_TIMED
    async steps, peak memory under TRAIN_PEAK_GIB, and the three-path
    check of the per-token loss and the gradients at the phase's (layers,
    S) from the engine's master weights, after the engine is freed."""
    import dataclasses

    import numpy as np
    import torch

    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K

    model, B, S, (n_layers, path_s), mode = TRAIN_LONG[phase]
    mcfg = T.TransformerConfig(**model)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = initialize(dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=B),
                     loss_fn=T.make_loss_fn(mcfg, loss_chunks=LOSS_CHUNKS),
                     param_init_fn=lambda g: T.init(mcfg, g, device=dev),
                     param_logical_specs=T.logical_specs(mcfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": np.random.default_rng(0).integers(
        0, mcfg.vocab_size, (B, S + 1)).astype(np.int32)}

    # -- the main path, counted: one train step --------------------------------
    K.reset_launch_counts()
    first = eng.train_batch(batch)
    launches = K.all_launch_counts()
    # ---------------------------------------------------------------------------

    want = {n: (mcfg.n_layers if n in TRAIN_KERNELS
                or n in [f"{k}[{mode}]" for k in TRAIN_KERNELS] else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"a {phase} step should launch each flash kernel once per layer "
                             f"in its {mode} mode and nothing else: {launches}")
    history = [first] + [eng.train_batch(batch) for _ in range(TRAIN_LONG_STEPS - 1)]
    losses = [m["loss"] for m in history]
    if not all(np.isfinite(losses + [m["grad_norm"] for m in history])):
        raise AssertionError(f"non-finite loss or grad_norm: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over {TRAIN_LONG_STEPS} steps: {losses}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TRAIN_LONG_TIMED):
        eng.train_batch_async(batch)
    stop.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(stop) / TRAIN_LONG_TIMED
    tok_s = B * S / (step_ms / 1e3)
    breakdown = _where_time_goes(lambda: eng.train_batch(batch), top=10)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if peak_gib >= TRAIN_PEAK_GIB:
        raise AssertionError(f"{phase}: peak memory {peak_gib:.1f} GiB, over {TRAIN_PEAK_GIB}")

    # -- kernel path vs plain paths on one sequence, n_layers deep --------------
    master = eng.state.master
    sub = {k: v.detach().clone() for k, v in master.items() if k != "layers"}
    sub["layers"] = {k: v[:n_layers].detach().clone() for k, v in master["layers"].items()}
    del eng, master
    torch.cuda.empty_cache()
    pcfg = dataclasses.replace(mcfg, n_layers=n_layers)
    one = np.random.default_rng(1).integers(0, mcfg.vocab_size, (1, path_s + 1)).astype(np.int32)
    (nk, gk), (npl, gp), (n32, g32) = _grads_three_paths(T, sub, pcfg, one, dev)
    loss_stats = _path_errors("per-token loss", nk, npl, n32)
    unit = g32.square().mean().sqrt()
    grad_stats = _path_errors("gradients", gk / unit, gp / unit, g32 / unit)
    grad_stats["f32_grad_rms"] = unit.item()
    del gk, gp, g32, sub
    torch.cuda.empty_cache()
    report = {
        "init_s": init_s, "params": T.param_count(mcfg), "micro_batch": [B, S],
        "launches": {n: c for n, c in launches.items() if c},
        "losses": losses, "grad_norms": [m["grad_norm"] for m in history],
        "step_ms": step_ms, "tokens_per_s": tok_s,
        # MFU counts attention as the JAX package's flops_per_token does
        # (the causal 6 * L * S * E term; a window is not discounted)
        "mfu": tok_s * mcfg.flops_per_token(S) / H100_BF16_FLOPS,
        "flops_per_token": mcfg.flops_per_token(S),
        "peak_mem_gib": peak_gib, "where_time_goes": breakdown,
        "path_check": {"layers": n_layers, "S": path_s, "loss": loss_stats, "grads": grad_stats}}
    if mode == "window":
        report["attention_pairs_window_over_causal"] = _live_pairs(S, WINDOW) / _live_pairs(S, 0)
    return report


# ---------------------------------------------------------------------------
# phase 5: the evoformer attention path at AlphaFold 2 / OpenFold widths
# ---------------------------------------------------------------------------

def run_evoformer(dev):
    import torch

    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.ops.cuda import evoformer_attention as EV
    from deepspeed_tpu_torch.ops.evoformer_attention import ds4sci_evoformer_attention

    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain path is the reference
    out = {"launches": {n: 0 for n in K.WRAPPERS}, "cases": {}}
    for i, (name, case) in enumerate(EVO_CASES.items()):
        B, S, N, H, D = (case[x] for x in "BSNHD")
        q, k, v, b1, b2, do = _evo_inputs(case, dev, seed=10 + i)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, b1, b2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)

        # -- the main path, counted: one forward and backward -----------------
        K.reset_launch_counts()
        o = ds4sci_evoformer_attention(leaves[0], leaves[1], leaves[2], [leaves[3], leaves[4]])
        o.backward(do)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        # -----------------------------------------------------------------------

        peak = torch.cuda.max_memory_allocated(dev) - before
        want = {n: int(n in EVO_KERNELS) for n in launches}
        if launches != want:
            raise AssertionError(f"{name}: a forward and backward should launch each evoformer "
                                 f"kernel once and nothing else: {launches}")
        for n, c in launches.items():
            out["launches"][n] += c
        logits_bytes = 4 * B * S * H * N * N  # one f32 [G, N, N] tensor
        if peak >= logits_bytes:
            raise AssertionError(f"{name}: fwd+bwd peak {peak} bytes is not under one f32 "
                                 f"[G, N, N] logits tensor ({logits_bytes} bytes)")
        kernel = [o.detach()] + [x.grad for x in leaves]
        del o, leaves

        # -- kernel path vs plain paths: bf16 plain, and f32 plain as the
        #    reference for both; each tensor in units of its f32 RMS, so the
        #    fixed slack of _path_errors is relative to its scale
        paths = []
        for dtype in (torch.bfloat16, torch.float32):
            x = [t.to(dtype) for t in (q, k, v, b1, b2)]
            po, plse = EV.evoformer_fwd_plain(*x)
            paths.append([po] + list(EV.evoformer_bwd_plain(*x, po, plse, do.to(dtype))))
            del x, po, plse
        checks = {}
        for t, gk, gp, g32 in zip(("o", "dq", "dk", "dv", "db1", "db2"), kernel, *paths):
            unit = g32.float().square().mean().sqrt()
            checks[t] = _path_errors(f"{name} {t}", gk.float() / unit, gp.float() / unit,
                                     g32.float() / unit)
            checks[t].pop("argmax_agree_kernel_f32", None)
        del kernel, paths

        # -- timings (after the counted run) -----------------------------------
        leaves = [x.clone().requires_grad_() for x in (q, k, v, b1, b2)]
        fwd = lambda: ds4sci_evoformer_attention(q, k, v, [b1, b2])

        def fwd_bwd():
            o = ds4sci_evoformer_attention(leaves[0], leaves[1], leaves[2], leaves[3:])
            return torch.autograd.grad(o, leaves, do)

        sdpa_fwd, sdpa_bwd = _sdpa_evo(q, k, v, b1, b2, do)
        fwd_ms, fwd_bwd_ms = _time_ms(fwd, 5), _time_ms(fwd_bwd, 5)
        sdpa_ms = {"fwd": _time_ms(sdpa_fwd, 5), "bwd": _time_ms(sdpa_bwd, 5)}
        out["cases"][name] = {
            **case, "launches": {n: c for n, c in launches.items() if c},
            "peak_mem_bytes": peak, "logits_f32_bytes": logits_bytes,
            "peak_over_logits": peak / logits_bytes,
            "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms,
            "sdpa_ms": {**sdpa_ms, "fwd_bwd": sdpa_ms["fwd"] + sdpa_ms["bwd"]},
            "path": checks}
        del leaves, sdpa_fwd, sdpa_bwd, q, k, v, b1, b2, do
        torch.cuda.empty_cache()
    return out


def _init_served(T, cfg, dev):
    """Random bf16 weights of a served model from seed 0 (T.init), with
    every bias (zero at init: q/k/v, output, MLP, LayerNorm and lm_head
    biases) drawn as normal(0, 0.02), so that the path check reaches each
    bias term."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    params = T.init(cfg, g, device=dev, dtype=torch.bfloat16)
    is_bias = lambda n: n == "lm_head_b" or n.endswith("_bias") or n in (
        "bq", "bk", "bv", "bo", "b_in", "b_out")
    for tree in (params, params["layers"]):
        for name, w in tree.items():
            if not isinstance(w, dict) and is_bias(name):
                w.copy_(torch.randn(w.shape, generator=g, device=dev) * 0.02)
    return params


def _gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    _require_environment()
    import torch

    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops import cuda as K
    from deepspeed_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    cfg = T.TransformerConfig(**FLAGSHIP)

    t0 = time.perf_counter()
    libs = build.build_all(build.SOURCES + tuple(FAULT_BUILDS.values()))
    build_s = time.perf_counter() - t0

    def done(phase, report):
        """Print a phase's report with the seconds since the script began
        (and those spent reading profiler events so far)."""
        print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - t0,
                          "profiler_events_s_so_far": PROFILER_POST_S[0], **report}))

    print(json.dumps({"phase": "build", "seconds": build_s,
                      "flash_fwd_build_s": build.BUILD_SECONDS.get("flash_fwd"),
                      "seconds_by_source": build.BUILD_SECONDS,
                      "libraries": {n: p.name for n, p in libs.items()}}))
    for name in libs:
        for line in (build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    kernels = check_kernels(cfg, dev)
    done("kernels", {"ok": True})
    tr = run_train(T.TransformerConfig(**TRAIN_MODEL), dev)
    done("train", tr)
    sl, bf16_serving = run_serving(cfg, dev)
    done("serve", sl)
    q8, _ = run_serving(cfg, dev, int8=True, bf16=bf16_serving)
    done("serve_int8", q8)
    gr = run_serve_graphs(cfg, dev)
    done("serve_graphs", gr)
    q8w = run_serve_int8w(cfg, dev, sl, gr)
    done("serve_int8w", q8w)
    sch = run_serve_scheduler(cfg, dev)
    done("serve_scheduler", sch)
    kvh = run_kv_handoff(cfg, dev)
    done("kv_handoff", kvh)
    served = {}
    for mode, model in SERVED_7B:
        mc = T.TransformerConfig(**model)
        phase = f"serve_{mode}"
        served[phase], params = run_serve_long(mc, dev, _init_served(T, mc, dev), mode)
        done(phase, served[phase])
        served[phase + "_int8"], params = run_serve_long(mc, dev, params, mode, int8=True)
        done(phase + "_int8", served[phase + "_int8"])
        del params
        torch.cuda.empty_cache()
    trains = {}
    for phase in TRAIN_LONG:
        trains[phase] = run_train_long(dev, phase)
        done(phase, trains[phase])
    ev = run_evoformer(dev)
    done("evoformer", ev)

    paths = {"train": tr, "serve": sl, "serve_int8": q8, "serve_graphs": gr, "serve_int8w": q8w,
             "serve_scheduler": sch, "kv_handoff": kvh, **served, **trains, "evoformer": ev}
    line = []
    # each mode (window, ALiBi, layout bitmap, wide group, head_dim 80, 96
    # and 256) is a path of its kernel: same source, same TPU kernel
    sources = {**KERNELS, **{f"{n}[{mode}]": KERNELS[n]
                             for mode, names in K.MODES.items() for n in names}}
    for name, (source, replaces) in sources.items():
        k = kernels[name]
        by_path = {p: r["launches"].get(name, 0) for p, r in paths.items()}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sum(by_path.values()),
                     "launches_by_path": by_path, "shape": k["shape"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound"][0],
                     "bound_by": k["bound"][1], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(_gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
