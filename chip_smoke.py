#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (numbers measured in this run, on this card):

1. device   — the card's name and power limit (nvidia-smi), then the build
              of every CUDA kernel with nvcc for sm_90a from ``csrc/``;
   plan_smem — every registry config at full width in each quant mode its
              path has, bf16 and float32, planned by the compiler for the
              H100 at 4 slots and a 130-row chunk over 1000 positions and
              over 2048: for each distinct set of Hopper kernels a stage
              of those plans launches, one launch at the plan's shapes
              under ``torch.profiler``, each kernel's shared memory
              (static + dynamic) equal to the lint's count and the
              largest to ``smem_estimate`` (required);
2. kernel   — each kernel against its plain PyTorch version at the main
              paths' shapes (llama3-8b and gpt2: the projections, FFNs and
              their int8 twins at a prefill chunk, decode and a verify
              dispatch of 4 slots x 5 rows, gpt2's also at whole-prompt
              lengths; the o-projection, the LM head over the padded
              vocabulary and gpt2's LayerNorm rows; chunk, decode and
              verify attention over full-precision, int8 and fp8 pools;
              the training path's static attention and streamed
              cross-entropy at a training step's tokens: gpt2 8 x 1024,
              llama3-8b 2 x 2048 with GQA, and the int8 twins a w8 step
              runs there (K10a and K10b at llama3-8b's 4096 rows, K10c at
              gpt2's 8192); granite-moe-3b's MoE experts
              (K12), router product, ln2 rows, projections and attention
              at decode, verify, a prefill chunk and a whole prompt, and
              granite-moe-1b's experts, projections, attention and loss
              at a training step's 2 x 2048 tokens; zamba2-2.7b's SSD
              scan (K13) at whole prompts of 1000, 999, 37 and 128 tokens
              and a training step's 2 x 2048, its shared block's GELU GLU
              without a folded norm (K4, K10b), decode attention (K1, K9a)
              and static attention (K7) at head dim 80, projections,
              ln2 rows, LM head and loss; rwkv6-7b's wkv recurrence (K14)
              at the same prompts and step, y and the final state each
              against its own scale, its final LayerNorm rows and LM head
              (K5, Vp 65536) at 1, 4 and 1000 rows, and its loss),
              in bfloat16 and float32: max error against the stated
              tolerance (the losses' parts in nats: 5e-4, since lse is
              about log V), kernel / plain / library times (CUDA events, L2
              flushed between launches) and the card's bound; every row
              of each verify kernel equals its decode kernel at that
              row's length, bit for bit; K12's bound counts the experts
              and (token, expert) pairs its gates keep, the dense-gather
              bound beside it;
   qwen_kernel_cases, qwen_rows — the same checks at the Qwen paths'
              widths (``qwen_kernel_cases``): qwen3-0.6b's and
              qwen1.5-0.5b's projections, o-projection, FFN (and qwen3's
              int8 twins) at a prefill chunk, decode and a verify
              dispatch, their LM head over the padded 151936-token
              vocabulary and their chunk, decode and verify attention at
              head dim 64 (GQA 2 and 1) over full-precision, int8 and fp8
              pools; qwen2-vl-2b's at whole prompts of 1000 and 37 rows
              and decode, K7 at head dim 128 with GQA 6 and K1 / K9a at
              GQA 6; qwen3's and qwen2-vl's training step at 2 x 2048
              (projections, FFN, K7, K11); then K3, K10a, K4 and K10b at
              each Qwen width with rows at 1..63 rows bit-equal to the
              same rows at 64 (``qwen_rows``, required);
   gemma_kernel_cases, gemma_rows — gemma3-4b's widths
              (``gemma_kernel_cases``): its projections (K3 at N 2560 and
              1280, and K10a over int8 weights), o-projection and GELU-GLU
              with the norm folded in (K4, and K10b) at a prefill chunk,
              decode and a verify dispatch, its LM head over the
              262144-token vocabulary, and at head dim 320 (8 over 4
              heads) K2 and K9c (int8, fp8) chunks at offsets 896 and
              2944, K7 at 1000 and 3000 tokens, K1 / K9a at lengths 1023,
              1024, 1025, 0 and 3000 and K8 / K9b with rows across them,
              each under the 1024-token window and without it, and K9c and
              K9a under the window at head dim 128; then K3's, K10a's,
              K4's and K10b's rows at 1..63 rows bit-equal to the same
              rows at 64, K2's chunk rows bit-equal to K7's at the same
              positions and K9c's to one K9c call over the whole prompt,
              with and without the window (``gemma_rows``, required), and
              K7's local / global time at 3000 tokens (``gemma_window``);
              and a training step's 2 x 2048 tokens: K3, K10a, K4 and K10b
              at 4096 rows, K7 at head dim 320 over the folded heads
              windowed and global, K11 over the 262144-token vocabulary;
   hubert_kernel_cases — hubert-xlarge's widths: K5 (q/k/v, [T, 1280] @
              [1280, 1280]), K6 (D 1280, F 5120) and non-causal K7 (16
              over 16 heads of 80 a clip) at the encode's 8 clips x 1000
              frames and a training step's 2 x 2048, and K11 at the step
              (Vp 512 over the 504-entry codebook);
3. row_invariance — every call on the kernel plan's path gives rows 0..3
              the same bits at 4 rows (decode) as at 8, 12 and 20 (verify
              windows of 2, 3 and 5): the projection and FFN kernels and
              their int8 twins, the o-projection, the LM head and the
              norms, and granite-moe-3b's MoE stage at 1, 8, 12, 20 and
              64 rows (required), and zamba2's GELU GLU and its int8 twin
              (required); the eager plan's PyTorch calls at those
              shapes are reported beside them;
   paged_split — the split paged attention (K1, K8, K9a, K9b) at its
              partition, tile and page edges: 9 slots of lengths 0, 1,
              15, 16, 17, P - 1, P, P + 1 and the extent (320 positions,
              P = ``PAGED_PART``; verify windows of 5 rows whose first row
              sees those lengths), decode and verify, head dims 64 and
              128 (and 80 for decode), GQA groups 1 and 4, bfloat16 and
              float32, over full-precision, int8 and fp8 pools: each call
              against its plain version (``TOL``), repeated bit for bit,
              each verify row equal to the decode kernel at its length,
              each slot served alone equal to the same slot in the batch,
              and a shuffled page table equal to the identity one over the
              same pages (all required); kernel time, HBM rate of the live
              K/V and the number of live blocks;
   tensorcore, tensorcore_prefix, tensorcore_offset, tensorcore_rows,
   tensorcore_offset_q, tensorcore_ssd, tensorcore_wkv —
              the tensor-core kernels in bfloat16 beyond the paths' shapes:
              K7 at S = 1, 37, 63, 64, 65, 999, 1000 and 2048 with head dims
              64, 80 and 128 and GQA groups 1, 3 and 4 against its plain
              version and SDPA, and non-causal (MHA) at those S and head
              dims and at four kv_len < S cases, kv_len 0 among them; K2
              at chunk offsets 0, 63, 64, 65 and 896, 1, 37, 64 and 128
              rows, head dims 64 and 128 and GQA groups 1
              and 4 against its plain version and SDPA with the offset
              mask; K7 and K2 at a negative and a zero scale; K5 at 1, 4,
              16, 17, 64, 65, 128, 992 and 8192 rows at each path's (K, N)
              and an unaligned shape, splitting K and not, against its
              plain version and ``torch.matmul``; every FFN instance (K4
              SiLU with the folded norm and GELU, K6, K10b, K10c) at 1 to
              4096 rows at its path's (D, F) and at an unaligned shape
              against its plain version, the worst error of each reported;
              K3 and K10a (q/k/v shapes; K3 also the LM heads) at 1 to 4096
              rows at each path's (D, N) and an unaligned shape against
              their plain versions and ``F.rms_norm`` + ``torch.matmul``;
              K11 at each training path's step, at 1000 tokens, at a padded
              vocabulary of partial 128-column tiles with labels on its
              padded columns (their weights 8x the real ones) and
              unaligned, against its plain version (within 5e-4 nats) and
              ``h @ W``, ``logsumexp`` and ``gather``; K12 at 1 to 4096
              rows at granite-3b's and granite-1b's widths and, at 4, 20,
              128 and 1000 rows, under four adversarial routings (an
              expert no token keeps, every token on the same experts,
              ties that keep 2k, tiny kept gates), each call without a
              host sync, against its plain version row by row and the
              three-``bmm`` chain; K9c over int8 and fp8 codes at K2's
              offsets and rows, head dims 64 (GQA groups 1 and 3) and 128
              (group 4), against its plain version and SDPA on dequantized
              K/V; K13 at S = 1, 37, 64, 65, 289, 999 and 1000 (batch 1,
              the model's chunk) and 2 x 2048, y and the final state each
              on its own scale, against its plain version and the eager
              chunked scan; K14 at S = 1, 15, 16, 17, 37, 64, 65, 128, 999
              and 1000 (batch 1) and 2 x 2048 at rwkv6-7b's widths and at
              head sizes 16, 32 and 128 (8 heads, 200 tokens), y and the
              final state each on its own scale, against its plain
              version;
              every call repeated bit for bit (required); K7's rows 0..999
              equal at S = 1000 and S = 2048 on the same prefix, K2's rows
              equal to K7's rows at the same positions of the whole prompt,
              K9c's chunks' rows equal to one chunk's from offset 0
              (``tensorcore_offset_q``), K13's rows 0..999 equal at S =
              1000 and 2048, at Q = 1 and Q = 8, alone and in a batch of 2
              (``tensorcore_ssd``), K14's likewise at chunk 1 and chunk 8
              (``tensorcore_wkv``), and each FFN instance's, K3's, K10a's
              and K12's rows equal at 1 to 64 rows (required);
   compile, compile_edge — the StreamTensor compiler (``compile_model`` with
              the reference's defaults: TPU_V5E, DSE budget 12) on one block of
              llama3-8b, gpt2, granite-moe-3b, zamba2-2.7b, rwkv6-7b and
              hubert-xlarge at full width, 128 tokens (kernels, fusion groups,
              lowered implementations, FIFO depth, stage seconds), each
              simulated with its LP-sized FIFOs (required: completed); then
              every edge of each compiled graph, with and without a converter,
              materialized through the layout converter K15 from a seeded
              producer tensor in bfloat16 and float32, and llama3-8b's edges at
              1000 tokens in bfloat16 (streams up to 7.34 GB, one at a time),
              beside the identity FIFO and the paper's Fig. 5 pair: each stream
              equal to the plain version (``torch.equal``) and, on sampled
              tokens, to direct slicing; each group launching K15 once per
              stream; kernel, plain and ``aten::index`` gather times against
              the bytes bound;
4. fused_vs_eager, gpt2_fused_vs_eager, granite_fused_vs_eager —
              llama3-8b, gpt2 (jittered) and granite-moe-3b at full width
              cut to 4 layers, float32: a mixed burst through
              ``ServingEngine`` with the kernel plan and with the eager
              plan must give the same greedy tokens (gpt2 and granite:
              with chunked and with whole-prompt admission, the kernel
              plan launching exactly its path's kernels);
5. spec_fused_vs_eager — the three models at 4 layers, float32, on the
              speculative burst (8 prompts sharing a 512-token prefix, two
              repeated verbatim, 32 new tokens each): the plain engine (no
              prefix cache), the default engine (prefix cache on), the
              speculative engine (draft_len 4) with the kernel plan and
              with the eager plan must all give the same greedy tokens,
              the speculative one launching exactly its path's kernels;
6. quant_fused_vs_eager — the three models at 4 layers, float32: under every
              quant mode (kv_int8, kv_fp8, w8, w8_kv8) the kernel plan must
              give the eager plan's tokens (weight modes: on the eager w8
              reference weights), and under kv_int8 the speculative engine
              the plain engine's;
7. accuracy — the three models at 4 layers, float32 (gpt2 jittered): the
              teacher-forced gate of every quant mode against the
              unquantized engine (max logit error, token equality; the
              errors must be finite);
   qwen_fused_vs_eager — qwen3-0.6b, qwen1.5-0.5b and qwen2-vl-2b at
              full width cut to 4 layers, float32, weights jittered (the
              QKV biases and q/k norm scales start at zero): the phases
              4-7 above for each (qwen2-vl whole-prompt only, without the
              speculative engines, which M-RoPE refuses);
8. serve, gpt2_serve, granite_serve, spec_serve, quant_serve,
              quant_spec_serve — gpt2 at full width and depth, llama3-8b
              and granite-moe-3b at full width cut to 8 of their 32
              layers (``SERVE_LAYERS``), bfloat16, random weights
              drawn on the card from a seed (gpt2 jittered): a mixed burst
              of 8 prompts (37..1000 tokens; gpt2 up to 992 in its
              1024-position context; 32 new tokens each) through the
              paged, chunked-prefill engine (gpt2 and granite also
              whole-prompt); the
              speculative burst through the speculative engine against
              the plain engine, token for token (required: the path is
              row-invariant); then both under w8_kv8 (speculative token
              equality reported only: rejected draft rows leave their
              pages' scale growth behind, as in the reference).  Each
              burst must launch exactly its path's kernels (the quantized
              twins, and never K1, K2 or K8, under KV quantization) and
              complete every request; the first prompt served alone must
              repeat its burst tokens; llama3-8b's chunked burst once more
              through a fresh engine under ``torch.profiler``
              (``serve_profile``: device ms by stage, idle share);
   qwen_serve, qwen_quant_serve, qwen_spec_serve — the three Qwen
              configs at full width cut to 4 layers (``QWEN_SERVE_LAYERS``),
              bfloat16, weights jittered:
              the mixed burst (qwen3 and qwen1.5 chunked with the prefix
              cache, qwen2-vl whole-prompt) with its profile, each launch
              count exactly ``qwen_launches`` for the burst's prefill
              dispatches and decode steps, the solo request repeating its
              burst; qwen3's and qwen2-vl's burst again under w8_kv8;
              qwen3's speculative burst equal to the plain engine's;
   hubert_fused_vs_eager — hubert-xlarge at full width cut to 4 layers,
              float32, weights jittered: ``forward_hidden`` over 2 clips of
              1000 frames on the kernel plan equal to the eager plan's
              (1e-4) with exactly the encode's launches, then phase 9's
              training comparison on the pipeline's frame batches;
   gemma_fused_vs_eager — gemma3-4b at full width cut to 6 layers (five
              local, one global), float32, weights jittered: prompts of
              1100, 1030, 300 and 40 tokens (across the window), chunked
              and whole-prompt, kernel plan tokens equal to the eager
              plan's, each launching exactly its path's kernels;
   gemma_quant_fused_vs_eager, gemma accuracy — the same cut and prompts
              under every quant mode, chunked and whole-prompt, kernel plan
              tokens equal to the eager plan's with exactly
              ``gemma_launches`` of the mode; under kv_int8 the
              speculative engine's tokens equal to the plain engine's; the
              accuracy gate of every quant mode;
   zamba_fused_vs_eager, zamba accuracy — zamba2-2.7b at full width
              cut to 6 layers (one period: the shared block runs once),
              float32, whole-prompt admission: kernel plan tokens equal to
              the eager plan's, launches exactly ``zamba_launches``; the
              accuracy gate of every quant mode;
   gemma_serve, gemma_spec_serve — gemma3-4b at full width cut to 12
              of its 34 layers (``GEMMA_SERVE_LAYERS``: two periods),
              bfloat16, weights jittered, max_len 4096: 8 prompts of
              3000, 2100, 1500, 1100, 1025, 1024, 600 and 37 tokens, 32
              new tokens each, chunked with the prefix cache and
              whole-prompt (with its profile), then the speculative burst over
              a shared 1200-token prefix equal to the plain engine; each
              burst launching exactly ``gemma_launches``, the solo request
              repeating its burst;
   gemma_quant_serve, gemma_quant_spec_serve — the same bursts under
              w8_kv8 at 6 layers (``GEMMA_QUANT_SERVE_LAYERS``: one
              period; ``GEMMA_QUANT_PATHS``: K9c, K9a, K9b, K10a, K10b,
              K7 for whole prompts; never K1, K2 or K8), each launching
              exactly ``gemma_launches`` under w8_kv8, the solo request
              repeating its burst; speculative equality reported;
   hubert_encode — hubert-xlarge at full width and depth (48 layers),
              bfloat16, weights jittered: ``forward_hidden`` over 8 clips
              of 1000 frames under ``torch.no_grad``, twice, each launching
              exactly K5 144, K6 48 and K7 48 times, the second bit-equal
              to the first, the hidden states finite; frames/s, then a
              profiled encode (device ms by stage, idle share);
   zamba_serve, zamba_quant_serve — zamba2-2.7b at full width and
              depth, bfloat16, the mixed burst with whole-prompt admission,
              plain and under w8_kv8: every request completes, the solo
              request repeats its burst, the launches are exactly K13 54
              per prefill, K3 (x3), K7 and K4 9 per prefill, K1 or K9a and
              K4 or K10b 9 per decode step, K5 and the RMSNorm rows 9 per
              call, K3 once per call for the LM head; state bytes
              reported beside the KV bytes;
   rwkv_fused_vs_eager, rwkv_serve — rwkv6-7b (no attention, no K/V
              pools, whole-prompt admission, weights jittered): at full
              width cut to 4 layers, float32, kernel plan tokens equal to
              the eager plan's with launches exactly ``rwkv_launches``;
              at full width and depth, bfloat16, the mixed burst: every
              request completes, the solo request repeats its burst, the
              launches are exactly K14 32 per prefill and the LayerNorm
              rows and K5 (LM head) once per prefill and decode step;
   serve_contiguous, serve_contiguous_paged — llama3-8b at 8 layers,
              bfloat16, the weights of ``serve``: its mixed burst through
              the contiguous slot cache (``paged=False``: whole prompts
              through K7, decode through the plain decode attention; K3,
              K4, K5 and K7 launch, never K1 or K2), then through the
              paged whole-prompt engine, each profiled, every request
              done, the solo prompt repeating its burst; TTFT, TPOT,
              tokens/s, reserved and peak KV bytes and idle share side by
              side (``serve_contiguous_vs_paged``);
   serve_surface — K1 over 32- and 64-token pages and K2 on 256-row
              chunks (and K7 at the contiguous path's prompt) against
              their plain versions in bfloat16 and float32
              (``surface_kernel_cases``); a 256-row chunk's K2 rows equal
              to K7's rows of the whole prompt in bfloat16 (required;
              float32 reported) and K1 over 16-, 32- and 64-token pages
              of the same K/V compared bit for bit (reported); then
              llama3-8b at 4 layers, float32: one burst each through the
              default engine, page sizes 32 and 64, 256-token chunks, the
              bhsd layout, the adaptive decode block, whole-prompt, and
              the contiguous cache in both layouts, tokens equal within
              the chunked engines and within the whole-prompt ones,
              launches exact, page size and chunk as asked (required);
   serve_launcher — ``python -m repro_torch.launch.serve`` in-process:
              llama3-8b ``--fused --layers 8`` paged, ``--contiguous`` and
              ``--page-size 32``, and gpt2 ``--fused`` at full size; exit
              code 0, the two ``[serve]`` lines, launches exact;
   serve_pages — the compiler's granules at ``max_len`` 1000: the kernel
              rows over 10-token pages (K1, K9a beside 16-token pages; K8,
              K9b) and 130-row chunks (K2, K9c) at gpt2's and llama3-8b's
              widths against their plain versions, K1's bits over 10-,
              15- and 16-token pages (reported); gpt2 at full width cut to
              6 layers, chunked, plain, speculative and kv_int8, in
              float32 and bf16 at 1000 (10-token pages, 130-token chunks)
              and 1024 (16, 128): launches exact, the plan verified, the
              float32 plain and speculative tokens equal across the two
              (required; kv_int8 and bf16 reported); an engine handed a
              plan with an over-budget SSD tile refused before any launch,
              and built with ``verify="off"`` (required);
   serve_telemetry — llama3-8b at 8 layers, bf16, the chunked burst
              through an engine with telemetry off and one with it on
              (``repro_torch.obs``), same weights, after a warm-up: tokens
              bit-equal, each engine's launches exactly the chunked
              path's, the off recorder empty, the request-lifecycle and
              dispatch event counts equal to the requests and the
              engine's counters, the Chrome trace valid with the engine
              and slot lanes, the histograms' percentiles ordered
              (required); the event count and trace bytes, TTFT and TPOT
              p50/p90/p99 from the registry's histograms beside the exact
              medians from the request stamps, the dispatch walls' p50
              and p99, and the on/off wall and TPOT ratio (reported);
   obs_demo — ``python -m repro_torch.obs --demo`` in-process (gpt2 at
              full width, 2 layers, chunked + speculative, telemetry on
              and off): exit code 0, its three files written, launches
              exactly the speculative gpt2 path's;
   tune_roundtrip — ``python -m repro_torch.tuning``'s round trip on
              gpt2 at full width and depth (jittered), bf16 and float32, 4
              slots over 1024 positions: the first engine start tunes
              (the card's lint prunes, CUDA events time the five driver
              families) and writes a table stamped with the card's
              fingerprint, the second makes zero measurements, resolves an
              equal plan and decodes equal tokens; the driver families'
              entries ``measured``, the paged ones ``analytic``; float32
              tokens equal to the untuned engine's; two candidates of each
              driver stage that the card signature collapses give
              bit-equal outputs (all required);
   tune_serve — llama3-8b at 8 layers, bf16: the tuning pass over the
              engine's plan (host seconds, the card memory it adds, each
              measured latency beside the same call timed as ``kernel``
              times and that phase's row), then the chunked burst untuned
              and tuned: every driver stage timed once, the plan
              ``hybrid``, the tuned burst's launches exact for its page
              size and chunk, its tokens equal to the untuned burst's or
              each differing request traced to the granules (required);
              TTFT and TPOT of both (reported);
9. train_fused_vs_eager — the four models at full width cut to 4 layers
              (gemma3-4b 6, weights jittered), float32, B = 2, S = 256:
              the kernel plan's ``forward_train``
              loss against the eager plan's (relative 1e-5) and every
              gradient leaf (1e-4), 3 ``make_train_step`` steps on each plan
              (losses within 1e-4), and the kernel plan's launches per step
              equal to the plan's (the forward, the re-run of each layer
              under remat, the loss once);
   train_w8_ste — llama3-8b at 4 layers and gemma3-4b at 6, float32,
              under w8: the kernel plan's step (the int8 twins K10a and
              K10b forward, the straight-through gradient back) against
              the eager plan's on the dequantized weights, loss at 1e-5 and
              every gradient leaf at 1e-4 relative, launches the plan's;
10. train   — ``Trainer.run()`` on the kernel plan, bfloat16 compute over
              float32 master weights and AdamW state: gpt2 at full width
              and depth (B = 8, S = 1024) for 6 steps with a checkpoint
              every 3, then a second trainer resuming from step 3 and
              replaying steps 4-6 (losses equal at relative 1e-3, bit
              equality reported); llama3-8b at full width cut to 2 layers
              (B = 2, S = 2048; the full depth does not fit one card) for
              3 steps and a timed restore; granite-moe-1b and zamba2-2.7b
              at full width and depth and rwkv6-7b at full width cut to 2
              layers (B = 2, S = 2048, lr 3e-5) for 3 steps, no
              checkpoint; qwen3-0.6b and qwen2-vl-2b (on the pipeline's
              patch embeddings and M-RoPE positions) at full width and
              depth likewise; hubert-xlarge at full width cut to 12
              layers (``HUBERT_TRAIN_LAYERS``) on the pipeline's frame
              embeddings, weights jittered (lr
              1e-4), with a checkpoint at step 2 and a trainer resuming
              there to replay step 3; gemma3-4b at full width cut to 6
              layers (``GEMMA_TRAIN_LAYERS``: five local, one global; B =
              2, S = 2048, lr 3e-5, no checkpoint); and under w8
              (``quant_train``: each w8 weight quantized at every call
              from the float32 masters) gemma3-4b at 6 layers, llama3-8b
              at 2 (lr 3e-5) and gpt2 at full depth (lr 1e-3), 3 steps
              each, no checkpoint.  Losses finite and falling,
              launches the plan's; step time, tokens/s, peak memory and
              checkpoint seconds reported;
   plan_verify — every plan the run built (``record_plan_builds``: one
              DSE per new config and shape, its host milliseconds
              reported) and the plans of ``plan_smem``, verified for the
              card (``verify_plan(device="cuda")``, clean: required);
11. kernels — one line listing every kernel, once per model and path
              (serving, encode, training or compile) that runs it, with
              its check results and that path's own launch count (a
              compile group: its streams' times and bounds summed).

Every phase line carries ``t_s``, the seconds since the script started.
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside this script, it exits non-zero and prints
no result.  Full results and the nvcc resource report also go to
``--out`` (default ``build/chip_smoke/``): ``chip_smoke.json``,
``ptxas.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # float32 outside the tensor cores
# Max |kernel - plain| over max |plain|.  float32: the two sum in different
# orders (up to 14336-long dot products); bfloat16: on top of that an
# intermediate rounded to bf16 (normalised x, h, p) may land one bf16 ulp
# apart, and outputs are bf16.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TPU_KERNELS = {
    "rmsnorm_matmul": "src/repro/kernels/rmsnorm_matmul.py:28",
    "streamed_ffn": "src/repro/kernels/streamed_ffn.py:57",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "paged_attention": "src/repro/kernels/paged_attention.py:61",
    "block_matmul": "src/repro/kernels/block_matmul.py:29",
    "streamed_mlp": "src/repro/kernels/streamed_ffn.py:181",
    "flash_attention_static": "src/repro/kernels/flash_attention.py:33",
    "paged_verify_attention": "src/repro/kernels/paged_attention.py:169",
    "paged_attention_q": "src/repro/kernels/paged_attention.py:113",
    "paged_verify_attention_q": "src/repro/kernels/paged_attention.py:232",
    "flash_attention_q": "src/repro/kernels/flash_attention.py:151",
    "rmsnorm_matmul_w8": "src/repro/kernels/rmsnorm_matmul.py:38",
    "streamed_ffn_w8": "src/repro/kernels/streamed_ffn.py:81",
    "streamed_mlp_w8": "src/repro/kernels/streamed_ffn.py:205",
    # Not a TPU kernel: the eager LayerNorm the reference leaves to XLA,
    # made a kernel so that its rows do not depend on the row count.
    "row_norm": "src/repro/models/layers.py:195",
    "streamed_xent": "src/repro/kernels/streamed_xent.py:35",
    "moe_experts": "src/repro/kernels/moe_experts.py:35",
    # The row-norm helper's RMSNorm mode: the eager RMSNorm the reference
    # leaves to XLA in front of the MoE router and experts.
    "rms_norm_rows": "src/repro/models/layers.py:187",
    "mamba2_scan": "src/repro/kernels/mamba2_scan.py:34",
    "rwkv6_wkv": "src/repro/kernels/rwkv6_wkv.py:33",
    # Both Pallas bodies (`_copy_kernel` :30, the window `kernel` :79)
    # behind the one function.
    "convert_layout": "src/repro/kernels/stream_converter.py:34",
}
HELPERS = {"row_norm", "rms_norm_rows"}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "rmsnorm_matmul": _CSRC + "rmsnorm_matmul.cu",
    "streamed_ffn": _CSRC + "streamed_ffn.cu",
    "flash_attention": _CSRC + "flash_mma.cu",
    "paged_attention": _CSRC + "paged_attention.cuh",
    "block_matmul": _CSRC + "block_matmul.cu",
    "streamed_mlp": _CSRC + "streamed_ffn.cu",
    "flash_attention_static": _CSRC + "flash_mma.cu",
    "paged_verify_attention": _CSRC + "paged_attention.cuh",
    "paged_attention_q": _CSRC + "paged_attention.cuh",
    "paged_verify_attention_q": _CSRC + "paged_attention.cuh",
    "flash_attention_q": _CSRC + "flash_mma.cu",
    "rmsnorm_matmul_w8": _CSRC + "rmsnorm_matmul.cu",
    "streamed_ffn_w8": _CSRC + "streamed_ffn_w8.cu",
    "streamed_mlp_w8": _CSRC + "streamed_ffn_w8.cu",
    "row_norm": _CSRC + "row_norm.cu",
    "streamed_xent": _CSRC + "streamed_xent.cu",
    "moe_experts": _CSRC + "moe_experts.cu",
    "rms_norm_rows": _CSRC + "row_norm.cu",
    "mamba2_scan": _CSRC + "mamba2_scan.cu",
    "rwkv6_wkv": _CSRC + "rwkv6_wkv.cu",
    "convert_layout": _CSRC + "stream_converter.cu",
}
# The kernels each serving path must launch; every other count must be 0.
# On the kernel plan the o-projection runs through block_matmul, llama3's
# final norm and LM head through one rmsnorm_matmul, gpt2's LM head through
# block_matmul and its LayerNorms through row_norm (row invariance).
LLAMA_PATH = {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
              "paged_attention", "block_matmul"}
GPT2_PATHS = {
    "chunked": {"block_matmul", "streamed_mlp", "flash_attention",
                "paged_attention", "row_norm"},
    "whole_prompt": {"block_matmul", "streamed_mlp",
                     "flash_attention_static", "paged_attention",
                     "row_norm"},
}
# granite-moe: llama3's attention kernels (at head dim 64), its final norm
# and LM head through rmsnorm_matmul; ln2 through the row-norm kernel's
# RMSNorm mode, the router product through block_matmul (besides the
# o-projection), the experts through moe_experts.
GRANITE = "granite-moe-3b-a800m"
GRANITE_TRAIN = "granite-moe-1b-a400m"
_GRANITE = {"rmsnorm_matmul", "block_matmul", "rms_norm_rows", "moe_experts"}
GRANITE_PATHS = {
    "chunked": _GRANITE | {"flash_attention", "paged_attention"},
    "whole_prompt": _GRANITE | {"flash_attention_static", "paged_attention"},
}
SERVE_PATHS = {"llama3-8b": {"chunked": LLAMA_PATH}, "gpt2": GPT2_PATHS,
               GRANITE: GRANITE_PATHS}
# The speculative engine verifies every decode: K8, never K1.
SPEC_PATHS = {
    "llama3-8b": {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
                  "paged_verify_attention", "block_matmul"},
    "gpt2": {"block_matmul", "streamed_mlp", "flash_attention",
             "paged_verify_attention", "row_norm"},
    GRANITE: _GRANITE | {"flash_attention", "paged_verify_attention"},
}
# Under w8_kv8 the attention kernels read code pools (K9, never K1, K2 or
# K8) and the w8 stages run their int8 twins (K10); the o-projection and
# the LM head stay at full precision, as does gpt2's qkv block_matmul.
# Whole-prompt admission attends over the fresh full-precision K/V (K7)
# before placing it into the pools as codes.
QUANT_MODE = "w8_kv8"
QUANT_PATHS = {
    ("llama3-8b", "chunked"): {"rmsnorm_matmul_w8", "streamed_ffn_w8",
                               "flash_attention_q", "paged_attention_q",
                               "block_matmul", "rmsnorm_matmul"},
    ("gpt2", "chunked"): {"block_matmul", "streamed_mlp_w8",
                          "flash_attention_q", "paged_attention_q",
                          "row_norm"},
    ("gpt2", "whole_prompt"): {"block_matmul", "streamed_mlp_w8",
                               "flash_attention_static",
                               "paged_attention_q", "row_norm"},
    ("llama3-8b", "speculative"): {"rmsnorm_matmul_w8", "streamed_ffn_w8",
                                   "flash_attention_q",
                                   "paged_verify_attention_q",
                                   "block_matmul", "rmsnorm_matmul"},
    ("gpt2", "speculative"): {"block_matmul", "streamed_mlp_w8",
                              "flash_attention_q",
                              "paged_verify_attention_q", "row_norm"},
    # granite: qkv through the int8 twin, the experts at full precision
    # (K12 has no int8 twin), the LM head rmsnorm_matmul as llama3's.
    (GRANITE, "chunked"): _GRANITE | {"rmsnorm_matmul_w8",
                                      "flash_attention_q",
                                      "paged_attention_q"},
    (GRANITE, "whole_prompt"): _GRANITE | {"rmsnorm_matmul_w8",
                                           "flash_attention_static",
                                           "paged_attention_q"},
    (GRANITE, "speculative"): _GRANITE | {"rmsnorm_matmul_w8",
                                          "flash_attention_q",
                                          "paged_verify_attention_q"},
}
# zamba2 (whole-prompt admission only): K13 in every layer, the shared
# block's kernels in each of its applications: qkv through rmsnorm_matmul,
# the static flash kernel at head dim 80, ln2 through the row-norm
# kernel's RMSNorm mode, the GELU GLU through streamed_ffn without a
# folded norm, the o-projection through block_matmul, decode through K1;
# the final norm and LM head through rmsnorm_matmul.  Under w8_kv8 the
# qkv and FFN run their int8 twins and decode reads int8 pages (K9a).
ZAMBA = "zamba2-2.7b"
ZAMBA_LAYERS = 54


def zamba_launches(prefills: int, steps: int, quant: str = "none",
                   layers: int = ZAMBA_LAYERS, every: int = 6) -> dict:
    """Every kernel's exact launches in a zamba2 burst of ``prefills``
    whole-prompt prefills and ``steps`` decode steps: K13 once per layer
    per prefill; per shared-block application q, k and v (rmsnorm_matmul),
    ln2, the FFN and the o-projection in every prefill and decode step,
    attention through the static flash kernel in prefill and the paged
    kernel in decode; the final norm and LM head once per call.  The
    shared block runs after every ``every``-th layer."""
    shared = layers // every
    calls = prefills + steps
    w8 = quant in ("w8", "w8_kv8")
    out = {"mamba2_scan": layers * prefills,
           "flash_attention_static": shared * prefills,
           ("paged_attention_q" if quant in ("kv_int8", "kv_fp8", "w8_kv8")
            else "paged_attention"): shared * steps,
           "streamed_ffn_w8" if w8 else "streamed_ffn": shared * calls,
           "block_matmul": shared * calls, "rms_norm_rows": shared * calls,
           "rmsnorm_matmul": calls + (0 if w8 else 3 * shared * calls)}
    if w8:
        out["rmsnorm_matmul_w8"] = 3 * shared * calls
    return {k: n for k, n in out.items() if n}


# rwkv6 (whole-prompt admission only, no attention, no K/V pools): K14 in
# every layer of a prefill (decode runs the eager one-token recurrence, as
# the reference); the final LayerNorm through the row-norm kernel and the
# LM head through block_matmul once per prefill and per decode step.
RWKV = "rwkv6-7b"
RWKV_LAYERS = 32


def rwkv_launches(prefills: int, steps: int,
                  layers: int = RWKV_LAYERS) -> dict:
    """Every kernel's exact launches in an rwkv6 burst of ``prefills``
    whole-prompt prefills and ``steps`` decode steps."""
    calls = prefills + steps
    out = {"rwkv6_wkv": layers * prefills, "row_norm": calls,
           "block_matmul": calls}
    return {k: n for k, n in out.items() if n}


# The Qwen decoders run llama3-8b's plan stage for stage: q/k/v with ln1
# folded in and the final norm + LM head through rmsnorm_matmul, the FFN
# with ln2 folded in through streamed_ffn, the o-projection through
# block_matmul, chunk / whole-prompt / decode / verify attention through
# K2 / K7 / K1 / K8; the QKV bias, qk-norm and M-RoPE are PyTorch ops
# beside them, as they are XLA ops in the reference.  qwen3 and qwen1.5
# prefill in chunks; qwen2-vl (M-RoPE) only whole prompts, and never
# verifies speculatively.  Under w8_kv8 as llama3's (K9, K10a, K10b).
QWEN3, QWEN15, QWEN2VL = "qwen3-0.6b", "qwen1.5-0.5b", "qwen2-vl-2b"
QWEN = (QWEN3, QWEN15, QWEN2VL)
QWEN_PATHS = {"chunked": LLAMA_PATH,
              "whole_prompt": (LLAMA_PATH - {"flash_attention"})
              | {"flash_attention_static"}}
QWEN_QUANT_PATHS = {
    "chunked": QUANT_PATHS[("llama3-8b", "chunked")],
    "whole_prompt": (QUANT_PATHS[("llama3-8b", "chunked")]
                     - {"flash_attention_q"}) | {"flash_attention_static"}}


def qwen_launches(layers: int, prefills: int, steps: int, *, whole: bool,
                  quant: str = "none") -> dict:
    """Every kernel's exact launches in a Qwen burst of ``prefills``
    prefill dispatches (prompt chunks, or whole prompts with ``whole``)
    and ``steps`` decode steps: per layer and call q, k and v through
    rmsnorm_matmul, the o-projection and the FFN; attention once per
    layer in a prefill (K2, or K7 whole) and in a decode step (K1); the
    final norm and LM head through rmsnorm_matmul once per call.  Under a
    weight mode the q/k/v and FFN launches are their int8 twins', under a
    KV mode the chunk and decode attention read codes (K9c, K9a)."""
    calls = prefills + steps
    w8 = quant in ("w8", "w8_kv8")
    kv8 = quant in ("kv_int8", "kv_fp8", "w8_kv8")
    attn = ("flash_attention_static" if whole
            else "flash_attention_q" if kv8 else "flash_attention")
    out = {attn: layers * prefills,
           "paged_attention_q" if kv8 else "paged_attention": layers * steps,
           "streamed_ffn_w8" if w8 else "streamed_ffn": layers * calls,
           "block_matmul": layers * calls,
           "rmsnorm_matmul": calls + (0 if w8 else 3 * layers * calls)}
    if w8:
        out["rmsnorm_matmul_w8"] = 3 * layers * calls
    return {k: n for k, n in out.items() if n}


# gemma3-4b runs llama3-8b's plan stage for stage in both of its layer
# kinds, the FFN a GELU-GLU with ln2 folded in (K4); the five local layers
# of every six pass their 1024-token sliding window to K2 / K7 / K1 / K8,
# the global one none; qk-norm is a PyTorch op.  The speculative engine
# verifies every decode (K8, never K1).
GEMMA = "gemma3-4b"
GEMMA_WINDOW = 1024
GEMMA_PATHS = {"chunked": LLAMA_PATH,
               "whole_prompt": QWEN_PATHS["whole_prompt"],
               "speculative": SPEC_PATHS["llama3-8b"]}
# The served burst: prompts on both sides of the window and one at 3000
# tokens, where a local layer reads 1024 positions a step and a global one
# 3000; a 4096-position context.
GEMMA_BURST = (3000, 2100, 1500, 1100, 1025, 1024, 600, 37)
GEMMA_MAX_LEN = 4096
GEMMA_SHARED = 1200       # the speculative burst's shared prefix
# Under w8_kv8 as llama3's: the code twins K9c / K9a / K9b over the pools
# (never K2, K1 or K8), K10a for q/k/v and K10b (GELU with ln2 folded in)
# for the FFN; whole prompts attend over their fresh full-precision K/V
# (K7) before it is placed into the pools as codes.
GEMMA_QUANT_PATHS = {
    "chunked": QWEN_QUANT_PATHS["chunked"],
    "whole_prompt": QWEN_QUANT_PATHS["whole_prompt"],
    "speculative": QUANT_PATHS[("llama3-8b", "speculative")]}


def gemma_launches(layers: int, prefills: int, steps: int, *, whole=False,
                   verifies: int = 0, quant: str = "none") -> dict:
    """Every kernel's exact launches in a gemma3 burst of ``prefills``
    prefill dispatches (prompt chunks, or whole prompts with ``whole``),
    ``steps`` decode steps and ``verifies`` verify dispatches: the Qwen
    count (``qwen_launches``, under ``quant`` as there) for the prefills
    and decode steps, and per verify dispatch a decode step's kernels with
    K8 (K9b over codes) in K1's place."""
    out = qwen_launches(layers, prefills, steps, whole=whole, quant=quant)
    if verifies:
        w8 = quant in ("w8", "w8_kv8")
        kv8 = quant in ("kv_int8", "kv_fp8", "w8_kv8")
        out["paged_verify_attention_q" if kv8
            else "paged_verify_attention"] = layers * verifies
        for k in ("streamed_ffn_w8" if w8 else "streamed_ffn",
                  "block_matmul"):
            out[k] = out.get(k, 0) + layers * verifies
        out["rmsnorm_matmul"] = (out.get("rmsnorm_matmul", 0)
                                 + verifies * (1 + (0 if w8 else 3 * layers)))
        if w8:
            out["rmsnorm_matmul_w8"] = (out.get("rmsnorm_matmul_w8", 0)
                                        + 3 * layers * verifies)
    return out


# hubert-xlarge, the encoder (no decode, no serving engine): gpt2's plan
# stage for stage, its attention non-causal through the static flash
# kernel (K7) at head dim 80, 16 over 16 heads.  The encode is
# ``forward_hidden`` over 8 clips of 1000 frames (20 s of audio each at
# the 50 frames a second of the stubbed feature extractor) in inference:
# q, k and v through block_matmul, the MLP through streamed_mlp and the
# attention through K7 once per layer, the LayerNorms and the
# o-projection PyTorch ops (the training path's routing, as the
# reference's ``forward_hidden``).
HUBERT = "hubert-xlarge"
HUBERT_CLIPS, HUBERT_FRAMES = 8, 1000
HUBERT_PATH = {"block_matmul": 3, "streamed_mlp": 1,
               "flash_attention_static": 1}
HUBERT_LR = 1e-4          # the training phase's AdamW rate
# hubert-xlarge trains at 12 of its 48 layers: at full depth its
# checkpoint snapshot, write and restore took 45 of the phase's 57 s in a
# 1058 s run of this script on an H100 (the encode keeps full depth).
HUBERT_TRAIN_LAYERS = 12


def hubert_launches(layers: int) -> dict:
    """Every kernel's exact launches in one encode of ``layers`` layers."""
    return {k: n * layers for k, n in HUBERT_PATH.items()}


# llama3-8b and granite-moe-3b serve at full width cut to 8 of their 32
# layers: at full depth their eight bursts took 250 s, and the script has
# to stay well inside its time limit with every model's phases (929 s
# with them at 16 layers once the Qwen phases joined).  rwkv6-7b trains
# at 2 of its 32 layers for the same reason (its eager wkv backward makes
# about 10^5 small launches a step).
SERVE_LAYERS = {"llama3-8b": 8, GRANITE: 8}
RWKV_TRAIN_LAYERS = 2
# The Qwen bursts at 4 of their 24-28 layers: at full depth they took 180
# s of a 794 s run, and beside gemma3-4b's full-depth bursts, with the
# Qwen bursts at 8 layers, the script took 1081 s.
QWEN_SERVE_LAYERS = 4
# gemma3-4b serves at 12 of its 34 layers (two periods of five local
# layers and a global one): with hubert-xlarge's phases the script took
# 959 s with gemma3's bursts at full depth (104 s of them).  Its quantized
# bursts (w8_kv8) serve 6 (one period): at 12 they took 41 s of the 64 s
# its quantized phases added to an 806 s script on an H100, over their
# 60 s budget.
GEMMA_SERVE_LAYERS = 12
GEMMA_QUANT_SERVE_LAYERS = 6


# The training path on the kernel plan: each layer's forward launches, the
# static flash kernel for attention; under remat the backward runs every
# layer's forward again (the eager backward itself launches nothing); the
# loss kernel once per step.  The o-projection, the norms outside the
# kernels and every backward are PyTorch ops.
TRAIN_LAYER_LAUNCHES = {
    "llama3-8b": {"rmsnorm_matmul": 3, "streamed_ffn": 1,
                  "flash_attention_static": 1},
    "gpt2": {"block_matmul": 3, "streamed_mlp": 1,
             "flash_attention_static": 1},
    GRANITE_TRAIN: {"rmsnorm_matmul": 3, "moe_experts": 1,
                    "flash_attention_static": 1},
}
TRAIN_LAYER_LAUNCHES[GRANITE] = TRAIN_LAYER_LAUNCHES[GRANITE_TRAIN]
TRAIN_LAYER_LAUNCHES[QWEN3] = TRAIN_LAYER_LAUNCHES["llama3-8b"]
TRAIN_LAYER_LAUNCHES[QWEN2VL] = TRAIN_LAYER_LAUNCHES["llama3-8b"]
TRAIN_LAYER_LAUNCHES[HUBERT] = TRAIN_LAYER_LAUNCHES["gpt2"]
# zamba2: per shared-block application (K13 per layer apart).
TRAIN_LAYER_LAUNCHES[ZAMBA] = {"rmsnorm_matmul": 3,
                                       "streamed_ffn": 1,
                                       "flash_attention_static": 1}
# gemma3: llama3's stages in both layer kinds (the window rides on K7's
# call in the local layers), K4 its GELU-GLU with ln2 folded in.
TRAIN_LAYER_LAUNCHES[GEMMA] = TRAIN_LAYER_LAUNCHES["llama3-8b"]
# Under a weight mode (w8, w8_kv8) each w8 stage launches its int8 twin
# (K10a, K10b, K10c) in the unquantized kernel's place; K5 (gpt2's q/k/v),
# K7, K11 and K12 have no twin.  A KV mode changes nothing in training.
W8_TWINS = {"rmsnorm_matmul": "rmsnorm_matmul_w8",
            "streamed_ffn": "streamed_ffn_w8",
            "streamed_mlp": "streamed_mlp_w8"}
# Training shapes: gpt2 at GPT-2's 1024-token context (8 sequences),
# llama3-8b, granite-moe-1b-a400m, zamba2-2.7b, rwkv6-7b, qwen3-0.6b,
# qwen2-vl-2b, gemma3-4b (past its 1024-token window) and hubert-xlarge
# (frames) at 2 x 2048.
TRAIN_SHAPES = {"gpt2": (8, 1024), "llama3-8b": (2, 2048),
                GRANITE_TRAIN: (2, 2048), ZAMBA: (2, 2048),
                RWKV: (2, 2048), QWEN3: (2, 2048), QWEN2VL: (2, 2048),
                GEMMA: (2, 2048), HUBERT: (2, 2048)}
# gemma3-4b trains at 6 of its 34 layers (one period: five local layers
# and a global one): float32 masters, gradients and two AdamW moments take
# 16 bytes a parameter, 75 GB at full depth (embed and lm_head 671 M
# parameters each, a layer 98.3 M), about 31 GB at 6 layers.
GEMMA_TRAIN_LAYERS = 6
CODES = ("int8", "fp8")
# A verify dispatch: 4 slots x a 5-row window (draft_len 4); the window
# ladder's other rungs give 2 and 3 rows.
SLOTS, WINDOW = 4, 5
SPEC_T = SLOTS * WINDOW


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started, so consecutive lines time the phases."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def train_step_launches(model: str, layers: int, remat: bool = True,
                        quant: str = "none"):
    """Each kernel's launches in one training step on the kernel plan
    (zamba2: K13 in every layer, the shared block's kernels in each of its
    ``layers // 6`` applications; rwkv6: K14 in every layer, nothing
    else but the loss); under a weight mode the int8 twins
    (``W8_TWINS``) in their kernels' place."""
    runs = 2 if remat else 1
    if model == RWKV:
        out = {"rwkv6_wkv": runs * layers}
    elif model == ZAMBA:
        out = {"mamba2_scan": runs * layers}
        out.update({k: runs * n * (layers // 6)
                    for k, n in TRAIN_LAYER_LAUNCHES[model].items()})
    else:
        out = {k: runs * n * layers
               for k, n in TRAIN_LAYER_LAUNCHES[model].items()}
    if quant in ("w8", "w8_kv8"):
        out = {W8_TWINS.get(k, k): n for k, n in out.items()}
    out["streamed_xent"] = 1
    return out


# --------------------------------------------------------------------- #
# Timing and bounds
# --------------------------------------------------------------------- #

class Timer:
    """Median of per-launch CUDA-event times, with a buffer larger than the
    50 MB L2 rewritten before each launch (the model finds weights cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #

def _randn(torch, gen, dtype, dev):
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)
    return randn


def _code_dtype(torch, code):
    """None (full precision), or the torch dtype of "int8" / "fp8" codes."""
    return {None: None, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[code]


def _encode(torch, x, code, page_axis):
    """(codes, scales) of ``x`` [P, ps, H, D] (page_axis 0) or [H, S, D]
    cut into 16-position pages: one float32 scale per (page, head), each
    page's amax over qmax, as the pools hold them."""
    from repro_torch.serving.kv_cache import kv_quant_qmax, quantize_kv
    dt = _code_dtype(torch, code)
    if page_axis == 0:
        s = x.float().abs().amax(dim=(1, 3)) / kv_quant_qmax(dt)   # [P, H]
        return quantize_kv(x, s[:, None, :, None], dt), s
    h, n, d = x.shape
    pages = x.reshape(h, n // 16, 16, d)
    s = pages.float().abs().amax(dim=(2, 3)) / kv_quant_qmax(dt)  # [H, n/16]
    pos = s.repeat_interleave(16, dim=1).contiguous()              # [H, S]
    return quantize_kv(x, pos[..., None], dt), pos


def _flash_case(torch, K, ref, randn, isz, name, hq, hkv, hd, sq, skv,
                q_off, dev, code=None, scale=None, window=0, causal=True,
                kv_len=None):
    """A causal flash call and its SDPA yardstick: the offset branch over a
    gathered extent (``q_off`` set, kv_len = q_off + sq), or the static
    branch over a whole prompt (``q_off`` None, sq == skv, kv_len
    ``kv_len`` or skv); with ``code``
    the offset branch over int8 / fp8 codes with per-position scales (its
    library yardstick: SDPA with the offset mask on K/V dequantized
    outside the timing, as K10a's is ``torch.matmul`` on dequantized W).
    ``scale``: the softmax scale (None: 1 / sqrt(D)); ``window`` > 0: a
    sliding window (SDPA with the window in its mask; the bytes count the
    keys some query sees); ``causal`` False: the static branch's
    non-causal attention (hubert's encoder; SDPA without the causal mask,
    with the kv_len mask where kv_len < skv)."""
    if q_off is not None:
        kv_len = q_off + sq
    elif kv_len is None:
        kv_len = skv
    q = randn(hq, sq, hd)
    k = randn(hkv, skv, hd)
    v = randn(hkv, skv, hd)
    qpos = (q_off or 0) + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = ((kpos <= qpos) if causal else torch.ones_like(kpos <= qpos)) \
        & (kpos < kv_len)
    kv_first = 0
    if window:
        mask &= kpos > qpos - window
        kv_first = max((q_off or 0) - window + 1, 0)
    live_pairs = int(mask.sum()) * hq
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = hq // hkv
    kv_bytes = 2 * hkv * (kv_len - kv_first) * hd * isz
    if code is not None:
        (k, ks), (v, vs) = (_encode(torch, t.float(), code, 1) for t in (k, v))
        kernel = lambda: K.flash_attention_2d_q(
            q, k, v, k_scale=ks, v_scale=vs, q_offset=q_off, kv_len=kv_len,
            kv_group=g, window=window)
        plain = lambda: ref.flash_attention_offset(
            q, k, v, q_offset=q_off, kv_len=kv_len, kv_group=g, k_scale=ks,
            v_scale=vs, window=window)
        kd, vd = ((c.float() * cs[..., None]).to(q.dtype)
                  for c, cs in ((k, ks), (v, vs)))
        library = lambda: sdpa(q[None], kd[None], vd[None], attn_mask=mask,
                               enable_gqa=True, scale=scale)
        kv_bytes = 2 * hkv * (kv_len - kv_first) * (hd + 4)   # + scales
        shape = (f"Hq={hq},Hkv={hkv},D={hd},Sq={sq},Skv={skv},"
                 f"q_offset={q_off},kv_len={kv_len},codes={code}")
    elif q_off is None:
        kernel = lambda: K.flash_attention_2d(q, k, v, kv_len=kv_len,
                                              kv_group=g, scale=scale,
                                              window=window, causal=causal)
        plain = lambda: ref.flash_attention_static(q, k, v, kv_len=kv_len,
                                                   kv_group=g, scale=scale,
                                                   window=window,
                                                   causal=causal)
        if window or kv_len < skv:
            library = lambda: sdpa(q[None], k[None], v[None],
                                   attn_mask=mask, enable_gqa=True,
                                   scale=scale)
        else:
            library = lambda: sdpa(q[None], k[None], v[None],
                                   is_causal=causal, enable_gqa=True,
                                   scale=scale)
        shape = f"Hq={hq},Hkv={hkv},D={hd},S={sq}"
        if kv_len < skv:
            shape += f",kv_len={kv_len}"
        if not causal:
            shape += ",non-causal"
    else:
        kernel = lambda: K.flash_attention_2d(q, k, v, q_offset=q_off,
                                              kv_len=kv_len, kv_group=g,
                                              scale=scale, window=window)
        plain = lambda: ref.flash_attention_offset(q, k, v, q_offset=q_off,
                                                   kv_len=kv_len, kv_group=g,
                                                   scale=scale, window=window)
        library = lambda: sdpa(q[None], k[None], v[None], attn_mask=mask,
                               enable_gqa=True, scale=scale)
        shape = (f"Hq={hq},Hkv={hkv},D={hd},Sq={sq},Skv={skv},"
                 f"q_offset={q_off},kv_len={kv_len}")
    if scale is not None:
        shape += f",scale={scale}"
    if window:
        shape += f",window={window}"
    return dict(name=name, head_dim=hd, shape=shape, kernel=kernel,
                plain=plain, library=library, cublas=None,
                nbytes=2 * hq * sq * hd * isz + kv_bytes,
                flops=4 * hd * live_pairs)


def _paged_pools(torch, randn, gen, b, maxp, hkv, hd, code, dev, ps=16):
    """K/V pools of 1 + b * maxp ``ps``-token pages (codes and [P, Hkv]
    scales with ``code``), a shuffled page table, and the pool's bytes per
    KV element (codes + amortized scales, or the dtype's)."""
    pool_pages = 1 + b * maxp
    kp = randn(pool_pages, ps, hkv, hd)
    vp = randn(pool_pages, ps, hkv, hd)
    scales = {}
    if code is not None:
        (kp, ks), (vp, vs) = (_encode(torch, t.float(), code, 0)
                              for t in (kp, vp))
        scales = dict(k_scale=ks, v_scale=vs)
    perm = torch.randperm(pool_pages - 1, generator=gen, device=dev) + 1
    table = perm[:b * maxp].reshape(b, maxp).to(torch.int32).contiguous()
    per_elem = (1 + 4 / (ps * hd)) if code is not None else None
    return kp, vp, scales, table, per_elem


def _paged_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev,
                code=None, ps=16):
    """Paged decode: 4 slots, ``maxp`` ``ps``-token pages of capacity
    each; with ``code`` over int8 / fp8 code pools (K9a)."""
    b = 4
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b, maxp,
                                               hkv, hd, code, dev, ps)
    lens = [1000, 517, 37, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = randn(b, 1, hq, hd)
    if code is None:
        kernel = lambda: K.paged_decode_attention(qd, kp, vp, table, lengths)
    else:
        kernel = lambda: K.paged_decode_attention_q(qd, kp, vp, table,
                                                    lengths, **sc)
    return dict(
        name="paged_attention" if code is None else "paged_attention_q",
        head_dim=hd,
        shape=(f"B={b},Hq={hq},Hkv={hkv},D={hd},ps={ps},lengths={lens}"
               + (f",codes={code}" if code else "")),
        kernel=kernel,
        plain=lambda: ref.paged_decode_attention(qd, kp, vp, table, lengths,
                                                 **sc),
        library=None, cublas=None,
        nbytes=2 * b * hq * hd * isz
        + 2 * sum(lens) * hkv * hd * (per_elem or isz) + (b * maxp + b) * 4,
        flops=4 * hd * hq * sum(lens))


def _verify_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev,
                 code=None, ps=16):
    """Speculative verify: 4 slots, a 5-row window at offsets 1000, 517,
    37 and 0, ``maxp`` ``ps``-token pages of capacity each (with ``code``
    over code pools, K9b).  The bytes are the live pages' K/V (through
    each slot's deepest row) plus q and out, as the decode kernel's; the
    operations count each row's own extent."""
    b, w = SLOTS, WINDOW
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b, maxp,
                                               hkv, hd, code, dev, ps)
    offs = [1000, 517, 37, 0]
    q_off = torch.tensor(offs, dtype=torch.int32, device=dev)
    qv = randn(b, w, hq, hd)
    rows = sum(o + i + 1 for o in offs for i in range(w))
    if code is None:
        verify, decode = K.paged_verify_attention, K.paged_decode_attention
    else:
        verify, decode = K.paged_verify_attention_q, K.paged_decode_attention_q
    return dict(
        name=("paged_verify_attention" if code is None
              else "paged_verify_attention_q"), head_dim=hd,
        shape=(f"B={b},W={w},Hq={hq},Hkv={hkv},D={hd},ps={ps},"
               f"q_off={offs}" + (f",codes={code}" if code else "")),
        kernel=lambda: verify(qv, kp, vp, table, q_off, **sc),
        plain=lambda: ref.paged_verify_attention(qv, kp, vp, table, q_off,
                                                 **sc),
        library=None, cublas=None,
        nbytes=2 * b * w * hq * hd * isz
        + 2 * sum(o + w for o in offs) * hkv * hd * (per_elem or isz)
        + (b * maxp + b) * 4,
        flops=4 * hd * hq * rows,
        rows_vs_decode=lambda out: [
            bool(torch.equal(out[:, i:i + 1], decode(
                qv[:, i:i + 1].contiguous(), kp, vp, table, q_off + i + 1,
                **sc)))
            for i in range(w)])


def _attention_cases(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp,
                     flash_skv, dev):
    """The chunk, decode and verify attention calls at one model's widths,
    over full-precision pools and over int8 and fp8 codes (K2/K1/K8 and
    their twins K9c/K9a/K9b): a 128-token chunk at offset 896 over a
    ``flash_skv``-position gathered extent; 4 slots of lengths 1000, 517,
    37, 0; a 5-row verify window at those offsets."""
    cases = []
    for code in (None,) + CODES:
        cases.append(_flash_case(
            torch, K, ref, randn, isz,
            "flash_attention" if code is None else "flash_attention_q",
            hq, hkv, hd, 128, flash_skv, 896, dev, code))
        cases.append(_paged_case(torch, K, ref, randn, isz, gen, hq, hkv,
                                 hd, maxp, dev, code))
        vc = _verify_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp,
                          dev, code)
        cases.append(dict(vc, path="speculative"))
    return cases


def _w8(torch, *ws):
    """(codes, scales) of each weight, quantized per output channel."""
    from repro_torch.models.layers import quantize_channelwise
    return [quantize_channelwise(w) for w in ws]


def _rms_library(torch, x, s, w):
    """K3's library yardstick: ``F.rms_norm`` with the gain ``1 + scale``,
    then ``torch.matmul`` (two PyTorch calls; K10a's on the dequantized
    weights)."""
    gain = (1.0 + s.float()).to(x.dtype)
    return lambda: torch.matmul(torch.nn.functional.rms_norm(
        x, (x.shape[-1],), gain, 1e-6), w)


def _layer_cases(torch, K, ref, randn, isz, t, d, ns, f, path, w8=True,
                 o_proj=True, activation="silu"):
    """One dense RMSNorm/SwiGLU layer's kernel calls at ``t`` rows: the
    projections with ln1 folded in (K3, an output width each in ``ns``),
    the o-projection (K5, D x D; not with ``o_proj`` False: training's is
    a PyTorch product), the FFN with ln2 folded in (K4, F; ``activation``
    "gelu": gemma3's GELU-GLU), and with ``w8`` their int8 twins (K10a,
    K10b); ``path`` tags the cases."""
    x = randn(t, d)
    s = randn(d, scale=0.1)
    xn = ref.rms_rows(x, s, 1e-6)
    cases = []
    for n in ns:
        w = randn(d, n, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="rmsnorm_matmul", shape=f"T={t},D={d},N={n}",
            kernel=lambda x=x, s=s, w=w: K.rmsnorm_matmul(x, s, w),
            plain=lambda x=x, s=s, w=w: ref.rmsnorm_matmul(x, s, w),
            library=_rms_library(torch, x, s, w),
            cublas=lambda xn=xn, w=w: torch.matmul(xn, w),
            nbytes=(t * d + d + d * n + t * n) * isz,
            flops=2 * t * d * n, path=path))
        if not w8:
            continue
        (c, ws), = _w8(torch, w)
        wq = (c.float() * ws).to(x.dtype)
        cases.append(dict(
            name="rmsnorm_matmul_w8", shape=f"T={t},D={d},N={n},int8",
            kernel=lambda x=x, s=s, c=c, ws=ws: K.rmsnorm_matmul_w8(
                x, s, c, w_scale=ws),
            plain=lambda x=x, s=s, c=c, ws=ws: ref.rmsnorm_matmul_w8(
                x, s, c, ws),
            library=_rms_library(torch, x, s, wq),
            cublas=lambda xn=xn, wq=wq: torch.matmul(xn, wq),
            nbytes=(t * d + d + t * n) * isz + d * n + 4 * n,
            flops=2 * t * d * n, path=path))
    if o_proj:
        w_o = randn(d, d, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="block_matmul", shape=f"o_proj M={t},K={d},N={d}",
            kernel=lambda x=x, w=w_o: K.block_matmul(x, w),
            plain=lambda x=x, w=w_o: ref.block_matmul(x, w),
            library=lambda x=x, w=w_o: torch.matmul(x, w), cublas=None,
            nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d,
            path=path))
    wg = randn(d, f, scale=1 / math.sqrt(d))
    wu = randn(d, f, scale=1 / math.sqrt(d))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    act = {"silu": torch.nn.functional.silu,
           "gelu": lambda y: torch.nn.functional.gelu(
               y, approximate="tanh")}[activation]
    cases.append(dict(
        name="streamed_ffn",
        shape=f"T={t},D={d},F={f}"
        + ("" if activation == "silu" else f",{activation}"),
        kernel=lambda x=x, s=s, a=wg, b=wu, c=wd: K.streamed_ffn(
            x, a, b, c, norm_scale=s, activation=activation),
        plain=lambda x=x, s=s, a=wg, b=wu, c=wd: ref.streamed_ffn(
            x, a, b, c, norm_scale=s, activation=activation),
        library=None,
        cublas=lambda xn=xn, a=wg, b=wu, c=wd: torch.matmul(
            act(xn @ a) * (xn @ b), c),
        nbytes=(2 * t * d + d + 3 * d * f) * isz, flops=6 * t * d * f,
        path=path))
    if not w8:
        return cases
    (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
    wgq, wuq, wdq = ((c.float() * sc).to(x.dtype)
                     for c, sc in ((cg, sg), (cu, su), (cd, sd)))
    cases.append(dict(
        name="streamed_ffn_w8",
        shape=f"T={t},D={d},F={f},int8"
        + ("" if activation == "silu" else f",{activation}"),
        kernel=lambda x=x, s=s, q=(cg, cu, cd, sg, su, sd):
            K.streamed_ffn_w8(x, *q[:3], wg_scale=q[3], wu_scale=q[4],
                              wd_scale=q[5], norm_scale=s,
                              activation=activation),
        plain=lambda x=x, s=s, q=(cg, cu, cd, sg, su, sd):
            ref.streamed_ffn_w8(x, *q[:3], wg_scale=q[3], wu_scale=q[4],
                                wd_scale=q[5], norm_scale=s,
                                activation=activation),
        library=None,
        cublas=lambda xn=xn, a=wgq, b=wuq, c=wdq: torch.matmul(
            act(xn @ a) * (xn @ b), c),
        nbytes=(2 * t * d + d) * isz + 3 * d * f + 4 * (2 * f + d),
        flops=6 * t * d * f, path=path))
    return cases


def kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """llama3-8b's kernel calls: name, shape label, kernel / plain /
    library call (one PyTorch call computing the same function, or None),
    a cuBLAS yardstick (the matmuls alone, on pre-normalised x and, for
    the int8 twins, dequantized weights; or None), and the bytes and
    operations the call needs.  The projections and the FFN at a prefill
    chunk (T = 128), a decode step (4) and a verify dispatch (20), full
    precision and int8; the o-projection (block_matmul) and the final norm
    with the LM head over the padded vocabulary (rmsnorm_matmul) at one
    prefill read-out row, decode and verify; the attention calls."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    d, f = 4096, 14336
    for t in (128, 4, SPEC_T):
        cases += _layer_cases(torch, K, ref, randn, isz, t, d, (4096, 1024),
                              f, "speculative" if t == SPEC_T else None)
    vocab = padded_vocab(128256)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        cases.append(dict(
            name="rmsnorm_matmul", shape=f"lm_head T={t},D={d},N={vocab}",
            kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, head),
            plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, head),
            library=_rms_library(torch, x, s, head),
            cublas=lambda xn=xn: torch.matmul(xn, head),
            nbytes=(t * d + d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab,
            path="speculative" if t == SPEC_T else None))
    cases += _attention_cases(torch, K, ref, randn, isz, gen, 32, 8, 128,
                              128, 2048, dev)
    # The training path at a step's 2 x 2048 tokens: the projections and
    # the FFN (their forward; the backward is PyTorch's), and their int8
    # twins (K10a, K10b: the forward of the w8 step) ...
    b, s = TRAIN_SHAPES["llama3-8b"]
    cases += _layer_cases(torch, K, ref, randn, isz, b * s, d, (4096, 1024),
                          f, "train", o_proj=False)
    # ... and the attention: the 2 sequences folded into the heads (64
    # query heads over 16 KV heads, GQA group 4), as
    # ``ops.flash_attention`` flattens them.
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 32, b * 8,
                                  128, s, s, None, dev), path="train"))
    return cases


def gpt2_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """gpt2's kernel calls, as ``kernel_cases``: the projections (K = N =
    1024; the o-projection has the same shape), the MLP (D = 1024, F =
    4096, full precision and int8) and the LayerNorm rows at a prefill
    chunk, at decode, at a verify dispatch and at whole prompts of the
    serve burst's longest (992 rows) and shortest (37 rows: a partial
    tile, split K) lengths; the LM head (block_matmul over the padded
    vocabulary) at one row, decode and verify; attention at head dim 64
    with 16 query and 16 KV heads.  ``path`` tags the cases only
    whole-prompt admission or the speculative engine runs."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    gelu = torch.nn.functional.gelu
    cases = []
    d, f = 1024, 4096
    for t in (128, 4, 992, 37, SPEC_T):
        path = ("whole_prompt" if t in (992, 37)
                else "speculative" if t == SPEC_T else None)
        x = randn(t, d)
        w = randn(d, d, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="block_matmul", shape=f"M={t},K={d},N={d}",
            kernel=lambda x=x, w=w: K.block_matmul(x, w),
            plain=lambda x=x, w=w: ref.block_matmul(x, w),
            library=lambda x=x, w=w: torch.matmul(x, w), cublas=None,
            nbytes=(t * d + d * d + t * d) * isz, flops=2 * t * d * d,
            path=path))
        wu = randn(d, f, scale=1 / math.sqrt(d))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        cases.append(dict(
            name="streamed_mlp", shape=f"T={t},D={d},F={f}",
            kernel=lambda x=x, a=wu, b=wd: K.streamed_mlp(x, a, b),
            plain=lambda x=x, a=wu, b=wd: ref.streamed_mlp(x, a, b),
            library=None,
            cublas=lambda x=x, a=wu, b=wd: torch.matmul(
                gelu(x @ a, approximate="tanh"), b),
            nbytes=(2 * t * d + 2 * d * f) * isz, flops=4 * t * d * f,
            path=path))
        (cu, su), (cd, sd) = _w8(torch, wu, wd)
        wuq, wdq = ((c.float() * sc).to(dtype) for c, sc in ((cu, su),
                                                            (cd, sd)))
        cases.append(dict(
            name="streamed_mlp_w8", shape=f"T={t},D={d},F={f},int8",
            kernel=lambda x=x, q=(cu, cd, su, sd): K.streamed_mlp_w8(
                x, q[0], q[1], wu_scale=q[2], wd_scale=q[3]),
            plain=lambda x=x, q=(cu, cd, su, sd): ref.streamed_mlp_w8(
                x, q[0], q[1], wu_scale=q[2], wd_scale=q[3]),
            library=None,
            cublas=lambda x=x, a=wuq, b=wdq: torch.matmul(
                gelu(x @ a, approximate="tanh"), b),
            nbytes=2 * t * d * isz + 2 * d * f + 4 * (f + d),
            flops=4 * t * d * f, path=path))
        sc, bi = randn(d), randn(d)
        cases.append(dict(
            name="row_norm", shape=f"T={t},D={d}",
            kernel=lambda x=x, a=sc, b=bi: K.layer_norm_rows(x, a, b),
            plain=lambda x=x, a=sc, b=bi: ref.layer_norm_rows(x, a, b),
            library=lambda x=x, a=sc, b=bi: torch.nn.functional.layer_norm(
                x, (d,), a, b, 1e-5), cublas=None,
            nbytes=(2 * t * d + 2 * d) * isz, flops=8 * t * d, path=path))
    vocab = padded_vocab(50257)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        cases.append(dict(
            name="block_matmul", shape=f"lm_head M={t},K={d},N={vocab}",
            kernel=lambda x=x: K.block_matmul(x, head),
            plain=lambda x=x: ref.block_matmul(x, head),
            library=lambda x=x: torch.matmul(x, head), cublas=None,
            nbytes=(t * d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab,
            path="speculative" if t == SPEC_T else None))
    cases += _attention_cases(torch, K, ref, randn, isz, gen, 16, 16, 64, 64,
                              1024, dev)
    # The whole-prompt branch over a 1000-token prompt.
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 16, 16, 64, 1000,
                                  1000, None, dev), path="whole_prompt"))
    # The training path at a step's 8 x 1024 tokens: the projections, the
    # MLP and the attention (the 8 sequences folded into 128 heads).
    b, s = TRAIN_SHAPES["gpt2"]
    t = b * s
    x = randn(t, d)
    w = randn(d, d, scale=1 / math.sqrt(d))
    cases.append(dict(
        name="block_matmul", shape=f"M={t},K={d},N={d}", path="train",
        kernel=lambda: K.block_matmul(x, w),
        plain=lambda: ref.block_matmul(x, w),
        library=lambda: torch.matmul(x, w), cublas=None,
        nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d))
    wu = randn(d, f, scale=1 / math.sqrt(d))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    cases.append(dict(
        name="streamed_mlp", shape=f"T={t},D={d},F={f}", path="train",
        kernel=lambda: K.streamed_mlp(x, wu, wd),
        plain=lambda: ref.streamed_mlp(x, wu, wd),
        library=None,
        cublas=lambda: torch.matmul(gelu(x @ wu, approximate="tanh"), wd),
        nbytes=(2 * t * d + 2 * d * f) * isz, flops=4 * t * d * f))
    # The w8 step's MLP: K10c over the codes of the same weights.
    (cu, su), (cd, sd) = _w8(torch, wu, wd)
    wuq, wdq = ((c.float() * sc).to(dtype) for c, sc in ((cu, su), (cd, sd)))
    cases.append(dict(
        name="streamed_mlp_w8", shape=f"T={t},D={d},F={f},int8",
        path="train",
        kernel=lambda: K.streamed_mlp_w8(x, cu, cd, wu_scale=su,
                                         wd_scale=sd),
        plain=lambda: ref.streamed_mlp_w8(x, cu, cd, wu_scale=su,
                                          wd_scale=sd),
        library=None,
        cublas=lambda: torch.matmul(gelu(x @ wuq, approximate="tanh"), wdq),
        nbytes=2 * t * d * isz + 2 * d * f + 4 * (f + d),
        flops=4 * t * d * f))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 16, b * 16,
                                  64, s, s, None, dev), path="train"))
    return cases


def xent_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """K11 at the training paths' shapes: gpt2 (T = 8 x 1024 tokens, D =
    1024, Vp = 50432 over its 50257-token vocabulary), llama3-8b (T =
    2 x 2048, D = 4096, Vp = vocab = 128256), granite-moe-1b-a400m (T =
    2 x 2048, D = 1024, Vp = 49408 over 49155) and zamba2-2.7b (T = 2 x
    2048, D = 2560, Vp = vocab = 32000).  About 10% of the labels are
    ignored; the kernel gets them clamped to 0, as ``streamed_xent_loss``
    passes them.  Held to its plain version in nats (``_xent_err``).  The
    library yardstick is the cuBLAS chain ``h @ W``, ``torch.logsumexp``
    and ``gather``."""
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    return [_xent_case(torch, K, ref, randn, gen, isz, model, d, vocab, dev)
            for model, d, vocab in (("gpt2", 1024, 50257),
                                    ("llama3-8b", 4096, 128256),
                                    (GRANITE_TRAIN, 1024, 49155),
                                    (ZAMBA, 2560, 32000),
                                    (RWKV, 4096, 65536))]


def _xent_case(torch, K, ref, randn, gen, isz, model, d, vocab, dev):
    """K11 at ``model``'s training step (``TRAIN_SHAPES``), D ``d`` over
    the padded ``vocab``; about 10% of the labels ignored (clamped to 0,
    as ``streamed_xent_loss`` passes them); its library yardstick the
    chain ``h @ W``, ``torch.logsumexp`` and ``gather``."""
    from repro_torch.models.params import padded_vocab

    def library(h, w, y, vocab):
        logits = (h @ w)[:, :vocab].float()
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(1, y.long()[:, None])[:, 0])

    b, s = TRAIN_SHAPES[model]
    t, vp = b * s, padded_vocab(vocab)
    h = randn(t, d)
    w = randn(d, vp, scale=1 / math.sqrt(d))
    y = torch.randint(0, vocab, (t,), generator=gen, device=dev,
                      dtype=torch.int32)
    ignored = torch.rand(t, generator=gen, device=dev) < 0.1
    y = torch.where(ignored, 0, y).to(torch.int32)
    return dict(
        name="streamed_xent", model=model, path="train", head_dim=None,
        shape=f"T={t},D={d},Vp={vp},vocab={vocab},ignored=10%",
        kernel=lambda: K.streamed_xent_parts(h, w, y, vocab_size=vocab),
        plain=lambda: ref.xent_parts_ref(h, w, y, vocab),
        library=lambda: library(h, w, y, vocab),
        rel=_xent_err, tol=XENT_TOL_NATS,
        cublas=None, nbytes=(t * d + d * vp) * isz + 3 * t * 4,
        flops=2 * t * d * vp)


def _moe_inputs(torch, randn, t, d, f, e, top_k, dtype):
    """x [T, D], the real router's gates for it (top-k of softmax(x @ wr),
    renormalised: ``layers.gates_from_logits``) and the expert stacks."""
    from repro_torch.models.layers import gates_from_logits
    x = randn(t, d)
    wr = randn(d, e, scale=1 / math.sqrt(d))
    gates = gates_from_logits(x.float() @ wr.float(), top_k, dtype)
    wg, wu = (randn(e, d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(e, f, d, scale=1 / math.sqrt(f))
    return x, wr, gates, wg, wu, wd


def _moe_library(torch, x, g, wg, wu, wd):
    """The same function as cuBLAS calls, on the dense gather (every
    expert for every token): three batched products over the experts and
    the gate-weighted sum."""
    xe = x.expand(wg.shape[0], -1, -1)
    h = torch.nn.functional.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.einsum("etd,te->td", torch.bmm(h, wd), g)


MOE_ROUTINGS = ("router", "no token keeps expert 0",
                "all on experts 0..k-1", "ties keep 2k", "tiny kept gates")


def _moe_routings(torch, x, wr, top_k, dtype):
    """Gates [T, E] for x: the router's (``gates_from_logits``, top-k of
    softmax(x @ wr)) and four adversarial routings of the same tokens:
    "no token keeps expert 0" (its column zeroed), "all on experts 0..k-1"
    (1/k each), "ties keep 2k" (the first 2k logits tied at the top: the
    router keeps every tie) and "tiny kept gates" (every third row's gates
    times 1e-30, and the next row keeping one more expert at 1e-30, both
    normal bfloat16 values)."""
    from repro_torch.models.layers import gates_from_logits
    logits = x.float() @ wr.float()
    t, e = logits.shape
    g = gates_from_logits(logits, top_k, dtype)
    none = g.clone()
    none[:, 0] = 0
    same = torch.zeros_like(g)
    same[:, :top_k] = 1.0 / top_k
    tied = logits.clone()
    tied[:, :2 * top_k] = logits.amax(dim=1, keepdim=True) + 1.0
    tiny = g.float().clone()
    rows = torch.arange(t, device=g.device)
    tiny[rows % 3 == 0] *= 1e-30
    first = (g == 0).float().argmax(dim=1)
    extra = rows[rows % 3 == 1]
    tiny[extra, first[extra]] = 1e-30
    return dict(zip(MOE_ROUTINGS, (
        g, none, same, gates_from_logits(tied, top_k, dtype),
        tiny.to(dtype))))


def _no_sync(torch, fn):
    """``fn()`` with any host synchronization raising
    (``set_sync_debug_mode("error")``)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _row_rel(got, want) -> float:
    """max over rows of max |got - want| / max |want| within the row (a row
    all of tiny gates has its own scale; inf where a zero row is not)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(dim=-1)
    scale = w.abs().amax(dim=-1)
    rel = err / scale.clamp_min(1e-38)
    rel = rel.masked_fill((scale == 0) & (err == 0), 0.0)
    return float(rel.max().item())


def granite_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """granite-moe's kernel calls (``model`` set per case): K12 at
    granite-3b's widths (D 1536, F 512, 40 experts, gates from a real
    router's top-8) at a decode step (T = 4), a verify dispatch (20), a
    prefill chunk (128) and a whole prompt (1000), and at granite-1b's (D
    1024, 32 experts) at a training step's 2 x 2048 tokens; the router
    product (block_matmul, N = 40) and ln2 (the row-norm kernel's RMSNorm
    mode) at the serving shapes; the qkv and LM-head rmsnorm_matmul calls
    (N = 1536 for q, 512 for k and v, 49408 for the padded vocabulary);
    attention at head dim 64 with 24 query and 8 KV heads (3b), its
    whole-prompt branch, and the training path's attention, qkv and loss
    at granite-1b's widths."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    d, f, e, top_k = 1536, 512, 40, 8

    def moe_case(model, t, d, e, path):
        x, wr, g, wg, wu, wd = _moe_inputs(torch, randn, t, d, f, e, top_k,
                                           dtype)
        # The bound counts what this router's gates need: the experts
        # some token kept, read once, and 6 D F operations per kept
        # (token, expert) pair, the work K12 does.  The dense-gather work
        # the library chain does (every expert for every token) is
        # reported beside it.  No host sync inside K12.
        kept = g != 0
        pairs, touched = int(kept.sum()), int(kept.any(0).sum())
        return x, wr, dict(
            name="moe_experts", model=model, path=path,
            shape=f"T={t},D={d},F={f},E={e},top_k={top_k}",
            kernel=lambda: _no_sync(
                torch, lambda: K.moe_experts(x, g, wg, wu, wd)),
            plain=lambda: ref.moe_experts(x, g, wg, wu, wd),
            library=lambda: _moe_library(torch, x, g, wg, wu, wd),
            cublas=None,
            nbytes=(2 * t * d + t * e + 3 * touched * d * f) * isz,
            flops=6 * d * f * pairs,
            dense=dict(gate_pairs=pairs, experts_touched=touched,
                       dense_bytes=(2 * t * d + t * e + 3 * e * d * f) * isz,
                       dense_flops=6 * t * d * f * e))

    for t in (4, SPEC_T, 128, 1000):
        path = {SPEC_T: "speculative", 1000: "whole_prompt"}.get(t)
        x, wr, case = moe_case(GRANITE, t, d, e, path)
        cases.append(case)
        cases.append(dict(
            name="block_matmul", model=GRANITE, path=path,
            shape=f"router M={t},K={d},N={e}",
            kernel=lambda x=x, w=wr: K.block_matmul(x, w),
            plain=lambda x=x, w=wr: ref.block_matmul(x, w),
            library=lambda x=x, w=wr: torch.matmul(x, w), cublas=None,
            nbytes=(t * d + d * e + t * e) * isz, flops=2 * t * d * e))
        s = randn(d, scale=0.1)
        w1 = (1.0 + s.float()).to(dtype)
        cases.append(dict(
            name="rms_norm_rows", model=GRANITE, path=path,
            shape=f"T={t},D={d}",
            kernel=lambda x=x, s=s: K.rms_norm_rows(x, s),
            plain=lambda x=x, s=s: ref.rms_rows(x, s, 1e-6),
            library=lambda x=x, w1=w1: torch.nn.functional.rms_norm(
                x, (d,), w1, 1e-6),
            cublas=None, nbytes=(2 * t * d + d) * isz, flops=4 * t * d))
        if t == 1000:
            continue
        xn = ref.rms_rows(x, s, 1e-6)
        for n in (1536, 512):
            w = randn(d, n, scale=1 / math.sqrt(d))
            cases.append(dict(
                name="rmsnorm_matmul", model=GRANITE, path=path,
                shape=f"T={t},D={d},N={n}",
                kernel=lambda x=x, s=s, w=w: K.rmsnorm_matmul(x, s, w),
                plain=lambda x=x, s=s, w=w: ref.rmsnorm_matmul(x, s, w),
                library=_rms_library(torch, x, s, w),
                cublas=lambda xn=xn, w=w: torch.matmul(xn, w),
                nbytes=(t * d + d + d * n + t * n) * isz,
                flops=2 * t * d * n))
    vocab = padded_vocab(49155)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        cases.append(dict(
            name="rmsnorm_matmul", model=GRANITE,
            path="speculative" if t == SPEC_T else None,
            shape=f"lm_head T={t},D={d},N={vocab}",
            kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, head),
            plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, head),
            library=_rms_library(torch, x, s, head),
            cublas=lambda xn=xn: torch.matmul(xn, head),
            nbytes=(t * d + d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab))
    cases += [dict(c, model=GRANITE) for c in _attention_cases(
        torch, K, ref, randn, isz, gen, 24, 8, 64, 128, 2048, dev)]
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 24, 8, 64, 1000,
                                  1000, None, dev),
                      model=GRANITE, path="whole_prompt"))
    # granite-1b's training step (2 x 2048 tokens): the experts, the qkv
    # projections (N = 1024 for q, 512 for k and v) and the attention
    # (2 sequences folded into 32 query heads over 16 KV heads).
    b, sl = TRAIN_SHAPES[GRANITE_TRAIN]
    t, d1 = b * sl, 1024
    x, _, case = moe_case(GRANITE_TRAIN, t, d1, 32, "train")
    cases.append(case)
    sc = randn(d1, scale=0.1)
    xn = ref.rms_rows(x, sc, 1e-6)
    for n in (1024, 512):
        w = randn(d1, n, scale=1 / math.sqrt(d1))
        cases.append(dict(
            name="rmsnorm_matmul", model=GRANITE_TRAIN, path="train",
            shape=f"T={t},D={d1},N={n}",
            kernel=lambda w=w: K.rmsnorm_matmul(x, sc, w),
            plain=lambda w=w: ref.rmsnorm_matmul(x, sc, w),
            library=_rms_library(torch, x, sc, w),
            cublas=lambda w=w: torch.matmul(xn, w),
            nbytes=(t * d1 + d1 + d1 * n + t * n) * isz,
            flops=2 * t * d1 * n))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 16, b * 8,
                                  64, sl, sl, None, dev),
                      model=GRANITE_TRAIN, path="train"))
    return cases


def _ssd_case(torch, K, ref, randn, isz, b, s, path):
    """K13 at zamba2's widths (80 heads of 64, state 64) over ``b``
    sequences of ``s`` tokens, in the model's chunk: realistic operands
    (dt from the init's dt_bias through softplus, a_log the init's).  The
    library yardstick is the eager chunked ``mamba2_ssd`` (no one PyTorch
    call computes the SSD).  Operations: per chunk of Q rows, C B^T and the
    (C B^T o L) x product over the Q(Q+1)/2 pairs the mask keeps, then C
    h^T and the state update.  y and the final state are checked each
    against its own scale."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import _chunk_of
    h, p, n = 80, 64, 64
    q = _chunk_of(s, 128)
    x = randn(b, s, h, p)
    dt_bias = torch.log(torch.expm1(torch.exp(torch.linspace(
        math.log(1e-3), math.log(1e-1), h, device=x.device))))
    dt = torch.nn.functional.softplus(
        randn(b, s, h, scale=0.5).float() + dt_bias).to(x.dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=x.device)).to(
        x.dtype)
    bm, cm = randn(b, s, n), randn(b, s, n)
    d_skip = randn(h)
    args = (x, dt, a_log, bm, cm, d_skip)
    pairs = q * (q + 1) // 2
    flops = b * h * (s // q) * (2 * pairs * (n + p) + 4 * q * p * n)
    return dict(
        name="mamba2_scan", model=ZAMBA, path=path, parts=True, args=args,
        shape=f"B={b},S={s},Q={q},H={h},P={p},N={n}",
        kernel=lambda: K.mamba2_ssd(*args, chunk=q),
        plain=lambda: ref.mamba2_ssd(*args, chunk=q),
        library=lambda: L.mamba2_ssd(*args, chunk=q), cublas=None,
        nbytes=(2 * b * s * h * p + b * s * h + 2 * b * s * n + 2 * h) * isz
        + 4 * b * h * p * n, flops=flops)


def zamba_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """zamba2-2.7b's kernel calls: K13 at whole prompts of 1000 (Q 8), 999
    (Q 1), 37 (Q 37) and 128 (Q 128) tokens and at a training step's 2 x
    2048 (Q 128); the shared block's GELU GLU (K4, D 2560, F 10240, no
    folded norm) and its int8 twin K10b at a decode step (T 4), 128 rows
    and a 1000-token prompt, K4 at the training step's 4096 rows; its qkv
    (K3, N 2560, and the int8 twin K10a), ln2 rows and o-projection (K5) at
    decode and a whole prompt; the final norm with the LM head (K3, N
    32000) at one row and at decode; decode attention at head dim 80 (32
    query and KV heads; slots of 1000, 517, 37 and 0 positions) over
    bf16, int8 and fp8 pages (K1, K9a); the static flash kernel at head
    dim 80 over a 1000-token prompt and the training step's 2 sequences of
    2048 (folded into 64 heads); the training step's qkv projection (K3,
    T 4096) and loss (K11, Vp 32000)."""
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    for s in (1000, 999, 37, 128):
        cases.append(_ssd_case(torch, K, ref, randn, isz, 1, s,
                               "whole_prompt"))
    b, sl = TRAIN_SHAPES[ZAMBA]
    cases.append(_ssd_case(torch, K, ref, randn, isz, b, sl, "train"))
    d, f = 2560, 10240
    wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
    wgq, wuq, wdq = ((c.float() * sc).to(dtype)
                     for c, sc in ((cg, sg), (cu, su), (cd, sd)))
    gelu = lambda v: torch.nn.functional.gelu(v, approximate="tanh")
    for t in (4, 128, 1000, b * sl):
        path = {1000: "whole_prompt", b * sl: "train"}.get(t)
        x = randn(t, d)
        cases.append(dict(
            name="streamed_ffn", model=ZAMBA, path=path,
            shape=f"T={t},D={d},F={f},gelu,no norm",
            kernel=lambda x=x: K.streamed_ffn(x, wg, wu, wd,
                                              activation="gelu"),
            plain=lambda x=x: ref.streamed_ffn(x, wg, wu, wd,
                                               activation="gelu"),
            library=None,
            cublas=lambda x=x: torch.matmul(gelu(x @ wg) * (x @ wu), wd),
            nbytes=(2 * t * d + 3 * d * f) * isz, flops=6 * t * d * f))
        if t == b * sl:
            continue
        cases.append(dict(
            name="streamed_ffn_w8", model=ZAMBA, path=path,
            shape=f"T={t},D={d},F={f},gelu,no norm,int8",
            kernel=lambda x=x: K.streamed_ffn_w8(
                x, cg, cu, cd, wg_scale=sg, wu_scale=su, wd_scale=sd,
                activation="gelu"),
            plain=lambda x=x: ref.streamed_ffn_w8(
                x, cg, cu, cd, wg_scale=sg, wu_scale=su, wd_scale=sd,
                activation="gelu"),
            library=None,
            cublas=lambda x=x: torch.matmul(gelu(x @ wgq) * (x @ wuq), wdq),
            nbytes=2 * t * d * isz + 3 * d * f + 4 * (2 * f + d),
            flops=6 * t * d * f))
    w_q = randn(d, d, scale=1 / math.sqrt(d))
    (cq, sq), = _w8(torch, w_q)
    wqq = (cq.float() * sq).to(dtype)
    head = randn(d, 32000, scale=1 / math.sqrt(d))
    for t in (1, 4, 1000):
        path = "whole_prompt" if t == 1000 else None
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        if t > 1:
            cases += [dict(
                name="rmsnorm_matmul", model=ZAMBA, path=path,
                shape=f"T={t},D={d},N={d}",
                kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, w_q),
                plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, w_q),
                library=_rms_library(torch, x, s, w_q),
                cublas=lambda xn=xn: torch.matmul(xn, w_q),
                nbytes=(2 * t * d + d + d * d) * isz, flops=2 * t * d * d),
                dict(
                name="rmsnorm_matmul_w8", model=ZAMBA, path=path,
                shape=f"T={t},D={d},N={d},int8",
                kernel=lambda x=x, s=s: K.rmsnorm_matmul_w8(
                    x, s, cq, w_scale=sq),
                plain=lambda x=x, s=s: ref.rmsnorm_matmul_w8(x, s, cq, sq),
                library=_rms_library(torch, x, s, wqq),
                cublas=lambda xn=xn: torch.matmul(xn, wqq),
                nbytes=(2 * t * d + d) * isz + d * d + 4 * d,
                flops=2 * t * d * d),
                dict(
                name="block_matmul", model=ZAMBA, path=path,
                shape=f"o_proj M={t},K={d},N={d}",
                kernel=lambda x=x: K.block_matmul(x, w_q),
                plain=lambda x=x: ref.block_matmul(x, w_q),
                library=lambda x=x: torch.matmul(x, w_q), cublas=None,
                nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d),
                dict(
                name="rms_norm_rows", model=ZAMBA, path=path,
                shape=f"T={t},D={d}",
                kernel=lambda x=x, s=s: K.rms_norm_rows(x, s),
                plain=lambda x=x, s=s: ref.rms_rows(x, s, 1e-6),
                library=lambda x=x, w1=(1.0 + s.float()).to(dtype):
                    torch.nn.functional.rms_norm(x, (d,), w1, 1e-6),
                cublas=None, nbytes=(2 * t * d + d) * isz,
                flops=4 * t * d)]
        if t < 1000:
            cases.append(dict(
                name="rmsnorm_matmul", model=ZAMBA, path=path,
                shape=f"lm_head T={t},D={d},N=32000",
                kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, head),
                plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, head),
                library=_rms_library(torch, x, s, head),
                cublas=lambda xn=xn: torch.matmul(xn, head),
                nbytes=(t * d + d + d * 32000 + t * 32000) * isz,
                flops=2 * t * d * 32000))
    # The training step's q / k / v projection (one shape for all three).
    t = b * sl
    x = randn(t, d)
    s = randn(d, scale=0.1)
    xn = ref.rms_rows(x, s, 1e-6)
    cases.append(dict(
        name="rmsnorm_matmul", model=ZAMBA, path="train",
        shape=f"T={t},D={d},N={d}",
        kernel=lambda: K.rmsnorm_matmul(x, s, w_q),
        plain=lambda: ref.rmsnorm_matmul(x, s, w_q),
        library=_rms_library(torch, x, s, w_q),
        cublas=lambda: torch.matmul(xn, w_q),
        nbytes=(2 * t * d + d + d * d) * isz, flops=2 * t * d * d))
    for code in (None,) + CODES:
        cases.append(dict(_paged_case(torch, K, ref, randn, isz, gen, 32, 32,
                                      80, 128, dev, code), model=ZAMBA))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 32, 32, 80, 1000,
                                  1000, None, dev),
                      model=ZAMBA, path="whole_prompt"))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 32, b * 32,
                                  80, sl, sl, None, dev),
                      model=ZAMBA, path="train"))
    return cases


def _wkv_case(torch, K, ref, randn, isz, b, s, path, h=64, n=64):
    """K14 at rwkv6-7b's widths (``h`` = 64 heads of ``n`` = 64) over ``b``
    sequences of ``s`` tokens, at the model's chunk (neither kernel takes it): r, k, v
    in the dtype, the decay as the model makes it (float32
    ``exp(-exp(.))`` around the init's ``w_bias``), a nonzero bonus ``u``.
    y and the final state are checked each against its own scale.
    Operations: the recurrence's 7 N^2 per token and head (kv, u kv, the
    sum, r (...), S w, + kv) at the operands' type's peak (bf16: the
    sequence-split scan's products run on the tensor cores, and the bytes
    set the bound).  Bytes: r, k, v and y in the dtype, w in float32, u,
    the state out in float32.  No PyTorch call computes it."""
    from repro_torch.models.model import _chunk_of
    q = _chunk_of(s, 64)
    r, k, v = (randn(b, s, h, n) for _ in range(3))
    w_bias = torch.linspace(-6.0, -0.5, n, device=r.device)
    w = torch.exp(-torch.exp(randn(b, s, h, n, scale=0.5).float() + w_bias))
    u = randn(h, n, scale=0.5)
    args = (r, k, v, w, u)
    return dict(
        name="rwkv6_wkv", model=RWKV, path=path, parts=True, args=args,
        shape=f"B={b},S={s},chunk={q},H={h},N={n}",
        kernel=lambda: K.wkv6(*args, chunk=q),
        plain=lambda: ref.wkv6(*args), library=None, cublas=None,
        nbytes=b * s * h * n * (4 * isz + 4) + 4 * b * h * n * n + h * n * isz,
        flops=7 * b * s * h * n * n)


def rwkv_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """rwkv6-7b's kernel calls: K14 at whole prompts of 1000 (chunk 8),
    999 (chunk 1), 37 and 128 tokens and at a training step's 2 x 2048;
    the final LayerNorm rows (D 4096) and the LM head (K5, D 4096 x Vp
    65536) at one row (a prefill's last position), at decode (4 slots) and
    at 1000 rows (no path runs that: reported for scale)."""
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = [_wkv_case(torch, K, ref, randn, isz, 1, s, "whole_prompt")
             for s in (1000, 999, 37, 128)]
    b, sl = TRAIN_SHAPES[RWKV]
    cases.append(_wkv_case(torch, K, ref, randn, isz, b, sl, "train"))
    d, vocab = 4096, 65536
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, 1000):
        path = "wide" if t == 1000 else None
        x = randn(t, d)
        sc, bi = randn(d, scale=0.1), randn(d, scale=0.1)
        cases += [dict(
            name="row_norm", model=RWKV, path=path, shape=f"T={t},D={d}",
            kernel=lambda x=x, a=sc, c=bi: K.layer_norm_rows(x, a, c),
            plain=lambda x=x, a=sc, c=bi: ref.layer_norm_rows(x, a, c),
            library=lambda x=x, a=sc, c=bi: torch.nn.functional.layer_norm(
                x, (d,), a, c, 1e-5), cublas=None,
            nbytes=(2 * t * d + 2 * d) * isz, flops=8 * t * d), dict(
            name="block_matmul", model=RWKV, path=path,
            shape=f"lm_head M={t},K={d},N={vocab}",
            kernel=lambda x=x: K.block_matmul(x, head),
            plain=lambda x=x: ref.block_matmul(x, head),
            library=lambda x=x: torch.matmul(x, head), cublas=None,
            nbytes=(t * d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab)]
    return cases


def qwen_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """The Qwen paths' kernel calls at their own widths (``kernel_cases``'
    fields): a layer's projections (q and k/v widths), o-projection and
    FFN (``_layer_cases``; int8 twins where a burst runs ``w8_kv8``) and
    the final norm with the LM head over the padded 151936-token
    vocabulary, at qwen3's and qwen1.5's prefill chunk (128 rows), decode
    (4) and verify dispatch (20) with their chunk, decode and verify
    attention (qwen3 D 64 with 16 over 8 heads, qwen1.5 16 over 16) over
    full-precision, int8 and fp8 pools, and at qwen2-vl's whole prompts
    (1000 and 37 rows: K7 at D 128 with 12 over 2 heads, GQA 6) and decode
    (K1 and K9a at GQA 6); qwen3's and qwen2-vl's training step at 2 x
    2048: projections, FFN, K7 with the sequences folded into the heads,
    and K11."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    out = []
    for model in QWEN:
        cfg = get_config(model)
        d, f = cfg.d_model, cfg.d_ff
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        ns = tuple(dict.fromkeys((cfg.q_dim, cfg.kv_dim)))
        whole = model == QWEN2VL
        w8 = model != QWEN15        # the burst runs w8_kv8
        rows = ((1000, "whole_prompt"), (37, "whole_prompt"), (4, None)) \
            if whole else ((128, None), (4, None), (SPEC_T, "speculative"))
        cases = []
        for t, path in rows:
            cases += _layer_cases(torch, K, ref, randn, isz, t, d, ns, f,
                                  path, w8=w8)
        vocab = padded_vocab(cfg.vocab_size)
        head = randn(d, vocab, scale=1 / math.sqrt(d))
        for t in (1, 4) if whole else (1, 4, SPEC_T):
            x = randn(t, d)
            sc = randn(d, scale=0.1)
            xn = ref.rms_rows(x, sc, 1e-6)
            cases.append(dict(
                name="rmsnorm_matmul", shape=f"lm_head T={t},D={d},N={vocab}",
                kernel=lambda x=x, sc=sc, w=head: K.rmsnorm_matmul(x, sc, w),
                plain=lambda x=x, sc=sc, w=head: ref.rmsnorm_matmul(x, sc, w),
                library=_rms_library(torch, x, sc, head),
                cublas=lambda xn=xn, w=head: torch.matmul(xn, w),
                nbytes=(t * d + d + d * vocab + t * vocab) * isz,
                flops=2 * t * d * vocab,
                path="speculative" if t == SPEC_T else None))
        if whole:
            cases += [_paged_case(torch, K, ref, randn, isz, gen, hq, hkv,
                                  hd, 128, dev, code)
                      for code in (None,) + CODES]
            cases.append(dict(_flash_case(
                torch, K, ref, randn, isz, "flash_attention_static", hq,
                hkv, hd, 1000, 1000, None, dev), path="whole_prompt"))
        else:
            cases += _attention_cases(torch, K, ref, randn, isz, gen, hq,
                                      hkv, hd, 128, 2048, dev)
        if model in TRAIN_SHAPES:
            b, sl = TRAIN_SHAPES[model]
            cases += _layer_cases(torch, K, ref, randn, isz, b * sl, d, ns,
                                  f, "train", w8=False, o_proj=False)
            cases.append(dict(_flash_case(
                torch, K, ref, randn, isz, "flash_attention_static", b * hq,
                b * hkv, hd, sl, sl, None, dev), path="train"))
            cases.append(_xent_case(torch, K, ref, randn, gen, isz, model, d,
                                    cfg.vocab_size, dev))
        out += [dict(c, model=model) for c in cases]
    return out


def _unequal_row_counts(torch, kern, x):
    """The row counts t < 64 at which ``kern(x[:t])`` is not bit-equal to
    the first t rows of ``kern(x)`` (x: 64 rows)."""
    full = kern(x)
    return [t for t in range(1, x.shape[0])
            if not torch.equal(kern(x[:t].contiguous()), full[:t])]


def check_qwen_rows(torch, dev="cuda"):
    """bf16 K3 (each q/k/v width), K10a, K4 and K10b at each Qwen width:
    rows at 1..63 rows bit-equal to the same rows at 64 (required: a
    verify dispatch must reproduce decode rows, and a prompt served alone
    its burst)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import ROW_INVARIANT_T
    gen = torch.Generator(device=dev).manual_seed(4321)
    randn = _randn(torch, gen, torch.bfloat16, dev)
    out = []
    for model in QWEN:
        cfg = get_config(model)
        d, f = cfg.d_model, cfg.d_ff
        s = randn(d, scale=0.1)
        x = randn(ROW_INVARIANT_T, d)
        insts = {}
        for n in dict.fromkeys((cfg.q_dim, cfg.kv_dim)):
            w = randn(d, n, scale=1 / math.sqrt(d))
            (c, ws), = _w8(torch, w)
            insts[f"rmsnorm_matmul N={n}"] = (
                lambda x, w=w: K.rmsnorm_matmul(x, s, w))
            insts[f"rmsnorm_matmul_w8 N={n}"] = (
                lambda x, c=c, ws=ws: K.rmsnorm_matmul_w8(x, s, c,
                                                          w_scale=ws))
        wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
        insts[f"streamed_ffn F={f}"] = (
            lambda x: K.streamed_ffn(x, wg, wu, wd, norm_scale=s))
        insts[f"streamed_ffn_w8 F={f}"] = (
            lambda x: K.streamed_ffn_w8(x, cg, cu, cd, norm_scale=s,
                                        wg_scale=sg, wu_scale=su,
                                        wd_scale=sd))
        for name, kern in insts.items():
            bad = _unequal_row_counts(torch, kern, x)
            row = {"phase": "qwen_rows", "model": model, "call": name,
                   "D": d, "equal_1_to_64": not bad, "unequal_at": bad[:8]}
            emit(row)
            out.append(row)
    bad = [f"{r['model']} {r['call']}" for r in out if not r["equal_1_to_64"]]
    if bad:
        raise AssertionError(f"qwen_rows: rows differ at 1..63 rows: {bad}")
    return out


def _gemma_paged_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, dev,
                      window, verify, code=None):
    """gemma3's decode (K1) or verify (K8) call at head dim 320: 5 slots
    of lengths 1023, 1024, 1025, 0 and 3000 (decode), or 5-row windows
    whose rows see 1021..1025, 1022..1026, 1023..1027, 1..5 and
    2999..3003 positions (verify), over a 4096-position page table, with
    ``window`` (0: a global layer); with ``code`` over int8 / fp8 code
    pools (K9a, K9b).  The bytes are the K/V positions the rows see (at
    most ``window`` a row), q and out; the operations each row's own
    positions."""
    b, ps, maxp = 5, 16, GEMMA_MAX_LEN // 16
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b, maxp,
                                               hkv, hd, code, dev)
    w = WINDOW if verify else 1
    base = [1020, 1021, 1022, 0, 2998] if verify else [1023, 1024, 1025, 0,
                                                       3000]
    lens = [[o + i + 1 for i in range(w)] if verify else [o]
            for o in base]
    seen = [[min(n, window) if window else n for n in row] for row in lens]
    # A slot's positions read: from its shallowest row's window start to
    # its deepest row.
    span = [max(r) - (max(min(r) - window, 0) if window else 0)
            for r in lens]
    base_t = torch.tensor(base, dtype=torch.int32, device=dev)
    q = randn(b, w, hq, hd)
    rows = sum(sum(r) for r in seen)
    if code is None:
        verify_k, decode_k = K.paged_verify_attention, K.paged_decode_attention
    else:
        verify_k = K.paged_verify_attention_q
        decode_k = K.paged_decode_attention_q
    kern = verify_k if verify else decode_k
    plain_fn = (ref.paged_verify_attention if verify
                else ref.paged_decode_attention)
    name = "paged_verify_attention" if verify else "paged_attention"
    case = dict(
        name=name + ("_q" if code else ""),
        head_dim=hd, path="speculative" if verify else None,
        shape=(f"B={b},W={w},Hq={hq},Hkv={hkv},D={hd},ps={ps},"
               + (f"q_off={base}" if verify else f"lengths={base}")
               + f",window={window}" + (f",codes={code}" if code else "")),
        kernel=lambda: kern(q, kp, vp, table, base_t, window=window, **sc),
        plain=lambda: plain_fn(q, kp, vp, table, base_t, window=window,
                               **sc),
        library=None, cublas=None,
        nbytes=2 * b * w * hq * hd * isz
        + 2 * sum(span) * hkv * hd * (per_elem or isz) + (b * maxp + b) * 4,
        flops=4 * hd * hq * rows)
    if verify:
        case["rows_vs_decode"] = lambda out: [
            bool(torch.equal(out[:, i:i + 1], decode_k(
                q[:, i:i + 1].contiguous(), kp, vp, table, base_t + i + 1,
                window=window, **sc)))
            for i in range(w)]
    return case


def gemma_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """gemma3-4b's kernel calls at its widths (``kernel_cases``' fields):
    a layer's projections with ln1 folded in (K3 at N 2560 for q, 1280 for
    k and v, and its int8 twin K10a), o-projection (K5) and GELU-GLU with
    ln2 folded in (K4, and its int8 twin K10b) at a prefill chunk (128
    rows), decode (4) and a verify dispatch (20); the final norm with the
    LM head over the 262144-token vocabulary at 1, 4 and 20 rows; at head
    dim 320 with 8 query heads over 4: K2 chunks of 128 rows at offsets
    896 and 2944 over a 4096-position gathered extent and their twin over
    int8 and fp8 codes (K9c), K7 at whole prompts of 1000 and 3000, K1 and
    K8 at the window's edge lengths (``_gemma_paged_case``) and their
    twins over code pools (K9a, K9b), each under the 1024-token window and
    without it (a global layer); and K9c and K9a under the window at head
    dim 128 over int8 codes; a training step's 2 x 2048 tokens: K3, K10a,
    K4 and K10b at T = 4096, K7 over the folded heads windowed and global,
    and K11 over the 262144-token vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cfg = get_config(GEMMA)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    ns = (cfg.q_dim, cfg.kv_dim)
    cases = []
    for t, path in ((128, None), (4, None), (SPEC_T, "speculative")):
        cases += _layer_cases(torch, K, ref, randn, isz, t, d, ns, f, path,
                              activation="gelu")
    vocab = padded_vocab(cfg.vocab_size)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        sc = randn(d, scale=0.1)
        xn = ref.rms_rows(x, sc, 1e-6)
        cases.append(dict(
            name="rmsnorm_matmul", shape=f"lm_head T={t},D={d},N={vocab}",
            kernel=lambda x=x, sc=sc, w=head: K.rmsnorm_matmul(x, sc, w),
            plain=lambda x=x, sc=sc, w=head: ref.rmsnorm_matmul(x, sc, w),
            library=_rms_library(torch, x, sc, head),
            cublas=lambda xn=xn, w=head: torch.matmul(xn, w),
            nbytes=(t * d + d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab,
            path="speculative" if t == SPEC_T else None))
    for window in (GEMMA_WINDOW, 0):
        for off in (896, 2944):
            for code in (None,) + CODES:
                cases.append(_flash_case(
                    torch, K, ref, randn, isz,
                    "flash_attention" if code is None
                    else "flash_attention_q", hq, hkv, hd, 128,
                    GEMMA_MAX_LEN, off, dev, code=code, window=window))
        for s in (1000, 3000):
            cases.append(dict(_flash_case(
                torch, K, ref, randn, isz, "flash_attention_static", hq,
                hkv, hd, s, s, None, dev, window=window),
                path="whole_prompt"))
        for verify in (False, True):
            for code in (None,) + CODES:
                cases.append(_gemma_paged_case(
                    torch, K, ref, randn, isz, gen, hq, hkv, hd, dev,
                    window, verify, code))
    # The training step at 2 x 2048 tokens: the projections (K3, K10a),
    # the GELU-GLU with ln2 folded in (K4, K10b), K7 at head dim 320 with
    # the two sequences folded into the heads, windowed (a local layer)
    # and global, and the loss over the 262144-token vocabulary (K11;
    # T x Vp = 2^30).
    b, s = TRAIN_SHAPES[GEMMA]
    cases += _layer_cases(torch, K, ref, randn, isz, b * s, d, ns, f,
                          "train", o_proj=False, activation="gelu")
    for window in (GEMMA_WINDOW, 0):
        cases.append(dict(_flash_case(
            torch, K, ref, randn, isz, "flash_attention_static", b * hq,
            b * hkv, hd, s, s, None, dev, window=window), path="train"))
    cases.append(_xent_case(torch, K, ref, randn, gen, isz, GEMMA, d,
                            cfg.vocab_size, dev))
    # The window over codes at head dim 128 too (path "d128": no gemma3
    # burst runs it).
    cases.append(dict(_flash_case(
        torch, K, ref, randn, isz, "flash_attention_q", hq, hkv, 128, 128,
        GEMMA_MAX_LEN, 2944, dev, code="int8", window=GEMMA_WINDOW),
        path="d128"))
    cases.append(dict(_gemma_paged_case(
        torch, K, ref, randn, isz, gen, hq, hkv, 128, dev, GEMMA_WINDOW,
        False, "int8"), path="d128"))
    return [dict(c, model=GEMMA) for c in cases]


def check_gemma_rows(torch, timer, dev="cuda"):
    """bf16 K3 and K10a (q and k/v widths) and K4 and K10b (GELU-GLU with
    the norm folded in) at gemma3's widths: rows at 1..63 rows bit-equal
    to the same rows at 64 (required); K2's 128-row chunks at offsets 896
    and 2944 bit-equal to K7's rows at the same positions of the
    3072-token prompt, and K9c's over int8 and fp8 codes to one K9c call
    over the whole prompt from offset 0, with the window and without
    (required: a chunked prompt then gives its whole-prompt rows).  K7
    with and without the window at 3000 tokens: the local layer's time
    over the global layer's."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import ROW_INVARIANT_T
    gen = torch.Generator(device=dev).manual_seed(4322)
    randn = _randn(torch, gen, torch.bfloat16, dev)
    cfg = get_config(GEMMA)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    s = randn(d, scale=0.1)
    x = randn(ROW_INVARIANT_T, d)
    insts = {}
    for n in (cfg.q_dim, cfg.kv_dim):
        w = randn(d, n, scale=1 / math.sqrt(d))
        insts[f"rmsnorm_matmul N={n}"] = (
            lambda x, w=w: K.rmsnorm_matmul(x, s, w))
    wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    insts[f"streamed_ffn F={f},gelu"] = (
        lambda x: K.streamed_ffn(x, wg, wu, wd, norm_scale=s,
                                 activation="gelu"))
    for n in (cfg.q_dim, cfg.kv_dim):
        (c, ws), = _w8(torch, randn(d, n, scale=1 / math.sqrt(d)))
        insts[f"rmsnorm_matmul_w8 N={n}"] = (
            lambda x, c=c, ws=ws: K.rmsnorm_matmul_w8(x, s, c, w_scale=ws))
    (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
    insts[f"streamed_ffn_w8 F={f},gelu"] = (
        lambda x: K.streamed_ffn_w8(x, cg, cu, cd, wg_scale=sg, wu_scale=su,
                                    wd_scale=sd, norm_scale=s,
                                    activation="gelu"))
    out = []
    for name, kern in insts.items():
        bad = _unequal_row_counts(torch, kern, x)
        row = {"phase": "gemma_rows", "model": GEMMA, "call": name, "D": d,
               "equal_1_to_64": not bad, "unequal_at": bad[:8]}
        emit(row)
        out.append(row)
    n = 3072
    q, k, v = randn(hq, n, hd), randn(hkv, n, hd), randn(hkv, n, hd)
    for window in (GEMMA_WINDOW, 0):
        whole = K.flash_attention_2d(q, k, v, kv_group=hq // hkv,
                                     window=window)
        for off in (896, 2944):
            chunk = K.flash_attention_2d(
                q[:, off:off + 128].contiguous(), k, v, q_offset=off,
                kv_len=off + 128, kv_group=hq // hkv, window=window)
            row = {"phase": "gemma_rows", "model": GEMMA,
                   "call": f"flash_attention q_offset={off}",
                   "window": window,
                   "equal_1_to_64": bool(torch.equal(
                       chunk, whole[:, off:off + 128]))}
            emit(row)
            out.append(row)
    for code in CODES:
        (kc, ks), (vc, vs) = (_encode(torch, t.float(), code, 1)
                              for t in (k, v))
        for window in (GEMMA_WINDOW, 0):
            whole = K.flash_attention_2d_q(q, kc, vc, k_scale=ks, v_scale=vs,
                                           q_offset=0, kv_group=hq // hkv,
                                           window=window)
            for off in (896, 2944):
                chunk = K.flash_attention_2d_q(
                    q[:, off:off + 128].contiguous(), kc, vc, k_scale=ks,
                    v_scale=vs, q_offset=off, kv_len=off + 128,
                    kv_group=hq // hkv, window=window)
                row = {"phase": "gemma_rows", "model": GEMMA,
                       "call": f"flash_attention_q {code} q_offset={off}",
                       "window": window,
                       "equal_1_to_64": bool(torch.equal(
                           chunk, whole[:, off:off + 128]))}
                emit(row)
                out.append(row)
    q3, k3, v3 = q[:, :3000].contiguous(), k[:, :3000].contiguous(), \
        v[:, :3000].contiguous()
    ms = {w: timer(lambda w=w: K.flash_attention_2d(
        q3, k3, v3, kv_group=hq // hkv, window=w))
        for w in (GEMMA_WINDOW, 0)}
    emit({"phase": "gemma_window", "model": GEMMA, "S": 3000,
          "local_ms": ms[GEMMA_WINDOW], "global_ms": ms[0],
          "local_over_global": ms[GEMMA_WINDOW] / ms[0]})
    bad = [f"{r['call']} {r.get('window', '')}" for r in out
           if not r["equal_1_to_64"]]
    if bad:
        raise AssertionError(f"gemma_rows: rows differ: {bad}")
    return out


def hubert_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """hubert-xlarge's kernel calls at its widths (``kernel_cases``'
    fields), at the encode's 8 clips x 1000 frames (path ``encode``) and
    a training step's 2 x 2048 (``train``): the q/k/v projection (K5,
    [T, 1280] @ [1280, 1280]), the MLP (K6, D 1280, F 5120) and the
    non-causal attention (K7, 16 over 16 heads of 80 a clip, the clips
    folded into the heads, as ``ops.flash_attention`` flattens them); the
    training step's loss (K11, Vp 512 over the 504-entry codebook)."""
    from repro_torch.configs import get_config
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    gelu = torch.nn.functional.gelu
    cfg = get_config(HUBERT)
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim_
    cases = []
    for (b, sl), path in (((HUBERT_CLIPS, HUBERT_FRAMES), "encode"),
                          (TRAIN_SHAPES[HUBERT], "train")):
        t = b * sl
        x = randn(t, d)
        w = randn(d, d, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="block_matmul", shape=f"qkv M={t},K={d},N={d}", path=path,
            kernel=lambda x=x, w=w: K.block_matmul(x, w),
            plain=lambda x=x, w=w: ref.block_matmul(x, w),
            library=lambda x=x, w=w: torch.matmul(x, w), cublas=None,
            nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d))
        wu = randn(d, f, scale=1 / math.sqrt(d))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        cases.append(dict(
            name="streamed_mlp", shape=f"T={t},D={d},F={f}", path=path,
            kernel=lambda x=x, a=wu, c=wd: K.streamed_mlp(x, a, c),
            plain=lambda x=x, a=wu, c=wd: ref.streamed_mlp(x, a, c),
            library=None,
            cublas=lambda x=x, a=wu, c=wd: torch.matmul(
                gelu(x @ a, approximate="tanh"), c),
            nbytes=(2 * t * d + 2 * d * f) * isz, flops=4 * t * d * f))
        cases.append(dict(_flash_case(
            torch, K, ref, randn, isz, "flash_attention_static", b * h,
            b * h, hd, sl, sl, None, dev, causal=False), path=path))
    cases.append(_xent_case(torch, K, ref, randn, gen, isz, HUBERT, d,
                            cfg.vocab_size, dev))
    return [dict(c, model=HUBERT) for c in cases]


def _flat(torch, out):
    """A kernel's output, its parts concatenated when it has several
    (streamed_xent: lse and gold)."""
    if isinstance(out, tuple):
        return torch.cat([o.reshape(-1) for o in out])
    return out


def _llama_cases(torch, K, ref, dtype, gen):
    return [dict(c, model="llama3-8b")
            for c in kernel_cases(torch, K, ref, dtype, gen)]


def _gpt2_cases(torch, K, ref, dtype, gen):
    return [dict(c, model="gpt2")
            for c in gpt2_kernel_cases(torch, K, ref, dtype, gen)]


KERNEL_CASES = (_llama_cases, _gpt2_cases, xent_cases, granite_kernel_cases,
                zamba_kernel_cases, rwkv_kernel_cases)


def check_kernels(torch, timer, case_sets=KERNEL_CASES, phase="kernel"):
    """Each case of ``case_sets`` (functions of (torch, K, ref, dtype,
    generator) giving model-tagged cases) in bfloat16 and float32 against
    its plain version, one ``phase`` line each; raises if any disagrees."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(1234)
        cases = [c for fn in case_sets for c in fn(torch, K, ref, dtype, gen)]
        for c in cases:
            got, plain = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            out, want = _flat(torch, got), _flat(torch, plain)
            err = (out.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            rel = err / max(scale, 1e-30)
            if c.get("parts"):          # each output against its own scale
                rel = max(_rel(a.float(), b.float())
                          for a, b in zip(got, plain))
            if "rel" in c:              # the case's own measure (K11: nats)
                rel = c["rel"](got, plain)
            tol = c.get("tol", TOL[dname])
            bound_ms, bound_by = bound(c["nbytes"], c["flops"], dname)
            # Each verify row against the decode kernel at its length, bit
            # for bit (comparison launches; no path's count).
            same_rows = (c["rows_vs_decode"](out) if "rows_vs_decode" in c
                         else None)
            row = {"phase": phase, "name": c["name"], "model": c["model"],
                   "head_dim": c.get("head_dim"), "path": c.get("path"),
                   "dtype": dname,
                   "shape": c["shape"], "max_abs_err": err,
                   "max_abs_ref": scale, "rel_err": rel, "tol": tol,
                   "ok": bool(rel <= tol and math.isfinite(rel)
                              and math.isfinite(err)
                              and (same_rows is None or all(same_rows))),
                   "rows_equal_decode": same_rows,
                   # The plain version is a check, not a yardstick: the
                   # median of 3 launches (some take 0.1-0.4 s).
                   "ms": timer(c["kernel"]),
                   "plain_ms": timer(c["plain"], iters=3),
                   "library_ms": (timer(c["library"])
                                  if c["library"] is not None else None),
                   "cublas_ms": (timer(c["cublas"])
                                 if c["cublas"] is not None else None),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": c["nbytes"], "flops": c["flops"]}
            if "dense" in c:
                row.update(c["dense"], dense_bound_ms=bound(
                    c["dense"]["dense_bytes"], c["dense"]["dense_flops"],
                    dname)[0])
            emit(row)
            rows.append(row)
            if c["name"] in ("paged_attention", "paged_attention_q"):
                zero = out[3].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"{c['name']}: a length-0 slot "
                                         f"gave |out| up to {zero}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(f"{r['name']} {r['dtype']} "
                                         f"{r['shape']} rel {r['rel_err']} "
                                         f"rows {r['rows_equal_decode']}"
                                         for r in bad))
    return rows


def _same_rows(torch, fn, x, model, dname, name, counts):
    """Whether ``fn`` gives rows 0..3 (row 0 at a count of 1) the bits it
    gives them at 4 rows, at each row count; emitted as a row."""
    base = fn(x[:SLOTS].contiguous())
    same = {t: bool(torch.equal(fn(x[:t].contiguous())[:min(t, SLOTS)],
                                base[:min(t, SLOTS)]))
            for t in counts}
    row = {"phase": "row_invariance", "model": model, "dtype": dname,
           "call": name, "equal_to_T4": same,
           "required": "torch" not in name}
    emit(row)
    return row


def check_row_invariance(torch):
    """Bit-for-bit: rows 0..3 of each call on the kernel plan's path at T
    rows (8, 12, 20: verify windows of 2, 3 and 5 over 4 slots) against
    the same call at T = 4 (a decode step), at llama3's and gpt2's shapes,
    in bfloat16 and float32: the projection and FFN kernels and their int8
    twins, the o-projection (block_matmul), the final norm with the LM head
    (rmsnorm_matmul over the padded vocabulary; gpt2: block_matmul) and
    gpt2's LayerNorm (row_norm); granite-moe-3b's MoE stage at 1, 8,
    12, 20 and 64 rows (its parts and the whole); and zamba2's GELU GLU
    without a folded norm and its int8 twin.  Exact acceptance needs
    every one of them to pass (required; the MoE gate arithmetic is
    PyTorch's but on the path, so required too).  The eager plan's
    PyTorch calls at the same shapes (``torch.matmul``, PyTorch's norms)
    are reported beside them."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import padded_vocab
    out, bad = [], []
    widths = {"llama3-8b": (4096, 14336), "gpt2": (1024, 4096)}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(99)
        randn = _randn(torch, gen, dtype, "cuda")
        for model, (d, f) in widths.items():
            vocab = padded_vocab(get_config(model).vocab_size)
            x = randn(SPEC_T, d)
            s = randn(d, scale=0.1)
            w_o = randn(d, d, scale=1 / math.sqrt(d))
            w_k = randn(d, d // 4 if model == "llama3-8b" else d,
                        scale=1 / math.sqrt(d))
            wu = randn(d, f, scale=1 / math.sqrt(d))
            wg = randn(d, f, scale=1 / math.sqrt(d))
            wd = randn(f, d, scale=1 / math.sqrt(f))
            head = randn(d, vocab, scale=1 / math.sqrt(d))
            (ck, sk), (cg, sg), (cu, su), (cd, sd) = _w8(torch, w_k, wg, wu,
                                                         wd)
            calls = {"o_proj block_matmul": lambda a: K.block_matmul(a, w_o),
                     "o_proj torch.matmul": lambda a: torch.matmul(a, w_o),
                     "lm_head torch.matmul": lambda a: torch.matmul(a, head)}
            if model == "llama3-8b":
                calls.update({
                    "lm_head rmsnorm_matmul": (
                        lambda a: K.rmsnorm_matmul(a, s, head)),
                    "final rms_norm torch": lambda a: L.rms_norm(a, s),
                    "rmsnorm_matmul N=4096": (
                        lambda a: K.rmsnorm_matmul(a, s, w_o)),
                    "rmsnorm_matmul N=1024": (
                        lambda a: K.rmsnorm_matmul(a, s, w_k)),
                    "rmsnorm_matmul_w8 N=1024": (
                        lambda a: K.rmsnorm_matmul_w8(a, s, ck, w_scale=sk)),
                    "streamed_ffn": (
                        lambda a: K.streamed_ffn(a, wg, wu, wd,
                                                 norm_scale=s)),
                    "streamed_ffn_w8": (
                        lambda a: K.streamed_ffn_w8(
                            a, cg, cu, cd, wg_scale=sg, wu_scale=su,
                            wd_scale=sd, norm_scale=s))})
            else:
                calls.update({
                    "lm_head block_matmul": (
                        lambda a: K.block_matmul(a, head)),
                    "layer_norm row_norm": (
                        lambda a: K.layer_norm_rows(a, s, s)),
                    "layer_norm torch": lambda a: L.layer_norm(a, s, s),
                    "block_matmul": lambda a: K.block_matmul(a, w_k),
                    "streamed_mlp": lambda a: K.streamed_mlp(a, wu, wd),
                    "streamed_mlp_w8": (
                        lambda a: K.streamed_mlp_w8(a, cu, cd, wu_scale=su,
                                                    wd_scale=sd))})
            for name, fn in calls.items():
                row = _same_rows(torch, fn, x, model, dname, name,
                                 (2 * SLOTS, 3 * SLOTS, SPEC_T))
                out.append(row)
                if row["required"] and not all(row["equal_to_T4"].values()):
                    bad.append(f"{model} {dname} {name} "
                               f"{row['equal_to_T4']}")
        # granite-moe-3b's MoE stage at 1..64 rows: ln2 (the row-norm
        # kernel's RMSNorm mode), the router product (block_matmul), the
        # gate arithmetic (PyTorch's softmax, top-k threshold and row sum),
        # the experts (K12, on fixed gates) and the whole stage.
        from repro_torch.models.layers import gates_from_logits
        d, f, e = 1536, 512, 40
        x, wr, g, wg, wu, wd = _moe_inputs(torch, randn, 64, d, f, e, 8,
                                           dtype)
        s = randn(d, scale=0.1)

        def stage(a):
            h = K.rms_norm_rows(a, s)
            return K.moe_experts(h, gates_from_logits(
                K.block_matmul(h, wr), 8, a.dtype), wg, wu, wd)

        calls = {
            "rms_norm_rows": lambda a: K.rms_norm_rows(a, s),
            "router block_matmul": lambda a: K.block_matmul(a, wr),
            "moe gates (PyTorch ops)": lambda a: gates_from_logits(
                K.block_matmul(a, wr), 8, a.dtype),
            "moe_experts": lambda a: K.moe_experts(
                a, g[:a.shape[0]].contiguous(), wg, wu, wd),
            "moe stage": stage,
            "rms_norm torch": lambda a: L.rms_norm(a, s)}
        for name, fn in calls.items():
            row = _same_rows(torch, fn, x, GRANITE, dname, name,
                             (1, 2 * SLOTS, 3 * SLOTS, SPEC_T, 64))
            out.append(row)
            if row["required"] and not all(row["equal_to_T4"].values()):
                bad.append(f"{GRANITE} {dname} {name} {row['equal_to_T4']}")
        # zamba2's shared-block FFN: GELU, no folded norm, and its int8
        # twin.
        d, f = 2560, 10240
        x = randn(SPEC_T, d)
        wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
        calls = {
            "streamed_ffn gelu": lambda a: K.streamed_ffn(
                a, wg, wu, wd, activation="gelu"),
            "streamed_ffn_w8 gelu": lambda a: K.streamed_ffn_w8(
                a, cg, cu, cd, wg_scale=sg, wu_scale=su, wd_scale=sd,
                activation="gelu")}
        for name, fn in calls.items():
            row = _same_rows(torch, fn, x, ZAMBA, dname, name,
                             (2 * SLOTS, 3 * SLOTS, SPEC_T))
            out.append(row)
            if not all(row["equal_to_T4"].values()):
                bad.append(f"{ZAMBA} {dname} {name} {row['equal_to_T4']}")
    if bad:
        raise AssertionError("rows change with the row count: "
                             + "; ".join(bad))
    return out


# The split paged attention (K1, K8, K9a, K9b) at its edges: slots whose
# lengths sit on the page (16), tile (32) and partition (PAGED_PART)
# boundaries and at the extent, which ends in a partial partition.
SPLIT_MAXP = 20                   # 320 positions: partitions 128, 128, 64
SPLIT_HKV = 8
SPLIT_D = (64, 80, 128)           # 80: decode only (zamba2's shared block)
SPLIT_G = (1, 4)


def _identity_pages(torch, ref, kp, vp, sc, table):
    """The pools rearranged so that slot i's page j is page 1 + i maxp + j,
    with that identity table: the same K/V (and scales) at every position
    as ``table`` reads from ``kp`` / ``vp`` (fp8 codes moved as bytes)."""
    src = torch.cat([table.new_zeros(1), table.reshape(-1)]).long()
    ident = torch.arange(1, table.numel() + 1, dtype=torch.int32,
                         device=table.device).reshape(table.shape)
    scales = {k: v[src].contiguous() for k, v in sc.items()}
    kp, vp = (ref.code_view(t)[src].view(t.dtype).contiguous()
              for t in (kp, vp))
    return kp, vp, scales, ident


def _split_case(torch, K, ref, timer, randn, gen, dtype, d, g, code, w,
                dev="cuda"):
    """One decode (w = 1) or verify call over slots at the edge lengths
    (verify: row 0 sees them): the required checks and the measurements,
    as one row."""
    from repro_torch.kernels.common import PAGED_PART, cdiv
    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    part, ps = PAGED_PART, 16
    extent = SPLIT_MAXP * ps
    lens = [0, 1, 15, 16, 17, part - 1, part, part + 1, extent]
    b, hkv, hq = len(lens), SPLIT_HKV, SPLIT_HKV * g
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b,
                                               SPLIT_MAXP, hkv, d, code, dev)
    q = randn(b, w, hq, d)
    if w == 1:
        base = lens
        fn = K.paged_decode_attention if code is None \
            else K.paged_decode_attention_q
        plain = ref.paged_decode_attention
    else:
        base = [n - 1 for n in lens[:-1]] + [extent - w]
        fn = K.paged_verify_attention if code is None \
            else K.paged_verify_attention_q
        plain = ref.paged_verify_attention
    decode = K.paged_decode_attention if code is None \
        else K.paged_decode_attention_q
    bt = torch.tensor(base, dtype=torch.int32, device=dev)
    call = lambda: fn(q, kp, vp, table, bt, **sc)
    out, again = call(), call()
    want = plain(q, kp, vp, table, bt, **sc)
    _sync(torch, dev)
    rel = _rel(out.float(), want.float())
    checks = {"repeat": bool(torch.equal(out, again)),
              "zero_row": not bool(out[0, 0].any())}
    if w > 1:
        checks["rows_equal_decode"] = all(
            bool(torch.equal(out[:, i:i + 1], decode(
                q[:, i:i + 1].contiguous(), kp, vp, table, bt + i + 1,
                **sc))) for i in range(w))
    checks["alone_equal_batch"] = all(
        bool(torch.equal(fn(q[i:i + 1], kp, vp, table[i:i + 1].contiguous(),
                            bt[i:i + 1], **sc), out[i:i + 1]))
        for i in range(b))
    ikp, ivp, isc, itable = _identity_pages(torch, ref, kp, vp, sc, table)
    checks["identity_equal_shuffled"] = bool(torch.equal(
        fn(q, ikp, ivp, itable, bt, **isc), out))
    deepest = [min(max(n + (w > 1) + w - 1, 0), extent) for n in base]
    live_kv = sum(deepest) * hkv * d * 2
    nbytes = (2 * q.numel() * isz + live_kv * (per_elem or isz)
              + table.numel() * 4 + b * 4)
    ms = timer(call)
    row = {"phase": "paged_split", "name": fn.__name__, "dtype": dname,
           "head_dim": d, "group": g, "window": w, "codes": code,
           "lengths" if w == 1 else "q_off": base, "rel_err": rel,
           "tol": TOL[dname], **checks,
           "ok": bool(rel <= TOL[dname] and math.isfinite(rel)
                      and all(checks.values())),
           "ms": ms, "bytes": nbytes, "hbm_gb_s": nbytes / ms / 1e6,
           "live_blocks": sum(hkv * cdiv(n, part) for n in deepest),
           "grid_blocks": b * hkv * cdiv(extent, part)}
    emit(row)
    return row


def check_paged_split(torch, timer, dev="cuda"):
    """The ``paged_split`` phase (see the module docstring); raises when a
    required check fails."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(2222)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        randn = _randn(torch, gen, dtype, dev)
        for d in SPLIT_D:
            for g in SPLIT_G:
                for code in (None,) + CODES:
                    for w in ((1,) if d == 80 else (1, WINDOW)):
                        rows.append(_split_case(torch, K, ref, timer, randn,
                                                gen, dtype, d, g, code, w,
                                                dev))
    bad = [f"{r['name']} {r['dtype']} D={r['head_dim']} G={r['group']} "
           f"W={r['window']} codes={r['codes']} rel {r['rel_err']}"
           for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("split paged attention: " + "; ".join(bad))
    return rows


# The tensor-core kernels (bf16) beyond the paths' own shapes: K7 at its
# 64-row / 64-key tile edges and at long prompts, over head dims and GQA
# groups; K5 in every tile class (1-16, 17-64 and more rows), splitting and
# not, at each path's (K, N), and through its scalar loads (K and N not
# multiples of 8; an x at an odd address).
TC_FLASH_S = (1, 37, 63, 64, 65, 999, 1000, 2048)
TC_FLASH_D = (64, 80, 128)
TC_FLASH_GROUPS = (1, 3, 4)
# Non-causal K7 with keys past kv_len: (head dim, GQA group, S, kv_len);
# kv_len 0 gives zero rows.
TC_NONCAUSAL_KV_LEN = ((80, 1, 1000, 937), (64, 4, 65, 1),
                       (128, 3, 2048, 1500), (80, 1, 37, 0))
TC_MATMUL_M = (1, 4, 16, 17, 64, 65, 128, 992, 8192)
# gpt2's projections and LM head, llama3's o-projection, granite-3b's
# router and o-projection, zamba2's o-projection, rwkv6's LM head; an
# unaligned shape.
TC_MATMUL_KN = ((1024, 1024), (1024, 50432), (4096, 4096), (1536, 40),
                (1536, 1536), (2560, 2560), (4096, 65536), (1000, 1001))


def _tc_row(torch, timer, case, dname="bfloat16"):
    """One tensor-core case: max error against the plain version, two
    calls bit-equal (required: no atomics sum values), kernel / plain /
    library times and the bound; the error by the case's own ``rel`` and
    ``tol`` where it has them (streamed_xent's, in nats), each output on
    its own scale where it has ``parts`` (K13's y and state)."""
    got, again, want = case["kernel"](), case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    if "rel" in case:
        rel = case["rel"](got, want)
    elif case.get("parts"):          # each output against its own scale
        rel = max(_rel(a.float(), b.float()) for a, b in zip(got, want))
    else:
        rel = _rel(got.float(), want.float())
    tol = case.get("tol", TOL[dname])
    got, again = _flat(torch, got), _flat(torch, again)
    same = bool(torch.equal(got, again))
    bound_ms, bound_by = bound(case["nbytes"], case["flops"], dname)
    row = {"phase": "tensorcore", "name": case["name"],
           "shape": case["shape"], "dtype": dname, "rel_err": rel,
           "tol": tol, "deterministic": same,
           "ok": bool(rel <= tol and math.isfinite(rel) and same),
           "ms": timer(case["kernel"]),
           "plain_ms": timer(case["plain"], iters=3),
           "library_ms": (timer(case["library"])
                          if case["library"] is not None else None),
           "bound_ms": bound_ms, "bound_by": bound_by,
           **case.get("extra", {})}
    emit(row)
    return row


# K2 (the offset branch, chunked prefill) at its 64-row / 64-key tile edges:
# query offsets, chunk rows, head dims, GQA groups; K7 and K2 also at a
# negative and a zero scale.
TC_OFFSET_Q = (0, 63, 64, 65, 896)
TC_OFFSET_ROWS = (1, 37, 64, 128)
TC_OFFSET_D = (64, 128)
TC_OFFSET_GROUPS = (1, 4)
# The streamed FFN (K4, K6, K10b, K10c) on the tensor cores: the fused
# launch at 1..64 rows, the two passes above; each instance at its path's
# (D, F), and every instance at an unaligned shape.
TC_FFN_T = (1, 4, 16, 17, 20, 64, 65, 128, 1000, 4096)
TC_FFN_WIDTHS = {"llama3-8b": (4096, 14336), ZAMBA: (2560, 10240),
                 "gpt2": (1024, 4096)}
TC_FFN_UNALIGNED = ((1000, 1001), (4, 128))   # (D, F), rows


def _ffn_instances(torch, K, ref, randn, d, f):
    """The six bf16 FFN instances at (d, f): name -> (model, label, kernel
    fn, plain fn, weight bytes, flops per row) for x [T, d]; weights drawn
    once (the int8 twins' codes quantized from them per output channel)."""
    wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    s = randn(d, scale=0.1)
    (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
    q8 = dict(wg_scale=sg, wu_scale=su, wd_scale=sd)
    glu, mlp = 3 * d * f, 2 * d * f
    return {
        "streamed_ffn": ("llama3-8b", "silu, folded norm",
                         lambda x: K.streamed_ffn(x, wg, wu, wd,
                                                  norm_scale=s),
                         lambda x: ref.streamed_ffn(x, wg, wu, wd,
                                                    norm_scale=s),
                         2 * (glu + d), 6 * d * f),
        "streamed_ffn_w8": ("llama3-8b", "silu, folded norm, int8",
                            lambda x: K.streamed_ffn_w8(
                                x, cg, cu, cd, norm_scale=s, **q8),
                            lambda x: ref.streamed_ffn_w8(
                                x, cg, cu, cd, norm_scale=s, **q8),
                            glu + 2 * d + 4 * (2 * f + d), 6 * d * f),
        "streamed_ffn gelu": (ZAMBA, "gelu",
                              lambda x: K.streamed_ffn(x, wg, wu, wd,
                                                       activation="gelu"),
                              lambda x: ref.streamed_ffn(
                                  x, wg, wu, wd, activation="gelu"),
                              2 * glu, 6 * d * f),
        "streamed_ffn_w8 gelu": (ZAMBA, "gelu, int8",
                                 lambda x: K.streamed_ffn_w8(
                                     x, cg, cu, cd, activation="gelu",
                                     **q8),
                                 lambda x: ref.streamed_ffn_w8(
                                     x, cg, cu, cd, activation="gelu",
                                     **q8),
                                 glu + 4 * (2 * f + d), 6 * d * f),
        "streamed_mlp": ("gpt2", "gelu",
                         lambda x: K.streamed_mlp(x, wu, wd),
                         lambda x: ref.streamed_mlp(x, wu, wd),
                         2 * mlp, 4 * d * f),
        "streamed_mlp_w8": ("gpt2", "gelu, int8",
                            lambda x: K.streamed_mlp_w8(
                                x, cu, cd, wu_scale=su, wd_scale=sd),
                            lambda x: ref.streamed_mlp_w8(
                                x, cu, cd, wu_scale=su, wd_scale=sd),
                            mlp + 4 * (f + d), 4 * d * f)}


def _ffn_tc_rows(torch, timer, K, ref, randn, sms):
    """Every bf16 FFN instance at ``TC_FFN_T`` rows at its path's (D, F)
    and at ``TC_FFN_UNALIGNED``, against its plain version (``TOL``) and
    deterministic; each instance's rows at 1..64 rows equal its rows at 64
    (required: the fused launch's row invariance)."""
    from repro_torch.kernels.common import ROW_INVARIANT_T, ffn_plan
    rows, same = [], []
    for (d, f), ts in [(TC_FFN_WIDTHS[m], TC_FFN_T) for m in TC_FFN_WIDTHS
                       ] + [TC_FFN_UNALIGNED]:
        insts = _ffn_instances(torch, K, ref, randn, d, f)
        aligned = (d, f) != TC_FFN_UNALIGNED[0]
        for name, (model, label, kern, plain, wbytes, fl) in insts.items():
            if aligned and TC_FFN_WIDTHS[model] != (d, f):
                continue
            for t in ts:
                x = randn(t, d)
                mode, f_per_split, splits = ffn_plan(t, d, f, sms)
                rows.append(_tc_row(torch, timer, dict(
                    name=name.split()[0], shape=f"{model} {label} T={t},"
                    f"D={d},F={f}" + ("" if aligned else ",unaligned"),
                    kernel=lambda x=x, k=kern: k(x),
                    plain=lambda x=x, p=plain: p(x), library=None,
                    nbytes=wbytes + 2 * 2 * t * d, flops=fl * t,
                    extra={"mode": ("fused", "two-pass")[mode],
                           "f_per_split": f_per_split, "splits": splits})))
            if not aligned:
                continue
            bad = _unequal_row_counts(torch, kern, randn(ROW_INVARIANT_T, d))
            row = {"phase": "tensorcore_rows", "name": name, "model": model,
                   "D": d, "F": f, "equal_1_to_64": not bad,
                   "unequal_at": bad[:8]}
            emit(row)
            same.append(row)
    return rows, same


# K3 and its int8 twin K10a on the tensor cores: one launch up to 64 rows,
# a row pass and the Large class above; (D, N) of each path's q/k/v
# projections and LM head (K10a: q/k/v only, the LM head is never int8),
# and an unaligned shape.  K11 at each training path's step, at 1000 tokens
# (a partial token tile), at a padded vocabulary that is not a whole number
# of 128-column tiles with labels on its padded columns, and unaligned.
TC_NORM_T = (1, 4, 16, 17, 20, 64, 65, 128, 1000, 4096)
TC_NORM_DN = {"llama3-8b": ((4096, 4096), (4096, 1024), (4096, 128256)),
              GRANITE: ((1536, 1536), (1536, 512), (1536, 49408)),
              ZAMBA: ((2560, 2560), (2560, 32000)),
              GRANITE_TRAIN: ((1024, 1024), (1024, 512))}
TC_NORM_UNALIGNED = (1000, 1001)
TC_LM_HEAD_N = 10000     # N above this: an LM head
TC_XENT = (("gpt2", 8192, 1024, 50432, 50257),
           ("llama3-8b", 4096, 4096, 128256, 128256),
           (GRANITE_TRAIN, 4096, 1024, 49408, 49155),
           (ZAMBA, 4096, 2560, 32000, 32000),
           (RWKV, 4096, 4096, 65536, 65536),
           ("partial token tile", 1000, 1024, 50432, 50257),
           ("padded vocabulary", 512, 1024, 50264, 50257),
           ("unaligned", 300, 1000, 1001, 999))


def _norm_tc_rows(torch, timer, K, ref, randn, sms):
    """bf16 K3 and K10a at ``TC_NORM_T`` rows at each path's (D, N) and at
    ``TC_NORM_UNALIGNED``, against their plain versions (``TOL``),
    deterministic, against ``F.rms_norm`` + ``torch.matmul``; each
    serving shape's rows at 1..64 rows equal its rows at 64 (required:
    the one-launch classes' row invariance, q/k/v and the LM head)."""
    from repro_torch.kernels.common import ROW_INVARIANT_T, mma_plan
    rows, same = [], []
    shapes = [(m, dn) for m, dns in TC_NORM_DN.items() for dn in dns]
    for model, (d, n) in shapes + [("unaligned", TC_NORM_UNALIGNED)]:
        w = randn(d, n, scale=1 / math.sqrt(d))
        s = randn(d, scale=0.1)
        insts = {"rmsnorm_matmul": (
            lambda x: K.rmsnorm_matmul(x, s, w),
            lambda x: ref.rmsnorm_matmul(x, s, w), w, 2 * d * n)}
        if n < TC_LM_HEAD_N:
            (c, ws), = _w8(torch, w)
            wq = (c.float() * ws).to(torch.bfloat16)
            insts["rmsnorm_matmul_w8"] = (
                lambda x: K.rmsnorm_matmul_w8(x, s, c, w_scale=ws),
                lambda x: ref.rmsnorm_matmul_w8(x, s, c, ws), wq,
                d * n + 4 * n)
        for name, (kern, plain, wl, wbytes) in insts.items():
            for t in TC_NORM_T:
                x = randn(t, d)
                _, _, k_per_split, splits = mma_plan(t, d, n, sms)
                rows.append(_tc_row(torch, timer, dict(
                    name=name, shape=f"{model} T={t},D={d},N={n}",
                    kernel=lambda x=x, k=kern: k(x),
                    plain=lambda x=x, p=plain: p(x),
                    library=_rms_library(torch, x, s, wl),
                    nbytes=wbytes + 2 * (t * d + d + t * n),
                    flops=2 * t * d * n,
                    extra={"k_per_split": k_per_split, "splits": splits})))
            if model in ("unaligned", GRANITE_TRAIN):
                continue        # on no serving path
            bad = _unequal_row_counts(torch, kern, randn(ROW_INVARIANT_T, d))
            row = {"phase": "tensorcore_rows", "name": name, "model": model,
                   "D": d, "N": n, "equal_1_to_64": not bad,
                   "unequal_at": bad[:8]}
            emit(row)
            same.append(row)
    return rows, same


# K11's error: the largest |kernel - plain| in nats over lse and the finite
# golds (both in the log domain; lse is about log V, so an error relative to
# it would hide a wrong sum).  The runs read at most 2e-5 nats (bf16, llama3
# at T 4096) and 2e-6 (float32).  A sum over llama3-8b's vocabulary that
# missed one 128-column tile would be off by 1e-3, one that took in gpt2's
# 175 padded columns by 3.5e-3, and one that took in the ``tensorcore``
# phase's padded columns (weights 8x the real ones) by nats.
XENT_TOL_NATS = 5e-4


def _xent_err(got, want) -> float:
    """K11's error in nats (``XENT_TOL_NATS``); a masked gold (-1e30, a
    label on a padded column) must be masked in both, else inf."""
    (lse, gold), (w_lse, w_gold) = got, want
    masked = w_gold <= -1e29
    if not bool(((gold <= -1e29) == masked).all()):
        return math.inf
    err = (lse.double() - w_lse.double()).abs().max().item()
    if not bool(masked.all()):
        err = max(err, (gold[~masked].double() - w_gold[~masked].double()
                        ).abs().max().item())
    return err


def _xent_head(torch, randn, d, vp, vocab):
    """A head [d, vp] for the ``tensorcore`` phase's K11 rows: the padded
    columns (``v >= vocab``) 8x the real ones, so their logits stand far
    above the real ones' logsumexp and a sum that let them in is nats
    off."""
    w = randn(d, vp, scale=1 / math.sqrt(d))
    w[:, vocab:] *= 8
    return w


def _xent_tc_rows(torch, timer, K, ref, randn, gen, sms):
    """bf16 K11 at ``TC_XENT``'s shapes (about 10% of the labels ignored,
    passed clamped to 0; where Vp > vocab, 1% on its padded columns, whose
    weights ``_xent_head`` makes large) against its plain version (in
    nats: ``_xent_err``), deterministic, against ``h @ W``, ``logsumexp``
    and ``gather``."""
    from repro_torch.kernels.streamed_xent import xent_mma_plan
    rows = []
    for label, t, d, vp, vocab in TC_XENT:
        h = randn(t, d)
        w = _xent_head(torch, randn, d, vp, vocab)
        y = torch.randint(0, vocab, (t,), generator=gen, device="cuda",
                          dtype=torch.int32)
        y = torch.where(torch.rand(t, generator=gen, device="cuda") < 0.1,
                        0, y)
        if vp > vocab:
            pad = torch.randint(vocab, vp, (t,), generator=gen,
                                device="cuda", dtype=torch.int32)
            y = torch.where(torch.rand(t, generator=gen, device="cuda")
                            < 0.01, pad, y)
        y = y.to(torch.int32)

        def library(h=h, w=w, y=y, vocab=vocab):
            logits = (h @ w)[:, :vocab].float()
            return (torch.logsumexp(logits, dim=-1),
                    logits.gather(1, y.clamp(max=vocab - 1).long()[:, None]
                                  )[:, 0])

        per, splits = xent_mma_plan(t, vp, sms)
        rows.append(_tc_row(torch, timer, dict(
            rel=_xent_err, tol=XENT_TOL_NATS,
            name="streamed_xent",
            shape=f"{label} T={t},D={d},Vp={vp},vocab={vocab}",
            kernel=lambda h=h, w=w, y=y, v=vocab: K.streamed_xent_parts(
                h, w, y, vocab_size=v),
            plain=lambda h=h, w=w, y=y, v=vocab: ref.xent_parts_ref(
                h, w, y, v),
            library=library, nbytes=(t * d + d * vp) * 2 + 3 * t * 4,
            flops=2 * t * d * vp,
            extra={"tiles_per_split": per, "splits": splits})))
    return rows


# K12 (``moe_experts``) in bf16 on the tensor cores: the fused launch at
# 1..64 rows, the two passes above; granite-3b's and granite-1b's (D, F, E)
# with the router's top-8 gates, and at granite-3b's widths the adversarial
# routings of ``_moe_routings`` at a decode step, a verify dispatch, a
# prefill chunk and a whole prompt.
TC_MOE_T = (1, 4, 16, 17, 20, 64, 65, 128, 1000, 4096)
TC_MOE_WIDTHS = {GRANITE: (1536, 512, 40), GRANITE_TRAIN: (1024, 512, 32)}
TC_MOE_ROUTED_T = (4, SPEC_T, 128, 1000)
TC_MOE_TOP_K = 8


def _moe_cases(torch, dtype):
    """K12's ``tensorcore`` cases, (model, routing, T, x, gates, wg, wu,
    wd): ``TC_MOE_T`` rows at each width with the router's gates, and at
    granite-3b's widths the other routings of ``_moe_routings`` at
    ``TC_MOE_ROUTED_T``; inputs drawn per case from a seed of (T, D, E), so
    that another tree's kernel gets the same tensors (``chip_phases.py
    moe``)."""
    for model, (d, f, e) in TC_MOE_WIDTHS.items():
        for t in TC_MOE_T:
            routings = (MOE_ROUTINGS if model == GRANITE
                        and t in TC_MOE_ROUTED_T else ("router",))
            for routing in routings:
                gen = torch.Generator(device="cuda").manual_seed(
                    t * 1_000_003 + d * 1009 + e)
                x, wr, _, wg, wu, wd = _moe_inputs(
                    torch, _randn(torch, gen, dtype, "cuda"), t, d, f, e,
                    TC_MOE_TOP_K, dtype)
                g = _moe_routings(torch, x, wr, TC_MOE_TOP_K,
                                  dtype)[routing]
                yield model, routing, t, x, g, wg, wu, wd


def _moe_tc_case(torch, K, ref, model, routing, t, x, g, wg, wu, wd):
    """One K12 case of ``_moe_cases``: each K12 call under ``_no_sync``;
    held to the plain version row by row (``_row_rel``: a row of tiny
    gates on its own scale) and to the library chain; bound from the kept
    pairs."""
    from repro_torch.kernels.common import moe_plan
    d, f, e = TC_MOE_WIDTHS[model]
    kept = g != 0
    pairs, touched = int(kept.sum()), int(kept.any(0).sum())
    mode, f_per_split, splits = moe_plan(t, f)
    library = _moe_library(torch, x, g, wg, wu, wd)
    return dict(
        name="moe_experts", shape=f"{model} {routing} T={t},D={d},F={f},"
        f"E={e}",
        kernel=lambda: _no_sync(torch, lambda: K.moe_experts(x, g, wg, wu,
                                                             wd)),
        plain=lambda: ref.moe_experts(x, g, wg, wu, wd),
        library=lambda: _moe_library(torch, x, g, wg, wu, wd),
        rel=_row_rel, nbytes=(2 * t * d + t * e + 3 * touched * d * f) * 2,
        flops=6 * d * f * pairs,
        extra={"mode": ("fused", "two-pass")[mode],
               "f_per_split": f_per_split, "splits": splits,
               "gate_pairs": pairs, "experts_touched": touched,
               "library_rel_err": _rel(library.float(),
                                       ref.moe_experts(x, g, wg, wu,
                                                       wd).float())})


def _moe_tc_rows(torch, timer, K, ref, randn):
    """K12 at ``_moe_cases``, each within ``TOL`` of its plain version row
    by row, within ``TOL`` of the library chain (which rounds y to bf16 per
    expert), deterministic, no host sync; rows at 1..64 equal their rows
    at 64 (router gates at both widths, and every token on the same
    experts), required."""
    from repro_torch.kernels.common import ROW_INVARIANT_T
    rows, same = [], []
    for case in _moe_cases(torch, torch.bfloat16):
        rows.append(_tc_row(torch, timer, _moe_tc_case(torch, K, ref,
                                                       *case)))
    for r in rows:
        r["ok"] = bool(r["ok"] and r["library_rel_err"] <= TOL["bfloat16"])
    for model, routing in ((GRANITE, "router"), (GRANITE_TRAIN, "router"),
                           (GRANITE, "all on experts 0..k-1")):
        d, f, e = TC_MOE_WIDTHS[model]
        x, wr, _, wg, wu, wd = _moe_inputs(torch, randn, ROW_INVARIANT_T, d,
                                           f, e, TC_MOE_TOP_K,
                                           torch.bfloat16)
        g = _moe_routings(torch, x, wr, TC_MOE_TOP_K,
                          torch.bfloat16)[routing]
        full = K.moe_experts(x, g, wg, wu, wd)
        bad = [t for t in range(1, ROW_INVARIANT_T)
               if not torch.equal(K.moe_experts(
                   x[:t].contiguous(), g[:t].contiguous(), wg, wu, wd),
                   full[:t])]
        row = {"phase": "tensorcore_rows", "name": "moe_experts",
               "model": model, "routing": routing, "D": d, "F": f, "E": e,
               "equal_1_to_64": not bad, "unequal_at": bad[:8]}
        emit(row)
        same.append(row)
    return rows, same


# K9c (the offset branch over int8 / fp8 codes) on the tensor cores: K2's
# offsets and rows at head dim 64 (GQA groups 1 and 3: gpt2, granite-3b)
# and 128 (group 4: llama3), each code; its yardstick SDPA with the offset
# mask on K/V dequantized outside the timing.
TC_OFFSET_Q_DG = ((64, 1), (64, 3), (128, 4))
# ... and its main paths' chunks (128 rows at offset 896): (Hq, Hkv, D,
# gathered extent) of llama3-8b, gpt2 and granite-moe-3b.
TC_OFFSET_Q_PATHS = ((32, 8, 128, 2048), (16, 16, 64, 1024),
                     (24, 8, 64, 2048))


def page_extent(n: int) -> int:
    """A gathered extent over ``n`` positions: whole 16-token pages (the
    code pools' scale granule) with one page past them."""
    return -(-n // 16) * 16 + 16


def _flash_q_tc_rows(torch, timer, K, ref, randn):
    """K9c at its paths' chunks (``TC_OFFSET_Q_PATHS``) and at
    ``TC_OFFSET_Q`` x ``TC_OFFSET_ROWS`` x ``TC_OFFSET_Q_DG`` (2 KV heads,
    over ``page_extent`` positions), each code, each within ``TOL`` of its
    plain version and deterministic; then ``tensorcore_offset_q``
    (required): at each code and (D, G) of the sweep but G = 1, the rows
    of every swept (q_offset, rows) chunk equal, bit for bit, the rows at
    the same positions of one chunk from offset 0 over the whole extent."""
    rows, same = [], []
    for code in CODES:
        for hq, hkv, d, skv in TC_OFFSET_Q_PATHS:
            rows.append(_tc_row(torch, timer, _flash_case(
                torch, K, ref, randn, 2, "flash_attention_q", hq, hkv, d,
                128, skv, 896, "cuda", code)))
        for d, g in TC_OFFSET_Q_DG:
            for q_off in TC_OFFSET_Q:
                for sq in TC_OFFSET_ROWS:
                    skv = page_extent(q_off + sq)
                    rows.append(_tc_row(torch, timer, _flash_case(
                        torch, K, ref, randn, 2, "flash_attention_q",
                        2 * g, 2, d, sq, skv, q_off, "cuda", code)))
    top = max(TC_OFFSET_Q) + max(TC_OFFSET_ROWS)
    skv = page_extent(top)
    for code in CODES:
        for d, g in TC_OFFSET_Q_DG[1:]:
            q = randn(2 * g, top, d)
            (k, ks), (v, vs) = (_encode(torch, randn(2, skv, d).float(),
                                        code, 1) for _ in range(2))
            kw = dict(k_scale=ks, v_scale=vs, kv_group=g)
            whole = K.flash_attention_2d_q(q, k, v, q_offset=0, kv_len=top,
                                           **kw)
            for q_off in TC_OFFSET_Q:
                for sq in TC_OFFSET_ROWS:
                    n = q_off + sq
                    chunk = K.flash_attention_2d_q(
                        q[:, q_off:n].contiguous(), k, v, q_offset=q_off,
                        kv_len=n, **kw)
                    row = {"phase": "tensorcore_offset_q", "codes": code,
                           "head_dim": d, "group": g, "q_offset": q_off,
                           "rows": sq, "equal": bool(torch.equal(
                               chunk, whole[:, q_off:n]))}
                    emit(row)
                    same.append(row)
    return rows, same


# K13 (the SSD scan) on the tensor cores: whole prompts at batch 1 over
# the model's chunks (37: one chunk; 64, 65: the segment edge; 289: Q 1;
# 999: Q 1; 1000: Q 8) and a training step's 2 x 2048.
TC_SSD_S = (1, 37, 64, 65, 289, 999, 1000)


def _ssd_tc_rows(torch, timer, K, ref, randn):
    """K13 at ``TC_SSD_S`` (batch 1) and 2 x 2048, y and the final state
    each within ``TOL`` of the plain version on its own scale, each
    deterministic; then ``tensorcore_ssd`` (required, bit for bit): rows
    0..999 of a 2048-token sequence equal the 1000-token sequence's; the
    same 1000 tokens at Q = 1 and Q = 8 give the same y and state; a
    sequence alone gives the y and state it gets in a batch of 2."""
    isz = 2
    rows, same = [], []
    shapes = [(1, s) for s in TC_SSD_S] + [TRAIN_SHAPES[ZAMBA]]
    for b, s in shapes:
        rows.append(_tc_row(torch, timer, _ssd_case(
            torch, K, ref, randn, isz, b, s, None)))
    x, dt, a_log, bm, cm, d = _ssd_case(torch, K, ref, randn, isz, 2, 2048,
                                        None)["args"]

    def scan(lo, hi, n, q):   # sequences lo..hi-1, their first n tokens
        cut = [t[lo:hi, :n].contiguous() for t in (x, dt, bm, cm)]
        return K.mamba2_ssd(cut[0], cut[1], a_log, cut[2], cut[3], d,
                            chunk=q)

    full, q8, q1 = scan(0, 1, 2048, 128), scan(0, 1, 1000, 8), scan(
        0, 1, 1000, 1)
    pair, alone = scan(0, 2, 1000, 8), scan(1, 2, 1000, 8)
    checks = {
        "prefix 1000 of 2048": torch.equal(full[0][:, :1000], q8[0]),
        "Q 1 and Q 8": all(torch.equal(a, b) for a, b in zip(q8, q1)),
        "alone and in a batch of 2": all(
            torch.equal(a, b[1:]) for a, b in zip(alone, pair))}
    for name, ok in checks.items():
        row = {"phase": "tensorcore_ssd", "check": name, "equal": bool(ok)}
        emit(row)
        same.append(row)
    return rows, same


# K14 (the wkv recurrence) on the tensor cores: whole prompts at batch 1
# around the 16-token sub-block and 64-token segment edges (1, 15, 16, 17,
# 64, 65), a prompt of one partial segment (37), two whole segments (128),
# the model's chunk 1 (999) and 8 (1000), and a training step's 2 x 2048;
# the other head sizes the kernels take, at 8 heads over 200 tokens.
TC_WKV_S = (1, 15, 16, 17, 37, 64, 65, 128, 999, 1000)
TC_WKV_N = (16, 32, 128)


def _wkv_tc_rows(torch, timer, K, ref, randn):
    """K14 at ``TC_WKV_S`` (batch 1) and 2 x 2048, and at ``TC_WKV_N``, y
    and the final state each within ``TOL`` of the plain version on its
    own scale, each deterministic; then ``tensorcore_wkv`` (required, bit for bit): rows
    0..999 of a 2048-token sequence equal the 1000-token sequence's; the
    same 1000 tokens at chunk 1 and chunk 8 give the same y and state; a
    sequence alone gives the y and state it gets in a batch of 2."""
    isz = 2
    rows, same = [], []
    shapes = [(1, s) for s in TC_WKV_S] + [TRAIN_SHAPES[RWKV]]
    for b, s in shapes:
        rows.append(_tc_row(torch, timer, _wkv_case(
            torch, K, ref, randn, isz, b, s, None)))
    for n in TC_WKV_N:
        rows.append(_tc_row(torch, timer, _wkv_case(
            torch, K, ref, randn, isz, 1, 200, None, h=8, n=n)))
    r, k, v, w, u = _wkv_case(torch, K, ref, randn, isz, 2, 2048,
                              None)["args"]

    def scan(lo, hi, n, q):   # sequences lo..hi-1, their first n tokens
        cut = [t[lo:hi, :n].contiguous() for t in (r, k, v, w)]
        return K.wkv6(*cut, u, chunk=q)

    full, q8, q1 = scan(0, 1, 2048, 64), scan(0, 1, 1000, 8), scan(
        0, 1, 1000, 1)
    pair, alone = scan(0, 2, 1000, 8), scan(1, 2, 1000, 8)
    checks = {
        "prefix 1000 of 2048": torch.equal(full[0][:, :1000], q8[0]),
        "chunk 1 and chunk 8": all(torch.equal(a, b)
                                   for a, b in zip(q8, q1)),
        "alone and in a batch of 2": all(
            torch.equal(a, b[1:]) for a, b in zip(alone, pair))}
    for name, ok in checks.items():
        row = {"phase": "tensorcore_wkv", "check": name, "equal": bool(ok)}
        emit(row)
        same.append(row)
    return rows, same


def check_tensorcore(torch, timer):
    """K7 (``flash_attention_static``), K2 (the offset branch of
    ``flash_attention_2d``), K5 (``block_matmul``), the streamed FFN (K4,
    K6, K10b, K10c), K3 and K10a (``rmsnorm_matmul``, ``_w8``) and K11
    (``streamed_xent_parts``) in bf16 on the tensor cores at ``TC_*``'s
    shapes (2 KV heads for K7 and K2), each against its plain version
    (``TOL``) and its library call or chain (SDPA, with the offset mask
    for K2; ``torch.matmul``; ``F.rms_norm`` + ``torch.matmul``; ``h @
    W``, ``logsumexp``, ``gather``), each deterministic; K7's
    prefix property (required): rows 0..999 of a 2048-token prompt equal
    the 1000-token prompt's, bit for bit, at each head dim (GQA group 4);
    K2's rows equal K7's rows at the same positions of the whole prompt,
    bit for bit, at every swept offset, row count and head dim
    (``tensorcore_offset``, required); the FFN's, K3's, K10a's and K12's
    rows equal at 1..64 rows (``tensorcore_rows``, required); K12
    (``moe_experts``) at ``TC_MOE_*`` (``_moe_tc_rows``); K9c
    (``flash_attention_2d_q``) at K2's offsets and rows over int8 and fp8
    codes, with its chunks' rows equal to one chunk's from offset 0
    (``_flash_q_tc_rows``, required); K13 (``mamba2_ssd``) at
    ``TC_SSD_S`` and 2 x 2048, bit for bit across prompt lengths, chunks
    and batches (``_ssd_tc_rows``, required); K14 (``wkv6``) at
    ``TC_WKV_S`` and 2 x 2048, likewise (``_wkv_tc_rows``, required)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import mma_plan, sm_count
    gen = torch.Generator(device="cuda").manual_seed(2020)
    randn = _randn(torch, gen, torch.bfloat16, "cuda")
    rows, prefix, offset = [], [], []
    for s in TC_FLASH_S:
        for d in TC_FLASH_D:
            for g in TC_FLASH_GROUPS:
                rows.append(_tc_row(torch, timer, _flash_case(
                    torch, K, ref, randn, 2, "flash_attention_static",
                    2 * g, 2, d, s, s, None, "cuda")))
    # K7 non-causal (hubert's encoder, MHA), and with keys past kv_len.
    for s in TC_FLASH_S:
        for d in TC_FLASH_D:
            rows.append(_tc_row(torch, timer, _flash_case(
                torch, K, ref, randn, 2, "flash_attention_static", 2, 2, d,
                s, s, None, "cuda", causal=False)))
    for d, g, s, kv_len in TC_NONCAUSAL_KV_LEN:
        rows.append(_tc_row(torch, timer, _flash_case(
            torch, K, ref, randn, 2, "flash_attention_static", 2 * g, 2, d,
            s, s, None, "cuda", causal=False, kv_len=kv_len)))
    for q_off in TC_OFFSET_Q:
        for sq in TC_OFFSET_ROWS:
            for d in TC_OFFSET_D:
                for g in TC_OFFSET_GROUPS:
                    rows.append(_tc_row(torch, timer, _flash_case(
                        torch, K, ref, randn, 2, "flash_attention", 2 * g, 2,
                        d, sq, q_off + sq, q_off, "cuda")))
    for scale in (-0.125, 0.0):
        rows.append(_tc_row(torch, timer, _flash_case(
            torch, K, ref, randn, 2, "flash_attention_static", 8, 2, 128,
            1000, 1000, None, "cuda", scale=scale)))
        rows.append(_tc_row(torch, timer, _flash_case(
            torch, K, ref, randn, 2, "flash_attention", 8, 2, 128, 128,
            1024, 896, "cuda", scale=scale)))
    # K2 against K7 over the whole prompt: K/V gathered a few positions
    # past kv_len (masked), as the cache gather leaves them.
    for d in TC_OFFSET_D:
        top = max(TC_OFFSET_Q) + max(TC_OFFSET_ROWS)
        q, k, v = randn(8, top, d), randn(2, top + 7, d), randn(2, top + 7, d)
        for q_off in TC_OFFSET_Q:
            for sq in TC_OFFSET_ROWS:
                n = q_off + sq
                whole = K.flash_attention_2d(
                    *(t[:, :n].contiguous() for t in (q, k, v)), kv_group=4)
                chunk = K.flash_attention_2d(
                    q[:, q_off:n].contiguous(), k, v, q_offset=q_off,
                    kv_len=n, kv_group=4)
                row = {"phase": "tensorcore_offset", "head_dim": d,
                       "q_offset": q_off, "rows": sq,
                       "equal": bool(torch.equal(chunk, whole[:, q_off:n]))}
                emit(row)
                offset.append(row)
    for d in TC_FLASH_D:
        q, k, v = randn(8, 2048, d), randn(2, 2048, d), randn(2, 2048, d)
        full = K.flash_attention_2d(q, k, v, kv_group=4)
        part = K.flash_attention_2d(*(t[:, :1000].contiguous()
                                      for t in (q, k, v)), kv_group=4)
        row = {"phase": "tensorcore_prefix", "head_dim": d,
               "equal": bool(torch.equal(full[:, :1000], part))}
        emit(row)
        prefix.append(row)
    sms = sm_count(torch.device("cuda"))
    for k, n in TC_MATMUL_KN:
        w = randn(k, n, scale=1 / math.sqrt(k))
        for m in TC_MATMUL_M:
            x = randn(m, k)
            _, _, k_per_split, splits = mma_plan(m, k, n, sms)
            rows.append(_tc_row(torch, timer, dict(
                name="block_matmul", shape=f"M={m},K={k},N={n}",
                kernel=lambda x=x: K.block_matmul(x, w),
                plain=lambda x=x: ref.block_matmul(x, w),
                library=lambda x=x: torch.matmul(x, w),
                nbytes=(m * k + k * n + m * n) * 2, flops=2 * m * k * n,
                extra={"splits": splits, "k_per_split": k_per_split})))
    # x at an odd address: the scalar loads at an aligned shape.
    k = n = 1024
    w = randn(k, n, scale=1 / math.sqrt(k))
    for m in (4, 128):
        x = randn(m * k + 1)[1:].view(m, k)
        rows.append(_tc_row(torch, timer, dict(
            name="block_matmul", shape=f"M={m},K={k},N={n},x at +2 bytes",
            kernel=lambda x=x: K.block_matmul(x, w),
            plain=lambda x=x: ref.block_matmul(x, w),
            library=lambda x=x: torch.matmul(x, w),
            nbytes=(m * k + k * n + m * n) * 2, flops=2 * m * k * n)))
    ffn, ffn_same = _ffn_tc_rows(torch, timer, K, ref, randn, sms)
    rows += ffn
    norm, norm_same = _norm_tc_rows(torch, timer, K, ref, randn, sms)
    rows += norm
    rows += _xent_tc_rows(torch, timer, K, ref, randn, gen, sms)
    moe, moe_same = _moe_tc_rows(torch, timer, K, ref, randn)
    rows += moe
    flash_q, flash_q_same = _flash_q_tc_rows(torch, timer, K, ref, randn)
    rows += flash_q
    ssd, ssd_same = _ssd_tc_rows(torch, timer, K, ref, randn)
    rows += ssd
    wkv, wkv_same = _wkv_tc_rows(torch, timer, K, ref, randn)
    rows += wkv
    worst = {}
    for r in ffn:
        key = r["shape"].split(" T=")[0]
        worst[key] = max(worst.get(key, 0.0), r["rel_err"])
    emit({"phase": "tensorcore_ffn_error", "max_rel_err": worst})
    bad = [f"{r['name']} {r['shape']} rel {r['rel_err']} deterministic "
           f"{r['deterministic']}" for r in rows if not r["ok"]]
    bad += [f"prefix D={r['head_dim']}" for r in prefix if not r["equal"]]
    bad += [f"offset D={r['head_dim']} q_offset={r['q_offset']} "
            f"rows={r['rows']}" for r in offset if not r["equal"]]
    bad += [f"rows {r['name']} {r.get('F', r.get('N'))} at "
            f"{r['unequal_at']}" for r in ffn_same + norm_same + moe_same
            if not r["equal_1_to_64"]]
    bad += [f"offset_q {r['codes']} D={r['head_dim']} q_offset="
            f"{r['q_offset']} rows={r['rows']}" for r in flash_q_same
            if not r["equal"]]
    bad += [f"ssd {r['check']}" for r in ssd_same if not r["equal"]]
    bad += [f"wkv {r['check']}" for r in wkv_same if not r["equal"]]
    if bad:
        raise AssertionError("tensor-core kernels: " + "; ".join(bad))
    return {"rows": rows, "prefix": prefix, "offset": offset,
            "ffn_rows": ffn_same, "norm_rows": norm_same,
            "moe_rows": moe_same, "offset_q": flash_q_same,
            "ssd": ssd_same, "wkv": wkv_same, "ffn_max_rel_err": worst}


# --------------------------------------------------------------------- #
# Phases 3 and 4: the serving engine
# --------------------------------------------------------------------- #

def burst(rng, vocab: int, lengths):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _weights(torch, cfg, seed: int, jitter: bool, device="cuda"):
    """Random weights drawn on the card from ``seed``; jittered for the
    LayerNorm configs, whose zero-initialised norm scales would zero every
    logit and make any comparison pass for nothing."""
    from repro_torch.models import init_params
    from repro_torch.serving.accuracy import jitter_params
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    if jitter:
        params = jitter_params(
            params, torch.Generator(device=device).manual_seed(seed + 10))
    return params


def _fused_eager(torch, cfg, params, prompts, chunked, device="cuda",
                 max_len=512):
    """One burst with the kernel plan and one with the eager plan:
    ({fused: tokens}, {fused: seconds}, the kernel plan's launches)."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    tokens, seconds = {}, {}
    for fused in (True, False):
        eng = ServingEngine(
            dataclasses.replace(cfg, use_fused_kernels=fused), params,
            batch_slots=4, max_len=max_len, chunked=chunked, device=device)
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=8)
        _sync(torch, device)
        seconds[fused] = time.perf_counter() - t0
        tokens[fused] = [r.out_tokens for r in reqs]
        if fused:
            launches = {k: n for k, n in K.launch_counts().items() if n}
    return tokens, seconds, launches


def _free(torch, device):
    if device == "cuda":
        torch.cuda.empty_cache()


def fused_vs_eager(torch, cfg, device="cuda", lengths=(150, 40, 300, 9)):
    """``cfg``: llama3-8b cut to 4 layers, float32."""
    params = _weights(torch, cfg, 1, jitter=False, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    tokens, seconds, _ = _fused_eager(torch, cfg, params, prompts, True,
                                      device)
    equal = tokens[True] == tokens[False]
    row = {"phase": "fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts],
           "new_tokens": 8, "tokens_equal": equal,
           "fused_s": seconds[True], "eager_s": seconds[False],
           "fused_tokens": tokens[True], "eager_tokens": tokens[False]}
    emit(row)
    del params
    _free(torch, device)
    if not equal:
        raise AssertionError("fused and eager plans gave different greedy "
                             "tokens")
    return row


def admission_fused_vs_eager(torch, cfg, *, jitter, phase, expect,
                             device="cuda", lengths=(150, 40, 300, 9),
                             modes=("chunked", "whole_prompt"),
                             max_len=512):
    """``cfg``: a model with both admission paths (gpt2 with jittered
    weights, granite-moe-3b, qwen3, qwen1.5) cut to 4 layers, float32, or
    with ``modes`` the one it has (qwen2-vl: whole prompts).  Fused and
    eager tokens must agree under each admission mode, and the kernel
    plan's burst must launch exactly ``expect[mode]``.  Whether chunked
    and whole-prompt tokens agree is reported, not required: the two sum
    attention in different orders."""
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": 8}
    fused_tokens, bad = {}, []
    for mode in modes:
        tokens, seconds, launches = _fused_eager(
            torch, cfg, params, prompts, mode == "chunked", device, max_len)
        row[mode] = {"tokens_equal": tokens[True] == tokens[False],
                     "fused_s": seconds[True], "eager_s": seconds[False],
                     "fused_tokens": tokens[True],
                     "eager_tokens": tokens[False], "launches": launches}
        fused_tokens[mode] = tokens[True]
        if not row[mode]["tokens_equal"]:
            bad.append(f"{mode}: kernel plan != eager plan")
        if set(launches) != expect[mode]:
            bad.append(f"{mode}: launched {sorted(launches)}, expected "
                       f"{sorted(expect[mode])}")
    if len(modes) == 2:
        row["chunked_equals_whole_prompt"] = (fused_tokens["chunked"]
                                              == fused_tokens["whole_prompt"])
    emit(row)
    del params
    _free(torch, device)
    if bad:
        raise AssertionError(f"{phase} {cfg.name}: " + "; ".join(bad))
    return row


def serve(torch, cfg, params, expect, *, init_s, chunked=True,
          phase="serve", device="cuda", max_len=2048, lo=37, hi=1000,
          new=32, profile=False, lengths=None, engine_kw=None,
          keep_tokens=False):
    """A mixed burst of 8 prompts through the engine with the kernel plan;
    the kernels in ``expect`` must each launch, and no other.  ``profile``:
    the burst once more, through a fresh engine, under ``torch.profiler``
    (device ms by stage, idle share of its wall).  ``lengths``: the
    prompts' lengths (default: ``lo``, ``hi`` and 6 drawn between).
    ``engine_kw``: more engine arguments (``paged=False``: the contiguous
    slot cache).  ``keep_tokens``: the row keeps every request's tokens
    (``tokens``)."""
    from repro_torch import kernels as K
    from repro_torch.models.params import cache_leaf_kind, weight_bytes
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    lengths, prompts = _serve_prompts(cfg.vocab_size, lo, hi, lengths)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=max_len,
                        chunked=chunked, device=device, **(engine_kw or {}))
    eng.generate([prompts[2][:8]], max_new_tokens=2)       # warm-up
    _sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, max_new_tokens=new)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    # The burst's window (``generate`` opens it), read before the solo
    # request.
    window = eng.snapshot("last_generate")
    burst_metrics = {k: int(window[k]) for k in COUNTER_NAMES}
    solo = eng.generate([prompts[0]], max_new_tokens=new)[0].out_tokens
    generated = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "quant": cfg.quant,
           "admission": "chunked" if eng.chunked else "whole_prompt",
           "paged": eng.metrics["paged"],
           "page_size": eng.metrics["page_size"],
           "prefill_chunk": eng.metrics["prefill_chunk"],
           # Resident weights of the engine's tree: int8 codes and scales
           # in place of the w8 stages' weights under a weight mode.
           "weight_bytes": weight_bytes(eng.params), "init_s": init_s,
           "slots": 4, "max_len": max_len, "prompt_lengths": lengths,
           "new_tokens": new, "wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_s": statistics.median(ttft),
           "ttft_max_s": max(ttft),
           "tpot_mean_ms": 1e3 * statistics.mean(tpot),
           "kv_bytes_peak": eng.metrics["kv_bytes_peak"],
           "kv_bytes_reserved": eng.metrics["kv_bytes_reserved"],
           "kv_itemsize_effective": eng.metrics["kv_itemsize_effective"],
           # Slot-contiguous recurrent state (zamba2's SSM and conv rows,
           # rwkv6's wkv state and token-shift rows).
           "state_bytes": sum(t.numel() * t.element_size()
                              for n, t in eng.cache.items()
                              if cache_leaf_kind(n) == "state"),
           "device_mem_peak": (torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
           "metrics": burst_metrics, "launches": counts,
           "solo_repeats_burst": solo == reqs[0].out_tokens,
           "first_tokens": reqs[0].out_tokens[:8]}
    emit(row)
    if keep_tokens:
        row["tokens"] = [r.out_tokens for r in reqs]
    problems = []
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            problems.append(f"{name} launched {c} times")
    for r in reqs:
        if r.failed or not r.done or len(r.out_tokens) != new:
            problems.append(f"request {r.rid}: done={r.done} failed="
                            f"{r.failed} tokens={len(r.out_tokens)}")
        if any(not 0 <= t < cfg.vocab_size for t in r.out_tokens):
            problems.append(f"request {r.rid}: token outside the vocab")
    if not row["solo_repeats_burst"]:
        problems.append("the first prompt served alone gave other tokens")
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    if profile:
        del eng
        _free(torch, device)
        prof = profile_burst(torch, cfg, params, chunked=chunked,
                             device=device, max_len=max_len, lo=lo, hi=hi,
                             new=new, lengths=lengths, engine_kw=engine_kw)
        row["profile"] = prof
        emit({"phase": f"{phase}_profile", "config": cfg.name,
              "layers": cfg.num_layers, "admission": row["admission"],
              **(prof or {"device_ms": None})})
    return row


def _serve_prompts(vocab: int, lo: int, hi: int, lengths=None):
    """``serve``'s burst: (lengths, prompts), 8 prompts of ``lo``, ``hi``
    and 6 lengths between, drawn from numpy seed 2, or of ``lengths``."""
    rng = np.random.default_rng(2)
    if lengths is None:
        lengths = [lo, hi] + [int(n) for n in rng.integers(lo, hi + 1, 6)]
    else:
        lengths = list(lengths)
    return lengths, burst(rng, vocab, lengths)


def profile_burst(torch, cfg, params, *, chunked=True, device="cuda",
                  max_len=2048, lo=37, hi=1000, new=32, lengths=None,
                  engine_kw=None):
    """``serve``'s burst through a fresh engine (no prefix-cache hits from
    an earlier one), warmed up as there, under ``torch.profiler``: device
    ms by stage (``profile_device``) and the idle share of the profiled
    wall; None where the profiler saw no device time."""
    from repro_torch.serving import ServingEngine
    _, prompts = _serve_prompts(cfg.vocab_size, lo, hi, lengths)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=max_len,
                        chunked=chunked, device=device, **(engine_kw or {}))
    eng.generate([prompts[2][:8]], max_new_tokens=2)
    prof = profile_device(torch, lambda: eng.generate(
        prompts, max_new_tokens=new))
    if prof is not None:
        prof["idle_share"] = 1 - prof["busy_ms"] / prof["profiled_wall_ms"]
    return prof


# --------------------------------------------------------------------- #
# Phases 7 and 8: speculative decoding over the prefix cache
# --------------------------------------------------------------------- #

def spec_burst(vocab: int, shared_len: int = 512):
    """8 prompts for 4 slots: one shared 512-token prefix (four 128-token
    chunks: the system prompt chat and agent traffic repeats) with distinct
    random suffixes of 37..480 tokens (numpy seed 2), the last two
    repeating the second and third verbatim; at most 992 tokens, so every
    request gets 32 new tokens in gpt2's 1024-position context.
    ``shared_len``: another prefix length (gemma3: 1200, past its
    window)."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    lengths = [37, 480] + [int(n) for n in rng.integers(37, 481, 4)]
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in lengths]
    return prompts + [prompts[1].copy(), prompts[2].copy()]


def _first_divergence(a, b):
    """Index of the first token where two outputs differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


SPEC_ENGINES = {
    "plain": dict(prefix_cache=False),
    "default": {},
    "speculative": dict(speculative=True, draft_len=4),
    "speculative_eager": dict(speculative=True, draft_len=4, fused=False),
}


def spec_fused_vs_eager(torch, cfg, *, jitter, max_len, expect,
                        device="cuda", new=32):
    """``cfg``: full width cut to 4 layers, float32, kernel plan.  The four
    engines of ``SPEC_ENGINES`` must give the same greedy tokens on the
    speculative burst, and the speculative engine on the kernel plan must
    launch exactly the kernels of ``expect``."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = spec_burst(cfg.vocab_size)
    row = {"phase": "spec_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": new}
    tokens = {}
    for name, kw in SPEC_ENGINES.items():
        kw = dict(kw)
        run_cfg = dataclasses.replace(cfg, use_fused_kernels=kw.pop(
            "fused", True))
        eng = ServingEngine(run_cfg, params, batch_slots=SLOTS,
                            max_len=max_len, device=device, **kw)
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=new)
        _sync(torch, device)
        tokens[name] = [r.out_tokens for r in reqs]
        m = eng.metrics
        row[name] = {"seconds": time.perf_counter() - t0,
                     "launches": {k: n for k, n in K.launch_counts().items()
                                  if n},
                     "equal_to_plain": tokens[name] == tokens["plain"],
                     "first_divergence": [
                         _first_divergence(a, b) for a, b in
                         zip(tokens[name], tokens["plain"])],
                     **{k: m[k] for k in (
                         "prefix_hit_pages", "draft_tokens",
                         "accepted_tokens", "verify_dispatches",
                         "rollbacks", "dispatches")}}
        del eng
    row["plain_tokens"] = tokens["plain"]
    emit(row)
    del params
    _free(torch, device)
    bad = [n for n in SPEC_ENGINES if not row[n]["equal_to_plain"]]
    if bad:
        raise AssertionError(f"{cfg.name}: {bad} gave other greedy tokens "
                             "than the plain engine")
    spec_launches = set(row["speculative"]["launches"])
    if spec_launches != expect:
        raise AssertionError(f"{cfg.name}: the speculative engine launched "
                             f"{sorted(spec_launches)}, expected "
                             f"{sorted(expect)}")
    return row


def spec_serve(torch, cfg, params, expect, *, init_s, max_len,
               require_equal=True, phase="spec_serve", device="cuda",
               new=32, shared_len=512):
    """``cfg``: full width and depth, bfloat16, kernel plan.  The
    speculative burst through the speculative engine (prefix cache on),
    then through the plain engine for per-request token equality, which
    ``require_equal`` makes a condition of the run: every call on the
    kernel plan's path is row-invariant, so verify rows reproduce decode
    rows bit for bit.  Under KV quantization it is reported only: rejected
    draft rows leave their pages' scale growth behind, as the reference
    does (``kv_cache.py:848``), so later codes may differ from the plain
    engine's."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    prompts = spec_burst(cfg.vocab_size, shared_len)
    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=max_len,
                        speculative=True, draft_len=4, device=device)
    eng.generate([prompts[2][:8]], max_new_tokens=2)       # warm-up
    _sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, max_new_tokens=new)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    window = eng.snapshot("last_generate")
    burst_metrics = {k: int(window[k]) for k in COUNTER_NAMES}
    kv_peak = window["kv_bytes_peak"]
    mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
    del eng
    _free(torch, device)
    plain = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=max_len,
                          prefix_cache=False, device=device)
    t1 = time.perf_counter()
    base = [r.out_tokens for r in plain.generate(prompts,
                                                 max_new_tokens=new)]
    _sync(torch, device)
    plain_wall = time.perf_counter() - t1
    del plain
    _free(torch, device)
    generated = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    bm = burst_metrics
    row = {"phase": phase, "config": cfg.name, "quant": cfg.quant,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "init_s": init_s,
           "slots": SLOTS, "max_len": max_len,
           "prompt_lengths": [len(p) for p in prompts], "new_tokens": new,
           "wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": max(ttft),
           "tpot_mean_ms": 1e3 * statistics.mean(tpot),
           "accept_rate": bm["accepted_tokens"] / max(bm["draft_tokens"], 1),
           "dispatches_per_token": (bm["verify_dispatches"]
                                    / max(bm["spec_tokens"], 1)),
           "prefix_hit_rate": (bm["prefix_hit_pages"]
                               / max(bm["prompt_pages"], 1)),
           "rollbacks": bm["rollbacks"], "kv_bytes_peak": kv_peak,
           "device_mem_peak": mem_peak, "metrics": burst_metrics,
           "launches": counts, "plain_wall_s": plain_wall,
           "plain_tokens_per_s": generated / plain_wall,
           "equal_to_plain": [r.out_tokens == b for r, b in zip(reqs, base)],
           "equal_required": require_equal,
           "first_divergence": [_first_divergence(r.out_tokens, b)
                                for r, b in zip(reqs, base)]}
    emit(row)
    problems = []
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            problems.append(f"{name} launched {c} times")
    for r in reqs:
        if r.failed or not r.done or len(r.out_tokens) != new:
            problems.append(f"request {r.rid}: done={r.done} failed="
                            f"{r.failed} tokens={len(r.out_tokens)}")
        if any(not 0 <= t < cfg.vocab_size for t in r.out_tokens):
            problems.append(f"request {r.rid}: token outside the vocab")
    if bm["prefix_hit_pages"] <= 0:
        problems.append("no prefix page was hit")
    if bm["rollbacks"] <= 0:
        problems.append("no draft was rolled back")
    if require_equal and not all(row["equal_to_plain"]):
        problems.append("speculative tokens differ from the plain engine's "
                        f"at {row['first_divergence']}")
    if problems:
        raise AssertionError(f"{phase} {cfg.name}: " + "; ".join(problems))
    return row


# --------------------------------------------------------------------- #
# Phases 9-11: quantized serving
# --------------------------------------------------------------------- #

def quant_fused_vs_eager(torch, cfg, *, jitter, device="cuda",
                         lengths=(150, 40, 300, 9), new=8, required=True):
    """``cfg``: full width cut to 4 layers, float32, kernel plan.  Under
    every quant mode the kernel plan must give the eager plan's greedy
    tokens; the eager plan of a weight mode runs on the eager w8 reference
    (each w8 stage's weight quantized and dequantized back), since the
    reference's eager plan keeps full-precision weights.  Under kv_int8 the
    speculative engine (prefix cache on) must give the plain engine's
    tokens, where the config verifies speculatively (not qwen2-vl).
    ``required`` False reports the equalities without failing on them."""
    from repro_torch import kernels as K
    from repro_torch.models import supports_speculative
    from repro_torch.models.params import dequantize_weights, quantize_weights
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.accuracy import QUANT_MODES
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    eager_cfg = dataclasses.replace(cfg, use_fused_kernels=False)
    kw = dict(batch_slots=SLOTS, max_len=512, device=device)
    row = {"phase": "quant_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": new}
    bad = []
    for mode in QUANT_MODES:
        qcfg = dataclasses.replace(cfg, quant=mode)
        ref_params = dequantize_weights(qcfg, quantize_weights(qcfg, params))
        K.reset_launches()
        fused = [r.out_tokens for r in ServingEngine(
            qcfg, params, **kw).generate(prompts, max_new_tokens=new)]
        launches = {k: n for k, n in K.launch_counts().items() if n}
        eager = [r.out_tokens for r in ServingEngine(
            dataclasses.replace(eager_cfg, quant=mode), ref_params,
            **kw).generate(prompts, max_new_tokens=new)]
        del ref_params
        row[mode] = {"tokens_equal": fused == eager, "fused_tokens": fused,
                     "eager_tokens": eager, "launches": launches}
        if fused != eager:
            bad.append(f"{mode}: kernel plan != eager plan")
        if mode == "kv_int8" and supports_speculative(cfg):
            plain = [r.out_tokens for r in ServingEngine(
                qcfg, params, prefix_cache=False, **kw).generate(
                    prompts, max_new_tokens=new)]
            spec = ServingEngine(qcfg, params, speculative=True, draft_len=4,
                                 **kw)
            spec_tokens = [r.out_tokens for r in spec.generate(
                prompts, max_new_tokens=new)]
            row[mode].update(
                speculative_equal_plain=spec_tokens == plain,
                speculative_first_divergence=[
                    _first_divergence(a, b)
                    for a, b in zip(spec_tokens, plain)],
                draft_tokens=spec.metrics["draft_tokens"],
                accepted_tokens=spec.metrics["accepted_tokens"],
                rollbacks=spec.metrics["rollbacks"])
            if spec_tokens != plain:
                bad.append("kv_int8: speculative != plain")
        _free(torch, device)
    row["required"] = required
    emit(row)
    del params
    _free(torch, device)
    if bad and required:
        raise AssertionError(f"quant_fused_vs_eager {cfg.name}: "
                             + "; ".join(bad))
    return row


def accuracy(torch, cfg, *, jitter, device="cuda"):
    """``cfg``: full width cut to 4 layers, float32.  The teacher-forced
    accuracy gate (``serving/accuracy.py``) of every quant mode against
    the unquantized engine on the kernel plan (weights jittered for gpt2
    only, as in the other phases): reported beside the reference's largest
    logit magnitude, and every logit error must be finite."""
    from repro_torch.serving.accuracy import QUANT_MODES, run_accuracy
    params = _weights(torch, cfg, 3, jitter=jitter, device=device)
    t0 = time.perf_counter()
    rep = run_accuracy(cfg, QUANT_MODES, params=params, fused=True,
                       device=device)
    row = {"phase": "accuracy", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": "float32",
           "seconds": time.perf_counter() - t0,
           "max_abs_logit": rep["none"]["max_abs_logit"],
           **{m: {k: rep[m][k] for k in ("max_logit_err", "tokens_equal",
                                         "kv_itemsize")}
              for m in QUANT_MODES}}
    emit(row)
    del params
    _free(torch, device)
    bad = [m for m in QUANT_MODES
           if not math.isfinite(rep[m]["max_logit_err"])]
    if bad:
        raise AssertionError(f"accuracy {cfg.name}: non-finite logit error "
                             f"under {bad}")
    return row


def full_depth(torch, cfg, model, *, jitter, max_len, hi, device="cuda"):
    """``cfg``: full width at the serving depth (``SERVE_LAYERS``),
    bfloat16, kernel plan; weights drawn once on the card (seed 2).  The
    mixed burst (``serve``; gpt2 and
    granite under chunked and whole-prompt admission), the speculative
    burst against the plain engine (``spec_serve``, exact), then both
    again under w8_kv8 (``quant_serve``, ``quant_spec_serve``).  Each
    burst launches exactly its path's kernels."""
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=jitter, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    modes = tuple(SERVE_PATHS[model])
    qcfg = dataclasses.replace(cfg, quant=QUANT_MODE)
    out = {"serve": {}, "quant_serve": {}}
    phase = {"llama3-8b": "serve", "gpt2": "gpt2_serve"}.get(
        model, "granite_serve")
    for mode in modes:
        out["serve"][mode] = serve(
            torch, cfg, params, SERVE_PATHS[model][mode], init_s=init_s,
            chunked=mode == "chunked", device=device, max_len=max_len, hi=hi,
            phase=phase, profile=model == "llama3-8b")
        _free(torch, device)
    out["spec_serve"] = spec_serve(torch, cfg, params, SPEC_PATHS[model],
                                   init_s=init_s, max_len=max_len,
                                   device=device)
    for mode in modes:
        out["quant_serve"][mode] = serve(
            torch, qcfg, params, QUANT_PATHS[(model, mode)], init_s=init_s,
            chunked=mode == "chunked", device=device, max_len=max_len, hi=hi,
            phase="quant_serve")
        _free(torch, device)
    out["quant_spec_serve"] = spec_serve(
        torch, qcfg, params, QUANT_PATHS[(model, "speculative")],
        init_s=init_s, max_len=max_len, require_equal=False,
        phase="quant_spec_serve", device=device)
    del params
    _free(torch, device)
    return out


# --------------------------------------------------------------------- #
# The engine's surface: the contiguous slot cache, page sizes and chunks,
# the bhsd layout, the adaptive decode block, the serving launcher
# --------------------------------------------------------------------- #

# The contiguous slot cache admits whole prompts (K7) and decodes without
# a page table through the plain decode attention, as the reference does:
# no K1 and no K2.  The paged whole-prompt path beside it for comparison.
CONTIGUOUS_PATH = {"rmsnorm_matmul", "streamed_ffn",
                   "flash_attention_static", "block_matmul"}
LLAMA_WHOLE_PATH = CONTIGUOUS_PATH | {"paged_attention"}
# ``serve_surface``: llama3-8b at full width cut to 4 layers, float32, a
# burst of 6 prompts (the 600-token one three 256-token chunks) through
# engines that differ in one argument each.  The chunked engines must
# give the default engine's tokens, the whole-prompt ones (paged and
# contiguous, either layout) the paged whole-prompt engine's.
SURFACE_LAYERS = 4
SURFACE_LENGTHS = (150, 40, 300, 9, 600, 77)
SURFACE_ENGINES = {
    "paged": {},
    "page_size_32": dict(page_size=32, prefill_chunk=128),
    "page_size_64": dict(page_size=64, prefill_chunk=128),
    "prefill_chunk_256": dict(prefill_chunk=256),
    "bhsd": dict(layout="bhsd"),
    "adaptive": dict(adaptive_decode_block=True),
    "whole_prompt": dict(chunked=False),
    "contiguous": dict(paged=False),
    "contiguous_bhsd": dict(paged=False, layout="bhsd"),
}
SURFACE_WHOLE = ("whole_prompt", "contiguous", "contiguous_bhsd")
CHUNK_256 = 256
# ``serve_launcher``: ``python -m repro_torch.launch.serve`` in-process,
# each run's launches exactly its path's.
LAUNCHER_RUNS = {
    "llama3-8b": (["--arch", "llama3-8b", "--fused", "--layers", "8"],
                  LLAMA_PATH),
    "llama3-8b contiguous": (["--arch", "llama3-8b", "--fused", "--layers",
                              "8", "--contiguous"], CONTIGUOUS_PATH),
    "llama3-8b page size 32": (["--arch", "llama3-8b", "--fused",
                                "--layers", "8", "--page-size", "32"],
                               LLAMA_PATH),
    "gpt2": (["--arch", "gpt2", "--fused"], GPT2_PATHS["chunked"]),
}


def surface_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """llama3-8b's attention at the surface's new shapes: K1 over 32- and
    64-token pages (4 slots of 1000, 517, 37 and 0 tokens in 1024
    positions), K2 on a 256-row chunk at offsets 768 and 0 of a
    1024-position extent (the first the path's row in ``kernels``), and K7 over a 1000-token prompt (the contiguous
    path's prefill), each tagged with its path."""
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = [dict(_paged_case(torch, K, ref, randn, isz, gen, 32, 8, 128,
                              1024 // ps, dev, ps=ps), path=f"page_size_{ps}")
             for ps in (32, 64)]
    cases += [dict(_flash_case(torch, K, ref, randn, isz, "flash_attention",
                               32, 8, 128, CHUNK_256, 1024, q_off, dev),
                   path="prefill_chunk_256") for q_off in (768, 0)]
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 32, 8, 128, 1000,
                                  1000, None, dev), path="contiguous"))
    return [dict(c, model="llama3-8b") for c in cases]


def _surface_bits(torch):
    """K2's rows of a 256-row chunk against K7's rows at the same positions
    of the whole prompt, bit for bit (bf16 at offsets 0, 256 and 768;
    float32 reported), and K1 over the same K/V in 16-, 32- and 64-token
    pages, bit for bit (reported).  Returns (rows, failures)."""
    from repro_torch import kernels as K
    rows, bad = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(77)
        randn = _randn(torch, gen, dtype, "cuda")
        top = 768 + CHUNK_256
        q, k, v = randn(32, top, 128), randn(8, top + 7, 128), \
            randn(8, top + 7, 128)
        for q_off in (0, 256, 768):
            n = q_off + CHUNK_256
            whole = K.flash_attention_2d(
                *(t[:, :n].contiguous() for t in (q, k, v)), kv_group=4)
            chunk = K.flash_attention_2d(
                q[:, q_off:n].contiguous(), k, v, q_offset=q_off, kv_len=n,
                kv_group=4)
            row = {"phase": "surface_chunk_rows", "dtype": dname,
                   "q_offset": q_off, "rows": CHUNK_256,
                   "equal": bool(torch.equal(chunk, whole[:, q_off:n]))}
            emit(row)
            rows.append(row)
            if dtype == torch.bfloat16 and not row["equal"]:
                bad.append(f"K2 256-row chunk at {q_off} != K7's rows")
        # One K/V sequence per slot, paged at each page size (identity
        # table past the NULL page).
        b, s = 4, 1024
        lengths = torch.tensor([1000, 517, 37, 0], dtype=torch.int32,
                               device="cuda")
        kseq, vseq = randn(b, s, 8, 128), randn(b, s, 8, 128)
        qd = randn(b, 1, 32, 128)
        outs = {}
        for ps in (16, 32, 64):
            def pool(seq):
                body = seq.reshape(b * (s // ps), ps, 8, 128)
                return torch.cat([torch.zeros_like(body[:1]), body])
            table = (torch.arange(b * (s // ps), device="cuda",
                                  dtype=torch.int32).reshape(b, -1) + 1)
            outs[ps] = K.paged_decode_attention(qd, pool(kseq), pool(vseq),
                                                table, lengths)
        row = {"phase": "surface_page_bits", "dtype": dname,
               "equal_to_ps16": {ps: bool(torch.equal(outs[ps], outs[16]))
                                 for ps in (32, 64)}}
        emit(row)
        rows.append(row)
    return rows, bad


def serve_surface(torch, timer, device="cuda"):
    """The surface's kernel rows (``surface_kernel_cases``, bf16 and f32
    against the plain versions), ``_surface_bits``, then the float32
    bursts of ``SURFACE_ENGINES``: tokens equal within the chunked group
    and within the whole-prompt group (required), chunked against
    whole-prompt reported; each burst launching exactly its path's
    kernels; the resolved page size and chunk as asked."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine
    out = {"kernel_rows": check_kernels(torch, timer, (surface_kernel_cases,),
                                        phase="surface_kernel_cases")}
    out["bits"], bad = _surface_bits(torch)
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              num_layers=SURFACE_LAYERS, dtype="float32",
                              use_fused_kernels=True)
    params = _weights(torch, cfg, 1, jitter=False, device=device)
    prompts = burst(np.random.default_rng(3), cfg.vocab_size,
                    SURFACE_LENGTHS)
    tokens, bursts = {}, {}
    for name, kw in SURFACE_ENGINES.items():
        kw = dict(kw)
        c = dataclasses.replace(cfg, kv_cache_layout=kw.pop("layout",
                                                            "bshd"))
        eng = ServingEngine(c, params, batch_slots=4, max_len=1024,
                            device=device, **kw)
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=16)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in K.launch_counts().items() if n}
        tokens[name] = [r.out_tokens for r in reqs]
        m = eng.metrics
        expect = (CONTIGUOUS_PATH if not eng.paged else
                  LLAMA_WHOLE_PATH if not eng.chunked else LLAMA_PATH)
        row = {"phase": "serve_surface", "engine": name,
               "config": cfg.name, "layers": cfg.num_layers,
               "dtype": cfg.dtype, "layout": c.kv_cache_layout,
               "prompts": list(SURFACE_LENGTHS), "new_tokens": 16,
               "wall_s": wall, "launches": launches,
               **{k: m[k] for k in ("paged", "chunked", "page_size",
                                    "prefill_chunk", "decode_block_last",
                                    "kv_bytes_reserved", "kv_bytes_peak",
                                    "dispatches", "scan_ticks", "ticks",
                                    "prefill_chunks")}}
        emit(row)
        bursts[name] = row
        if set(launches) != expect:
            bad.append(f"{name}: launched {sorted(launches)}, expected "
                       f"{sorted(expect)}")
        if any(r.failed or len(r.out_tokens) != 16 for r in reqs):
            bad.append(f"{name}: a request failed or fell short")
        want_ps = kw.get("page_size", 16) if eng.paged else 0
        want_chunk = (kw.get("prefill_chunk", 128) if eng.chunked else 0)
        if (m["page_size"], m["prefill_chunk"]) != (want_ps, want_chunk):
            bad.append(f"{name}: page size {m['page_size']}, chunk "
                       f"{m['prefill_chunk']}")
        del eng
        _free(torch, device)
    chunked = [n for n in SURFACE_ENGINES if n not in SURFACE_WHOLE]
    equal = {n: tokens[n] == tokens["paged"] for n in chunked}
    equal.update({n: tokens[n] == tokens["whole_prompt"]
                  for n in SURFACE_WHOLE})
    row = {"phase": "serve_surface_tokens", "equal": equal,
           "chunked_equals_whole_prompt": (tokens["paged"]
                                           == tokens["whole_prompt"]),
           "adaptive_blocks": [bursts["adaptive"]["scan_ticks"],
                               bursts["paged"]["scan_ticks"]]}
    emit(row)
    bad += [f"{n}: tokens differ" for n, ok in equal.items() if not ok]
    del params
    _free(torch, device)
    if bad:
        raise AssertionError("serve_surface: " + "; ".join(bad))
    out.update(bursts=bursts, tokens=row)
    return out


def serve_contiguous(torch, device="cuda"):
    """llama3-8b at full width cut to ``SERVE_LAYERS``, bfloat16, kernel
    plan, the weights of ``full_depth`` (seed 2): ``serve``'s mixed burst
    through the contiguous slot cache (exact launches, every request done,
    the solo prompt repeating its burst, profiled), then through the paged
    whole-prompt engine on the same weights, and the two side by side."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b"), use_fused_kernels=True,
                              num_layers=SERVE_LAYERS["llama3-8b"])
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=False, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    out = {"contiguous": serve(
        torch, cfg, params, CONTIGUOUS_PATH, init_s=init_s, chunked=False,
        phase="serve_contiguous", device=device, profile=True,
        engine_kw={"paged": False})}
    _free(torch, device)
    out["paged_whole_prompt"] = serve(
        torch, cfg, params, LLAMA_WHOLE_PATH, init_s=init_s, chunked=False,
        phase="serve_contiguous_paged", device=device, profile=True)
    del params
    _free(torch, device)

    def idle(r):
        return (r.get("profile") or {}).get("idle_share")

    emit({"phase": "serve_contiguous_vs_paged", "config": cfg.name,
          "layers": cfg.num_layers,
          **{f"{k}_{name}": r[k] for name, r in (
              ("contiguous", out["contiguous"]),
              ("paged", out["paged_whole_prompt"]))
             for k in ("ttft_p50_s", "tpot_mean_ms", "tokens_per_s",
                       "kv_bytes_reserved", "kv_bytes_peak")},
          "idle_share_contiguous": idle(out["contiguous"]),
          "idle_share_paged": idle(out["paged_whole_prompt"]),
          "first_tokens_equal": (out["contiguous"]["first_tokens"]
                                 == out["paged_whole_prompt"]["first_tokens"])})
    return out


def serve_launcher(torch, device="cuda"):
    """``repro_torch.launch.serve.main`` in-process for each of
    ``LAUNCHER_RUNS`` on the card: exit code 0, the reference's two
    ``[serve]`` lines (printed here too), launches exactly the run's
    path's."""
    import contextlib
    import io
    from repro_torch import kernels as K
    from repro_torch.launch.serve import main as serve_main
    out, bad = {}, []
    for name, (argv, expect) in LAUNCHER_RUNS.items():
        buf = io.StringIO()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_main(argv)
        _sync(torch, device)
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in K.launch_counts().items() if n}
        lines = buf.getvalue().splitlines()
        for ln in lines:
            print(ln, flush=True)
        row = {"phase": "serve_launcher", "run": name, "argv": argv,
               "rc": rc, "seconds": seconds, "lines": lines,
               "launches": launches}
        emit(row)
        out[name] = row
        if rc != 0 or sum(ln.startswith("[serve]") for ln in lines) != 2:
            bad.append(f"{name}: rc {rc}, lines {lines[:2]}")
        if set(launches) != expect:
            bad.append(f"{name}: launched {sorted(launches)}, expected "
                       f"{sorted(expect)}")
        _free(torch, device)
    if bad:
        raise AssertionError("serve_launcher: " + "; ".join(bad))
    return out


# --------------------------------------------------------------------- #
# Telemetry: the event recorder, the typed registry and its exporters
# --------------------------------------------------------------------- #

TELEMETRY_HISTOGRAMS = ("ttft_s", "tpot_s", "queue_wait_s",
                        "chunk_latency_s", "decode_dispatch_s")


def _finite(x):
    """A JSON-safe number: ``None`` for an empty histogram's ``nan``."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def serve_telemetry(torch, out_dir, device="cuda", serve_row=None):
    """llama3-8b at full width, ``SERVE_LAYERS`` deep, bf16, seed-2
    weights: ``serve``'s chunked burst through an engine with telemetry
    off, then one with it on, each after a warm-up (the recorder cleared
    after it).  Telemetry is a pure observer: equal tokens and launches,
    and with ``serve_row`` (the ``serve`` phase's row of the same burst)
    the off engine's launches and first tokens equal that row's.  Writes
    the on engine's Chrome trace to ``out_dir``."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.obs import (DISPATCH_DECODE, DISPATCH_PREFILL_CHUNK,
                                 REQ_ADMITTED, REQ_FINISHED, REQ_FIRST_TOKEN,
                                 REQ_QUEUED, chrome_trace,
                                 validate_chrome_trace)
    from repro_torch.serving import ServingEngine
    new = 32
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              use_fused_kernels=True,
                              num_layers=SERVE_LAYERS["llama3-8b"])
    params = _weights(torch, cfg, 2, jitter=False, device=device)
    lengths, prompts = _serve_prompts(cfg.vocab_size, 37, 1000)
    runs = {}
    for on in (False, True):
        eng = ServingEngine(cfg, params, batch_slots=4, max_len=2048,
                            page_size=16, prefill_chunk=128, chunked=True,
                            telemetry=on, device=device)
        eng.generate([prompts[2][:8]], max_new_tokens=2)   # warm-up
        _sync(torch, device)
        eng.obs.clear()
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=new)
        _sync(torch, device)
        runs[on] = {"reqs": reqs, "wall": time.perf_counter() - t0,
                    "launches": {k: n for k, n in K.launch_counts().items()
                                 if n},
                    "window": eng.snapshot("last_generate"),
                    "recorded": len(eng.obs.events)}
        if not on:
            off_inert = eng.obs.events == () and not eng.obs.enabled
            del eng
            _free(torch, device)
    off, on = runs[False], runs[True]
    win = on["window"]
    trace = chrome_trace(eng.obs.events)
    text = json.dumps(trace)
    with open(os.path.join(out_dir, "serve_telemetry_trace.json"),
              "w") as fh:
        fh.write(text)
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    tokens_equal = ([r.out_tokens for r in on["reqs"]]
                    == [r.out_tokens for r in off["reqs"]])
    tpot = {k: statistics.mean(r.tpot_s for r in runs[k]["reqs"])
            for k in (False, True)}
    row = {"phase": "serve_telemetry", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompt_lengths": lengths, "new_tokens": new, "slots": 4,
           "page_size": eng.kv.page_size, "prefill_chunk": eng.chunk,
           "tokens_equal": tokens_equal,
           "launches_off": off["launches"], "launches_on": on["launches"],
           "events": len(eng.obs.events), "events_dropped": eng.obs.dropped,
           "trace_bytes": len(text), "trace_lanes": sorted(lanes),
           "wall_off_s": off["wall"], "wall_on_s": on["wall"],
           "wall_ratio": on["wall"] / off["wall"],
           "tpot_mean_off_ms": 1e3 * tpot[False],
           "tpot_mean_on_ms": 1e3 * tpot[True],
           "tpot_ratio": tpot[True] / tpot[False],
           "first_tokens": off["reqs"][0].out_tokens[:8],
           "ttft_median_s": statistics.median(r.ttft_s for r in on["reqs"]),
           "tpot_median_s": statistics.median(r.tpot_s for r in on["reqs"]),
           "counters": {k: int(win[k]) for k in (
               "prefills", "prefill_chunks", "dispatches", "generated",
               "prefix_hit_pages", "prompt_pages")}}
    for h in TELEMETRY_HISTOGRAMS + ("prefill_dispatch_s",):
        for q in ("count", "p50", "p90", "p99"):
            row[f"{h}_{q}"] = _finite(win[f"{h}_{q}"])
    emit(row)
    problems = []
    if not tokens_equal:
        problems.append("tokens differ with telemetry on")
    for key in ("launches_off", "launches_on"):
        if set(row[key]) != LLAMA_PATH:
            problems.append(f"{key}: {sorted(row[key])}")
    if row["launches_off"] != row["launches_on"]:
        problems.append("launch counts differ with telemetry on")
    if serve_row is not None and (
            {k: n for k, n in serve_row["launches"].items() if n}
            != row["launches_off"]
            or serve_row["first_tokens"] != row["first_tokens"]):
        problems.append("the off engine's launches or first tokens differ "
                        "from the serve phase's")
    if not off_inert or off["recorded"]:
        problems.append("the off recorder holds events")
    n = len(prompts)
    for name in (REQ_QUEUED, REQ_ADMITTED, REQ_FIRST_TOKEN, REQ_FINISHED):
        if eng.obs.count(name) != n:
            problems.append(f"{name}: {eng.obs.count(name)} events")
    if eng.obs.count(DISPATCH_PREFILL_CHUNK) != win["prefill_chunks"]:
        problems.append("prefill-chunk events != prefill_chunks")
    if eng.obs.count(DISPATCH_DECODE) != win["dispatches"]:
        problems.append("decode events != dispatches")
    errs = validate_chrome_trace(trace)
    if errs:
        problems.append(f"trace invalid: {errs[:3]}")
    if not {"engine", "slot0", "slot1", "slot2", "slot3"} <= lanes:
        problems.append(f"trace lanes {sorted(lanes)}")
    for h in TELEMETRY_HISTOGRAMS:
        p = [win[f"{h}_p{q}"] for q in (50, 90, 99)]
        if not (win[f"{h}_count"] > 0 and p[0] <= p[1] <= p[2]):
            problems.append(f"{h}: count {win[f'{h}_count']}, "
                            f"percentiles {p}")
    del eng, params
    _free(torch, device)
    if problems:
        raise AssertionError("serve_telemetry: " + "; ".join(problems))
    return row


def obs_demo(torch, out_dir, device="cuda"):
    """``repro_torch.obs.__main__.main(["--demo", "--out", ...])``
    in-process on the card: exit code 0, ``trace.json``, ``events.jsonl``
    and ``metrics.prom`` written, launches exactly the speculative gpt2
    path's."""
    import contextlib
    import io
    from repro_torch import kernels as K
    from repro_torch.obs.__main__ import main as obs_main
    out = os.path.join(out_dir, "obs_demo")
    buf = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(["--demo", "--out", out])
    _sync(torch, device)
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in K.launch_counts().items() if n}
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(ln, flush=True)
    files = {f: os.path.getsize(os.path.join(out, f))
             for f in ("trace.json", "events.jsonl", "metrics.prom")
             if os.path.exists(os.path.join(out, f))}
    row = {"phase": "obs_demo", "rc": rc, "seconds": seconds,
           "files": files, "launches": launches}
    emit(row)
    _free(torch, device)
    bad = []
    if rc != 0:
        bad.append(f"rc {rc}: {[ln for ln in lines if 'FAIL' in ln]}")
    if len(files) != 3:
        bad.append(f"files written: {sorted(files)}")
    if set(launches) != SPEC_PATHS["gpt2"]:
        bad.append(f"launched {sorted(launches)}, expected "
                   f"{sorted(SPEC_PATHS['gpt2'])}")
    if bad:
        raise AssertionError("obs_demo: " + "; ".join(bad))
    return row


# --------------------------------------------------------------------- #
# zamba2 and rwkv6: recurrent state, whole-prompt admission
# --------------------------------------------------------------------- #

def recurrent_fused_vs_eager(torch, cfg, *, phase, launches, jitter,
                             device="cuda", lengths=(150, 40, 300, 9)):
    """``cfg``: a recurrent-state model at full width cut in depth,
    float32 (zamba2 at 6 layers: one period, the shared block runs once;
    rwkv6 at 4, jittered).  The kernel plan's greedy tokens must equal the
    eager plan's, the engine must admit whole prompts, and the kernel
    plan's burst must launch exactly ``launches(prefills, decode
    steps)``."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": 8}
    tokens = {}
    for fused in (True, False):
        eng = ServingEngine(
            dataclasses.replace(cfg, use_fused_kernels=fused), params,
            batch_slots=SLOTS, max_len=512, device=device)
        K.reset_launches()
        t0 = time.perf_counter()
        tokens[fused] = [r.out_tokens for r in eng.generate(
            prompts, max_new_tokens=8)]
        _sync(torch, device)
        row["fused_s" if fused else "eager_s"] = time.perf_counter() - t0
        if fused:
            row["admission"] = ("chunked" if eng.chunked
                                else "whole_prompt")
            row["launches"] = {k: n for k, n in K.launch_counts().items()
                               if n}
            row["expected"] = launches(eng.metrics["prefills"],
                                       eng.metrics["scan_ticks"])
    row.update(tokens_equal=tokens[True] == tokens[False],
               fused_tokens=tokens[True], eager_tokens=tokens[False])
    emit(row)
    del params
    _free(torch, device)
    bad = []
    if not row["tokens_equal"]:
        bad.append("kernel plan != eager plan")
    if row["launches"] != row["expected"]:
        bad.append(f"launched {row['launches']}, expected "
                   f"{row['expected']}")
    if row["admission"] != "whole_prompt":
        bad.append("not admitted whole-prompt")
    if bad:
        raise AssertionError(f"{phase}: " + "; ".join(bad))
    return row


def _exact_launches(phase, quant, row, prefills, want) -> None:
    """A ``serve`` burst's launch counts against ``want``, the exact
    counts for its ``prefills`` prefill dispatches and decode steps; one
    line, and a failure when they differ."""
    got = {k: n for k, n in row["launches"].items() if n}
    emit({"phase": f"{phase}_launches", "config": row["config"],
          "quant": quant, "prefills": prefills,
          "decode_steps": row["metrics"]["scan_ticks"], "launches": got,
          "expected": want, "exact": got == want})
    if got != want:
        raise AssertionError(f"{phase} {row['config']} {quant}: launched "
                             f"{got}, expected {want}")


def recurrent_serve(torch, cfg, *, phases, launches, jitter, device="cuda"):
    """``cfg``: a recurrent-state model at full width and depth, bfloat16,
    kernel plan; weights drawn once on the card (seed 2; jittered for
    rwkv6, whose LayerNorm scales start at zero and token-shift mixes at
    one).  The mixed burst (``serve``: 8 prompts of 37..1000 tokens, 32
    new tokens each, 4 slots, max_len 2048, whole-prompt admission) under
    each quant mode of ``phases`` ({quant: phase name}); each burst must
    launch exactly ``launches(prefills, decode steps, quant)``."""
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=jitter, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    out = {}
    for quant, phase in phases.items():
        qcfg = dataclasses.replace(cfg, quant=quant)
        row = serve(torch, qcfg, params, set(launches(1, 1, quant)),
                    init_s=init_s, chunked=None, phase=phase, device=device)
        m = row["metrics"]
        _exact_launches(phase, quant, row, m["prefills"],
                        launches(m["prefills"], m["scan_ticks"], quant))
        out[quant] = row
        _free(torch, device)
    del params
    _free(torch, device)
    return out


# --------------------------------------------------------------------- #
# The Qwen decoders: qk-norm, the QKV bias, M-RoPE
# --------------------------------------------------------------------- #

def qwen_fused_vs_eager(torch, model, device="cuda"):
    """``model`` at full width cut to 4 layers, float32, weights jittered
    (the biases and the q/k norm scales start at zero): the kernel plan's
    greedy tokens equal the eager plan's on the mixed burst (qwen3 and
    qwen1.5: chunked and whole-prompt; qwen2-vl: whole-prompt), each
    burst launching exactly its path's kernels; qwen3 and qwen1.5 also
    on the speculative burst (``spec_fused_vs_eager``: plain, prefix
    cache, speculative on both plans, all equal); every quant mode's
    kernel plan equal to its eager plan (``quant_fused_vs_eager``;
    reported, not required, for qwen2-vl: below); the accuracy gate of
    every quant mode."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(model), num_layers=4,
                              dtype="float32")
    fused = dataclasses.replace(cfg, use_fused_kernels=True)
    whole = model == QWEN2VL
    out = {"admission": admission_fused_vs_eager(
        torch, cfg, jitter=True, phase="qwen_fused_vs_eager",
        expect=QWEN_PATHS, device=device,
        modes=("whole_prompt",) if whole else ("chunked", "whole_prompt"))}
    if not whole:
        out["speculative"] = spec_fused_vs_eager(
            torch, fused, jitter=True, max_len=2048, device=device,
            expect=SPEC_PATHS["llama3-8b"])
    # qwen2-vl's whole prompts reach the KV quantizer from each plan's own
    # prefill products, 3.4e-6 apart (relative), so a few fp8 codes differ
    # (9 of 81920 for request 1) and its first decode step parts the
    # plans on a tie: the eager plan's top two logits are equal to the
    # bit (argmax takes the lower index), the kernel plan's 2.1e-5 apart;
    # on the kernel plan's pools both plans' decodes pick the same token
    # (measured on the card; PERF.md §6).
    out["quant"] = quant_fused_vs_eager(torch, fused, jitter=True,
                                        device=device, required=not whole)
    out["accuracy"] = accuracy(torch, cfg, jitter=True, device=device)
    return out


def qwen_serve(torch, model, device="cuda"):
    """``model`` at full width cut to ``QWEN_SERVE_LAYERS``, bfloat16,
    kernel plan, weights
    drawn on the card (seed 2) and jittered: the mixed burst (``serve``:
    8 prompts of 37..1000 tokens, 32 new tokens each, 4 slots, max_len
    2048; qwen3 and qwen1.5 chunked with the prefix cache, qwen2-vl
    whole-prompt) with its profile; qwen3 also the speculative burst
    against the plain engine (``spec_serve``, exact); qwen3 and qwen2-vl
    also the mixed burst under w8_kv8.  Each mixed burst must launch
    exactly ``qwen_launches`` for its prefill dispatches and decode
    steps."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(model), use_fused_kernels=True,
                              num_layers=QWEN_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=True, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    whole = model == QWEN2VL
    mode = "whole_prompt" if whole else "chunked"
    out = {"serve": {}, "quant_serve": {}}
    quants = ("none", QUANT_MODE) if model != QWEN15 else ("none",)
    for quant in quants:
        qcfg = dataclasses.replace(cfg, quant=quant)
        plain = quant == "none"
        row = serve(torch, qcfg, params,
                    (QWEN_PATHS if plain else QWEN_QUANT_PATHS)[mode],
                    init_s=init_s, chunked=not whole, device=device,
                    phase="qwen_serve" if plain else "qwen_quant_serve",
                    profile=plain)
        m = row["metrics"]
        prefills = m["prefills"] if whole else m["prefill_chunks"]
        _exact_launches(row["phase"], quant, row, prefills, qwen_launches(
            cfg.num_layers, prefills, m["scan_ticks"], whole=whole,
            quant=quant))
        out["serve" if plain else "quant_serve"][mode] = row
        _free(torch, device)
    if model == QWEN3:
        out["spec_serve"] = spec_serve(
            torch, cfg, params, SPEC_PATHS["llama3-8b"], init_s=init_s,
            max_len=2048, phase="qwen_spec_serve", device=device)
    del params
    _free(torch, device)
    return out


def gemma_fused_vs_eager(torch, device="cuda"):
    """gemma3-4b at full width cut to 6 layers (five local, one global: one
    period of its pattern), float32, weights jittered (the q/k norm scales
    start at zero): the kernel plan's greedy tokens equal the eager plan's
    on a burst of prompts on both sides of the 1024-token window (1100,
    1030, 300 and 40 tokens), chunked and whole-prompt, each launching
    exactly its path's kernels."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(GEMMA), num_layers=6,
                              dtype="float32")
    return admission_fused_vs_eager(
        torch, cfg, jitter=True, phase="gemma_fused_vs_eager",
        expect=GEMMA_PATHS, device=device, lengths=(1100, 1030, 300, 40),
        max_len=2048)


def gemma_serve(torch, device="cuda"):
    """gemma3-4b at full width cut to ``GEMMA_SERVE_LAYERS``, bfloat16,
    kernel plan, weights drawn on the card (seed 2) and jittered:
    ``GEMMA_BURST`` (8 prompts of 37..3000 tokens, 32 new tokens each, 4
    slots, max_len 4096) chunked with the prefix cache and whole-prompt
    (with its profile; at full depth the chunked burst's 85 chunks and
    208 decode steps took 95 s under the profiler on an H100),
    then the speculative burst over a shared 1200-token prefix against the
    plain engine (``spec_serve``, exact).  Each burst must launch exactly
    ``gemma_launches`` for its prefill dispatches, decode steps and verify
    dispatches; a prompt served alone repeats its burst tokens."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(GEMMA), use_fused_kernels=True,
                              num_layers=GEMMA_SERVE_LAYERS)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=True, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    out = {"serve": {}, "quant_serve": {}}
    for mode in ("chunked", "whole_prompt"):
        whole = mode == "whole_prompt"
        row = serve(torch, cfg, params, GEMMA_PATHS[mode], init_s=init_s,
                    chunked=not whole, device=device, phase="gemma_serve",
                    max_len=GEMMA_MAX_LEN, lengths=GEMMA_BURST,
                    profile=whole)
        m = row["metrics"]
        prefills = m["prefills"] if whole else m["prefill_chunks"]
        _exact_launches(row["phase"], "none", row, prefills, gemma_launches(
            layers, prefills, m["scan_ticks"], whole=whole))
        out["serve"][mode] = row
        _free(torch, device)
    row = spec_serve(torch, cfg, params, GEMMA_PATHS["speculative"],
                     init_s=init_s, max_len=GEMMA_MAX_LEN,
                     phase="gemma_spec_serve", device=device,
                     shared_len=GEMMA_SHARED)
    m = row["metrics"]
    _exact_launches(row["phase"], "none", row, m["prefill_chunks"],
                    gemma_launches(layers, m["prefill_chunks"], 0,
                                   verifies=m["verify_dispatches"]))
    out["spec_serve"] = row
    del params
    _free(torch, device)
    return out


def gemma_quant_fused_vs_eager(torch, device="cuda",
                               lengths=(1100, 1030, 300, 40), new=8):
    """gemma3-4b at full width cut to 6 layers (one period), float32,
    weights jittered, prompts on both sides of the 1024-token window: in
    every quant mode the kernel plan's greedy tokens equal the eager
    plan's (a weight mode's eager plan on the eager w8 reference, as in
    ``quant_fused_vs_eager``), chunked and whole-prompt, each burst
    launching exactly ``gemma_launches`` for its mode; under kv_int8 the
    speculative engine (prefix cache on) gives the plain engine's tokens;
    the accuracy gate of every quant mode (``accuracy``), its errors
    finite."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.params import dequantize_weights, quantize_weights
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.accuracy import QUANT_MODES
    layers = 6
    cfg = dataclasses.replace(get_config(GEMMA), num_layers=layers,
                              dtype="float32")
    fused_cfg = dataclasses.replace(cfg, use_fused_kernels=True)
    params = _weights(torch, cfg, 1, jitter=True, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    kw = dict(batch_slots=SLOTS, max_len=2048, device=device)
    row = {"phase": "gemma_quant_fused_vs_eager", "config": cfg.name,
           "layers": layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": new}
    bad = []
    for mode in QUANT_MODES:
        qcfg = dataclasses.replace(fused_cfg, quant=mode)
        ref_params = dequantize_weights(qcfg, quantize_weights(qcfg, params))
        row[mode] = {}
        for adm in ("chunked", "whole_prompt"):
            whole = adm == "whole_prompt"
            K.reset_launches()
            eng = ServingEngine(qcfg, params, chunked=not whole, **kw)
            fused = [r.out_tokens for r in eng.generate(
                prompts, max_new_tokens=new)]
            launches = {k: n for k, n in K.launch_counts().items() if n}
            m = eng.metrics
            want = gemma_launches(
                layers, m["prefills"] if whole else m["prefill_chunks"],
                m["scan_ticks"], whole=whole, quant=mode)
            del eng
            eager = [r.out_tokens for r in ServingEngine(
                dataclasses.replace(cfg, quant=mode), ref_params,
                chunked=not whole, **kw).generate(prompts,
                                                  max_new_tokens=new)]
            row[mode][adm] = {"tokens_equal": fused == eager,
                              "fused_tokens": fused, "eager_tokens": eager,
                              "launches": launches, "expected": want,
                              "exact": launches == want}
            if fused != eager:
                bad.append(f"{mode} {adm}: kernel plan != eager plan")
            if launches != want:
                bad.append(f"{mode} {adm}: launched {launches}, expected "
                           f"{want}")
            _free(torch, device)
        del ref_params
        if mode == "kv_int8":
            plain = [r.out_tokens for r in ServingEngine(
                qcfg, params, prefix_cache=False, **kw).generate(
                    prompts, max_new_tokens=new)]
            spec = ServingEngine(qcfg, params, speculative=True, draft_len=4,
                                 **kw)
            spec_tokens = [r.out_tokens for r in spec.generate(
                prompts, max_new_tokens=new)]
            row[mode]["speculative_equal_plain"] = spec_tokens == plain
            row[mode]["speculative_first_divergence"] = [
                _first_divergence(a, b) for a, b in zip(spec_tokens, plain)]
            if spec_tokens != plain:
                bad.append("kv_int8: speculative != plain")
            del spec
            _free(torch, device)
    emit(row)
    del params
    _free(torch, device)
    out = {"fused_vs_eager": row,
           "accuracy": accuracy(torch, cfg, jitter=True, device=device)}
    if bad:
        raise AssertionError("gemma_quant_fused_vs_eager: " + "; ".join(bad))
    return out


def gemma_quant_serve(torch, device="cuda"):
    """gemma3-4b at full width cut to ``GEMMA_QUANT_SERVE_LAYERS``,
    bfloat16, kernel plan, weights drawn on the card (seed 2) and
    jittered, under w8_kv8: ``GEMMA_BURST`` chunked with the prefix cache,
    then whole
    prompts (``serve``), then the speculative burst against the plain
    engine (``spec_serve``; equality reported, not required, as for
    llama3 under w8_kv8).  Each burst must launch exactly
    ``gemma_launches`` under w8_kv8: the code twins and never K1, K2 or
    K8; a prompt served alone repeats its burst tokens."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(GEMMA), use_fused_kernels=True,
                              num_layers=GEMMA_QUANT_SERVE_LAYERS,
                              quant=QUANT_MODE)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=True, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    out = {"quant_serve": {}}
    for mode in ("chunked", "whole_prompt"):
        whole = mode == "whole_prompt"
        row = serve(torch, cfg, params, GEMMA_QUANT_PATHS[mode],
                    init_s=init_s, chunked=not whole, device=device,
                    phase="gemma_quant_serve", max_len=GEMMA_MAX_LEN,
                    lengths=GEMMA_BURST)
        m = row["metrics"]
        prefills = m["prefills"] if whole else m["prefill_chunks"]
        _exact_launches(row["phase"], QUANT_MODE, row, prefills,
                        gemma_launches(layers, prefills, m["scan_ticks"],
                                       whole=whole, quant=QUANT_MODE))
        out["quant_serve"][mode] = row
        _free(torch, device)
    row = spec_serve(torch, cfg, params, GEMMA_QUANT_PATHS["speculative"],
                     init_s=init_s, max_len=GEMMA_MAX_LEN,
                     require_equal=False, phase="gemma_quant_spec_serve",
                     device=device, shared_len=GEMMA_SHARED)
    m = row["metrics"]
    _exact_launches(row["phase"], QUANT_MODE, row, m["prefill_chunks"],
                    gemma_launches(layers, m["prefill_chunks"], 0,
                                   verifies=m["verify_dispatches"],
                                   quant=QUANT_MODE))
    out["quant_spec_serve"] = row
    del params
    _free(torch, device)
    return out


def _hubert_frames(torch, cfg, b, s, seed, device="cuda"):
    """Frame embeddings [b, s, D] in float32 drawn on the device from
    ``seed``, at the token pipeline's scale (0.1 x standard normal): what
    the reference's stubbed feature extractor hands the encoder."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return 0.1 * torch.randn(b, s, cfg.d_model, generator=gen,
                             device=device)


def hubert_fused_vs_eager(torch, device="cuda"):
    """hubert-xlarge at full width cut to 4 layers, float32, weights
    jittered (the LayerNorm scales start at zero): ``forward_hidden`` over
    2 clips of 1000 frames on the kernel plan equals the eager plan's at
    relative 1e-4 (max |d| over max |eager|) with exactly the encode's
    launches; then ``train_fused_vs_eager`` on the pipeline's frame
    batches: the loss (1e-5), every gradient leaf (1e-4) and 3 AdamW
    steps (1e-4)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import forward_hidden
    cfg = dataclasses.replace(get_config(HUBERT), num_layers=4,
                              dtype="float32")
    params = _weights(torch, cfg, 1, jitter=True, device=device)
    frames = _hubert_frames(torch, cfg, 2, HUBERT_FRAMES, 5, device)
    expect = hubert_launches(cfg.num_layers)
    hidden = {}
    with torch.no_grad():
        for fused in (True, False):
            K.reset_launches()
            hidden[fused] = forward_hidden(
                params, dataclasses.replace(cfg, use_fused_kernels=fused),
                {"embeds": frames}, remat=False)
            _sync(torch, device)
            if fused:
                counts, bad = _train_counts(torch, K, expect)
    row = {"phase": "hubert_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "clips": 2,
           "frames": HUBERT_FRAMES,
           "hidden_rel": _rel(hidden[True], hidden[False]),
           "hidden_max_abs": hidden[False].abs().max().item(),
           "launches": counts, "launches_expected": expect}
    emit(row)
    del params, hidden
    _free(torch, device)
    if not row["hidden_rel"] <= 1e-4 or bad:
        raise AssertionError(f"hubert_fused_vs_eager: hidden rel "
                             f"{row['hidden_rel']}, launches off {bad}")
    row["train"] = train_fused_vs_eager(torch, cfg, HUBERT, jitter=True,
                                        device=device)
    return row


def hubert_encode(torch, device="cuda"):
    """hubert-xlarge at full width and depth (48 layers), bfloat16, kernel
    plan, weights drawn on the card (seed 2) and jittered: ``forward_hidden``
    over ``HUBERT_CLIPS`` clips of ``HUBERT_FRAMES`` frames under
    ``torch.no_grad``, twice: each call launching exactly
    ``hubert_launches``, the second bit-equal to the first (required), the
    hidden states finite; frames/s from the second call's wall; a third
    call under ``torch.profiler`` (device ms by stage, idle share against
    its own wall); for scale, the eager plan's hidden states in
    bf16 on the same frames (relative difference reported: the two plans
    sum in other orders over 48 layers)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import forward_hidden
    cfg = dataclasses.replace(get_config(HUBERT), use_fused_kernels=True)
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=True, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    batch = {"embeds": _hubert_frames(torch, cfg, HUBERT_CLIPS,
                                      HUBERT_FRAMES, 3, device)}
    expect = hubert_launches(cfg.num_layers)
    torch.cuda.reset_peak_memory_stats()
    outs, walls, bad = [], [], {}
    with torch.no_grad():
        def encode(c=cfg):
            return forward_hidden(params, c, batch, remat=False)
        for _ in range(2):
            K.reset_launches()
            t1 = time.perf_counter()
            outs.append(encode())
            _sync(torch, device)
            walls.append(time.perf_counter() - t1)
            counts, off = _train_counts(torch, K, expect)
            bad.update(off)
        prof = profile_device(torch, encode)
        eager = encode(dataclasses.replace(cfg, use_fused_kernels=False))
    frames = HUBERT_CLIPS * HUBERT_FRAMES
    if prof is not None:
        # Against the profiled call's own wall: the kernels' summed device
        # time exceeds an unprofiled encode's wall (the device never
        # waits on the host here).
        prof["idle_share"] = 1 - prof["busy_ms"] / prof["profiled_wall_ms"]
    row = {"phase": "hubert_encode", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "clips": HUBERT_CLIPS, "frames_per_clip": HUBERT_FRAMES,
           "init_s": init_s, "wall_s": walls,
           "frames_per_s": frames / walls[1],
           "shape": list(outs[0].shape),
           "finite": bool(torch.isfinite(outs[0]).all()),
           "repeat_bit_equal": bool(torch.equal(outs[0], outs[1])),
           "eager_rel": _rel(outs[0].float(), eager.float()),
           "device_mem_peak": torch.cuda.max_memory_allocated(),
           "launches": counts, "launches_expected": expect,
           "profile": prof}
    emit(row)
    del params, outs, eager
    _free(torch, device)
    problems = []
    if row["shape"] != [HUBERT_CLIPS, HUBERT_FRAMES, cfg.d_model]:
        problems.append(f"shape {row['shape']}")
    if not row["finite"]:
        problems.append("hidden states not finite")
    if not row["repeat_bit_equal"]:
        problems.append("a second encode differs")
    if bad:
        problems.append(f"launches off the path's: {bad}")
    if problems:
        raise AssertionError("hubert_encode: " + "; ".join(problems))
    return row


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #

def _rel(got, want) -> float:
    """max |got - want| over max |want| (float64)."""
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-30)


def _train_counts(torch, K, expect):
    """The launch counts since the last reset, and what differs from
    ``expect`` (every other kernel must stay at 0)."""
    counts = {k: n for k, n in K.launch_counts().items() if n}
    bad = {k: (counts.get(k, 0), expect.get(k, 0))
           for k in set(counts) | set(expect)
           if counts.get(k, 0) != expect.get(k, 0)}
    return counts, bad


def train_fused_vs_eager(torch, cfg, model, *, jitter, device="cuda",
                         steps=3):
    """``cfg``: full width cut to 4 layers, float32.  On one batch (B = 2,
    S = 256, from the token pipeline) the kernel plan's ``forward_train``
    loss must equal the eager plan's at relative 1e-5 and every gradient
    leaf agree at relative 1e-4 (max |d| over max |eager|); then 3
    ``make_train_step`` steps from the same weights on each plan must give
    losses within relative 1e-4.  The kernel plan's launches in each step
    must be the plan's: the forward, the re-run of each layer under remat,
    the loss once (``train_step_launches``)."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import (AdamWConfig, init_opt_state,
                                         make_train_step)
    from repro_torch.models import forward_train, init_params
    from repro_torch.models.params import map_tree, tree_leaves
    from repro_torch.serving.accuracy import jitter_params
    params0 = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                          device=device, dtype=torch.float32)
    if jitter:
        params0 = jitter_params(
            params0, torch.Generator(device=device).manual_seed(11))
    pipe = TokenPipeline(cfg, ShapeConfig("smoke", 256, 2, "train"), seed=0)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in pipe.batch_at(0).items()}
    expect = train_step_launches(model, cfg.num_layers, quant=cfg.quant)
    leaves = tree_leaves(params0)
    for p in leaves:
        p.requires_grad_(True)
    loss, grads = {}, {}
    for fused in (True, False):
        K.reset_launches()
        out = forward_train(params0, dataclasses.replace(
            cfg, use_fused_kernels=fused), batch)
        grads[fused] = torch.autograd.grad(out, leaves)
        _sync(torch, device)
        loss[fused] = float(out.detach())
        if fused:
            grad_counts, grad_bad = _train_counts(torch, K, expect)
    grad_rel = max(_rel(a, b) for a, b in zip(grads[True], grads[False]))
    del grads
    _free(torch, device)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    losses, step_bad = {}, []
    for fused in (True, False):
        run_cfg = dataclasses.replace(cfg, use_fused_kernels=fused)
        params = map_tree(lambda t: t.detach().clone(), params0)
        opt = init_opt_state(params)
        step_fn = make_train_step(run_cfg, opt_cfg, device=device)
        losses[fused] = []
        for i in range(steps):
            K.reset_launches()
            params, opt, m = step_fn(params, opt, pipe.batch_at(i))
            losses[fused].append(float(m["loss"]))
            if fused:
                _, bad = _train_counts(torch, K, expect)
                if bad:
                    step_bad.append((i, bad))
        del params, opt
        _free(torch, device)
    step_rel = [abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                    losses[False])]
    row = {"phase": "train_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": 2,
           "seq_len": 256, "loss_fused": loss[True],
           "loss_eager": loss[False],
           "loss_rel": abs(loss[True] - loss[False]) / abs(loss[False]),
           "grad_rel_max": grad_rel, "step_losses_fused": losses[True],
           "step_losses_eager": losses[False], "step_loss_rel": step_rel,
           "launches_per_step": grad_counts, "expected_per_step": expect}
    emit(row)
    del params0, leaves
    _free(torch, device)
    problems = []
    if not row["loss_rel"] <= 1e-5:
        problems.append(f"loss rel {row['loss_rel']}")
    if not grad_rel <= 1e-4:
        problems.append(f"gradient rel {grad_rel}")
    if not all(r <= 1e-4 for r in step_rel):
        problems.append(f"step losses rel {step_rel}")
    if grad_bad or step_bad:
        problems.append(f"launches off the plan's: {grad_bad} {step_bad}")
    if problems:
        raise AssertionError(f"train_fused_vs_eager {cfg.name}: "
                             + "; ".join(problems))
    return row


def train_w8_ste(torch, cfg, model, *, device="cuda"):
    """``cfg``: full width cut to 4 layers (gemma3 6), float32, ``w8``.
    The straight-through identity on one batch (B = 2, S = 256, from the
    token pipeline): the kernel plan's ``forward_train`` on weights W
    (each w8 stage's int8 twin forward, the reference's straight-through
    backward) against the eager plan's on dq(W), each w8 stage's weight
    quantized and dequantized (``params.quantize_weights``,
    ``dequantize_weights``): the losses at relative 1e-5 (the twins
    against PyTorch's products over the same dequantized weights, as in
    ``train_fused_vs_eager``) and every gradient leaf at relative 1e-4
    (max |d| over max |eager|; a w8 weight's gradient against the eager
    gradient of its dequantized copy, so the gradient passed through
    the rounding as if it were not there); the kernel plan's launches the
    plan's under w8."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models import forward_train, init_params
    from repro_torch.models.params import (dequantize_weights, map_tree,
                                           quantize_weights, tree_leaves)
    fused_cfg = dataclasses.replace(cfg, use_fused_kernels=True)
    params = init_params(fused_cfg,
                         torch.Generator(device=device).manual_seed(3),
                         device=device, dtype=torch.float32)
    with torch.no_grad():
        dq = dequantize_weights(fused_cfg,
                                quantize_weights(fused_cfg, params))
    leaves, dq_leaves = tree_leaves(params), tree_leaves(dq)
    w8 = [i for i, (a, b) in enumerate(zip(leaves, dq_leaves)) if a is not b]
    weight_rel = max(_rel(dq_leaves[i], leaves[i]) for i in w8)
    for t in leaves + [dq_leaves[i] for i in w8]:
        t.requires_grad_(True)
    pipe = TokenPipeline(cfg, ShapeConfig("smoke", 256, 2, "train"), seed=0)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in pipe.batch_at(0).items()}
    expect = train_step_launches(model, cfg.num_layers, quant=cfg.quant)
    K.reset_launches()
    out = forward_train(params, fused_cfg, batch)
    fused = torch.autograd.grad(out, leaves)
    _sync(torch, device)
    counts, bad = _train_counts(torch, K, expect)
    loss_fused = float(out.detach())
    out = forward_train(dq, dataclasses.replace(cfg, use_fused_kernels=False),
                        batch)
    eager = torch.autograd.grad(out, dq_leaves)
    loss_eager = float(out.detach())
    rels = [_rel(a, b) for a, b in zip(fused, eager)]
    row = {"phase": "train_w8_ste", "config": cfg.name, "quant": cfg.quant,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": 2,
           "seq_len": 256, "w8_leaves": len(w8),
           "w8_weight_rel_change": weight_rel, "loss_fused": loss_fused,
           "loss_eager_dequantized": loss_eager,
           "loss_rel": abs(loss_fused - loss_eager) / abs(loss_eager),
           "grad_rel_max": max(rels),
           "grad_rel_max_w8_leaves": max(rels[i] for i in w8),
           "launches": counts, "expected": expect}
    emit(row)
    del params, dq, leaves, dq_leaves, fused, eager, out
    _free(torch, device)
    problems = []
    if not w8:
        problems.append("no w8 weight in the tree")
    if not row["loss_rel"] <= 1e-5:
        problems.append(f"loss rel {row['loss_rel']}")
    if not row["grad_rel_max"] <= 1e-4:
        problems.append(f"gradient rel {row['grad_rel_max']}")
    if bad:
        problems.append(f"launches off the plan's: {bad}")
    if problems:
        raise AssertionError(f"train_w8_ste {cfg.name}: "
                             + "; ".join(problems))
    return row


# Device time by kernel name: the repository's kernels (name fragment ->
# what runs it; every ``__global__`` function in ``csrc/`` matches one),
# the rest is PyTorch's (cuBLAS for the eager backward and the
# o-projection, elementwise, norms, AdamW).
OWN_KERNELS = (("tiled_matmul_kernel", "projections (f32 K3, K5)"),
               ("block_mma_kernel", "projections (K5, tensor cores)"),
               ("rmsnorm_mma_kernel", "projections (K3, tensor cores)"),
               ("rmsnorm_rstd_kernel", "projections (K3, tensor cores)"),
               ("split_reduce_kernel", "float32 split sums (K3-K6)"),
               ("streamed_ffn_kernel", "FFN (f32 K4/K6)"),
               ("ffn_mma_kernel", "FFN (K4/K6, tensor cores)"),
               ("rms_rows_kernel", "FFN (K4/K6, tensor cores)"),
               ("moe_", "MoE experts (K12)"),
               ("mamba2_ssd_kernel", "SSD scan (K13, CUDA cores)"),
               ("ssd_seg_", "SSD scan (K13, tensor cores)"),
               ("wkv6_kernel", "wkv recurrence (K14, CUDA cores)"),
               ("wkv_seg_", "wkv recurrence (K14, tensor cores)"),
               ("flash_mma_kernel", "attention (K2, K7, tensor cores)"),
               ("flash_mma_q_kernel", "attention (K9c, tensor cores)"),
               ("flash_mma_q_window_kernel",
                "attention (K9c, tensor cores)"),
               ("flash_offset_kernel", "attention (CUDA cores)"),
               ("xent_", "loss (K11)"),
               ("paged_window_kernel", "paged attention (K1, K8, K9a/b)"),
               ("paged_combine_kernel", "paged attention (K1, K8, K9a/b)"),
               ("row_norm_kernel", "row norms"),
               ("convert_kernel", "layout converter (K15)"))


def profile_step(torch, tr):
    """One more step of trainer ``tr`` under ``torch.profiler``: device
    milliseconds of the repository's kernels by stage and of PyTorch's
    kernels (cuBLAS gemms apart), the step's wall under the profiler and
    the seconds spent reading the trace.  Only device activity is traced,
    and the trace is read as kineto's flat event list: host op events and
    ``prof.events()``'s tree of them take minutes for a step of ~10^5 small
    launches (rwkv6's eager wkv backward).  None when the trace holds no
    device time."""
    batch = tr.pipeline.batch_at(tr.step)

    def step():
        tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state,
                                                batch)
        float(m["loss"])

    return profile_device(torch, step)


def profile_device(torch, fn):
    """``fn()`` under ``torch.profiler``, device activity only: device
    milliseconds by stage (``OWN_KERNELS``; PyTorch's kernels, cuBLAS
    gemms apart), their sum, the wall of ``fn`` under the profiler and the
    seconds spent reading the trace.  None when the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    ms: dict = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        stage = next((v for k, v in OWN_KERNELS if k in name), None)
        if stage is None:
            stage = ("PyTorch gemm" if any(
                k in name.lower() for k in ("gemm", "xmma", "cutlass"))
                else "PyTorch other")
        ms[stage] = ms.get(stage, 0.0) + e.duration_ns() / 1e6
    if not ms:
        return None
    return {"device_ms": ms, "busy_ms": sum(ms.values()),
            "profiled_wall_ms": wall * 1e3,
            "trace_read_s": time.perf_counter() - t1}


def train(torch, cfg, model, *, steps, ckpt_every, replay_from, lr, note,
          device="cuda", jitter=False):
    """``cfg``: full width (gpt2 also full depth), bfloat16 compute, kernel
    plan, through ``Trainer.run()``: float32 master weights and AdamW
    state drawn by the trainer (seed 0), token-pipeline batches of
    ``TRAIN_SHAPES[model]``, a checkpoint every ``ckpt_every`` steps
    (under ``build/train_ckpt/``, removed after).  With ``replay_from`` a
    second trainer resumes from that step's checkpoint and replays the
    steps after it; its losses must equal the first run's at relative
    1e-3 (bit equality is reported: the embedding's backward accumulates
    with atomics).  Every loss must be finite and the last below the
    first; the launches must be ``steps`` times the plan's per step.
    ``jitter``: the trainer's fresh weights jittered before the first
    step (a LayerNorm stack's zero scales would zero every hidden
    state)."""
    import shutil
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    b, s = TRAIN_SHAPES[model]
    shape = ShapeConfig("train", s, b, "train")
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    first, second = (os.path.join(root, n) for n in ("run", "replay"))
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    # ckpt_every None: no checkpoint at all (the trainer writes one only
    # every ``checkpoint_every`` steps).
    tcfg = dict(total_steps=steps, checkpoint_every=ckpt_every or 10**9,
                log_every=10**9)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=first, **tcfg),
                 opt, device=device)
    if jitter:
        from repro_torch.serving.accuracy import jitter_params
        tr.init()
        tr.params = jitter_params(
            tr.params, torch.Generator(device=device).manual_seed(12))
    K.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    _sync(torch, device)
    wall = time.perf_counter() - t0
    per_step = train_step_launches(model, cfg.num_layers, quant=cfg.quant)
    counts, bad = _train_counts(
        torch, K, {k: n * steps for k, n in per_step.items()})
    losses = [l for _, l in tr.history]
    step_s = statistics.median(tr.step_s[1:])
    row = {"phase": "train", "config": cfg.name, "quant": cfg.quant,
           "layers": cfg.num_layers,
           "dtype": cfg.dtype, "master": "float32", "batch": b,
           "seq_len": s, "steps": steps, "lr": lr, "note": note,
           "losses": losses, "step_s": tr.step_s,
           "step_s_median_after_first": step_s,
           "tokens_per_s": b * s / step_s, "wall_s": wall,
           "device_mem_peak": torch.cuda.max_memory_allocated(),
           "ckpt_snapshot_s": tr.ckpt.snapshot_s,
           "ckpt_write_s": tr.ckpt.write_s,
           "disk_free_bytes": shutil.disk_usage(
               os.path.join(ROOT, "build")).free,
           "launches": counts, "launches_per_step_expected": per_step}
    # Where a step's time goes (one more step, after the counted run); the
    # idle share against the unprofiled median step.
    prof = profile_step(torch, tr)
    if prof is not None:
        prof["idle_share"] = 1 - prof["busy_ms"] / (1e3 * step_s)
    row["profile"] = prof
    del tr
    _free(torch, device)
    problems = []
    if replay_from:
        os.makedirs(second)
        name = f"step-{replay_from:08d}"
        os.replace(os.path.join(first, name), os.path.join(second, name))
        shutil.rmtree(first)
        tr2 = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=second,
                                                **tcfg), opt, device=device)
        if not tr2.resume() or tr2.step != replay_from:
            problems.append(f"no resume at step {replay_from}")
        tr2.run()
        _sync(torch, device)
        replay = [l for _, l in tr2.history]
        row.update(restore_s=tr2.restore_s, replay_losses=replay,
                   replay_rel=[abs(a - b) / abs(b) for a, b in
                               zip(replay, losses[replay_from:])],
                   replay_bit_equal=replay == losses[replay_from:])
        if len(replay) != steps - replay_from or not all(
                r <= 1e-3 for r in row["replay_rel"]):
            problems.append(f"replayed losses {replay} against "
                            f"{losses[replay_from:]}")
        del tr2
    elif ckpt_every:
        # Time a restore of the last checkpoint (no replay).
        from repro_torch.train import latest_checkpoint, restore_checkpoint
        t1 = time.perf_counter()
        restored = restore_checkpoint(latest_checkpoint(first), cfg,
                                      device=device)
        _sync(torch, device)
        row["restore_s"] = time.perf_counter() - t1
        del restored
    _free(torch, device)
    shutil.rmtree(root, ignore_errors=True)
    emit(row)
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}: not finite or not falling")
    if bad:
        problems.append(f"launches off the plan's: {bad}")
    if problems:
        raise AssertionError(f"train {cfg.name}: " + "; ".join(problems))
    return row


def train_w8_ste_phase(torch):
    """``train_w8_ste`` for llama3-8b at 4 layers and gemma3-4b at 6
    (``GEMMA_TRAIN_LAYERS``), float32, under w8."""
    from repro_torch.configs import get_config
    return {m: train_w8_ste(torch, dataclasses.replace(
        get_config(m), num_layers=n, dtype="float32", quant="w8"), m)
        for m, n in (("llama3-8b", 4), (GEMMA, GEMMA_TRAIN_LAYERS))}


def hubert_train(torch):
    """hubert-xlarge at full width cut to ``HUBERT_TRAIN_LAYERS``, bf16
    over float32 masters, weights jittered: 3 steps on the pipeline's
    frame embeddings (2 x 2048), a checkpoint at step 2 and a trainer
    resuming there to replay step 3."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(HUBERT),
                              num_layers=HUBERT_TRAIN_LAYERS,
                              use_fused_kernels=True)
    return train(
        torch, cfg, HUBERT, steps=3, ckpt_every=2, replay_from=2,
        lr=HUBERT_LR, jitter=True,
        note=f"full width cut to {HUBERT_TRAIN_LAYERS} of its 48 layers "
             "on the pipeline's frame embeddings, weights jittered; a "
             "checkpoint at step 2 and a trainer resuming there to replay "
             "step 3")


def gemma_train(torch, quant="none"):
    """gemma3-4b at full width cut to ``GEMMA_TRAIN_LAYERS``, bf16 over
    float32 masters: 3 steps on 2 x 2048 tokens, lr 3e-5, no
    checkpoint."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(GEMMA), num_layers=GEMMA_TRAIN_LAYERS,
                              use_fused_kernels=True, quant=quant)
    return train(
        torch, cfg, GEMMA, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
        note=f"full width cut to {GEMMA_TRAIN_LAYERS} layers (five local, "
             "one global): float32 weights, gradients and two AdamW moments "
             "of all 34 take 75 GB; no checkpoint (the CPU tests hold "
             "gemma3 checkpoints to the reference)")


def quant_train(torch):
    """The w8 training entries, bf16 over float32 masters, 3 steps each,
    no checkpoint: gemma3-4b at ``GEMMA_TRAIN_LAYERS`` (K10a, K10b's
    GELU-GLU with ln2 folded in), llama3-8b at 2 layers (K10a, K10b's
    SiLU-GLU) and gpt2 at full depth (K5, K10c), each w8 weight quantized
    at every call from the live float32 masters."""
    from repro_torch.configs import get_config
    note = ("w8: the int8 twins forward, the straight-through gradient "
            "back, float32 masters; no checkpoint")
    out = {GEMMA: gemma_train(torch, quant="w8")}
    out["llama3-8b"] = train(
        torch, dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                                   use_fused_kernels=True, quant="w8"),
        "llama3-8b", steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
        note=note + "; full width cut to 2 layers, as the bf16 entry")
    out["gpt2"] = train(
        torch, dataclasses.replace(get_config("gpt2"), use_fused_kernels=True,
                                   quant="w8"),
        "gpt2", steps=3, ckpt_every=None, replay_from=0, lr=1e-3,
        note=note + "; full width and depth")
    return out


def train_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """The training paths' rows (path "train") of llama3-8b's, gpt2's and
    gemma3-4b's kernel cases: K3, K10a, K4, K10b, K5, K6, K10c, K7 and
    gemma3's K11 at a step's tokens."""
    return [c for fn in (_llama_cases, _gpt2_cases, gemma_kernel_cases)
            for c in fn(torch, K, ref, dtype, gen)
            if c.get("path") == "train"]


# --------------------------------------------------------------------- #
# The compile path: the StreamTensor compiler, then K15 on every edge
# --------------------------------------------------------------------- #

# One block of each ported family at full width and its registry config,
# compiled with the reference's defaults (TPU_V5E, dse_budget 12) at 128
# tokens, as ``examples/quickstart.py`` compiles one; llama3-8b again at
# the serving bursts' longest prompt, whose largest stream (ln2 -> the
# gate projection) is 3.67e9 elements, 7.34 GB in bf16: past INT32_MAX,
# so it exercises the kernel's 64-bit offsets.
COMPILE_MODELS = ("llama3-8b", "gpt2", GRANITE, ZAMBA, RWKV, HUBERT)
COMPILE_TOKENS = 128
COMPILE_LONG = ("llama3-8b", 1000)
# Tokens of each stream held against direct slicing, besides the first
# and the last.
SLICE_SAMPLES = 32


def _tile_at(dst, t: int):
    """(row, column) data offset of stream token ``t`` of ``dst``, by
    Python integer arithmetic (independent of the kernel's and the plain
    version's decoding)."""
    idx, rem = [], t
    for tc in reversed(dst.tripcounts):
        idx.append(rem % tc)
        rem //= tc
    idx.reverse()
    return tuple(idx[k] * dst.steps[k] for k in dst.iter_map.results)


def _stream_cases(c, model, tokens):
    """One case per edge of a compiled block, with and without a
    converter."""
    return [dict(model=model, tokens=tokens,
                 edge=f"{u}->{v}" + (f"#{k}" if k else ""),
                 src=d["src_type"], dst=d["dst_type"],
                 spec=c.graph.edge_converter(u, v, k))
            for u, v, k, d in c.graph.edges()]


def _edge_data(torch, case, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(case["src"].data_shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _materialize(torch, K, ref, case, dtype, seed, device):
    """One edge on the main path: K15 on the producer tensor; the stream
    must equal the plain version (``torch.equal``: a copy, tolerance 0)
    and, on the first, the last and ``SLICE_SAMPLES`` seeded tokens,
    direct slicing of the tensor at ``dst``'s offsets."""
    src, dst = case["src"], case["dst"]
    data = _edge_data(torch, case, dtype, seed, device)
    out = K.convert_layout(data, src, dst)
    plain = ref.convert_layout_ref(data, src, dst)
    _sync(torch, device)
    equal_plain = bool(torch.equal(out, plain))
    del plain
    n = dst.num_tokens
    rng = np.random.default_rng(seed)
    sample = {0, n - 1, *rng.integers(0, n, SLICE_SAMPLES).tolist()}
    eh, ew = dst.elem_shape
    equal_slices = all(
        torch.equal(out[t], data[oh:oh + eh, ow:ow + ew])
        for t in sample for oh, ow in [_tile_at(dst, t)])
    return {"equal_plain": equal_plain, "equal_slices": equal_slices,
            "elements": out.numel()}


def _time_edge(torch, K, ref, timer, case, dtype, seed, device):
    """CUDA-event times of one edge: the kernel, the plain version, and
    one ``aten::index`` gather ``data[ih, iw]`` (the library call; its
    index tensors built outside the timed region); the bound moves the
    producer tensor once and the stream once at 3.35 TB/s."""
    src, dst = case["src"], case["dst"]
    data = _edge_data(torch, case, dtype, seed, device)
    n = dst.num_tokens
    eh, ew = dst.elem_shape
    oh, ow = ref.stream_token_offsets(dst, torch.arange(n, device=device))
    ih = (oh[:, None] + torch.arange(eh, device=device))[:, :, None]
    iw = (ow[:, None] + torch.arange(ew, device=device))[:, None, :]
    del oh, ow
    lib = data[ih, iw]
    same_library = bool(torch.equal(lib, ref.convert_layout_ref(data, src,
                                                                dst)))
    del lib
    nbytes = (data.numel() + n * eh * ew) * data.element_size()
    bound_ms, bound_by = bound(nbytes, 0.0, "bfloat16")
    row = {"ms": timer(lambda: K.convert_layout(data, src, dst)),
           "plain_ms": timer(lambda: ref.convert_layout_ref(data, src, dst),
                             iters=3),
           "library_ms": timer(lambda: data[ih, iw]),
           "library_equal": same_library,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
    del ih, iw, data
    _free(torch, device)
    return row


def compile_path(torch, timer, device="cuda"):
    """The compile path: ``compile_model`` on each ``COMPILE_MODELS``
    block (and ``COMPILE_LONG``), ``simulate_dataflow`` with the LP-sized
    FIFOs (required: completed), then every edge of each compiled graph,
    with and without a converter, through K15 in bfloat16 and float32
    (``COMPILE_LONG`` in bfloat16, one edge at a time), beside the
    identity FIFO and the paper's Fig. 5 pair.  Each group of streams is
    driven with the launch counts set to 0 just before it and read just
    after (exactly one K15 launch per stream); then each stream is timed.
    Returns the emitted rows, one aggregate row per group for the
    ``kernels`` line, and the groups' launch counts."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import compile_model, fig5_b, fig5_c
    from repro_torch.kernels import ref
    from repro_torch.runtime import simulate_dataflow
    t_phase = time.perf_counter()
    groups, blocks, compiled = {}, [], {}
    for model, tokens in [(m, COMPILE_TOKENS) for m in COMPILE_MODELS] + \
            [COMPILE_LONG]:
        t0 = time.perf_counter()
        c = compiled[model, tokens] = compile_model(get_config(model),
                                                    tokens=tokens)
        compile_s = time.perf_counter() - t0
        cases = _stream_cases(c, model, tokens)
        row = {"phase": "compile", "model": model, "tokens": tokens,
               "compile_s": compile_s, "stage_seconds": c.stage_seconds,
               "kernels": c.graph.num_kernels,
               "fusion_groups": [sorted(g) for g in c.fusion.groups],
               "implementations": [g.implementation for g in c.lowered],
               "fifo_total_depth": c.fifo.total_depth,
               "edges": len(cases),
               "converter_edges": sum(x["spec"] is not None for x in cases),
               "stream_bytes_bf16": sum(x["dst"].num_tokens
                                        * math.prod(x["dst"].elem_shape) * 2
                                        for x in cases)}
        if tokens == COMPILE_TOKENS:
            timings = {k.name: k.timing for k in c.graph.kernels()}
            t0 = time.perf_counter()
            sim = simulate_dataflow(c.graph, timings, plan=c.fifo)
            row.update(sim_completed=sim.completed, sim_makespan=sim.makespan,
                       sim_s=time.perf_counter() - t0)
            if not sim.completed:
                emit(row)
                raise AssertionError(f"compile {model}: the LP-sized FIFOs "
                                     f"deadlock at {sim.deadlock_kernels}")
        emit(row)
        blocks.append(row)
        path = "compile" if tokens == COMPILE_TOKENS else f"compile_{tokens}"
        groups[(model, path)] = cases
    ident = compiled["llama3-8b", COMPILE_TOKENS].graph.kernel(
        "L0.ln1").out_type
    groups[("itensor", "compile")] = [
        dict(model="itensor", tokens=None, edge="identity_fifo", src=ident,
             dst=ident, spec=None),
        dict(model="itensor", tokens=None, edge="fig5_b->fig5_c",
             src=fig5_b(), dst=fig5_c(), spec=None)]

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    edge_rows, paths, bad = [], [], []
    for (model, path), cases in groups.items():
        names = ("bfloat16",) if path != "compile" else tuple(dtypes)
        K.reset_launches()
        checks = [(i, case, d, _materialize(torch, K, ref, case,
                                            dtypes[d], i, device))
                  for i, case in enumerate(cases) for d in names]
        launches = K.launch_counts()
        paths.append((model, path, launches))
        want = {n: 0 for n in launches}
        want["convert_layout"] = len(checks)
        if launches != want:
            bad.append(f"{model} {path}: launches {launches}")
        for i, case, d, chk in checks:
            spec, dst = case["spec"], case["dst"]
            row = {"phase": "compile_edge", "model": model, "path": path,
                   "edge": case["edge"], "dtype": d,
                   "src": str(case["src"]), "dst": str(dst),
                   "converter": (None if spec is None else
                                 {"buf_shape": spec.buf_shape,
                                  "shared_prefix_len":
                                      spec.shared_prefix_len,
                                  "reuse_count": spec.reuse_count}),
                   "tokens": dst.num_tokens,
                   "shape": f"{case['src'].data_shape}->"
                            f"[{dst.num_tokens},{dst.elem_shape[0]},"
                            f"{dst.elem_shape[1]}]",
                   **chk,
                   **_time_edge(torch, K, ref, timer, case, dtypes[d], i,
                                device)}
            row["ok"] = bool(row["equal_plain"] and row["equal_slices"]
                             and row["library_equal"])
            if not row["ok"]:
                bad.append(f"{model} {path} {case['edge']} {d}")
            emit(row)
            edge_rows.append(row)
    # One row per group for the kernels line: its streams' bf16 times and
    # bounds summed (the whole block's materialization).
    summary_rows = []
    for model, path, _ in paths:
        mine = [r for r in edge_rows if r["model"] == model
                and r["path"] == path and r["dtype"] == "bfloat16"]
        summary_rows.append({
            "name": "convert_layout", "model": model, "path": path,
            "dtype": "bfloat16", "head_dim": None,
            "shape": f"{len(mine)} streams",
            "max_abs_err": 0.0 if all(r["equal_plain"] for r in mine)
            else math.inf,
            "ok": all(r["ok"] for r in edge_rows
                      if r["model"] == model and r["path"] == path),
            **{k: sum(r[k] for r in mine)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": "bytes"})
    emit({"phase": "compile_done",
          "seconds": time.perf_counter() - t_phase,
          "streams": len(edge_rows)})
    if bad:
        raise AssertionError("compile path: " + "; ".join(bad))
    return {"blocks": blocks, "edges": edge_rows, "rows": summary_rows,
            "paths": paths}


# --------------------------------------------------------------------- #

# --------------------------------------------------------------------- #
# The compiler's plans on the card: 10-token pages, the static verifier
# --------------------------------------------------------------------- #

# ``serve_pages``: gpt2 at full width cut to ``PAGES_LAYERS``, chunked, at
# ``max_len`` 1000, where the compiler's plan streams 10-token pages and
# 130-token chunks (K1 / K8 / K9a / K9b over 10-token pages, K2 / K9c on
# 130-row chunks), beside the same burst at 1024 (16-token pages,
# 128-token chunks).  The prompts cross chunk and page edges.
PAGES_LAYERS = 6
PAGES_MAX_LEN, PAGES_REF_LEN = 1000, 1024
PAGES_LENGTHS = (975, 131, 130, 261, 37, 10, 11, 600)
PAGES_NEW = 16
PAGES_ENGINES = {"plain": {}, "speculative": dict(speculative=True,
                                                  draft_len=4),
                 "kv_int8": dict(quant="kv_int8")}


def gpt2_launches(layers: int, prefills: int, steps: int, verifies: int = 0,
                  quant: str = "none") -> dict:
    """Every kernel's exact launches in a gpt2 burst of ``prefills``
    prompt chunks, ``steps`` decode steps and ``verifies`` verify
    dispatches: per layer and call ln1 and ln2 through the row-norm
    kernel, q, k, v and the o-projection through block_matmul, the MLP
    through streamed_mlp; attention once per layer in a chunk (K2), a
    decode step (K1) and a verify dispatch (K8); the final LayerNorm and
    the LM head (row_norm, block_matmul) once per call.  Under a KV mode
    the attention kernels read codes (K9c, K9a, K9b)."""
    prefills, steps, verifies = int(prefills), int(steps), int(verifies)
    calls = prefills + steps + verifies
    kv8 = quant in ("kv_int8", "kv_fp8", "w8_kv8")
    q = "_q" if kv8 else ""
    out = {"block_matmul": (4 * layers + 1) * calls,
           "row_norm": (2 * layers + 1) * calls,
           "streamed_mlp": layers * calls,
           f"flash_attention{q}": layers * prefills,
           f"paged_attention{q}": layers * steps,
           f"paged_verify_attention{q}": layers * verifies}
    return {k: n for k, n in out.items() if n}


def pages_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """The kernels over the compiler's new granules, at gpt2's widths (16
    heads of 64) and llama3-8b's (32 over 8 heads of 128): K1 and K9a
    over 10-token pages (4 slots of 1000, 517, 37 and 0 tokens) beside
    16-token pages, K8 and K9b over 10-token pages, K2 and K9c on a
    130-row chunk at offset 870 (1000 positions live in a 1008-position
    gathered extent, whole 16-position scale pages for the codes); tagged
    ``pages_10``."""
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    for model, (hq, hkv, hd) in (("gpt2", (16, 16, 64)),
                                 ("llama3-8b", (32, 8, 128))):
        for ps in (10, 16):
            c = _paged_case(torch, K, ref, randn, isz, gen, hq, hkv, hd,
                            -(-1000 // ps), dev, ps=ps)
            cases.append(dict(c, model=model,
                              path="pages_10" if ps == 10 else None))
        for code in (None, "int8"):
            if code is not None:
                cases.append(dict(_paged_case(
                    torch, K, ref, randn, isz, gen, hq, hkv, hd, 100, dev,
                    code=code, ps=10), model=model, path="pages_10"))
            cases.append(dict(_verify_case(
                torch, K, ref, randn, isz, gen, hq, hkv, hd, 101, dev,
                code=code, ps=10), model=model, path="pages_10"))
            cases.append(dict(_flash_case(
                torch, K, ref, randn, isz,
                "flash_attention" if code is None else "flash_attention_q",
                hq, hkv, hd, 130, 1008, 870, dev, code), model=model,
                path="pages_10"))
    return cases


def _page_bits(torch):
    """K1 over the same K/V in 10-, 15- and 16-token pages, bit for bit
    (reported: the float32 token equality below rests on it)."""
    from repro_torch import kernels as K
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(78)
        randn = _randn(torch, gen, dtype, "cuda")
        b, s = 4, 1200
        lengths = torch.tensor([1000, 517, 37, 0], dtype=torch.int32,
                               device="cuda")
        kseq, vseq = randn(b, s, 16, 64), randn(b, s, 16, 64)
        qd = randn(b, 1, 16, 64)
        got = {}
        for ps in (10, 15, 16):
            def pool(seq):
                body = seq.reshape(b * (s // ps), ps, 16, 64)
                return torch.cat([torch.zeros_like(body[:1]), body])
            table = (torch.arange(b * (s // ps), device="cuda",
                                  dtype=torch.int32).reshape(b, -1) + 1)
            got[ps] = K.paged_decode_attention(qd, pool(kseq), pool(vseq),
                                               table, lengths)
        out[str(dtype).split(".")[-1]] = {
            ps: bool(torch.equal(got[ps], got[16])) for ps in (10, 15)}
    return out


def _seeded_plan_refusal(torch, device="cuda"):
    """An engine handed a plan with an over-budget tile: zamba2-2.7b at
    full width (1 layer), float32, whose plan asks the SSD scan for
    256-row chunks at 4096 tokens (a float32 block of 480 KB).  Strict,
    it raises ``PlanVerificationError`` (``smem-exceeded``) before any
    allocation or launch; with ``verify="off"`` the same plan builds an
    engine, and its first prefill is refused by the kernel's wrapper with
    the bytes the lint counted, still before any launch."""
    from repro_torch import kernels as K
    from repro_torch.analysis import PlanVerificationError, smem_estimate
    from repro_torch.configs import get_config
    from repro_torch.core.stream_plan import KernelChoice, build_stream_plan
    import repro_torch.serving.engine as E
    cfg = dataclasses.replace(get_config(ZAMBA), num_layers=1,
                              dtype="float32", use_fused_kernels=True)
    plan = build_stream_plan(cfg, tokens=4096, kv_len=4096)
    bad_choice = KernelChoice("mamba2_scan", (("chunk", 256),))
    bad = plan.with_stage("mamba", "mixer", bad_choice)
    need = smem_estimate(cfg, bad, "mixer", bad_choice)
    params = _weights(torch, cfg, 3, jitter=False, device=device)
    real = E.resolve_plan
    E.resolve_plan = lambda *a, **k: bad
    K.reset_launches()
    row = {"phase": "serve_pages_seeded_plan", "config": cfg.name,
           "layers": 1, "dtype": cfg.dtype, "chunk": 256,
           "smem_estimate": need}
    try:
        try:
            E.ServingEngine(cfg, params, batch_slots=2, max_len=4096,
                            device=device)
            row["strict"] = "built"
        except PlanVerificationError as e:
            row["strict"] = sorted({d.code for d in e.diagnostics
                                    if d.severity == "error"})
        row["strict_launches"] = sum(K.launch_counts().values())
        eng = E.ServingEngine(cfg, params, batch_slots=2, max_len=4096,
                              device=device, verify="off")
        row["off_built"] = eng.plan.verified is None
        try:
            eng.generate([np.arange(512, dtype=np.int32) % 100],
                         max_new_tokens=2)
            row["off_prefill"] = "served"
        except ValueError as e:
            row["off_prefill"] = str(e)
        row["off_scan_launches"] = K.launch_counts()["mamba2_scan"]
    finally:
        E.resolve_plan = real
    emit(row)
    del params
    _free(torch, device)
    ok = (row["strict"] == ["smem-exceeded"] and row["strict_launches"] == 0
          and row["off_built"] and str(need) in row["off_prefill"]
          and row["off_scan_launches"] == 0)
    return row, ok


def serve_pages(torch, timer, device="cuda"):
    """``pages_kernel_cases`` against the plain versions (bf16 and f32),
    ``_page_bits``, then gpt2 at full width cut to ``PAGES_LAYERS``,
    chunked, through ``PAGES_ENGINES`` at ``max_len`` 1000 (the plan's
    10-token pages and 130-token chunks) and 1024 (16 and 128), in float32
    and bfloat16: launches exact at both (``gpt2_launches``), the page
    size and chunk the plan's; in float32 the plain and speculative
    tokens equal across the two (required; kv_int8 reported: each page's
    scale covers other positions at another page size); bf16 reported.
    Then ``_seeded_plan_refusal`` (required)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine
    out = {"kernel_rows": check_kernels(torch, timer, (pages_kernel_cases,),
                                        phase="pages_kernel_cases")}
    out["bits"] = _page_bits(torch)
    emit({"phase": "serve_pages_bits", "equal_to_ps16": out["bits"]})
    bad, bursts, equal = [], {}, {}
    prompts = burst(np.random.default_rng(4), get_config("gpt2").vocab_size,
                    PAGES_LENGTHS)
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("gpt2"),
                                  num_layers=PAGES_LAYERS, dtype=dname,
                                  use_fused_kernels=True)
        params = _weights(torch, cfg, 4, jitter=True, device=device)
        for name, kw in PAGES_ENGINES.items():
            toks = {}
            for max_len in (PAGES_MAX_LEN, PAGES_REF_LEN):
                eng = ServingEngine(cfg, params, batch_slots=SLOTS,
                                    max_len=max_len, device=device, **kw)
                K.reset_launches()
                t0 = time.perf_counter()
                reqs = eng.generate(prompts, max_new_tokens=PAGES_NEW)
                _sync(torch, device)
                wall = time.perf_counter() - t0
                m = eng.metrics
                got = {k: n for k, n in K.launch_counts().items() if n}
                want = gpt2_launches(
                    PAGES_LAYERS, m["prefill_chunks"],
                    0 if eng.speculative else m["scan_ticks"],
                    m["verify_dispatches"], eng.cfg.quant)
                toks[max_len] = [r.out_tokens for r in reqs]
                key = f"{dname}/{name}/{max_len}"
                row = {"phase": "serve_pages", "engine": name,
                       "dtype": dname, "layers": PAGES_LAYERS,
                       "max_len": max_len, "page_size": m["page_size"],
                       "prefill_chunk": m["prefill_chunk"],
                       "verified": m["verified"], "wall_s": wall,
                       "launches": got, "expected": want,
                       "exact": got == want,
                       **{k: m[k] for k in ("prefill_chunks", "scan_ticks",
                                            "verify_dispatches",
                                            "accepted_tokens",
                                            "prefix_hit_pages")}}
                emit(row)
                bursts[key] = row
                want_geom = ((10, 130) if max_len == PAGES_MAX_LEN
                             else (16, 128))
                if (m["page_size"], m["prefill_chunk"]) != want_geom:
                    bad.append(f"{key}: page size {m['page_size']}, chunk "
                               f"{m['prefill_chunk']}")
                if got != want:
                    bad.append(f"{key}: launched {got}, expected {want}")
                if m["verified"] != 1:
                    bad.append(f"{key}: the plan did not verify")
                if any(r.failed or len(r.out_tokens) != PAGES_NEW
                       for r in reqs):
                    bad.append(f"{key}: a request failed or fell short")
                del eng
            same = toks[PAGES_MAX_LEN] == toks[PAGES_REF_LEN]
            equal[f"{dname}/{name}"] = {
                "equal": same, "first_divergence": [
                    _first_divergence(a, b) for a, b in
                    zip(toks[PAGES_MAX_LEN], toks[PAGES_REF_LEN])]}
            if dname == "float32" and name != "kv_int8" and not same:
                bad.append(f"float32 {name}: 10-token pages gave other "
                           "tokens than 16-token pages")
        del params
        _free(torch, device)
    emit({"phase": "serve_pages_tokens", "equal": equal})
    out["seeded_plan"], ok = _seeded_plan_refusal(torch, device)
    if not ok:
        bad.append("the seeded plan was not refused as expected")
    if bad:
        raise AssertionError("serve_pages: " + "; ".join(bad))
    out.update(bursts=bursts, tokens=equal)
    return out


# --------------------------------------------------------------------- #
# The autotuner: the round trip on gpt2 at full size, llama3-8b's chunked
# burst under a tuned plan
# --------------------------------------------------------------------- #

# The round trip's gpt2 burst: ``serve_pages``'s prompts (across chunk and
# page edges) at ``max_len`` 1024.
TUNE_LENGTHS = PAGES_LENGTHS
TUNE_MAX_LEN = 1024
TUNE_NEW = 16
TUNE_DIR = os.path.join(ROOT, "build", "tune")


def _tune_path(name: str) -> str:
    """A fresh table file under ``build/tune/`` (any old one removed)."""
    os.makedirs(TUNE_DIR, exist_ok=True)
    path = os.path.join(TUNE_DIR, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def _table_sources(path: str) -> dict:
    """({kernel family: sorted sources of its entries}, backend) of a
    table file."""
    with open(path) as fh:
        raw = json.load(fh)
    out: dict = {}
    for key, e in raw["entries"].items():
        out.setdefault(key.split("|")[0], set()).add(e["source"])
    return {k: sorted(v) for k, v in out.items()}, raw["backend"]


def _collapsed_bits(torch, cfg, plan, device="cuda"):
    """For each stage of a driver family: its choice and the lattice point
    with every hint-only block (a name outside the family's
    ``CARD_BLOCKS``) moved to another lattice value, which the card
    signature collapses onto the choice, each through the tuner's driver
    on the same seeded operands: {stage: (blocks, other blocks, outputs
    bit-equal)}.  Equal bits are what the declaration claims."""
    from repro_torch.tuning import card_blocks
    from repro_torch.tuning.autotune import _signature, _tune_spaces
    from repro_torch.tuning.measure import DRIVEN, _driver
    dev = torch.device(device)
    out = {}
    for kind, stage, choice in plan.stage_choices():
        if (not choice.fused
                or choice.implementation not in DRIVEN):
            continue
        space = _tune_spaces()[choice.implementation]
        keep = card_blocks(choice.implementation, cfg.dtype)
        other = dataclasses.replace(choice, blocks=tuple(
            (n, next(x for x in sorted(space[n]) if x != v)
             if n in space and n not in keep else v)
            for n, v in choice.blocks))
        if (_signature(cfg, plan, stage, other, "cuda")
                != _signature(cfg, plan, stage, choice, "cuda")):
            raise AssertionError(f"{kind}.{stage}: {other.blocks} does not "
                                 f"collapse onto {choice.blocks}")
        a = _driver(cfg, plan, stage, choice, dev)()
        b = _driver(cfg, plan, stage, other, dev)()
        _sync(torch, device)
        out[f"{kind}.{stage}"] = {
            "blocks": [list(choice.blocks), list(other.blocks)],
            "equal": bool(torch.equal(a, b))}
        del a, b
    return out


def tune_roundtrip(torch, device="cuda"):
    """``python -m repro_torch.tuning``'s round trip on gpt2 at full width
    and depth (24 layers, jittered seed-5 weights), bf16 and float32: 4
    slots, ``max_len`` 1024, ``TUNE_LENGTHS`` prompts, ``TUNE_NEW`` new
    tokens.  Required: the first start tunes and writes a table stamped
    with the card's fingerprint, whose driver families' entries are
    ``measured`` and paged entries ``analytic``; the second start makes
    zero measurements and resolves an equal plan and equal tokens; in
    float32 the tuned tokens equal the untuned engine's (bf16: reported);
    for each driver family two candidates the card signature collapses
    give bit-equal outputs (``_collapsed_bits``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.stream_plan import plan_for
    from repro_torch.serving import ServingEngine
    from repro_torch.tuning import backend_fingerprint
    from repro_torch.tuning.__main__ import round_trip
    from repro_torch.tuning.measure import DRIVEN
    fp = backend_fingerprint(device)
    out, bad = {"backend": fp}, []
    prompts = burst(np.random.default_rng(5), get_config("gpt2").vocab_size,
                    TUNE_LENGTHS)
    for dname in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("gpt2"), dtype=dname,
                                  use_fused_kernels=True)
        params = _weights(torch, cfg, 5, jitter=True, device=device)
        path = _tune_path(f"gpt2-{dname}.json")
        t0 = time.perf_counter()
        stats, failures = round_trip(
            cfg, params, prompts, path=path, device=device, slots=SLOTS,
            max_len=TUNE_MAX_LEN, new_tokens=TUNE_NEW)
        wall = time.perf_counter() - t0
        sources, backend = _table_sources(path)
        plan_for.cache_clear()
        base = ServingEngine(cfg, params, batch_slots=SLOTS,
                             max_len=TUNE_MAX_LEN, device=device)
        untuned = [r.out_tokens for r in base.generate(
            [p.copy() for p in prompts], max_new_tokens=TUNE_NEW)]
        geometry = (base.metrics["page_size"], base.metrics["prefill_chunk"])
        del base
        bits = _collapsed_bits(torch, cfg, plan_for(cfg, SLOTS,
                                                    TUNE_MAX_LEN), device)
        same = stats["tokens"] == untuned
        row = {"phase": "tune_roundtrip", "config": cfg.name,
               "layers": cfg.num_layers, "dtype": dname, "wall_s": wall,
               **{k: v for k, v in stats.items() if k != "tokens"},
               "table_backend": backend, "entry_sources": sources,
               "untuned_geometry": list(geometry),
               "tuned_equals_untuned": same,
               "first_divergence": [_first_divergence(a, b) for a, b in
                                    zip(stats["tokens"], untuned)],
               "collapsed_bits": bits}
        emit(row)
        out[dname] = row
        bad += [f"{dname}: {f}" for f in failures]
        if backend != fp:
            bad.append(f"{dname}: table backend {backend!r}, not {fp!r}")
        for fam, srcs in sources.items():
            want = ["measured"] if fam in DRIVEN else ["analytic"]
            if srcs != want:
                bad.append(f"{dname}: {fam} entries {srcs}, expected {want}")
        if not set(DRIVEN) & set(sources):
            bad.append(f"{dname}: no driver family was timed")
        if dname == "float32" and not same:
            bad.append("float32: tuned tokens differ from the untuned "
                       "engine's")
        for st, b in bits.items():
            if not b["equal"]:
                bad.append(f"{dname} {st}: collapsed candidates differ")
        del params
        _free(torch, device)
    if bad:
        raise AssertionError("tune_roundtrip: " + "; ".join(bad))
    return out


def _kernel_row_ms(rows, name, shape):
    """The ``kernel`` phase's bf16 llama3-8b time of ``name`` at ``shape``
    (its shape label), or None where it has no such row."""
    for r in rows or ():
        if (r["name"] == name and r["model"] == "llama3-8b"
                and r["dtype"] == "bfloat16" and r["shape"] == shape):
            return r["ms"]
    return None


def tune_serve(torch, timer, rows=None, device="cuda"):
    """llama3-8b at full width, ``SERVE_LAYERS`` deep, bf16, seed-2 weights:
    the tuning pass over the engine's plan (4 slots over 2048 positions)
    into a fresh table (host seconds, the card memory it adds at its
    peak; each measured latency beside the same call timed as the
    ``kernel`` phase times (L2 flushed) and that phase's row at the same
    shape, from ``rows``), then ``serve``'s chunked burst untuned and
    under ``autotune=`` that tuner.  Required: every driver stage timed
    once and ``measured``, the plan ``hybrid``; the tuned burst launches
    exactly its path's kernels (``qwen_launches`` from its chunks and
    decode ticks), in as many chunks as the tuned chunk cuts the prompts
    into, over the tuned page size; its bf16 tokens equal the untuned
    burst's, or every differing request equals the untuned plan served at
    the tuned page size and chunk (its cause: the granules)."""
    from repro_torch.configs import get_config
    from repro_torch.core.stream_plan import plan_for
    from repro_torch.tuning import Tuner, make_key
    from repro_torch.tuning.autotune import _shape_ctx
    from repro_torch.tuning.measure import DRIVEN, _driver
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              use_fused_kernels=True,
                              num_layers=SERVE_LAYERS["llama3-8b"])
    layers = cfg.num_layers
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=False, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    max_len = 2048
    tuner = Tuner(_tune_path("llama3-8b.json"), device=device)
    base = plan_for(cfg, SLOTS, max_len)
    _sync(torch, device)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    tuned = tuner.tune_plan(cfg, base)
    _sync(torch, device)
    tune_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - mem0 if cuda else None
    bad, latencies = [], []
    for kind, stage, choice in tuned.stage_choices():
        if not choice.fused or stage == "verify_attn":
            continue
        key = make_key(choice.implementation, shape=_shape_ctx(cfg, tuned),
                       dtype=cfg.dtype, quant=cfg.quant,
                       mesh_axes=tuned.mesh_axes, blocks=choice.blocks)
        entry = tuner.table.entries[key]
        fam = choice.implementation
        same = sum(1 for k in tuner.table.entries
                   if k.split("|")[0] == fam)
        lat = {"stage": f"{kind}.{stage}", "kernel": fam,
               "blocks": list(choice.blocks), "source": choice.source,
               "tuned_ms": entry.latency_s * 1e3, "entries": same}
        if fam in DRIVEN:
            fn = _driver(cfg, tuned, stage, choice, torch.device(device))
            lat["kernel_phase_ms"] = timer(fn)
            t, d = tuned.tokens, cfg.d_model
            label = {"rmsnorm_matmul": f"T={t},D={d},N="
                     f"{min(cfg.q_dim, cfg.kv_dim)}",
                     "streamed_ffn": f"T={t},D={d},F={cfg.d_ff}"}.get(fam)
            lat["kernel_row_ms"] = _kernel_row_ms(rows, fam, label)
            del fn
            if choice.source != "measured" or same != 1:
                bad.append(f"{kind}.{stage}: {same} entries, source "
                           f"{choice.source}")
        latencies.append(lat)
    _free(torch, device)
    row = {"phase": "tune_serve_pass", "config": cfg.name,
           "layers": layers, "tokens": tuned.tokens,
           "kv_len": tuned.kv_len, "host_s": tune_s,
           "peak_card_bytes": peak, "candidates": tuner.stats.candidates,
           "pruned": tuner.stats.pruned, "measured": tuner.stats.measured,
           "plan_source": tuned.cost_source,
           "page_size": tuned.decode_page_size(),
           "base_page_size": base.decode_page_size(),
           "latencies": latencies}
    emit(row)
    if tuned.cost_source != "hybrid":
        bad.append(f"plan source {tuned.cost_source}, expected hybrid")
    out = {"pass": row}
    out["untuned"] = serve(torch, cfg, params, LLAMA_PATH, init_s=init_s,
                           device=device, max_len=max_len, hi=1000,
                           phase="tune_serve_untuned", keep_tokens=True)
    _free(torch, device)
    out["tuned"] = serve(torch, cfg, params, LLAMA_PATH, init_s=init_s,
                         device=device, max_len=max_len, hi=1000,
                         phase="tune_serve", keep_tokens=True,
                         engine_kw={"autotune": tuner})
    _free(torch, device)
    r = out["tuned"]
    ps, chunk = r["page_size"], r["prefill_chunk"]
    if ps != tuned.decode_page_size():
        bad.append(f"page size {ps}, the tuned plan's "
                   f"{tuned.decode_page_size()}")
    if chunk != min(tuned.prefill_chunk_size(ps), max_len):
        bad.append(f"chunk {chunk} is not the tuned plan's")
    m = r["metrics"]
    chunks = sum(-(-n // chunk) for n in r["prompt_lengths"])
    if m["prefix_hit_pages"] == 0 and m["prefill_chunks"] != chunks:
        bad.append(f"{m['prefill_chunks']} chunks, the tuned chunk cuts "
                   f"{chunks}")
    got = {k: n for k, n in r["launches"].items() if n}
    want = qwen_launches(layers, m["prefill_chunks"], m["scan_ticks"],
                         whole=False)
    if got != want:
        bad.append(f"launched {got}, expected {want}")
    differ = [i for i, (a, b) in enumerate(zip(r["tokens"],
                                               out["untuned"]["tokens"]))
              if a != b]
    causes = {}
    if differ:
        geo = serve(torch, cfg, params, LLAMA_PATH, init_s=init_s,
                    device=device, max_len=max_len, hi=1000,
                    phase="tune_serve_geometry", keep_tokens=True,
                    engine_kw={"page_size": ps, "prefill_chunk": chunk})
        _free(torch, device)
        for i in differ:
            causes[i] = {
                "first_divergence": _first_divergence(
                    r["tokens"][i], out["untuned"]["tokens"][i]),
                "cause": ("the tuned page size and chunk: the untuned plan "
                          "at them gives the tuned tokens"
                          if geo["tokens"][i] == r["tokens"][i]
                          else "unexplained")}
        bad += [f"request {i}: tuned tokens differ, cause unexplained"
                for i, c in causes.items() if c["cause"] == "unexplained"]
    summary = {"phase": "tune_serve_tokens", "tokens_equal": not differ,
               "differing": causes,
               "ttft_p50_s": [out["untuned"]["ttft_p50_s"],
                              r["ttft_p50_s"]],
               "tpot_mean_ms": [out["untuned"]["tpot_mean_ms"],
                                r["tpot_mean_ms"]],
               "geometry": [[out["untuned"]["page_size"],
                             out["untuned"]["prefill_chunk"]], [ps, chunk]],
               "launches_exact": got == want}
    emit(summary)
    out["tokens"] = summary
    del params
    _free(torch, device)
    if bad:
        raise AssertionError("tune_serve: " + "; ".join(bad))
    return out


# ``plan_verify``: every registry config at full width, in each quant mode
# whose path it has, in bf16 and float32 (the float32 cuts' kernels), at
# these (tokens, kv_len) beside the shapes the run's own phases resolved: 4
# slots over the new 1000-position extent and a 130-row chunk of it, and
# over 2048 positions.
PLAN_SHAPES = ((4, 1000), (130, 1000), (4, 2048), (128, 2048))
# (config, plan, host seconds) of every ``build_stream_plan`` the run's
# ``plan_for`` makes, one per new (config, tokens, kv_len):
# ``record_plan_builds``.
PLAN_BUILDS: list = []


def record_plan_builds() -> None:
    """Time each plan the model entry points and engines build from here
    on (``plan_for`` calls ``build_stream_plan`` once per new shape)."""
    from repro_torch.core import stream_plan
    build = stream_plan.build_stream_plan
    if getattr(build, "recorded", False):
        return

    def timed(cfg, **kw):
        t0 = time.perf_counter()
        plan = build(cfg, **kw)
        PLAN_BUILDS.append((cfg, plan, time.perf_counter() - t0))
        return plan
    timed.recorded = True
    stream_plan.build_stream_plan = timed


def _plan_quants(cfg):
    """The quant modes whose serving path the config has."""
    from repro_torch.models.params import has_kv_pools
    if cfg.encoder_only or not has_kv_pools(cfg):
        return ("none",)
    return ("none", "kv_int8", "w8_kv8")


def _stage_call(torch, cfg, plan, kind, stage, choice, device="cuda"):
    """One call of the stage's kernel wrapper at the plan's shapes
    (``tokens`` rows; 4 slots at most for decode and verify, over
    ``kv_len`` positions; the widest verify window), on random inputs:
    for ``flash_attention`` the static branch over the plan's rows, then
    (where the config prefills in chunks) the offset branch over
    ``kv_len`` positions and, under KV quantization, its twin over codes."""
    from repro_torch import kernels as K
    from repro_torch.models.model import _chunk_of, supports_chunked_prefill
    from repro_torch.models.params import compute_dtype, padded_vocab
    from repro_torch.serving.kv_cache import kv_quant_dtype
    dt = compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(5)
    randn = _randn(torch, gen, dt, device)
    t, impl = max(1, plan.tokens), choice.implementation
    d, hd = cfg.d_model, cfg.head_dim_
    w8 = bool(choice.block("w8"))
    code = kv_quant_dtype(cfg.kv_quant)

    def codes(x):
        if code == torch.int8:
            return (x.float() * 64).round().clamp(-127, 127).to(code)
        return x.float().to(code)
    if impl in ("rmsnorm_matmul", "block_matmul"):
        x, w, s = randn(t, d), randn(d, cfg.q_dim), randn(d)
        if impl == "block_matmul":
            return lambda: K.block_matmul(x, w)
        if w8:
            (wq, ws), = _w8(torch, w)
            return lambda: K.rmsnorm_matmul_w8(x, s, wq, w_scale=ws)
        return lambda: K.rmsnorm_matmul(x, s, w)
    if impl in ("streamed_ffn", "streamed_mlp"):
        f, act = cfg.d_ff, cfg.activation
        x = randn(t, d)
        norm = randn(d) if choice.block("fuse_norm") else None
        ws = ([randn(d, f)] if impl == "streamed_ffn" else []) + [
            randn(d, f), randn(f, d)]
        if w8:
            qs = _w8(torch, *ws)
            names = ("wg", "wu", "wd")[-len(qs):]
            scales = {f"{n}_scale": s for n, (_, s) in zip(names, qs)}
            fn = (K.streamed_ffn_w8 if impl == "streamed_ffn"
                  else K.streamed_mlp_w8)
            return lambda: fn(x, *(c for c, _ in qs), activation=act,
                              norm_scale=norm, **scales)
        fn = K.streamed_ffn if impl == "streamed_ffn" else K.streamed_mlp
        return lambda: fn(x, *ws, activation=act, norm_scale=norm)
    if impl == "moe_experts":
        e, f = cfg.num_experts, cfg.d_ff
        x = randn(t, d)
        top = torch.randn(t, e, generator=gen, device=device).topk(
            cfg.top_k, dim=-1)
        gates = torch.zeros(t, e, device=device).scatter_(
            1, top.indices, torch.softmax(top.values, -1)).to(dt)
        wg, wu, wd = randn(e, d, f), randn(e, d, f), randn(e, f, d)
        return lambda: K.moe_experts(x, gates, wg, wu, wd,
                                     activation=cfg.activation)
    if impl == "mamba2_scan":
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x, b, c = randn(1, t, h, p), randn(1, t, n), randn(1, t, n)
        dtt = (torch.rand(1, t, h, generator=gen, device=device)
               * 0.1).to(dt)
        a_log = torch.zeros(h, device=device, dtype=dt)
        dsk = torch.ones(h, device=device, dtype=dt)
        q = _chunk_of(t, choice.block("chunk", 128) or 128)
        return lambda: K.mamba2_ssd(x, dtt, a_log, b, c, dsk, chunk=q)
    if impl == "rwkv6_wkv":
        h, n = cfg.rwkv_heads, cfg.rwkv_head_dim
        r, k, v = randn(1, t, h, n), randn(1, t, h, n), randn(1, t, h, n)
        w = -torch.rand(1, t, h, n, generator=gen, device=device) * 0.5
        u = randn(h, n)
        q = _chunk_of(t, choice.block("chunk", 64) or 64)
        return lambda: K.wkv6(r, k, v, w, u, chunk=q)
    if impl == "streamed_xent":
        hid, head = randn(t, d), randn(d, padded_vocab(cfg.vocab_size))
        labels = torch.randint(0, cfg.vocab_size, (t,), generator=gen,
                               device=device, dtype=torch.int32)
        return lambda: K.streamed_xent_parts(hid, head, labels,
                                             vocab_size=cfg.vocab_size)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    g = hq // hkv
    window = cfg.sliding_window if kind == "local_attn" else 0
    kv = max(plan.kv_len, t)
    if impl == "flash_attention":
        q = randn(hq, t, hd)
        k, v = randn(hkv, kv, hd), randn(hkv, kv, hd)
        kt, vt = k[:, :t].contiguous(), v[:, :t].contiguous()
        calls = [lambda: K.flash_attention_static(
            q, kt, vt, kv_group=g, causal=cfg.causal, window=window)]
        if supports_chunked_prefill(cfg):
            calls.append(lambda: K.flash_attention_2d(
                q, k, v, q_offset=kv - t, kv_len=kv, kv_group=g,
                window=window))
            if code is not None:
                kc, vc = codes(k), codes(v)
                sc = torch.full((hkv, kv), 0.01, device=device)
                calls.append(lambda: K.flash_attention_2d_q(
                    q, kc, vc, k_scale=sc, v_scale=sc, q_offset=kv - t,
                    kv_len=kv, kv_group=g, window=window))
        return lambda: [c() for c in calls]
    # decode_attn / verify_attn over the paged pools
    b, ps = min(t, SLOTS), choice.block("page_size", 16)
    maxp = -(-kv // ps)
    kp, vp = randn(1 + b * maxp, ps, hkv, hd), randn(1 + b * maxp, ps, hkv,
                                                     hd)
    table = (torch.arange(b * maxp, device=device, dtype=torch.int32)
             .reshape(b, maxp) + 1)
    sc = {}
    if code is not None:
        kp, vp = codes(kp), codes(vp)
        s = torch.full((1 + b * maxp, hkv), 0.01, device=device)
        sc = dict(k_scale=s, v_scale=s)
    if impl == "paged_attention":
        qd = randn(b, 1, hq, hd)
        lengths = torch.full((b,), kv, dtype=torch.int32, device=device)
        fn = K.paged_decode_attention_q if sc else K.paged_decode_attention
        return lambda: fn(qd, kp, vp, table, lengths, window=window, **sc)
    w = plan.verify_window(plan.decode_page_size())
    qv = randn(b, w, hq, hd)
    q_off = torch.full((b,), max(0, kv - w), dtype=torch.int32,
                       device=device)
    fn = K.paged_verify_attention_q if sc else K.paged_verify_attention
    return lambda: fn(qv, kp, vp, table, q_off, window=window, **sc)


def _kernels_smem(torch, calls, path, reps=3, sessions=6):
    """For each of ``calls`` (a maker of a call), the call once to warm up,
    then ``reps`` times under a ``torch.profiler`` session of its own:
    ([(kernel key, shared memory per block)] of the kernels the profiled
    calls launched, from the trace's kernel events ("shared memory":
    static + dynamic), PyTorch's own kernels left out; sessions run).  A
    session can lose kernel events (on an H100, a decode call's window
    kernel alone, or every event of three sessions in a row): each call
    runs ``reps`` times between pauses, and a session in which no kernel,
    or some kernel a number of times not a multiple of ``reps``, was
    recorded is run again, up to ``sessions`` times.  What the last
    session recorded is what is compared."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.common import kernel_key
    out = []
    for make in calls:
        fn = make()
        fn()
        torch.cuda.synchronize()
        for tries in range(1, sessions + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.01)
                for _ in range(reps):
                    fn()
                    torch.cuda.synchronize()
                time.sleep(0.01)
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
            os.remove(path)
            seen = [(kernel_key(e["name"]),
                     e.get("args", {}).get("shared memory"))
                    for e in events if e.get("cat") == "kernel"
                    and "at::" not in e["name"]]
            got = sorted(set(seen))
            counts = Counter(k for k, _ in seen)
            if got and all(n % reps == 0 for n in counts.values()):
                break
            time.sleep(0.05)
        del fn
        out.append((got, tries))
    return out


def _sweep_cases():
    """(config, tokens, kv_len) of every registry config at full width in
    each quant mode its path has (``_plan_quants``), bf16 and float32, at
    ``PLAN_SHAPES``."""
    from repro_torch.configs import ARCHS, get_config
    out = []
    for arch in sorted(ARCHS):
        base = get_config(arch)
        for quant in _plan_quants(base):
            for dtype in ("bfloat16", "float32"):
                cfg = dataclasses.replace(base, quant=quant, dtype=dtype,
                                          use_fused_kernels=True)
                out += [(cfg, t, kv) for t, kv in PLAN_SHAPES]
    return out


def plan_smem(torch, out_dir, device="cuda"):
    """For every Hopper kernel (name and bytes) a stage of the plans of
    ``_sweep_cases`` launches, one launch at that plan's shapes (``_stage_call``) under
    ``torch.profiler``: each kernel's shared memory (static + dynamic)
    equals the lint's count (``kernel_lint.stage_kernels``) and the
    largest equals ``smem_estimate`` (required).  Run first, in a fresh
    process: run after the serving and training phases' profiles, most
    of these sessions recorded no kernel at all."""
    from repro_torch.analysis import smem_estimate
    from repro_torch.analysis.kernel_lint import stage_kernels
    from repro_torch.core.stream_plan import plan_for
    # One launch per distinct set of (kernel, bytes) a stage asks.
    todo, sigs = [], set()
    for cfg, tokens, kv_len in _sweep_cases():
        plan = plan_for(cfg, tokens, kv_len)
        for kind, stage, choice in plan.stage_choices():
            want = stage_kernels(cfg, plan, stage, choice)
            sig = tuple(sorted((want or {}).items()))
            if want and sig not in sigs:
                sigs.add(sig)
                todo.append((cfg, plan, kind, stage, choice, want))
    got_all = _kernels_smem(torch, [
        (lambda a=a: _stage_call(torch, *a[:5], device)) for a in todo],
        os.path.join(out_dir, "smem_trace.json"))
    _free(torch, device)
    bad, checked, rows = [], {}, []
    for (cfg, plan, kind, stage, choice, want), (got, tries) in zip(
            todo, got_all):
        est = smem_estimate(cfg, plan, stage, choice)
        ok = (bool(got) and all(k in want and want[k] == v for k, v in got)
              and max(v for _, v in got) == est)
        r = {"phase": "plan_smem", "config": cfg.name, "quant": cfg.quant,
             "dtype": cfg.dtype, "stage": f"{kind}.{stage}",
             "impl": choice.implementation, "tokens": plan.tokens,
             "kv_len": plan.kv_len, "smem_estimate": est,
             "profiled": got, "expected": want,
             "profiler_sessions": tries, "ok": ok}
        emit(r)
        rows.append(r)
        if ok:
            checked.update(dict(got))
        else:
            bad.append(f"{cfg.name} {kind}.{stage}: profiled {got} in "
                       f"{tries} sessions, expected {want}")
    emit({"phase": "plan_smem_done", "kernels_checked": len(checked),
          "stage_launches": len(rows), "ok": not bad})
    if bad:
        raise AssertionError("plan_smem: " + "; ".join(bad))
    return rows


def plan_verify(torch, out_dir, device="cuda"):
    """Every plan this run built (``PLAN_BUILDS``) and the plans of
    ``_sweep_cases`` verify clean for the card
    (``verify_plan(device="cuda")``, required); reports each build's host
    milliseconds (one new shape: one DSE)."""
    from repro_torch.analysis import clean, verify_plan
    from repro_torch.core.stream_plan import plan_for
    record_plan_builds()
    built = {(cfg, plan.tokens, plan.kv_len) for cfg, plan, _ in PLAN_BUILDS}
    for cfg, tokens, kv_len in _sweep_cases():
        if (cfg, tokens, kv_len or tokens) not in built:
            plan_for(cfg, tokens, kv_len)        # recorded as it builds
    bad = []
    for cfg, plan, _ in PLAN_BUILDS:
        diags = verify_plan(plan, cfg, slots=SLOTS, max_len=plan.kv_len,
                            device="cuda")
        if not clean(diags):
            bad.append(f"{cfg.name}/{cfg.quant}/{cfg.dtype}/{plan.tokens}x"
                       f"{plan.kv_len}: " + "; ".join(
                           str(d) for d in diags if d.severity != "info"))
    builds = {}
    for cfg, plan, sec in PLAN_BUILDS:
        builds.setdefault(cfg.name, []).append(
            [cfg.quant, cfg.dtype, cfg.num_layers, plan.tokens, plan.kv_len,
             round(sec * 1e3, 3)])
    ms = sorted(sec * 1e3 for *_, sec in PLAN_BUILDS)
    row = {"phase": "plan_verify", "plans_verified": len(PLAN_BUILDS),
           "build_ms_min": ms[0], "build_ms_median": statistics.median(ms),
           "build_ms_max": ms[-1], "build_s_total": sum(ms) / 1e3,
           "unclean": bad}
    emit(row)
    for name, rows in builds.items():
        emit({"phase": "plan_verify_build_ms", "config": name,
              "quant_dtype_layers_tokens_kv_ms": rows})
    if bad:
        raise AssertionError("plan_verify: " + "; ".join(bad))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and ptxas.txt")
    args = ap.parse_args(argv)

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import on_hopper

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if not on_hopper():
        print(f"chip_smoke: {name} is not a Hopper (sm_90) card; the "
              "kernels are built for sm_90a", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    built = _build.build_all()
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "built": built, "nvcc": _build.find_nvcc(),
             "seconds_by_source": dict(_build.BUILD_SECONDS)}
    emit(build)
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        for n, log in _build.BUILD_LOG.items():
            fh.write(f"== {n}\n{log}\n")

    from repro_torch.configs import get_config
    llama, gpt2 = get_config("llama3-8b"), get_config("gpt2")
    results = {"device": smi, "name": name, "build": build}
    record_plan_builds()
    results["plan_smem"] = plan_smem(torch, out_dir)
    timer = Timer(torch)
    rows = check_kernels(torch, timer)
    results["kernel_checks"] = rows
    results["qwen_kernel_cases"] = check_kernels(
        torch, timer, (qwen_kernel_cases,), phase="qwen_kernel_cases")
    rows = rows + results["qwen_kernel_cases"]
    results["qwen_rows"] = check_qwen_rows(torch)
    results["gemma_kernel_cases"] = check_kernels(
        torch, timer, (gemma_kernel_cases,), phase="gemma_kernel_cases")
    rows = rows + results["gemma_kernel_cases"]
    results["gemma_rows"] = check_gemma_rows(torch, timer)
    results["hubert_kernel_cases"] = check_kernels(
        torch, timer, (hubert_kernel_cases,), phase="hubert_kernel_cases")
    rows = rows + results["hubert_kernel_cases"]
    results["row_invariance"] = check_row_invariance(torch)
    results["paged_split"] = check_paged_split(torch, timer)
    results["tensorcore"] = check_tensorcore(torch, timer)
    results["compile"] = compile_path(torch, timer)
    models = {"llama3-8b": (llama, False, 2048, 1000),
              "gpt2": (gpt2, True, 1024, 992),
              GRANITE: (get_config(GRANITE), False, 2048, 1000)}
    small = {m: dataclasses.replace(c, num_layers=4, dtype="float32")
             for m, (c, _, _, _) in models.items()}
    results["fused_vs_eager"] = fused_vs_eager(torch, small["llama3-8b"])
    results["gpt2_fused_vs_eager"] = admission_fused_vs_eager(
        torch, small["gpt2"], jitter=True, phase="gpt2_fused_vs_eager",
        expect=GPT2_PATHS)
    results["granite_fused_vs_eager"] = admission_fused_vs_eager(
        torch, small[GRANITE], jitter=False, phase="granite_fused_vs_eager",
        expect=GRANITE_PATHS)
    results["spec_fused_vs_eager"] = {
        m: spec_fused_vs_eager(
            torch, dataclasses.replace(small[m], use_fused_kernels=True),
            jitter=jit, max_len=ml, expect=SPEC_PATHS[m])
        for m, (_, jit, ml, _) in models.items()}
    results["quant_fused_vs_eager"] = {
        m: quant_fused_vs_eager(
            torch, dataclasses.replace(small[m], use_fused_kernels=True),
            jitter=jit)
        for m, (_, jit, _, _) in models.items()}
    results["accuracy"] = {m: accuracy(torch, small[m], jitter=jit)
                           for m, (_, jit, _, _) in models.items()}
    zamba = get_config(ZAMBA)
    results["zamba_fused_vs_eager"] = recurrent_fused_vs_eager(
        torch, dataclasses.replace(zamba, num_layers=6, dtype="float32",
                                   use_fused_kernels=True),
        phase="zamba_fused_vs_eager", jitter=False,
        launches=lambda p, s: zamba_launches(p, s, layers=6))
    rwkv = get_config(RWKV)
    results["rwkv_fused_vs_eager"] = recurrent_fused_vs_eager(
        torch, dataclasses.replace(rwkv, num_layers=4, dtype="float32",
                                   use_fused_kernels=True),
        phase="rwkv_fused_vs_eager", jitter=True,
        launches=lambda p, s: rwkv_launches(p, s, layers=4))
    results["accuracy"][ZAMBA] = accuracy(
        torch, dataclasses.replace(zamba, num_layers=6, dtype="float32"),
        jitter=False)
    results["qwen_fused_vs_eager"] = {m: qwen_fused_vs_eager(torch, m)
                                      for m in QWEN}
    results["gemma_fused_vs_eager"] = gemma_fused_vs_eager(torch)
    results["gemma_quant_fused_vs_eager"] = gemma_quant_fused_vs_eager(torch)
    results["hubert_fused_vs_eager"] = hubert_fused_vs_eager(torch)
    results["full_depth"] = {
        m: full_depth(torch, dataclasses.replace(
            c, use_fused_kernels=True,
            num_layers=SERVE_LAYERS.get(m, c.num_layers)),
            m, jitter=jit, max_len=ml, hi=hi)
        for m, (c, jit, ml, hi) in models.items()}
    results["zamba_serve"] = recurrent_serve(
        torch, dataclasses.replace(zamba, use_fused_kernels=True),
        phases={"none": "zamba_serve", QUANT_MODE: "zamba_quant_serve"},
        launches=zamba_launches, jitter=False)
    results["rwkv_serve"] = recurrent_serve(
        torch, dataclasses.replace(rwkv, use_fused_kernels=True),
        phases={"none": "rwkv_serve"}, jitter=True,
        launches=lambda p, s, quant: rwkv_launches(p, s))
    results["qwen_serve"] = {m: qwen_serve(torch, m) for m in QWEN}
    results["gemma_serve"] = gemma_serve(torch)
    results["gemma_serve"].update(gemma_quant_serve(torch))
    results["hubert_encode"] = hubert_encode(torch)
    results["serve_contiguous"] = serve_contiguous(torch)
    results["serve_surface"] = serve_surface(torch, timer)
    results["serve_launcher"] = serve_launcher(torch)
    results["serve_pages"] = serve_pages(torch, timer)
    results["serve_telemetry"] = serve_telemetry(
        torch, out_dir,
        serve_row=results["full_depth"]["llama3-8b"]["serve"]["chunked"])
    results["obs_demo"] = obs_demo(torch, out_dir)
    results["tune_roundtrip"] = tune_roundtrip(torch)
    results["tune_serve"] = tune_serve(torch, timer,
                                       rows=results["kernel_checks"])
    results["train_fused_vs_eager"] = {
        m: train_fused_vs_eager(torch, small[m], m, jitter=jit)
        for m, (_, jit, _, _) in models.items()}
    results["train_fused_vs_eager"][RWKV] = train_fused_vs_eager(
        torch, dataclasses.replace(rwkv, num_layers=RWKV_TRAIN_LAYERS,
                                   dtype="float32"), RWKV, jitter=True)
    gemma = get_config(GEMMA)
    results["train_fused_vs_eager"][GEMMA] = train_fused_vs_eager(
        torch, dataclasses.replace(gemma, num_layers=GEMMA_TRAIN_LAYERS,
                                   dtype="float32"), GEMMA, jitter=True)
    results["train_w8_ste"] = train_w8_ste_phase(torch)
    results["train"] = {
        "gpt2": train(torch, dataclasses.replace(gpt2, use_fused_kernels=True),
                      "gpt2", steps=6, ckpt_every=3, replay_from=3, lr=1e-3,
                      note="full width and depth"),
        "llama3-8b": train(
            torch, dataclasses.replace(llama, num_layers=2,
                                       use_fused_kernels=True),
            "llama3-8b", steps=3, ckpt_every=3, replay_from=0, lr=3e-5,
            note="full width cut to 2 layers: float32 weights, gradients "
                 "and two AdamW moments of all 32 layers take 128 GB, the "
                 "card has 80, and 2 layers keep the whole run within "
                 "about 600 s"),
        GRANITE_TRAIN: train(
            torch, dataclasses.replace(get_config(GRANITE_TRAIN),
                                       use_fused_kernels=True),
            GRANITE_TRAIN, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
            note="full width and depth; no checkpoint (the CPU tests hold "
                 "MoE checkpoints to the reference)"),
        ZAMBA: train(
            torch, dataclasses.replace(zamba, use_fused_kernels=True),
            ZAMBA, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
            note="full width and depth; no checkpoint (the CPU tests hold "
                 "zamba2 checkpoints to the reference)"),
        RWKV: train(
            torch, dataclasses.replace(rwkv, num_layers=RWKV_TRAIN_LAYERS,
                                       use_fused_kernels=True),
            RWKV, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
            note="full width cut to 2 layers: float32 weights, gradients "
                 "and two AdamW moments of all 32 layers take 120 GB, and "
                 "its host-bound step keeps the whole run within its time "
                 "limit; no checkpoint (the CPU tests hold rwkv6 "
                 "checkpoints to the reference)")}
    for m in (QWEN3, QWEN2VL):
        results["train"][m] = train(
            torch, dataclasses.replace(get_config(m), use_fused_kernels=True),
            m, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
            note="full width and depth; no checkpoint (the CPU tests hold "
                 "Qwen checkpoints to the reference)"
                 + ("; the pipeline's patch embeddings and M-RoPE "
                    "positions" if m == QWEN2VL else ""))
    results["train"][HUBERT] = hubert_train(torch)
    results["train"][GEMMA] = gemma_train(torch)
    results["train_w8"] = quant_train(torch)
    results["plan_verify"] = plan_verify(torch, out_dir)
    # One entry per kernel, model, head dim and serving path that runs it;
    # launches are that path's burst's own counters, reset just before it.
    paths = []
    for m, fd in {**results["full_depth"], **results["qwen_serve"],
                  GEMMA: results["gemma_serve"]}.items():
        for mode, r in fd["serve"].items():
            paths.append((m, mode, r["launches"]))
        for mode, r in fd["quant_serve"].items():
            paths.append((m, f"quant_{mode}", r["launches"]))
        for key, path in (("spec_serve", "speculative"),
                          ("quant_spec_serve", "quant_speculative")):
            if key in fd:
                paths.append((m, path, fd[key]["launches"]))
    paths.append((HUBERT, "encode", results["hubert_encode"]["launches"]))
    paths.append(("llama3-8b", "contiguous",
                  results["serve_contiguous"]["contiguous"]["launches"]))
    for path in ("page_size_32", "page_size_64", "prefill_chunk_256"):
        paths.append(("llama3-8b", path,
                      results["serve_surface"]["bursts"][path]["launches"]))
    rows = rows + results["serve_surface"]["kernel_rows"]
    for engine, path in (("plain", "pages_10"),
                         ("speculative", "pages_10_speculative"),
                         ("kv_int8", "quant_pages_10")):
        paths.append(("gpt2", path, results["serve_pages"]["bursts"][
            f"bfloat16/{engine}/{PAGES_MAX_LEN}"]["launches"]))
    rows = rows + results["serve_pages"]["kernel_rows"]
    paths.append(("llama3-8b", "tuned_chunked",
                  results["tune_serve"]["tuned"]["launches"]))
    for quant, r in results["zamba_serve"].items():
        paths.append((ZAMBA, "whole_prompt" if quant == "none"
                      else "quant_whole_prompt", r["launches"]))
    paths.append((RWKV, "whole_prompt",
                  results["rwkv_serve"]["none"]["launches"]))
    for m, r in results["train"].items():
        paths.append((m, "train", r["launches"]))
    for m, r in results["train_w8"].items():
        paths.append((m, "quant_train", r["launches"]))
    paths += results["compile"]["paths"]
    rows = rows + results["compile"]["rows"]
    summary = []
    for kname in TPU_KERNELS:
        for model, path, launches in paths:
            # Kernel rows carry the unquantized path's tag: a whole prompt
            # or a verify dispatch has the same shapes under w8_kv8.
            base = path.removeprefix("quant_")
            mine = [r for r in rows if r["name"] == kname
                    and r["model"] == model and r["dtype"] == "bfloat16"
                    and r["path"] in (None, base)]
            if not launches.get(kname) or not mine:
                continue
            # The path's own shape where it has one (a whole prompt, a
            # verify dispatch), else the prefill-chunk / main decode shape.
            head = next((r for r in mine if r["path"] == base), mine[0])
            summary.append({
                "name": kname, "route": "cuda", "source": SOURCES[kname],
                "replaces": TPU_KERNELS[kname],
                "helper": kname in HELPERS, "model": model,
                "path": path, "head_dim": head["head_dim"],
                "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "checks_ok": all(r["ok"] for r in rows
                                 if r["name"] == kname
                                 and r["model"] == model)})
    missing = sorted(set(TPU_KERNELS) - {e["name"] for e in summary})
    if missing:
        raise AssertionError(f"kernels no burst launched: {missing}")
    emit({"kernels": summary})
    results["kernels"] = summary
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        raise AssertionError(f"the port pulled in {leaked}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
