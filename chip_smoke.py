#!/usr/bin/env python3
"""Smoke run of tpullm_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits nonzero:
 1. card: name and power limit (nvidia-smi), torch and CUDA versions;
    whether the `regex` and `aiohttp` modules import there (for
    information: the port uses neither);
 2. build: compiles every kernel library from tpullm_torch/csrc with nvcc,
    one process per library (the qmm sources once per layout family), and
    prints each library's compile seconds, the `-Xptxas -v` report, and
    each tensor-core kernel's registers and spill bytes;
 3. kernels vs plain: each kernel against its plain PyTorch version on the
    card at the shapes of the main paths (qmm: all 22 formats at the 8B
    gate_up and down, M in {1, 8, 16, 512}: M = 1 and 8 on CUDA cores, 16
    and 512 on the tensor cores, M = 1 also timed cold, rotating among
    copies of the planes that together exceed the 50 MB L2, and at M = 512
    the CUDA-core kernel timed on the same planes; Q4_K and Q6_K also at
    the other Llama-3-8B shapes and Q5_K and Q8_0 at Mixtral's attention
    shapes, M = 1; qmm_grouped, the
    group-factored kernel: all 22 formats at the 8B gate_up and down, M
    in {1, 8, 16, 128, 512} (below 16 rows on the gemv body, from 16 on
    the grouped form of the tensor-core body, K split at down), timed
    beside qmm (qmm_tc from 16 rows) on the same planes; qmm_stack and qmm_gather: all 22
    formats as expert stacks at Mixtral's 4096→14336 and 14336→4096, stack
    M = 512 with a shared x (and, for Q4_K and Q6_K, a per-expert x), gather
    T in {2, 32} and T = 32 with every slot on one expert, and ids outside
    the stack giving NaN rows; flash: bf16, f16, f32 and q8 KV, T in {1, 512}, S = 4096,
    GQA 32/8
    (T = 1 the split-KV decode regime, T = 512 the tensor-core prefill
    regime, each also against the plain version of its own order, and the
    prefill's p rounding, one bf16 term and two, measured on its plain
    version), plus small softcap / window / sink / ALiBi cases), held to the NMSE
    bounds of the JAX package's conformance sweep; each timed with CUDA
    events over a CUDA graph of back-to-back calls (device time, not the
    Python wrapper's dispatch) beside its bound and a PyTorch library call;
 3a. flash at head dim 256 (the Gemma family): bf16, f16, f32 and q8 KV,
    Gemma-3-4B's heads (8 on 4 KV heads), S = 4096, the decode regime at
    T = 1 (B = 2, and B = 1 in a window of 1024) and at T = 8 (B = 1 at
    offset 2560, without and with the window: the ring speculation's
    verify forward, R = 16) and the prefill regime at T = 512 (B = 2, and
    B = 1 in the window), each timed as in 3 and
    against the plain version of its own order, and Gemma-2's softcap 50
    in both regimes;
 3a'. flash mla, flash dkdv: flash's latent form (the MLA cache, bf16, one
    KV head, S = 4096) at DeepSeek-V2-Lite's (Dk 576, Dv 512, 16 heads): the decode
    regime at T = 1 (B = 2, kv 38 / 3001; B = 1, kv 20; an idle slot) and
    at T = 2 and 4 (R = 32, 64: row groups), the prefill regime at T = 512
    (offsets 0 / 2500) and in a joint round (B = 4, T = 8, two idle); at
    MiniCPM3's (288, 256, 40 heads): the decode regime at T = 1 (R = 40,
    B = 2, kv 38 / 3001; also the prefill kernel timed at that call), T =
    512 and a joint round; flash at Dk ≠ Dv (the library flash_dkdv): (192,
    128) at 16 heads on 16 and (96, 64) at 40 on 40, bf16, f16, f32 and q8
    caches, T = 1 and 512, B = 2, kv 38 / 3001; each against its plain
    version and that of its own order, one counted launch a call, timed
    beside its bound and SDPA (on the cache's dtype; enable_gqa for the
    latent);
 3a''. phi kernels: qmm at the Phi-3-mini, Phi-2 and Qwen-7B (v1) 2-D
    shapes (the fused attn_qkv at Q5_K, Phi-3's gate|up, the Q6_K downs
    and heads), M = 1 and 512; flash at head dims 96 and 80 (Phi-3-mini,
    Phi-2; the library flash_narrow): bf16, f16, f32 and q8 KV, 32 heads on 8 at T = 1 (B = 2,
    kv 38 / 3001; B = 1, kv 20) and T = 512 (offsets 0 / 2500), S = 4096;
    the Phi shapes, 32 heads on 32 at B = 1: decode at R = 1, 9 and 16
    (Phi-3 under its window of 2047 at offset 3000 of 4096, Phi-2 at 1500
    of 2048) and Phi-3's 2560-token prefill under the window; each against
    its plain version and that of its own order, timed beside its bound
    and SDPA on the cache's dtype;
 3b. batched kernels: the shapes continuous batching gives the kernels,
    each against its plain version and timed as in 3: flash's decode
    regime at B = 4 and 8 slots with idle slots at offset −1 (their rows
    exactly 0) and kv lengths 20 to 4000, and its prefill regime in a joint
    round of 4 slots (two idle, T = 8 and 512), bf16 and q8 caches; qmm at
    M = 4 and 8 and qmm_tc at M = 4 × 512 (the 8B's Q4_K gate_up and Q6_K
    down); qmm_stack at 4 × 512 rows over Mixtral's 8 experts; qmm_gather
    at 8 and 16 routed slots of Mixtral's Q4_K experts;
 3c. verify kernels: the shapes speculative verification gives the
    kernels, each against its plain version and timed as in 3: flash at
    B = 1, offset 2500, T = 1 and 4 (the decode regime) and T = 8 (the
    verify bucket of the cli's --draft-max 5: the prefill regime), and at
    4 slots × 9 rows (the server's --draft-max 8) with offsets (−1, 0,
    2500, 100), bf16 and q8 caches; qmm at M = 8 and 9 and qmm_tc at M = 36
    (the 8B's Q4_K gate_up and Q6_K down);
 3d. qwen kernels: the Qwen shapes, each against its plain version and
    timed as in 3: qmm_gather over 128 experts (Qwen3-30B-A3B's Q4_K gate
    2048 → 768 and Q6_K down 768 → 2048) at T = 8, 32 and 128 rows (1, 4
    and 16 tokens' top-8: the bit-set path past 32 experts) and ids outside
    the stack giving NaN rows; qmm_stack over the 128 experts at M = 512;
    flash at D = 128 with 32 heads over 4 and 28 over 4 (a group of 7),
    bf16 and q8, T = 1 and 512, and for the group of 7 T = 2 (decode) and
    T = 3 (prefill); qmm at the Qwen 2-D linears' shapes, M = 1 and 512
    (Qwen2.5-7B's qkv, wo, gate_up, down and head at K = 3584 and 18944,
    Qwen3-30B-A3B's qkv, wo and head);
 3e. unfused kernels: qmm at the 8B's projections apart (Q4_K q
    4096 → 4096, k 4096 → 1024, gate 4096 → 14336; Q6_K v 4096 → 1024), M
    = 1 and 8: an Engine with a LoRA adapter launches them in place of the
    fused q|k|v and gate|up;
 3f. gemma kernels: qmm at Gemma-3-4B's linears (q|k|v and q, k, v apart,
    wo, gate|up, the Q6_K and Q4_K down), M = 1 and 8
    (its ring speculation's verify forward), each against its plain
    version and timed as in 3;
 3g. option kernels: flash at Falcon-7B's decode token (71 heads on one KV
    head of 64, R = 71: the decode regime in five row groups) on every
    cache format, B = 2 at kv 38 / 3001 and B = 1 at kv 1024, beside the
    prefill kernel at the same call (the route before the row groups); qmm
    at Apertus-8B's and AFM-4.5B's FFN shapes, M = 1 and 512;
 3h. alibi kernels: flash with ALiBi at BLOOM-7B1's heads (32 on 32 of
    128, the slopes of max bias 8), B = 1, S = 4096: the decode regime at
    R = 1, kv 3001, on every cache format, and on bf16 at kv 20 and the
    prefill regime at T = 512; each against its plain version and that of
    its own order, timed beside its bound and SDPA with the bias as its
    float mask;
 3i. bloom and gpt2 kernels: qmm at the Q4_K_M linears of BLOOM-7B1 and
    MPT-7B (q|k|v, wo, up, the Q6_K and Q4_K down), StarCoder-15.5B (the
    same and its Q6_K head) and GPT-2, M = 1, 2 (the 2-slot step) and 512,
    each against its plain version and timed as in 3;
 3j. conformance: tpullm_torch/tools/conformance.py's sweep on the card's
    kernels (every plane format through qmm at 1, 9, 16 and 128 rows, the
    expert gather and stack, flash on every cache format and head-dim form
    in both regimes, the row groups at R = 48, 71 and 80, the latent forms,
    sinks and ALiBi at kv 3001): no failed case; its summary printed as a
    JSON line before the kernels line;
 3k. moe family kernels: qmm at the Q4_K_M linears of OLMoE-1B-7B,
    Phi-3.5-MoE and Llama-4-Scout (q|k|v, wo, Scout's shared expert, the
    heads), M = 1 and 512; qmm_gather over OLMoE's 64 experts (T = 8 and
    128 rows of top-8) and Scout's 16 (T = 1 and 16 of top-1), qmm_stack
    at M = 512 over both; flash at 16 heads on 16, 32 on 8 and 40 on 8
    (D = 128), bf16 and q8; each timed as in 3;
 4. tiny: the tiny dense model at every dense preset and the tiny MoE at
    Q4_K_M, MXFP4_MOE and IQ2_XXS, served on the card against the CPU; and
    generate_tokens through a GBNF grammar and a penalised host Sampler on
    the card against the CPU;
 5. slice: a Llama-3-8B Q4_K_M GGUF synthesized from a seed with Llama-3's
    byte-level BPE vocab (tokenizer.ggml.model "gpt2", pre "llama-bpe"),
    a fixed mixed-script sentence through its tokenizer and back, then the
    model served by Engine with a bf16 KV cache: three
    prompts (one of 512 tokens), 64 generated tokens each (the decode
    chunk as CUDA-graph replays), one prompt twice for determinism; load
    time and its peak memory, TTFT, pp512 and decode tok/s, peak memory,
    device time by kernel family of one profiled chunk of decode steps (the
    graph's replays) and of one profiled 512-token prefill, each kernel's
    launches against the count expected per forward; and the graph phase
    (`graph_decode`):
    greedy ids of the graph against a decode_step loop over two chunks and
    a tail, launches per replay, capture seconds and pool bytes, decode
    wall, busy and idle a token with the graph beside eager steps, and two
    sampled runs from one seed;
 5b. tools: on the same 8B GGUF, the tools' main()s as a user runs them:
    the cli's completion (64 tokens through the host Sampler chain of
    --temp 0.8 --seed 1 --repeat-penalty 1.1, -v), taken apart on an
    Engine of its own (decode_step, the logits graph's replay, against the
    eager step with the same read-back, their logits compared; the host
    Sampler's ms a token; the idle share of a profiled chunk), the prompt
    cache run twice (reused, the same stdout at temp 0), a two-turn chat
    through stdin, tokenize against the engine's tokenizer, perplexity
    over SURVEY.md (2 windows of 512; the launches and time of each
    window) with the kernels and with dense bf16 weights, the KLD of the
    kernels against a base the dense run records, and the bench sweep
    -p 512 -n 128 -d 4096 -ctk bf16,f16,f32,q8_0 -r 1;
 5c. server: continuous batching on the same 8B GGUF: tpullm-torch-server's
    app (a BatchEngine of 4 slots, context 4096, bf16 cache, its decode
    graph of every width captured on the scheduler's thread) on 127.0.0.1 in this
    process, 8 requests at once through http.client (4 streamed chats and 4
    completions, prompts of 32 to 1024 tokens, 64 to 256 new tokens, greedy
    and seeded): each request's TTFT and rate, the aggregate rate; then the
    batched graph's ms a step at 1, 2 and 4 slots generating, its launches a
    replay, a profiled step by kernel family, and the batched logits
    teacher-forced on the single-stream Engine's greedy ids against its
    decode_step logits (NMSE ≤ 1e-3, the greedy ids that agree and where
    they part); a q8-cache BatchEngine at 4 slots; Mixtral Q4_K_M with 4
    layers at 4 slots (a joint prefill round and 32 batched steps
    teacher-forced on its Engine, the gather regime); and
    tpullm-torch-batched-bench -npp 128 -ntg 64 -npl 1,2,4,8 on the 8B;
 5d. speculative: on the same 8B GGUF, generate_speculative with the
    n-gram speculator (--draft-max 5), greedy, 128 tokens after a
    repetitive 256-token prompt, bf16 and q8 caches, and with a draft
    Engine on the same file (acceptance ≥ 0.9): the ids against the plain
    graph decode's, the verify rows teacher-forced against decode_step's
    (NMSE ≤ 1e-3, where the argmax parts and its margin), every round a
    replay of the verify graph with one forward's launches and no eager
    forward on the target or the draft but their prompts' and their graphs'
    first runs, rounds, drafts, acceptance, a verify replay's ms against a
    decode replay's and tok/s against the plain graph decode; the server's
    app at 4 slots plain, with --spec-type ngram_simple and with a draft
    model (--draft-max 8), 4 greedy completions at once: the same texts,
    the /metrics counters, each verify graph's launches a replay and one
    verify step's read around it, a verify step's ms against a decode
    step's; tpullm-torch-lookup create, stats and run;
 5e. engine options: on the same 8B GGUF, tpullm-torch-cvector-generator
    in this process (its main(); 4 prompt pairs, --method pca, dense bf16 weights);
    then one unfused Model shared by an Engine with a synthetic rank-16
    LoRA adapter on every projection (7 qmm a layer), one with control
    vectors (a synthetic file at strength 0.5, and the generated file),
    a plain Engine (which fuses the Model: 5 qmm a layer) and one with
    self-extend (grp_attn_n 4, a 2560-token prompt): each a prompt and 64
    greedy tokens on the decode graph, load s, peak GiB, decode tok/s,
    launches a decode replay, the logits teacher-forced on the greedy ids
    through the logits graph against the eager step (NMSE ≤ 1e-3, the same
    argmax), the adapter's and the vectors' logits against the plain
    engine's (they act), self-extend's flash launches those of the plain
    engine; GET /lora-adapters on a server over the adapter's Engine; the
    cli with --grp-attn-n 4;
 6. presets: Llama-3-8B served the same way with 4 layers, one prompt and
    16 decode steps each, at Q2_K, IQ4_XS, Q4_0, Q4_1,
    Q5_0, Q5_1, IQ4_NL and Q3_K_M; then Mixtral-8x7B at
    MXFP4_MOE with 4 layers (a 64-token prompt through qmm_stack, decode
    through qmm_gather); each file synthesized in a child process while the
    one before runs;
 7. i-quants: Llama-3-8B with 4 layers at IQ1_S, IQ3_XXS, IQ2_XXS,
    IQ2_XS, IQ2_M, IQ1_M, IQ3_M, TQ1_0 and TQ2_0; Mixtral-8x7B
    at IQ2_XXS with 4 layers; the 8B at Q4_K_M with 4 layers and Q4_K and
    Q6_K in qmm.GROUPED_TYPES, every 2-D launch through qmm_grouped, and a
    profiled 512-token prefill whose every 2-D launch of the layers ran
    qmm_grouped_tc_kernel;
 8. mixtral: a Mixtral-8x7B Q4_K_M GGUF with 4 layers (the 8-expert
    recipe; its Q4_K, Q5_K, Q6_K and Q8_0 tensors) synthesized from a seed
    and served the same way with a bf16 KV cache, with the graph phase;
 8b. gemma: Gemma-3-4B Q4_K_M (12 of its 34 layers, GEMMA_LAYERS; head dim 256, a window of 1024 on
    five layers of six, vocab 262144, tied head) synthesized from a seed:
    the tied Q6_K embedding's load peak in row chunks;
    Engine with the bf16 iSWA ring (2048 slots), with swa_full and with a
    q8 cache, prompts of 512 and 2560 tokens (the longer wraps the ring)
    and 64 greedy tokens each on the decode graph: the prefill cold and
    warm with each forward's ms, TTFT (warm), decode tok/s, the
    launches of a decode replay and of a prefill forward (the ring: flash
    on the 5 global layers, attention_ring on the 29 others), a decode
    token's device time by family; f16 and f32 rings; ring speculation:
    n-gram generate_speculative (64 tokens after a repetitive prompt that
    wraps the ring) against plain greedy decoding, its verify rows
    teacher-forced against the swa_full engine's (NMSE ≤ 1e-3), a rejected
    draft then a decode against an engine that never saw the draft, the
    verify graph's launches (flash on the global layers, attention_ring on
    the others) and ms against a decode replay's; ring against
    swa_full teacher-forced on the same ids (NMSE ≤ 1e-3), each run
    against dense bf16 weights; a state file of the ring engine saved and
    restored; a BatchEngine of 4 slots on the ring against Engine, a slot
    freed and admitted again; then the speculative Scheduler (n-gram
    drafts) on that 4-slot ring BatchEngine, 4 requests, the ids of the
    plain Scheduler;
 8c. deepseek2: DeepSeek-V2-Lite Q4_K_M (MLA with kv_lora_rank 512 + 64
    rope dims, 64 routed experts top-6 and 2 shared, one dense lead layer,
    vocab 102400) synthesized from a seed at full width with 9 of its 27
    layers: Engine on the bf16 latent at context 4096, prompts of 512 and
    2560 tokens cold and warm, 64 greedy tokens each on the decode graph,
    load s and peak GiB, TTFT (warm), decode tok/s, the launches of a
    decode replay and of a prefill forward (flash's latent form once a
    layer a forward, the packed gate/up expert stacks through qmm_gather or
    qmm_stack, the K = 1408 down stacks dense at load, the dense lead's K
    = 10944 down through the dequantize route), device ms by family; the
    latent's bytes a position against the decompressed cache's; the
    kernels against dense bf16 weights teacher-forced (the greedy ids
    equal); an MLA state file round trip; a BatchEngine of 4 slots
    teacher-forced against Engine;
 8d. qwen: tiny-qwen3moe (bf16 and q8), tiny-qwen2moe and tiny-qwen2 on
    the card against the CPU; Qwen3-30B-A3B Q4_K_M (48 layers, n_embd 2048,
    32 heads over 4 of 128, 128 experts top-8 of 768, vocab 151936, Qwen's
    BPE with pre "qwen2") synthesized from a seed at full width with 24 of
    its 48 layers: what earlier phases leave on the card, load s and peak GiB, served
    through Engine (`serve`) on a bf16 cache, prompts of 16
    (the gather at 128 rows), 2560 (one forward at the 4096 bucket, every
    expert on every token) and 512 (on the bf16 cache 2560 again: the
    determinism check), 64 greedy tokens each on the decode graph,
    launches per regime, device ms by family of a decode token and of a
    512-token prefill, a decode replay's and a prefill forward's launches;
    a BatchEngine of 4 slots (one idle) teacher-forced against Engine; no
    dequantize-route or dense-attention call; then Qwen2.5-7B Q4_K_M at
    full width with 4 layers (28 heads over 4, K = 3584 and 18944): served,
    and teacher-forced against dense bf16 weights;
 8d'. moe families (their GGUFs written by child processes from 8b on):
    tiny-olmoe, tiny-phimoe and tiny-llama4 on the card against the CPU,
    each in both expert regimes (tiny-llama4's chunks of 16 in a 256-slot
    cache through the counted dense chunk route); OLMoE-1B-7B Q4_K_M at full
    width and depth (64 experts top-8, q/k norms over the projection) on a
    bf16 and a q8 cache, launches against moe_launch_want, a 4-slot
    BatchEngine teacher-forced; Phi-3.5-MoE with 8 of 32 layers
    (sparsemixer, LayerNorms with biases, a biased head) served, and 1
    layer teacher-forced against dense bf16 weights; Llama-4-Scout with 4
    of 48 layers (a cache within one chunk: flash on every layer) served,
    its shared expert's and routed expert's ms a decode token;
 8e. phi: tiny-phi3, tiny-phi2 and tiny-qwen on the card against the CPU;
    Phi-3-mini-4k Q4_K_M (PHI3_LAYERS = 16 of its 32 layers, n_embd 3072, 32
    heads on 32 of 96, a window of 2047 on every layer, vocab 32064) at full width,
    context 4096: load s and peak GiB, served through Engine on a bf16 and
    a q8 cache (prompts of 16, 2560 and 512 tokens, 64 greedy tokens each
    on the decode graph; flash at d96 32 a forward, device ms by family of
    a decode token and a 512-token prefill), briefly on f16 and f32
    caches, a BatchEngine of 4 slots (one idle) teacher-forced against
    Engine; Phi-2 Q4_K_M (head dim 80, LayerNorms with biases, the parallel
    block, vocab 51200) at full width, context 2048, served the same way
    and teacher-forced against dense bf16 weights; Qwen-7B (v1) Q4_K_M at
    full width with 2 layers, served and teacher-forced against dense
    bf16 weights; no dequantize-route or dense-attention call;
 8f. mla models: deepseek2's MLA aliases synthesized from seed 0 at Q4_K_M:
    tiny-minicpm3 and tiny-plm on the card against the CPU in both MLA
    forms; MiniCPM3-4B (minicpm3: n_embd 2560, 40 heads on the latent 256 +
    32, q LoRA 768, dense SwiGLU, vocab 73448) at full width with 24 of its
    62 layers on the bf16 latent, context 4096: load s and peak GiB,
    prompts of 512 and 2560 tokens cold and warm, 64 greedy tokens each on
    the decode graph, TTFT, decode tok/s, launches per forward (flash's
    latent form at (288, 256) once a layer in both regimes: the decode
    regime at R = 40), device ms by family, teacher-forced against dense
    bf16 weights; PLM-1.8B (plm: n_embd 2048, 16 heads on the latent 512
    + 64, q direct, a gateless ReLU² FFN of 8192, vocab 151936, tied) at
    full width with PLM_LAYERS = 8 of its 32 layers the same way and a BatchEngine of 4 slots
    on its Model teacher-forced against Engine; each model's decompressed
    form (TPULLM_MLA=0: flash at (96, 64) and (192, 128)) on bf16, q8, f16
    and f32 caches, briefly, its bf16 logits held against the absorbed
    form's on the same ids;
 8g. fit (after 5e, on the 8B's file): tpullm-torch-fit-params at -c
    262144 on the card's free memory, then an Engine at its fitted context:
    predicted weights + cache against max_memory_allocated, within 10%;
 8h. llama options: Qwen3-VL-8B (qwen3vl, IMROPE) at full width with
    QWEN3VL_LAYERS = 8 of its 36 layers:
    text on the decode graph, a decode token profiled, prefill_embeddings of
    a 256-row image with its grid positions and three deepstack residuals
    against dense bf16 weights; with 4 layers Qwen2-VL-7B (an image too),
    Qwen3-VL-30B-A3B, Apertus-8B (xIELU), AFM-4.5B (ReLU²) and llama-embed
    (Engine.embed unchanged by an earlier prefill, /v1/embeddings);
 8i. falcon: Falcon-7B with 4 layers on bf16, f16, f32 and q8 caches (its
    decode token's flash in the decode regime's row groups, its K = 4544
    linears through the counted dequantize route), Pythia-6.9B with 4
    layers;
 8j. gguf (after 8g): Llama-3-8B Q4_K_M with 4 layers split by
    tpullm-torch-gguf-split into shards of 16 tensors; an Engine on shard 1
    against one on the whole file (the same greedy ids and prompt logits);
    tpullm-torch-gguf-hash of both (the same digest and UUID);
    tpullm-torch-gguf-convert-endian to big and back (byte-equal);
 8k. bloom: BLOOM-7B1 at full width and depth (30 layers, ALiBi, the
    250880-token head tied to the embedding) on bf16 and q8 caches: every
    linear through qmm, flash at d128 with ALiBi in the decode regime at
    every decode token, the head one torch.matmul (aten-level count), a
    decode token profiled by family with the head's share, a 2-slot
    BatchEngine teacher-forced against Engine; MPT-7B with 4 layers;
 8l. gpt2: GPT-2 at full width and depth, a 1100-token prompt at context
    2048 (its bucket and last tokens past the 1024 positions: clamped);
    StarCoder-15.5B with 4 layers (48 heads on one KV head: flash's row
    groups at every decode token);
 9. routes: the tiny model with a 250-token head on the card against the
    CPU, its head through the counted dequantize-then-matmul route, and one
    attention call at head dims (112, 112), which no kernel instantiates,
    through the counted dense path;
10. the card line, the `conformance` JSON line, the `kernels` JSON line,
    and the result line.

Every serving run checks its launches per regime: each forward's 2-D qmm
on the tensor cores from 16 rows (the prefill buckets of 16 and up, the
head aside: it runs on the last row only) and on CUDA cores below, the
expert stacks through qmm_stack above 16 rows and qmm_gather at or below;
and no call of a full-width model through either counted route.

Imports nothing of JAX or of the tpullm package. Exits nonzero without CUDA
or without the repository beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the port's kernels that sum a split K in a second launch; a decode runs
# none of them (qmm and qmm_grouped below 16 rows and qmm_gather sum theirs
# in the same launch)
REDUCTION_KERNELS = ("qmm_reduce_kernel", "qmm_stack_reduce_kernel", "qmm_gather_reduce_kernel")

# NMSE bounds of the JAX package's on-chip conformance sweep
QMM_NMSE_BOUND = 5e-4
FLASH_NMSE_BOUND = 2e-3
FLASH_Q8_NMSE_BOUND = 5e-3

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12

# the 8B linears, (name, K = n_in, N = n_out)
QMM_SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gate_up", 4096, 28672),
              ("down", 14336, 4096), ("head", 4096, 128256))
# the 8B FFN linears, held for every format at M in QMM_ROWS
PRESET_QMM_SHAPES = (("gate_up", 4096, 28672), ("down", 14336, 4096))
QMM_ROWS = (1, 8, 16, 512)
COLD_BYTES = 100e6  # plane copies a cold M = 1 timing rotates among, together
# Mixtral's Q5_K attn_output and Q8_0 attn_k/attn_v
MIXTRAL_ATTN_SHAPES = (("wo", 4096, 4096), ("wkv", 4096, 1024))
# Mixtral's expert stacks: 8 experts, gate and up 4096→14336, down 14336→4096
N_EXPERT = 8
EXPERT_SHAPES = (("gate", 4096, 14336), ("down", 14336, 4096))
# the qmm kernel's entry per plane format, and the shapes that hold it
QMM_KEYS = {"Q4_K": "qmm_q4k", "Q6_K": "qmm_q6k", "Q5_K": "qmm_q5k", "Q8_0": "qmm_q8_0",
            "Q4_0": "qmm_q4_0", "Q4_1": "qmm_q4_1", "Q5_0": "qmm_q5_0", "Q5_1": "qmm_q5_1",
            "MXFP4": "qmm_mxfp4", "IQ4_NL": "qmm_iq4_nl", "Q2_K": "qmm_q2k",
            "Q3_K": "qmm_q3k", "IQ4_XS": "qmm_iq4_xs", "IQ2_XXS": "qmm_iq2_xxs",
            "IQ2_XS": "qmm_iq2_xs", "IQ2_S": "qmm_iq2_s", "IQ3_XXS": "qmm_iq3_xxs",
            "IQ3_S": "qmm_iq3_s", "IQ1_S": "qmm_iq1_s", "IQ1_M": "qmm_iq1_m",
            "TQ1_0": "qmm_tq1_0", "TQ2_0": "qmm_tq2_0"}
# the shapes beyond PRESET_QMM_SHAPES that formats hold at M = 1
QMM_EXTRA = {"Q4_K": QMM_SHAPES[:2] + QMM_SHAPES[4:], "Q6_K": QMM_SHAPES[:2] + QMM_SHAPES[4:],
             "Q5_K": MIXTRAL_ATTN_SHAPES, "Q8_0": MIXTRAL_ATTN_SHAPES}
# the flash kernels by KV cache format (ops/kernels/flash.py FORMATS)
FLASH_FORMATS = ("bf16", "f16", "f32", "q8")
FLASH_KEYS = tuple(f"flash_{fmt}" for fmt in FLASH_FORMATS)
# flash's instantiations at head dim 256 (the Gemma family), a line each
FLASH256_KEYS = tuple(f"flash_{fmt}_d256" for fmt in FLASH_FORMATS)
# flash's instantiations at head dims 96 and 80 (Phi-3, Phi-2), a line each
FLASH_NARROW_KEYS = tuple(f"flash_{fmt}_d{d}" for d in (96, 80) for fmt in FLASH_FORMATS)
# flash's latent form (the MLA cache, bf16): Dk 576, Dv 512 (DeepSeek-V2,
# PLM) and Dk 288, Dv 256 (MiniCPM3)
FLASH_MLA_KEY = "flash_bf16_d576v512"
FLASH_MLA288_KEY = "flash_bf16_d288v256"
# flash at key width ≠ value width (the decompressed MLA form), a line each
DKDV_DIMS = ((192, 128), (96, 64))
FLASH_DKDV_KEYS = tuple(f"flash_{fmt}_d{d}v{dv}" for d, dv in DKDV_DIMS for fmt in FLASH_FORMATS)
# flash at head dim 64, the decode regime in row groups (Falcon-7B: 71 heads
# on one KV head), a line each
FLASH_ROWS_KEYS = tuple(f"flash_{fmt}_d64" for fmt in FLASH_FORMATS)
KERNELS = (*QMM_KEYS.values(), "qmm_tc", "qmm_grouped", "qmm_stack", "qmm_gather", *FLASH_KEYS,
           *FLASH256_KEYS, *FLASH_NARROW_KEYS, FLASH_MLA_KEY, FLASH_MLA288_KEY, *FLASH_DKDV_KEYS,
           *FLASH_ROWS_KEYS)
# the main path's representative shape per kernel, for the kernels line
REPRESENTATIVE = {"qmm_q4k": "Q4_K gate_up M=1", "qmm_q6k": "Q6_K down M=1",
                  "qmm_q5k": "Q5_K wo M=1", "qmm_q8_0": "Q8_0 wkv M=1",
                  **{QMM_KEYS[f]: f"{f} gate_up M=1" for f in QMM_KEYS if f not in QMM_EXTRA},
                  "qmm_tc": "Q4_K gate_up M=512",
                  "qmm_grouped": "Q4_K gate_up M=1", "qmm_stack": "Q4_K gate M=512 shared",
                  "qmm_gather": "Q4_K gate T=2",
                  **{f"flash_{fmt}": f"{fmt} T=1 S=4096" for fmt in FLASH_FORMATS},
                  **{f"flash_{fmt}_d256": f"{fmt} T=1 B=2 S=4096 D=256" for fmt in FLASH_FORMATS},
                  **{f"flash_{fmt}_d{d}": f"{fmt} T=1 B=2 S=4096 D={d}" for d in (96, 80)
                     for fmt in FLASH_FORMATS},
                  FLASH_MLA_KEY: "T=1 B=2 kv=38/3001 S=4096",
                  FLASH_MLA288_KEY: "d288v256 H=40 T=1 B=2 kv=38/3001 S=4096",
                  **{f"flash_{fmt}_d{d}v{dv}": f"{fmt} T=1 B=2 S=4096 D={d}/{dv}"
                     for d, dv in DKDV_DIMS for fmt in FLASH_FORMATS},
                  **{f"flash_{fmt}_d64": f"{fmt} H=71 T=1 B=2 kv=38/3001 S=4096 D=64"
                     for fmt in FLASH_FORMATS}}
REPLACES = {**{k: "tpullm/ops/pallas/qmm.py:121" for k in QMM_KEYS.values()},
            "qmm_tc": "tpullm/ops/pallas/qmm.py:121",
            "qmm_grouped": "tpullm/ops/pallas/qmm.py:153",
            "qmm_stack": "tpullm/ops/pallas/qmm.py:288",
            "qmm_gather": "tpullm/ops/pallas/qmm.py:381",
            **{key: "tpullm/ops/pallas/flash.py:69"
               for key in (*FLASH_KEYS, *FLASH256_KEYS, *FLASH_NARROW_KEYS, FLASH_MLA_KEY,
                           FLASH_MLA288_KEY, *FLASH_DKDV_KEYS, *FLASH_ROWS_KEYS)}}
SOURCES = {**{k: "tpullm_torch/csrc/qmm.cu" for k in QMM_KEYS.values()},
           "qmm_tc": "tpullm_torch/csrc/qmm.cu",
           "qmm_grouped": "tpullm_torch/csrc/qmm.cu",
           "qmm_stack": "tpullm_torch/csrc/qmm_moe.cu",
           "qmm_gather": "tpullm_torch/csrc/qmm_moe.cu",
           **{key: "tpullm_torch/csrc/flash.cu" for key in (*FLASH_KEYS, *FLASH256_KEYS,
                                                            *FLASH_NARROW_KEYS, FLASH_MLA_KEY,
                                                            FLASH_MLA288_KEY, *FLASH_DKDV_KEYS,
                                                            *FLASH_ROWS_KEYS)}}


def log(*a):
    print(*a, flush=True)


def expect(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean() / (ref * ref).mean().clamp_min(1e-300))


_CAPTURE_STREAM = []  # the one side stream every graph is captured on


def time_ms(fn, iters: int, warmup: int = 2, graph: bool = True) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events). With `graph` the calls are captured once in a CUDA graph and
    the replay is timed, so the time is the device's, not the Python
    wrapper's dispatch (a short kernel launched eagerly back to back is
    timed at the host's pace); without, the calls run eagerly (for plain
    versions that read values back to the host). The warm-up calls run on
    the capture stream (a kernel's counter buffer is made per stream, outside
    the capture)."""
    import torch

    if graph and not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0] if graph else torch.cuda.current_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        del g
        return start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / PEAK_BYTES, flops / PEAK_BF16
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    try:
        import regex
        found = f"imports (regex {regex.__version__})"
    except ImportError as e:
        found = f"does not import ({e})"
    log(f"[env] the regex module {found}; tpullm_torch does not use it "
        "(its BPE patterns run on the standard library's re)")
    try:
        import aiohttp
        found = f"imports (aiohttp {aiohttp.__version__})"
    except ImportError as e:
        found = f"does not import ({e})"
    log(f"[env] the aiohttp module {found}; tpullm_torch.server does not use it "
        "(its HTTP layer is the standard library's http.server)")
    return smi


def ptxas_entries(report: str) -> list[tuple[str, int, int, int]]:
    """(kernel<template ints>, registers, spill store bytes, spill load
    bytes) of each entry function in an `-Xptxas -v` report."""
    import re

    out, cur, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the mangled name's identifier (length-prefixed) that ends in _kernel
            mangled, cur = m.group(1), m.group(1)[:48]
            for i in range(len(mangled)):
                d = re.match(r"\d+", mangled[i:])
                ident = mangled[i + d.end():i + d.end() + int(d.group())] if d else ""
                if ident.endswith("_kernel") and ident.isidentifier():
                    targs = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i + d.end() + len(ident):])
                    args = re.findall(r"L[ib](\d+)E", targs.group(1)) if targs else []
                    cur = f"{ident}<{','.join(args)}>"
                    break
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((cur, int(m.group(1)), *spill))
            cur, spill = None, (0, 0)
    return out


def phase_build() -> dict:
    """Builds every library; returns each kernel's (registers, spill store
    bytes, spill load bytes) from the ptxas report (empty for libraries
    built before)."""
    from tpullm_torch.ops.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} libraries in {time.perf_counter() - t0:.1f}s "
        f"into {_build.BUILD_DIR}; nvcc seconds per library "
        f"{ {name: round(sec, 1) for name, (_, sec) in reports.items()} }")
    tc, regs = [], {}
    for name, (rep, _) in reports.items():
        entries = ptxas_entries(rep)
        regs.update({k: (r, st, ld) for k, r, st, ld in entries})
        log(f"[build] {name}: " + "; ".join(f"{k} {r} regs, spill {st}/{ld} B"
                                           for k, r, st, ld in entries))
        tc += [(k, r, st, ld) for k, r, st, ld in entries
               if k.startswith(("qmm_tc_kernel", "qmm_stack_kernel", "qmm_grouped_tc_kernel"))]
    for kind in ("qmm_tc_kernel", "qmm_stack_kernel", "qmm_grouped_tc_kernel"):
        ks = [e for e in tc if e[0].startswith(kind)]
        if ks:
            log(f"[build] {kind}: {len(ks)} instantiations, registers {min(e[1] for e in ks)}–"
                f"{max(e[1] for e in ks)}, spill stores {max(e[2] for e in ks)} B at most, "
                f"spilling: {[e[0] for e in ks if e[2] or e[3]]}")
    d256 = {k: v for k, v in regs.items() if k.startswith("flash_") and "<256," in k}
    log(f"[build] flash at D = 256 (registers, spill stores, spill loads): {d256}")
    narrow = {k: v for k, v in regs.items() if k.startswith("flash_") and
              ("<96,96," in k or "<80,80," in k)}
    log(f"[build] flash at D = 96 and 80 (registers, spill stores, spill loads): {narrow}")
    mla = {k: v for k, v in regs.items() if k.startswith("flash_mla")}
    log(f"[build] flash's latent form, Dk 576 / Dv 512 and 288 / 256 (registers, spill "
        f"stores, spill loads): {mla}")
    dkdv = {k: v for k, v in regs.items() if k.startswith("flash_") and
            ("<192,128," in k or "<96,64," in k)}
    log(f"[build] flash at Dk ≠ Dv, (192, 128) and (96, 64) (registers, spill stores, spill "
        f"loads): {dkdv}")
    return regs


def _random_planes(gtype, n_out: int, n_in: int, gen, dev):
    """Random packed blocks made on the card (as models/synth.random_packed
    makes them on the host), repacked to device planes."""
    import torch

    from tpullm_torch.gguf.constants import TYPE_TRAITS
    from tpullm_torch.models.synth import write_scales
    from tpullm_torch.ops import qmatmul

    tt = TYPE_TRAITS[gtype]
    nb = n_out * n_in // tt.block_size
    raw = torch.randint(0, 256, (nb, tt.type_size), generator=gen, device=dev,
                        dtype=torch.uint8)
    write_scales(raw, gtype, (torch.rand(nb, generator=gen, device=dev) + 0.5) * 0.02)
    return qmatmul.repack(raw.reshape(-1), gtype, n_out, n_in, dev)


def _cuda_core_qmm(x, planes, gtype, N: int, K: int):
    """The CUDA-core qmm kernel (TM = 8 rows a block) at an M of the
    tensor-core regime, uncounted: the kernel the tensor-core one replaced
    there, timed on the same planes."""
    import torch

    from tpullm_torch.ops.kernels import _build, qmm

    M = x.shape[0]
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    tm, split, per = qmm.gemv_plan(M, K, N, n_sm)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = torch.empty((split if split > 1 else 0, M, N), dtype=torch.float32,
                          device=x.device)
    tiles = -(-N // qmm.GEMV_BLOCK_N) * -(-M // tm)
    fn = _build.bind(f"qmm{qmm._FAMILY[gtype]}", "tpullm_qmm", qmm._QMM_ARGS)
    ops = [planes[qmm._code_plane(gtype)], planes.get("qh"), planes["scale"], planes.get("minus")]
    _build.check(fn(qmm._FMT[gtype], x.data_ptr(), *[None if t is None else t.data_ptr()
                                                     for t in ops],
                    out.data_ptr(), partial.data_ptr(),
                    _build.counters(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                                    tiles).data_ptr(), M, K, N, tm, split, per,
                    torch.cuda.current_stream(x.device).cuda_stream), "cuda-core qmm")
    return out


def cold_ms(fn, copies: list, iters: int) -> float:
    """Mean device time of fn(copy) over `iters` calls rotating among
    `copies` (each a set of planes), so that no call finds its planes left
    in the L2 by the one before."""
    i = iter(range(1 << 30))
    return time_ms(lambda: fn(copies[next(i) % len(copies)]), iters)


def phase_qmm(dev, results: dict):
    """qmm for every format at the 8B gate_up and down, M in QMM_ROWS (the
    CUDA-core kernel at M = 1, the tensor-core kernel at 16 and 512, and at
    512 the CUDA-core kernel on the same planes), and at the formats' other
    main-path shapes at M = 1."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(0)
    for fmt, key in QMM_KEYS.items():
        gtype = GGMLType[fmt]
        cases = [(shape, QMM_ROWS) for shape in PRESET_QMM_SHAPES]
        cases += [(shape, (1,)) for shape in QMM_EXTRA.get(fmt, ())]
        for (name, K, N), rows in cases:
            planes = _random_planes(gtype, N, K, gen, dev)
            plane_bytes = sum(t.numel() * t.element_size() for t in planes.values())
            w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
            for M in rows:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                got = qmm.qmm(x, planes, gtype, N, K)
                ref = qmm.qmm_reference(x, planes, gtype, N, K)
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                label = f"{gtype.name} {name} M={M}"
                expect(bool(torch.isfinite(got.float()).all()), f"{label} finite")
                expect(err <= QMM_NMSE_BOUND, f"{label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                iters = 20 if M < qmm.TC_MIN_M else 5
                ms = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters)
                plain = time_ms(lambda: qmm.qmm_reference(x, planes, gtype, N, K), 2, 1,
                                graph=False)
                lib = time_ms(lambda: torch.matmul(x, w_lib), iters)
                bms, by = bound_ms(M * K * 2 + plane_bytes + M * N * 2, 2.0 * M * K * N)
                row = dict(case=label, nmse=err, max_abs_err=mae, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           gbps=(plane_bytes + M * K * 2 + M * N * 2) / ms / 1e6,
                           tflops=2.0 * M * K * N / ms / 1e9)
                extra = ""
                if M == 1:
                    row["eager_ms"] = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters,
                                              graph=False)
                    n_copy = max(2, -(-int(COLD_BYTES) // plane_bytes))
                    copies = [planes] + [{k: t.clone() for k, t in planes.items()}
                                         for _ in range(n_copy - 1)]
                    row["cold_ms"] = cold_ms(lambda p: qmm.qmm(x, p, gtype, N, K), copies, 20)
                    row["cold_gbps"] = (plane_bytes + M * K * 2 + M * N * 2) / row["cold_ms"] / 1e6
                    extra = (f" cold {row['cold_ms']:.4f} ms ({row['cold_gbps']:.0f} GB/s); eager "
                             f"back to back {row['eager_ms']:.4f} ms")
                    del copies
                if M == max(QMM_ROWS):
                    cc = _cuda_core_qmm(x, planes, gtype, N, K)
                    torch.cuda.synchronize()
                    expect(nmse(cc.float(), ref.float()) <= QMM_NMSE_BOUND,
                           f"{label} CUDA-core kernel NMSE")
                    row["cuda_core_ms"] = time_ms(lambda: _cuda_core_qmm(x, planes, gtype, N, K),
                                                  3, 1)
                    extra = f" cuda-core kernel {row['cuda_core_ms']:.4f} ms"
                results.setdefault(key if M < qmm.TC_MIN_M else "qmm_tc", []).append(row)
                log(f"[qmm] {label}: nmse {err:.2e} max|d| {mae:.3g} kernel {ms:.4f} ms "
                    f"({row['gbps']:.0f} GB/s, {row['tflops']:.1f} TFLOP/s) bound {bms:.4f} ms "
                    f"({by}) plain {plain:.3f} ms cublas-on-dequantized {lib:.4f} ms{extra}")
            del w_lib, planes
    torch.cuda.empty_cache()


GROUPED_ROWS = (1, 8, 16, 128, 512)


def phase_grouped(dev, results: dict):
    """qmm_grouped, the group-factored kernel, for every format at the 8B
    gate_up and down, M in GROUPED_ROWS (below 16 rows the gemv body, from
    16 the grouped form of the tensor-core body, whose K is split at down
    and summed by qmm_reduce_kernel), against its plain version
    (qmm_grouped_reference), timed beside qmm (the materializing kernel of
    the same regime) on the same planes and cuBLAS on dequantized weights."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(3)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for fmt in QMM_KEYS:
        gtype = GGMLType[fmt]
        for name, K, N in PRESET_QMM_SHAPES:
            planes = _random_planes(gtype, N, K, gen, dev)
            plane_bytes = sum(t.numel() * t.element_size() for t in planes.values())
            w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
            for M in GROUPED_ROWS:
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                got = qmm.qmm_grouped(x, planes, gtype, N, K)
                ref = qmm.qmm_grouped_reference(x, planes, gtype, N, K)
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                label = f"{gtype.name} {name} M={M}"
                expect(bool(torch.isfinite(got.float()).all()), f"grouped {label} finite")
                expect(err <= QMM_NMSE_BOUND,
                       f"grouped {label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                tc = M >= qmm.TC_MIN_M
                split = (qmm.plan if tc else qmm.gemv_plan)(M, K, N, n_sm)[1]
                iters = 5 if tc else 20
                ms = time_ms(lambda: qmm.qmm_grouped(x, planes, gtype, N, K), iters)
                mat = time_ms(lambda: qmm.qmm(x, planes, gtype, N, K), iters)
                plain = time_ms(lambda: qmm.qmm_grouped_reference(x, planes, gtype, N, K), 2,
                                1, graph=False)
                lib = time_ms(lambda: torch.matmul(x, w_lib), iters)
                bms, by = bound_ms(M * K * 2 + plane_bytes + M * N * 2, 2.0 * M * K * N)
                results.setdefault("qmm_grouped", []).append(dict(
                    case=label, nmse=err, max_abs_err=mae, ms=ms, qmm_ms=mat, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib, split=split))
                log(f"[grouped] {label} (split {split}): nmse {err:.2e} max|d| {mae:.3g} "
                    f"grouped {ms:.4f} ms, {'qmm_tc' if tc else 'qmm'} on the same planes "
                    f"{mat:.4f} ms ({ms / mat:.3f}×), bound {bms:.4f} ms ({by}) plain "
                    f"{plain:.3f} ms cublas-on-dequantized {lib:.4f} ms")
            del w_lib, planes
    torch.cuda.empty_cache()


def _random_stack(gtype, n_out: int, n_in: int, gen, dev, n_expert: int = N_EXPERT) -> dict:
    """n_expert experts' random planes, stacked [E, rows, N]."""
    import torch

    per = [_random_planes(gtype, n_out, n_in, gen, dev) for _ in range(n_expert)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def phase_moe_kernels(dev, results: dict):
    """qmm_stack and qmm_gather against their plain versions at Mixtral's
    expert shapes; library call: torch.matmul on experts already dequantized
    to bf16 (for the gather, the ids gather of those experts inside the
    timed call)."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(2)
    M = 512
    for fmt in QMM_KEYS:
        gtype = GGMLType[fmt]
        for name, K, N in EXPERT_SHAPES:
            planes = _random_stack(gtype, N, K, gen, dev)
            expert_bytes = sum(t.numel() * t.element_size() for t in planes.values()) / N_EXPERT
            w_lib = torch.stack([qmatmul.dequant_planes({k: v[e] for k, v in planes.items()},
                                                        gtype, N, K, dtype=torch.bfloat16)
                                 for e in range(N_EXPERT)])  # [E, K, N]
            cases = []
            # a per-expert x moves one stride, the same for every format: Q4_K
            # and Q6_K hold it
            for batched in (False, True) if fmt in ("Q4_K", "Q6_K") else (False,):
                shape = (N_EXPERT, M, K) if batched else (M, K)
                x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
                cases.append(("qmm_stack", f"{gtype.name} {name} M={M} "
                              f"{'batched' if batched else 'shared'}",
                              lambda x=x: qmm.qmm_stack(x, planes, gtype, N, K),
                              lambda x=x: qmm.qmm_stack_reference(x, planes, gtype, N, K),
                              lambda x=x: torch.matmul(x, w_lib),
                              x.numel() * 2 + N_EXPERT * expert_bytes + N_EXPERT * M * N * 2,
                              2.0 * N_EXPERT * M * K * N, 3))
            for T, one in ((2, False), (32, False), (32, True)):
                x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
                if T == 2:  # one decode token: its top-2, two distinct experts
                    ids = torch.randperm(N_EXPERT, generator=gen, device=dev)[:2].int()
                elif one:  # every slot on one expert: row tiles of 8 of one expert
                    ids = torch.full((T,), 5, device=dev, dtype=torch.int32)
                else:  # the 16-token bucket's slots, with a repeated expert
                    ids = torch.randint(0, N_EXPERT, (T,), generator=gen, device=dev,
                                        dtype=torch.int32)
                    ids[-1] = ids[0]
                n_unique = int(torch.unique(ids).numel())  # the experts this run reads
                cases.append(("qmm_gather", f"{gtype.name} {name} T={T}"
                              f"{' one expert' if one else ''}",
                              lambda x=x, ids=ids: qmm.qmm_gather(x, ids, planes, gtype, N, K),
                              lambda x=x, ids=ids: qmm.qmm_gather_reference(x, ids, planes,
                                                                            gtype, N, K),
                              lambda x=x, ids=ids: torch.bmm(x[:, None, :],
                                                             w_lib[ids.long()])[:, 0],
                              x.numel() * 2 + T * 4 + n_unique * expert_bytes + T * N * 2,
                              2.0 * T * K * N, 20 if T == 2 else 5))
            # ids outside 0..E-1 give NaN rows, the others their expert's product
            x = torch.randn(4, K, generator=gen, device=dev).to(torch.bfloat16)
            ids = torch.tensor([3, N_EXPERT, -1, 3], device=dev, dtype=torch.int32)
            got = qmm.qmm_gather(x, ids, planes, gtype, N, K)
            ref = qmm.qmm_gather_reference(x[[0, 3]], ids[[0, 3]], planes, gtype, N, K)
            torch.cuda.synchronize()
            err = nmse(got[[0, 3]].float(), ref.float())
            expect(bool(torch.isnan(got[[1, 2]].float()).all()),
                   f"qmm_gather {gtype.name} {name}: NaN rows for ids outside the stack")
            expect(err <= QMM_NMSE_BOUND, f"qmm_gather {gtype.name} {name} beside invalid ids: "
                   f"NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
            log(f"[moe] qmm_gather {gtype.name} {name} ids {ids.tolist()}: NaN rows 1, 2; "
                f"rows 0, 3 nmse {err:.2e}")
            for key, label, kernel, plain, library, n_bytes, flops, iters in cases:
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                err = nmse(got.float(), ref.float())
                mae = float((got.float() - ref.float()).abs().max())
                expect(bool(torch.isfinite(got.float()).all()), f"{key} {label} finite")
                expect(err <= QMM_NMSE_BOUND, f"{key} {label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
                bms, by = bound_ms(n_bytes, flops)
                row = dict(case=label, nmse=err, max_abs_err=mae, ms=time_ms(kernel, iters),
                           plain_ms=time_ms(plain, 1, 1, graph=False), bound_ms=bms, bound_by=by,
                           library_ms=time_ms(library, iters))
                row["gbps"] = n_bytes / row["ms"] / 1e6
                row["tflops"] = flops / row["ms"] / 1e9
                results.setdefault(key, []).append(row)
                log(f"[moe] {key} {label}: nmse {err:.2e} max|d| {mae:.3g} kernel "
                    f"{row['ms']:.4f} ms ({row['gbps']:.0f} GB/s, {row['tflops']:.1f} TFLOP/s) "
                    f"bound {bms:.4f} ms ({by}) plain {row['plain_ms']:.3f} ms "
                    f"matmul-on-dequantized {row['library_ms']:.4f} ms")
            del planes, w_lib, cases
            torch.cuda.empty_cache()


def counted_call(key: str, fn):
    """fn() (a flash wrapper's call), which must count exactly one launch,
    under flash.LAUNCHES[key]."""
    from tpullm_torch.ops.kernels import flash

    before = flash.LAUNCHES[key], flash.launch_total()
    out = fn()
    expect((flash.LAUNCHES[key], flash.launch_total()) == (before[0] + 1, before[1] + 1),
           f"flash {key}: one counted launch a call")
    return out


def _flash_case(dev, gen, *, fmt, B, T, H, Hkv, D, S, offsets, softcap=0.0, window=0,
                sinks=False, alibi=False, timed=False, DV=None, slopes=None):
    """One flash call on random inputs against its plain version; `fmt`
    the KV cache format (FLASH_FORMATS): q is bf16, K/V drawn in f32 and
    stored in the cache's dtype (q8: quantized as the cache quantizes); V
    DV wide (None: D); with `alibi` the heads' ALiBi slopes `slopes` (None:
    a ramp from 0.5 to 0.01), and SDPA's mask, where timed, the float bias
    they give. The first call counts one launch under its key."""
    import torch
    import torch.nn.functional as F

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.kvcache import QuantKVCache

    q8 = fmt == "q8"
    kv_dtype = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
                "q8": torch.bfloat16}[fmt]
    DV = DV or D
    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev).to(kv_dtype)
    v = torch.randn(B, Hkv, S, DV, generator=gen, device=dev).to(kv_dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    sk = torch.randn(H, generator=gen, device=dev) if sinks else None
    sl = (torch.linspace(0.5, 0.01, H, device=dev) if slopes is None else slopes.to(dev)) \
        if alibi else None
    scale = D ** -0.5
    if q8:
        k_q, k_s = QuantKVCache._quantize(k)
        v_q, v_s = QuantKVCache._quantize(v)
        kv = (k_q, v_q)
        kw = dict(k_scale=k_s, v_scale=v_s)

        def kernel():
            return flash.flash_attention_q8(q, k_q, k_s, v_q, v_s, off, scale, softcap,
                                            window, sk, sl)
        k_lib = (k_q.float() * k_s[..., None]).to(torch.bfloat16)
        v_lib = (v_q.float() * v_s[..., None]).to(torch.bfloat16)
    else:
        kv, kw = (k, v), {}

        def kernel():
            return flash.flash_attention(q, k, v, off, scale, softcap, window, sk, sl)
        k_lib, v_lib = k, v

    def plain():
        return flash.flash_reference(q, *kv, off, scale, softcap, window, sk, sl, **kw)
    decode = flash.regime(T, H, Hkv) == "decode"
    key = f"{fmt}.{flash.dims_key(D, DV)}.{'decode' if decode else 'prefill'}"
    got = counted_call(key, kernel)
    ref = plain()
    torch.cuda.synchronize()
    expect(tuple(got.shape) == (B, T, H, DV), f"flash {key}: output {tuple(got.shape)}")
    idle = [b for b, o in enumerate(offsets) if o < 0]  # no visible key in their first row
    row = dict(regime="decode" if decode else "prefill", nmse=nmse(got.float(), ref.float()),
               max_abs_err=float((got.float() - ref.float()).abs().max()),
               finite=bool(torch.isfinite(got.float()).all()),
               idle_zero=not bool(got[idle, 0].float().any()))
    if not timed:
        return row
    # the plain version of the kernel's own order: its split plan, or its
    # tiles with p rounded as it rounds it (and, beside it, one bf16 term)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if decode:
        own = flash.flash_split_reference(q, *kv, off, scale, softcap, window, sk, sl,
                                          n_sm=n_sm, **kw)
    else:
        own = flash.flash_prefill_reference(q, *kv, off, scale, softcap, window, sk, sl, **kw)
        q32 = q.float()
        exact = flash.flash_reference(q32, *kv, off, scale, softcap, window, sk, sl, **kw)
        for terms in (1, 2):
            rounded = flash.flash_prefill_reference(q32, *kv, off, scale, softcap, window, sk,
                                                    sl, p_terms=terms, **kw)
            row[f"p_terms{terms}_nmse"] = nmse(rounded, exact)
        del exact, rounded
    row["nmse_own_order"] = nmse(got.float(), own.float())
    # work this run's data needs: keys up to each row's position (in its
    # window), per head, and the keys [window start, kv_len) read
    q_pos = np.asarray(offsets)[:, None] + np.arange(T)[None]
    vis = np.minimum(q_pos + 1, S)
    visible = float((np.minimum(vis, window) if window > 0 else vis).sum())
    kv_len = np.minimum(np.asarray(offsets) + T, S)
    if window > 0:
        kv_len = kv_len - np.maximum(0, np.asarray(offsets) - window + 1)
    # bytes of one position's K and V rows (q8: the codes and their scales)
    per_pos = (D + DV) * k.element_size() if not q8 else D + DV + 8
    n_bytes = q.numel() * 2 + B * T * H * DV * 2 + float(kv_len.sum()) * Hkv * per_pos
    bms, by = bound_ms(n_bytes, 2.0 * (D + DV) * H * visible)
    pos = torch.arange(S, device=dev)
    q_at = (off[:, None] + torch.arange(T, device=dev))[..., None]
    mask = pos[None, None, :] <= q_at
    if window > 0:
        mask &= pos[None, None, :] > q_at - window
    mask = mask[:, None]  # [B, 1, T, S]
    qt = q.transpose(1, 2).to(k_lib.dtype)  # SDPA on the cache's dtype
    if alibi:  # the bias as a float mask [B, H, T, S], −inf where masked
        bias = sl.float()[None, :, None, None] * (pos[None, None, None, :] - q_at[:, None])
        mask = torch.where(mask, bias, float("-inf")).to(qt.dtype)
    k_lib = k_lib.repeat_interleave(H // Hkv, dim=1)  # GQA heads expanded outside the timing
    v_lib = v_lib.repeat_interleave(H // Hkv, dim=1)

    def library():
        return F.scaled_dot_product_attention(qt, k_lib, v_lib, attn_mask=mask, scale=scale)
    row.update(ms=time_ms(kernel, 20), eager_ms=time_ms(kernel, 20, graph=False),
               plain_ms=time_ms(plain, 2, 1, graph=False), bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, 20), visible_pairs_per_head=visible / B)
    return row


def phase_flash(dev, results: dict):
    import torch

    gen = torch.Generator(dev).manual_seed(1)
    main = dict(B=2, H=32, Hkv=8, D=128, S=4096)
    for fmt, key in zip(FLASH_FORMATS, FLASH_KEYS):
        bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
        one = dict(main, B=1)
        cases = [(f"{fmt} T=1 S=4096", dict(T=1, offsets=(37, 3000), **main)),
                 (f"{fmt} T=512 S=4096", dict(T=512, offsets=(0, 2500), **main)),
                 # the 8B's decode at a short context (the serving profile's)
                 (f"{fmt} T=1 B=1 kv=20 S=4096", dict(T=1, offsets=(19,), **one)),
                 (f"{fmt} T=1 B=1 kv=100 S=4096", dict(T=1, offsets=(99,), **one))]
        small = dict(B=2, H=8, Hkv=2, S=300)
        cases += [
            ("softcap", dict(T=40, offsets=(0, 250), D=128, softcap=30.0, **small)),
            ("window", dict(T=40, offsets=(5, 200), D=64, window=48, **small)),
            ("sinks", dict(T=1, offsets=(0, 280), D=128, sinks=True, **small)),
            ("alibi", dict(T=33, offsets=(10, 240), D=64, alibi=True, **small)),
            ("all", dict(T=20, offsets=(3, 270), D=128, softcap=25.0, window=32, sinks=True,
                         alibi=True, **small)),
            ("all decode", dict(T=4, offsets=(3, 270), D=64, softcap=25.0, window=32, sinks=True,
                                alibi=True, **small)),
        ]
        for label, kw in cases:
            timed = "S=4096" in label
            row = _flash_case(dev, gen, fmt=fmt, timed=timed, **kw)
            row["case"] = label if timed else f"{fmt} {label}"
            expect(row["finite"], f"flash {row['case']} finite")
            expect(row["nmse"] <= bound, f"flash {row['case']} NMSE {row['nmse']:.3e} <= {bound}")
            results.setdefault(key, []).append(row)
            extra = ""
            if timed:
                expect(row["nmse_own_order"] <= bound, f"flash {row['case']} against the plain "
                       f"version of its own order: NMSE {row['nmse_own_order']:.3e}")
                extra = (f" (against its own order's plain version {row['nmse_own_order']:.2e})"
                         f" kernel {row['ms']:.4f} ms (eager back to back {row['eager_ms']:.4f})"
                         f" bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']}) plain {row['plain_ms']:.3f} ms "
                         f"sdpa {row['library_ms']:.4f} ms")
                if "p_terms1_nmse" in row:
                    extra += (f"; p for the PV product as one bf16 term: NMSE "
                              f"{row['p_terms1_nmse']:.2e}, as two: {row['p_terms2_nmse']:.2e} "
                              "(plain versions, f32 output, against f32 p)")
            log(f"[flash] {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} max|d| "
                f"{row['max_abs_err']:.3g}{extra}")
    torch.cuda.empty_cache()


# Gemma-3-4B's attention: 8 query heads on 4 KV heads of head dim 256, a
# window of 1024 on five layers of six; Gemma-2's softcap 50
D256_HEADS = dict(H=8, Hkv=4, D=256, S=4096)
D256_WINDOW = 1024
# Gemma-3-4B's ring speculation (GEMMA_SPEC_DRAFT 4 drafts and the pending
# token): verify forwards in the bucket of 8 rows, from about the 2560-token
# prompt's end
GEMMA_VERIFY_ROWS = 8
GEMMA_VERIFY_OFFSET = 2560


def phase_flash256(dev, results: dict):
    """Flash at head dim 256 (the Gemma family), each KV format: the decode
    regime at T = 1, B = 2 and B = 1, and at T = 8, B = 1 from offset
    GEMMA_VERIFY_OFFSET (Gemma-3's ring verify forward of GEMMA_VERIFY_ROWS:
    R = 16, the decode regime's last row count), the prefill regime at
    T = 512, each without and with Gemma-3's window of 1024, S = 4096
    (timed beside its bound and SDPA on the cache's dtype, and against the
    plain version of its own order), and Gemma-2's softcap 50 in both
    regimes (timed beside SDPA without it, which has none); rows go to
    `results` under flash_<fmt>_d256."""
    import torch

    gen = torch.Generator(dev).manual_seed(7)
    w = D256_WINDOW
    for fmt in FLASH_FORMATS:
        key = f"flash_{fmt}_d256"
        bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
        cases = [(f"{fmt} T=1 B=2 S=4096 D=256", dict(T=1, B=2, offsets=(37, 3000))),
                 (f"{fmt} T=1 B=1 window={w} S=4096 D=256",
                  dict(T=1, B=1, offsets=(3000,), window=w)),
                 (f"{fmt} T={GEMMA_VERIFY_ROWS} B=1 S=4096 D=256",
                  dict(T=GEMMA_VERIFY_ROWS, B=1, offsets=(GEMMA_VERIFY_OFFSET,))),
                 (f"{fmt} T={GEMMA_VERIFY_ROWS} B=1 verify window={w} S=4096 D=256",
                  dict(T=GEMMA_VERIFY_ROWS, B=1, offsets=(GEMMA_VERIFY_OFFSET,), window=w)),
                 (f"{fmt} T=512 B=2 S=4096 D=256", dict(T=512, B=2, offsets=(0, 2500))),
                 (f"{fmt} T=512 B=1 window={w} S=4096 D=256",
                  dict(T=512, B=1, offsets=(2500,), window=w)),
                 (f"{fmt} T=1 B=2 softcap=50 window={w} D=256",
                  dict(T=1, B=2, offsets=(37, 3000), softcap=50.0, window=w)),
                 (f"{fmt} T=512 B=2 softcap=50 D=256",
                  dict(T=512, B=2, offsets=(0, 2500), softcap=50.0))]
        for label, kw in cases:
            row = _flash_case(dev, gen, fmt=fmt, timed=True, **D256_HEADS, **kw)
            row["case"] = label
            expect(row["finite"], f"flash {label} finite")
            expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                   f"flash {label} NMSE {row['nmse']:.3e}, against the plain version of its "
                   f"own order {row['nmse_own_order']:.3e} <= {bound}")
            results.setdefault(key, []).append(row)
            log(f"[flash256] {label} ({row['regime']}): nmse {row['nmse']:.2e} max|d| "
                f"{row['max_abs_err']:.3g} (own order {row['nmse_own_order']:.2e}) kernel "
                f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}) plain {row['plain_ms']:.3f} ms sdpa "
                f"{row['library_ms']:.4f} ms" + (" (SDPA without the softcap)"
                                                 if "softcap" in label else ""))
    torch.cuda.empty_cache()


# flash at head dims 96 (Phi-3-mini: 32 heads on 32 KV heads, a window of
# 2047 on every layer of a full cache, context 4096) and 80 (Phi-2: 32 on
# 32, no window, context 2048); the GQA 32 / 8 cases of phase_flash beside
# them
NARROW_DIMS = (96, 80)
PHI_HEADS = {96: dict(H=32, Hkv=32, S=4096, window=2047), 80: dict(H=32, Hkv=32, S=2048)}
PHI_DECODE_OFFSET = {96: 3000, 80: 1500}  # the Phi decode cases' first query position
PHI_DECODE_ROWS = (1, 9, 16)  # a decode token, a 9-row verify, the decode regime's last R
PHI3_PROMPT = 2560  # Phi-3's windowed prefill (k_begin > 0 from its second block)


# the Phi and Qwen (v1) 2-D linears at Q4_K_M, (format, name, K, N): the
# fused attn_qkv (Q5_K), Phi-3's fused gate|up, the down projections at the
# recipe's Q6_K (use_more_bits layers; Q4_K on the others, as the 8B's), the
# Q6_K heads
PHI_QMM_SHAPES = (("Q5_K", "phi-3-mini qkv", 3072, 9216),
                  ("Q4_K", "phi-3-mini gate_up", 3072, 16384),
                  ("Q6_K", "phi-3-mini down", 8192, 3072),
                  ("Q6_K", "phi-3-mini head", 3072, 32064),
                  ("Q5_K", "phi-2 qkv", 2560, 7680),
                  ("Q4_K", "phi-2 up", 2560, 10240),
                  ("Q6_K", "phi-2 down", 10240, 2560),
                  ("Q6_K", "phi-2 head", 2560, 51200),
                  ("Q5_K", "qwen-7b qkv", 4096, 12288))
PHI_QMM_ROWS = (1, 512)


# the 8B's projections apart (an Engine with a LoRA adapter keeps them
# unfused): Q4_K q, k, gate (up is gate's shape), Q6_K v (the Q4_K_M
# recipe's attn_v in half the layers); wo is q's shape, down row 1's
UNFUSED_QMM_SHAPES = (("Q4_K", "q", 4096, 4096), ("Q4_K", "k", 4096, 1024),
                      ("Q4_K", "gate", 4096, 14336), ("Q6_K", "v", 4096, 1024))
UNFUSED_QMM_ROWS = (1, 8)  # a decode step and the single-stream verify bucket


def phase_unfused_kernels(dev, results: dict, unfused: dict):
    """qmm at the 8B's unfused projection shapes (UNFUSED_QMM_SHAPES), M
    in UNFUSED_QMM_ROWS (`qmm_at_shapes`): the linears a LoRA engine's
    decode and verify forwards launch in place of the fused q|k|v and
    gate|up."""
    import torch

    qmm_at_shapes("unfused", dev, torch.Generator(dev).manual_seed(19), UNFUSED_QMM_SHAPES,
                  UNFUSED_QMM_ROWS, results, unfused)


# Gemma-3-4B's 2-D linears at Q4_K_M (n_embd 2560, 8 heads on 4 of 256,
# n_ff 10240): q|k|v fused where attn_v is Q4_K, apart (Q4_K q, k; Q6_K v)
# on the recipe's use_more_bits layers (17 of 34); wo; the fused gate|up;
# the down projections at Q6_K (use_more_bits layers) and Q4_K (the tied
# head is a plain product)
GEMMA_QMM_SHAPES = (("Q4_K", "gemma-3-4b q|k|v", 2560, 4096),
                    ("Q4_K", "gemma-3-4b q", 2560, 2048),
                    ("Q4_K", "gemma-3-4b k", 2560, 1024),
                    ("Q6_K", "gemma-3-4b v", 2560, 1024),
                    ("Q4_K", "gemma-3-4b wo", 2048, 2560),
                    ("Q4_K", "gemma-3-4b gate|up", 2560, 20480),
                    ("Q6_K", "gemma-3-4b down", 10240, 2560),
                    ("Q4_K", "gemma-3-4b down", 10240, 2560))
GEMMA_QMM_ROWS = (1, GEMMA_VERIFY_ROWS)  # a decode step and the ring's verify forward


def phase_gemma_kernels(dev, results: dict, gemma: dict):
    """qmm at Gemma-3-4B's linear shapes (GEMMA_QMM_SHAPES), M in
    GEMMA_QMM_ROWS (`qmm_at_shapes`): the linears of its decode step and
    of its ring speculation's verify forward."""
    import torch

    qmm_at_shapes("gemma", dev, torch.Generator(dev).manual_seed(23), GEMMA_QMM_SHAPES,
                  GEMMA_QMM_ROWS, results, gemma)


def phase_phi_kernels(dev, results: dict, phi: dict):
    """The kernels at the Phi and Qwen (v1) shapes: qmm at PHI_QMM_SHAPES,
    M in PHI_QMM_ROWS (`qmm_at_shapes`), then flash at head dims 96 and 80
    (`phase_flash_narrow`); rows go to `results` and, the qmm ones, to
    `phi` by kernel."""
    import torch

    qmm_at_shapes("phi", dev, torch.Generator(dev).manual_seed(17), PHI_QMM_SHAPES,
                  PHI_QMM_ROWS, results, phi)
    phase_flash_narrow(dev, results)


def phase_flash_narrow(dev, results: dict):
    """Flash at head dims 96 and 80, each KV format: the decode regime at T =
    1 (B = 2, kv 38 / 3001; B = 1, kv 20) and the prefill regime at T = 512
    (offsets 0 / 2500), S = 4096, 32 heads on 8; then the Phi shapes, 32
    heads on 32 at B = 1: decode at R = T = 1, 9 and 16 (Phi-3 under its
    window of 2047 at offset 3000 of S = 4096; Phi-2 at offset 1500 of S =
    2048), and at D = 96 Phi-3's prefill of a 2560-token prompt under the
    window (offset 0: its later blocks start at k_begin > 0). Each against
    its plain version and the plain version of its own order, timed beside
    its bound and SDPA on the cache's dtype; rows go to `results` under
    flash_<fmt>_d<D>."""
    import torch

    gen = torch.Generator(dev).manual_seed(13)
    gqa = dict(H=32, Hkv=8, S=4096)
    for d in NARROW_DIMS:
        phi = PHI_HEADS[d]
        off = PHI_DECODE_OFFSET[d]
        for fmt in FLASH_FORMATS:
            key = f"flash_{fmt}_d{d}"
            bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
            cases = [(f"{fmt} T=1 B=2 S=4096 D={d}", dict(T=1, B=2, offsets=(37, 3000), **gqa)),
                     (f"{fmt} T=1 B=1 kv=20 S=4096 D={d}", dict(T=1, B=1, offsets=(19,), **gqa)),
                     (f"{fmt} T=512 B=2 S=4096 D={d}",
                      dict(T=512, B=2, offsets=(0, 2500), **gqa))]
            cases += [(f"{fmt} phi R={r} offset={off} S={phi['S']} D={d}",
                       dict(T=r, B=1, offsets=(off,), **phi)) for r in PHI_DECODE_ROWS]
            if d == 96:
                cases.append((f"{fmt} phi3 T={PHI3_PROMPT} window=2047 S=4096 D=96",
                              dict(T=PHI3_PROMPT, B=1, offsets=(0,), **phi)))
            for label, kw in cases:
                row = _flash_case(dev, gen, fmt=fmt, D=d, timed=True, **kw)
                row["case"] = label
                expect(row["finite"], f"flash {label} finite")
                expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                       f"flash {label} NMSE {row['nmse']:.3e}, against the plain version of "
                       f"its own order {row['nmse_own_order']:.3e} <= {bound}")
                results.setdefault(key, []).append(row)
                log(f"[flash narrow] {label} ({row['regime']}): nmse {row['nmse']:.2e} max|d| "
                    f"{row['max_abs_err']:.3g} (own order {row['nmse_own_order']:.2e}) kernel "
                    f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain "
                    f"{row['plain_ms']:.3f} ms sdpa {row['library_ms']:.4f} ms")
    torch.cuda.empty_cache()


# the batched shapes of continuous batching (the server phase's paths)
BATCH_OFFSETS = (-1, 19, -1, 3000, 63, -1, 3999, 500)  # per slot; −1 idle
SLOT_COUNTS = (4, 8)
# a joint prefill round of SERVE_SLOTS slots: two fed (one at the start of
# its prompt, one deep in it), two idle; its buckets' smallest and largest
ROUND_OFFSETS = (-1, 0, 2500, -1)
ROUND_TOKENS = (8, 512)
ROUND_ROWS = 4 * 512  # qmm_tc's and qmm_stack's rows in such a round of full chunks


def _held_row(tag: str, key: str, label: str, kernel, plain, library, n_bytes: float,
              flops: float, iters: int) -> dict:
    """One kernel call against its plain version (NMSE within the bound,
    finite), timed with its plain version and library call beside its
    bound."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = nmse(got.float(), ref.float())
    mae = float((got.float() - ref.float()).abs().max())
    expect(bool(torch.isfinite(got.float()).all()), f"{key} {label} finite")
    expect(err <= QMM_NMSE_BOUND, f"{key} {label} NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
    bms, by = bound_ms(n_bytes, flops)
    row = dict(case=label, nmse=err, max_abs_err=mae, ms=time_ms(kernel, iters),
               plain_ms=time_ms(plain, 1, 1, graph=False), bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, iters))
    log(f"[{tag}] {key} {label}: nmse {err:.2e} max|d| {mae:.3g} kernel {row['ms']:.4f} ms "
        f"bound {bms:.4f} ms ({by}) plain {row['plain_ms']:.3f} ms library "
        f"{row['library_ms']:.4f} ms")
    return row


def phase_batched_kernels(dev, results: dict, batched: dict):
    """The kernels at the shapes continuous batching gives them, each
    against its plain version: flash's decode regime at B = 4 and 8 slots
    with offsets BATCH_OFFSETS (idle slots at −1: their rows exactly 0;
    kv lengths 20 to 4000 of S = 4096), and its prefill regime at the
    joint round's B = SERVE_SLOTS with offsets ROUND_OFFSETS and T = 8 and
    512 (the smallest bucket and the prefill chunk; idle slots' first rows
    exactly 0), bf16 and q8 caches, the 8B's heads; qmm at M = 4 and 8 (the
    batched decode step) and qmm_tc at M = SERVE_SLOTS × 512 (a joint
    round of full chunks) for the 8B's Q4_K gate_up and Q6_K down;
    qmm_stack at the same rows over Mixtral's 8 experts (Q4_K gate on the
    shared x, Q6_K down on each expert's own x, as ops/moe.py feeds them);
    qmm_gather at 8 and 16 routed slots (4 and 8 slots' top-2) of Mixtral's
    Q4_K gate experts. Rows go to `results` (the kernels line's errors) and
    to `batched` by kernel."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(5)
    for fmt, key in zip(("bf16", "q8"), ("flash_bf16", "flash_q8")):
        bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
        cases = [(1, BATCH_OFFSETS[:B]) for B in SLOT_COUNTS]
        cases += [(T, ROUND_OFFSETS) for T in ROUND_TOKENS]
        for T, offsets in cases:
            B = len(offsets)
            row = _flash_case(dev, gen, fmt=fmt, B=B, T=T, H=32, Hkv=8, D=128, S=4096,
                              offsets=offsets, timed=True)
            row["case"] = (f"{fmt} T={T} B={B} slots {list(offsets)} S=4096"
                           + (" (joint round)" if T > 1 else ""))
            expect(row["finite"] and row["idle_zero"], f"flash {row['case']}: finite, idle rows 0")
            expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                   f"flash {row['case']} NMSE {row['nmse']:.3e}, own order "
                   f"{row['nmse_own_order']:.3e} <= {bound}")
            results[key].append(row)
            batched.setdefault(key, []).append(row)
            log(f"[batched] {key} {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} (own "
                f"order {row['nmse_own_order']:.2e}), idle rows 0, kernel {row['ms']:.4f} ms bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain {row['plain_ms']:.3f} ms "
                f"sdpa {row['library_ms']:.4f} ms")
    for fmt, name, K, N in (("Q4_K", "gate_up", 4096, 28672), ("Q6_K", "down", 14336, 4096)):
        gtype, key = GGMLType[fmt], QMM_KEYS[fmt]
        planes = _random_planes(gtype, N, K, gen, dev)
        plane_b = sum(t.numel() * t.element_size() for t in planes.values())
        w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
        for M in SLOT_COUNTS + (ROUND_ROWS,):
            tc = M >= qmm.TC_MIN_M
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            row = _held_row("batched", "qmm_tc" if tc else key, f"{fmt} {name} M={M}",
                            lambda x=x: qmm.qmm(x, planes, gtype, N, K),
                            lambda x=x: qmm.qmm_reference(x, planes, gtype, N, K),
                            lambda x=x: torch.matmul(x, w_lib),
                            M * K * 2 + plane_b + M * N * 2, 2.0 * M * K * N, 5 if tc else 20)
            results["qmm_tc" if tc else key].append(row)
            batched.setdefault("qmm_tc" if tc else key, []).append(row)
        del planes, w_lib, x
    M = ROUND_ROWS
    for fmt, (name, K, N), shared in (("Q4_K", EXPERT_SHAPES[0], True),
                                      ("Q6_K", EXPERT_SHAPES[1], False)):
        gtype = GGMLType[fmt]
        planes = _random_stack(gtype, N, K, gen, dev)
        expert_b = sum(t.numel() * t.element_size() for t in planes.values()) / N_EXPERT
        w_lib = torch.stack([qmatmul.dequant_planes({k: v[e] for k, v in planes.items()},
                                                    gtype, N, K, dtype=torch.bfloat16)
                             for e in range(N_EXPERT)])
        x = torch.randn(*((M, K) if shared else (N_EXPERT, M, K)), generator=gen,
                        device=dev).to(torch.bfloat16)
        row = _held_row("batched", "qmm_stack", f"{fmt} {name} M={M} (joint round) "
                        f"{'shared' if shared else 'batched'}",
                        lambda: qmm.qmm_stack(x, planes, gtype, N, K),
                        lambda: qmm.qmm_stack_reference(x, planes, gtype, N, K),
                        lambda: torch.matmul(x, w_lib),
                        x.numel() * 2 + N_EXPERT * expert_b + N_EXPERT * M * N * 2,
                        2.0 * N_EXPERT * M * K * N, 3)
        results["qmm_stack"].append(row)
        batched.setdefault("qmm_stack", []).append(row)
        del planes, w_lib, x
        torch.cuda.empty_cache()
    name, K, N = EXPERT_SHAPES[0]
    gtype = GGMLType.Q4_K
    planes = _random_stack(gtype, N, K, gen, dev)
    expert_b = sum(t.numel() * t.element_size() for t in planes.values()) / N_EXPERT
    w_lib = torch.stack([qmatmul.dequant_planes({k: v[e] for k, v in planes.items()},
                                                gtype, N, K, dtype=torch.bfloat16)
                         for e in range(N_EXPERT)])
    for slots in SLOT_COUNTS:
        T = 2 * slots  # each slot's token routed to its top-2
        x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
        ids = torch.stack([torch.randperm(N_EXPERT, generator=gen, device=dev)[:2]
                           for _ in range(slots)]).reshape(T).int()
        n_unique = int(torch.unique(ids).numel())
        row = _held_row("batched", "qmm_gather", f"Q4_K {name} T={T} ({slots} slots × top-2)",
                        lambda x=x, ids=ids: qmm.qmm_gather(x, ids, planes, gtype, N, K),
                        lambda x=x, ids=ids: qmm.qmm_gather_reference(x, ids, planes, gtype, N, K),
                        lambda x=x, ids=ids: torch.bmm(x[:, None, :], w_lib[ids.long()])[:, 0],
                        x.numel() * 2 + T * 4 + n_unique * expert_b + T * N * 2,
                        2.0 * T * K * N, 20)
        results["qmm_gather"].append(row)
        batched.setdefault("qmm_gather", []).append(row)
    del planes, w_lib
    torch.cuda.empty_cache()


def reset_launches():
    from tpullm_torch.runtime.graph import launch_counts

    for d in launch_counts():
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    """Launches per kernel entry of KERNELS (qmm_<format>: the CUDA-core
    regime; qmm_tc: the tensor-core regime, every format), the grouped,
    tensor-core and expert kernels' by format ("qmm_stack.MXFP4", ...), the
    flash launches of the decode regime ("flash_bf16.decode"), and the calls
    of the two counted routes."""
    from tpullm_torch.ops.kernels import flash, qmm

    got = {key: qmm.LAUNCHES[fmt] for fmt, key in QMM_KEYS.items()}
    got.update({"qmm_tc": sum(qmm.TC_LAUNCHES.values()),
                "qmm_grouped": sum(qmm.GROUPED_LAUNCHES.values()),
                "qmm_stack": sum(qmm.STACK_LAUNCHES.values()),
                "qmm_gather": sum(qmm.GATHER_LAUNCHES.values()),
                **{f"flash_{fmt}": flash.launch_total(fmt) for fmt in FLASH_FORMATS},
                **{f"flash_{fmt}.decode": flash.launch_total(fmt, "decode")
                   for fmt in FLASH_FORMATS},
                "dequant_routes": sum(qmm.DEQUANT_ROUTES.values()),
                "attn_dense_routes": sum(flash.ATTN_DENSE_ROUTES.values()),
                "attn_ring_routes": sum(flash.ATTN_RING_ROUTES.values()),
                **{f"flash_{k}": n for k, n in flash.LAUNCHES.items()}})
    for kind, counts in (("qmm_tc", qmm.TC_LAUNCHES), ("qmm_grouped", qmm.GROUPED_LAUNCHES),
                         ("qmm_stack", qmm.STACK_LAUNCHES), ("qmm_gather", qmm.GATHER_LAUNCHES)):
        got.update({f"{kind}.{fmt}": n for fmt, n in counts.items() if n})
    return got


def per_forward_launches(params) -> dict:
    """Kernel launches one forward makes: 2-D qmm in the layers (each
    quantized linear, fused or not, under a LoRA adapter or not) and for the
    head (on the last row only), expert kernels (each expert stack: in the
    gather regime qmm_gather, else qmm_stack) and flash (one per layer)."""
    from tpullm_torch.models.lora import LoraLinear
    from tpullm_torch.models.weights import FusedLinear, QuantExpertStack, QuantLinear

    def is_quant(m):
        return isinstance(m.base if isinstance(m, (FusedLinear, LoraLinear)) else m, QuantLinear)

    head = int(is_quant(params["output"])) if params["output"] is not None else 0
    layers = experts = 0
    for layer in params["layers"]:
        layers += sum(is_quant(m) for m in layer.values()
                      if isinstance(m, (QuantLinear, FusedLinear, LoraLinear)))
        experts += sum(isinstance(m, QuantExpertStack) for m in layer.values())
    return {"qmm": layers + head, "qmm_layers": layers, "head": head, "experts": experts,
            "flash": len(params["layers"])}


def flash_decode_forwards(hp, rows: list[int]) -> int:
    """The forwards among `rows` whose attention takes flash's decode regime."""
    from tpullm_torch.ops.kernels import flash

    return sum(flash.regime(r, hp.n_head, hp.n_head_kv) == "decode" for r in rows)


def bucket_rows(n_tokens: int) -> int:
    """The rows a forward over n_tokens runs (batch 1): its prefill bucket,
    1 at decode."""
    from tpullm_torch.runtime.engine import PREFILL_BUCKETS

    return next(b for b in PREFILL_BUCKETS if n_tokens <= b)


def check_launches(label: str, got: dict, per: dict, rows: list[int], kv: str,
                   decode_fw: int):
    """Launch counts of a run against per-forward counts and the rows of
    each forward (its bucket; 1 at decode): the 2-D qmm of the layers on
    the tensor cores from TC_MIN_M rows and on CUDA cores below, the head on
    CUDA cores (one row), unless the run sent them to qmm_grouped; the
    expert stacks through qmm_stack above the gather threshold and
    qmm_gather at or below it; no call through either counted route."""
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import qmm

    n = len(rows)
    tc_fw = sum(r >= qmm.TC_MIN_M for r in rows)
    stack_fw = sum(r > moe._GATHER_MAX_TOKENS for r in rows)
    cc_got = sum(got[k] for k in QMM_KEYS.values())
    fkey = "flash_q8" if kv == "q8_0" else f"flash_{kv}"
    log(f"[{label}] launches {got} over {n} forwards ({tc_fw} of ≥ {qmm.TC_MIN_M} rows, "
        f"{stack_fw} of > {moe._GATHER_MAX_TOKENS}); per forward {per}")
    expect(cc_got + got["qmm_tc"] + got["qmm_grouped"] == per["qmm"] * n,
           f"{label}: qmm launches {cc_got} + {got['qmm_tc']} + {got['qmm_grouped']} = "
           f"{per['qmm']} × {n}")
    if got["qmm_grouped"] == 0:
        expect(got["qmm_tc"] == per["qmm_layers"] * tc_fw,
               f"{label}: tensor-core qmm launches {got['qmm_tc']} = {per['qmm_layers']} × "
               f"{tc_fw} forwards of ≥ {qmm.TC_MIN_M} rows")
        expect(cc_got == per["qmm_layers"] * (n - tc_fw) + per["head"] * n,
               f"{label}: CUDA-core qmm launches {cc_got} = {per['qmm_layers']} × "
               f"{n - tc_fw} forwards of < {qmm.TC_MIN_M} rows + {per['head']} heads × {n} "
               "(none at ≥ 16 rows)")
    expect(got[fkey] == per["flash"] * n, f"{label}: {fkey} launches = {per['flash']} × {n}")
    expect(got[fkey + ".decode"] == per["flash"] * decode_fw,
           f"{label}: {fkey} decode-regime launches {got[fkey + '.decode']} = {per['flash']} × "
           f"{decode_fw} forwards (the rest prefill-regime)")
    expect(got["qmm_gather"] == per["experts"] * (n - stack_fw),
           f"{label}: qmm_gather launches {got['qmm_gather']} = {per['experts']} × "
           f"{n - stack_fw} gather-regime forwards")
    expect(got["qmm_stack"] == per["experts"] * stack_fw,
           f"{label}: qmm_stack launches {got['qmm_stack']} = {per['experts']} × "
           f"{stack_fw} stack-regime forwards")
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
           f"{label}: no call through the dequantize or dense-attention routes")


def phase_tiny(dev, tmp: Path):
    """The tiny dense model at every dense preset and the tiny MoE at
    Q4_K_M, MXFP4_MOE and IQ2_XXS on the card against the same models on the
    CPU: logits NMSE ≤ 1e-3, greedy ids equal."""
    import torch

    from tpullm_torch.models.synth import PRESETS

    fox = "the quick brown fox jumps over the lazy dog"
    # 52 tokens: the all-experts regime at prefill, the gather regime at decode
    dog = "the lazy dog jumps over the quick brown fox hello world"
    runs = [("tiny", "Q4_K_M", torch.bfloat16, fox), ("tiny", "Q4_K_M", "q8_0", fox),
            ("tiny-moe", "Q4_K_M", torch.bfloat16, dog),
            ("tiny-moe", "Q4_K_M", torch.bfloat16, "hello world"),  # a gather-regime prefill
            *[("tiny", ftype, torch.bfloat16, fox) for ftype in PRESETS
              if ftype not in ("Q4_K_M", "MXFP4_MOE")],
            ("tiny", "Q2_K", "q8_0", fox), ("tiny-moe", "MXFP4_MOE", torch.bfloat16, dog),
            ("tiny-moe", "IQ2_XXS", torch.bfloat16, dog)]
    for shape, ftype, kv, prompt in runs:
        gpu, cpu = tiny_card_vs_cpu("tiny", tmp, shape, ftype, kv, prompt)
        if (shape, ftype, kv) == ("tiny", "Q4_K_M", torch.bfloat16):
            grammar_run(gpu, cpu)


def tiny_card_vs_cpu(tag: str, tmp: Path, shape: str, ftype: str, kv, prompt: str):
    """The synthetic `shape` at `ftype` served on the card and on the CPU
    from one file: the prompt's logits and five decode steps' within NMSE
    1e-3, 16 greedy ids of the decode graph equal; returns both Engines."""
    import torch

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.runtime.engine import Engine

    path = make_synthetic_llama_gguf(tmp / f"{shape}-{ftype}.gguf", shape=shape, seed=0,
                                     ftype=ftype)
    gpu = Engine(path, max_seq=256, kv_dtype=kv)
    cpu = Engine(path, device="cpu", max_seq=256, kv_dtype=kv)
    ids = gpu.tokenizer.tokenize(prompt)
    errs = [nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (300, 17, 42, 260, 5):
        errs.append(nmse(torch.from_numpy(gpu.decode_step(tok)),
                         torch.from_numpy(cpu.decode_step(tok))))
    gpu.reset()
    cpu.reset()
    a = gpu.generate_tokens_device(ids, 16)
    b = cpu.generate_tokens_device(ids, 16)
    kv_name = "bf16" if kv is torch.bfloat16 else kv
    what = f"{shape} {ftype} kv={kv_name}"
    log(f"[{tag}] {what} {len(ids)}-token prompt: logits NMSE card vs cpu "
        f"max {max(errs):.2e}; greedy {'equal' if a == b else 'DIFFERENT'}")
    expect(max(errs) <= 1e-3, f"{what} logits NMSE {max(errs):.3e} <= 1e-3")
    expect(a == b, f"{what} greedy ids card {a} vs cpu {b}")
    return gpu, cpu


# words of lower-case letters, each after a space
GRAMMAR_WORDS = r'root ::= (" " [a-z]+)+'


def grammar_run(gpu, cpu):
    """generate_tokens through a GBNF grammar (GRAMMAR_WORDS) and a greedy
    Sampler with repetition penalties, on the card and on the CPU: the same
    ids, every one allowed by the grammar."""
    from tpullm_torch.grammar import GrammarConstraint
    from tpullm_torch.runtime.sampling import Sampler, SamplerParams

    def sampler(eng):
        c = GrammarConstraint.from_tokenizer(GRAMMAR_WORDS, eng.tokenizer)
        return Sampler(SamplerParams(temp=0.0, penalty_repeat=1.5, penalty_last_n=-1,
                                     penalty_freq=0.2, seed=42),
                       constraint_fn=c, constraint_accept=c.accept)

    ids = gpu.tokenizer.tokenize("hello world")
    outs = []
    for eng in (gpu, cpu):
        eng.reset()
        outs.append(list(eng.generate_tokens(ids, 24, sampler(eng))))
    text = gpu.tokenizer.detokenize(outs[0])
    log(f"[tiny] generate_tokens with the grammar {GRAMMAR_WORDS!r} and a penalised sampler: "
        f"card {outs[0]} {'equal to' if outs[0] == outs[1] else 'NOT'} the CPU's; text {text!r}")
    expect(outs[0] == outs[1], f"grammar run: card ids {outs[0]} vs cpu {outs[1]}")
    expect(len(outs[0]) > 0 and all(w.isalpha() and w.islower() for w in text.split()),
           f"grammar run: {text!r} is lower-case words")


PROFILE_MARGIN_S = 0.005  # host time between the recorded window's edges and fn's launches


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activity) after one warm-up
    step of the profiler, in which it traces one small launch, with
    PROFILE_MARGIN_S of host time before fn's first launch and after its
    last kernel ends: kernels near the start of a trace went missing (the
    first qmm launches of a 512-token prefill were absent from it). Returns
    (fn's result, the profile of fn alone; `device_events` reads it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    return out, prof


def device_events(prof):
    """(key, device µs, count) of each device-side event of a profile (a
    kernel, a copy or a fill, by name), each counted once. Left out: the
    host-side events (an operator's self device time is that of the kernels
    it launched, which the profile also lists under their own names:
    counting both would count every aten operator's kernels twice), and the
    profiler's step ranges, which it also draws on the device's timeline as
    annotations spanning the step's kernels."""
    from torch.autograd import DeviceType

    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if (us > 0.0 and e.device_type != DeviceType.CPU
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("ProfilerStep")):
            yield e.key, us, e.count


def _family(key: str) -> str:
    return next((k for k in ("qmm_stack", "qmm_gather", "qmm") if k in key),
                "flash" if "flash_" in key else "other")


def run_steps(runner, n: int, eager: bool = False) -> list[int]:
    """`n` decode steps of `runner` from its buffers' state, ids read back
    once: runner.run (graph replays on the card), or with `eager` the
    runner's step called n times on the current stream, no graph (the
    eager yardstick the graph is timed against)."""
    if not eager:
        return runner.run(n)
    runner.step_index.zero_()
    for _ in range(n):
        runner.step()
    return runner.ids[:n].tolist()


def _start(eng, runner, prompt) -> None:
    """A fresh prefill of `prompt`; its greedy id loaded into `runner`."""
    import torch

    eng.reset()
    with torch.inference_mode():
        runner.start(torch.tensor(int(np.argmax(eng.prefill(prompt))), device=eng.device),
                     eng.n_past)
    torch.cuda.synchronize()


def profile_decode(eng, runner, ids, steps: int, eager: bool = False, n_top: int = 8) -> dict:
    """Device time a decode step by kernel family over `steps` decode steps
    of `runner` (one run) after a prefill of `ids`: replays of its CUDA
    graph, the main path, or with `eager` the same steps without a graph;
    from torch.profiler (`profiled`). Beside it the launches of each of the
    port's reduction kernels (REDUCTION_KERNELS) among them: 0, as every
    kernel a decode runs sums its K split in its own launch; and the
    CUDA-event span of the steps on the card; the `n_top` kernels by device
    time."""
    import torch

    _start(eng, runner, ids)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def steps_run():
        start.record()
        with torch.inference_mode():
            run_steps(runner, steps, eager)
        end.record()

    _, prof = profiled(steps_run)
    fam = {"qmm": 0.0, "qmm_stack": 0.0, "qmm_gather": 0.0, "flash": 0.0, "other": 0.0}
    top, reduce_launches = [], dict.fromkeys(REDUCTION_KERNELS, 0)
    for key, us, n in device_events(prof):
        fam[_family(key)] += us
        top.append((us, key, n))
        for name in REDUCTION_KERNELS:  # no name is part of another
            if name in key:
                reduce_launches[name] += n
    top.sort(reverse=True)
    return {"steps": steps, "graph": not eager, "reduce_launches": reduce_launches,
            "device_ms_per_token": {k: v / 1e3 / steps for k, v in fam.items()},
            "event_span_ms_per_token": start.elapsed_time(end) / steps,
            "top": [(name[:60], round(us / 1e3 / steps, 4), n) for us, name, n in top[:n_top]]}


def profile_prefill(eng, ids) -> dict:
    """Device time of one prefill of `ids` by kernel family, from
    torch.profiler (`profiled`), beside its wall time (prompt in, logits on
    the host), the launches of each of the port's kernels by name in the
    trace, and the launches the wrappers counted (`read_launches`' keys
    that moved)."""
    import re

    import torch

    eng.reset()
    torch.cuda.synchronize()
    before = read_launches()

    def prefill():
        t0 = time.perf_counter()
        eng.prefill(ids)
        return time.perf_counter() - t0

    wall, prof = profiled(prefill)
    counted = {k: v - before.get(k, 0) for k, v in read_launches().items()
               if v != before.get(k, 0)}
    fam = {"qmm_tc": 0.0, "qmm_grouped": 0.0, "qmm_stack": 0.0, "qmm": 0.0, "flash": 0.0,
           "other": 0.0}
    launches: dict = {}
    for key, us, n in device_events(prof):
        kind = next((k for k in ("qmm_tc", "qmm_grouped", "qmm_stack", "qmm") if k in key),
                    "flash" if "flash_" in key else "other")
        fam[kind] += us
        m = re.search(r"\b((?:qmm|flash)_\w*kernel)\b", key)
        if m:
            launches[m.group(1)] = launches.get(m.group(1), 0) + n
    busy = sum(fam.values()) / 1e3
    expect(busy <= wall * 1e3, f"profile_prefill: {busy:.3f} ms of device time within the "
           f"prefill's {wall * 1e3:.3f} ms wall (one stream: no event counted twice)")
    return {"device_ms": {k: v / 1e3 for k, v in fam.items()}, "wall_ms": wall * 1e3,
            "launches": launches, "counted": counted}


def plane_bytes(params, n_expert_used: int) -> tuple[float, float]:
    """(bytes of every plane resident on the card, plane bytes one decode
    token streams: every 2-D linear and the head, and n_expert_used
    experts of each stack)."""
    import torch

    from tpullm_torch.models.weights import QuantExpertStack

    def nbytes(m):
        return sum(b.numel() * b.element_size() for b in m.buffers())

    resident = per_token = 0.0
    for m in [params["output"], *[v for layer in params["layers"] for v in layer.values()]]:
        if not isinstance(m, torch.nn.Module):
            continue
        resident += nbytes(m)
        per_token += (nbytes(m) / m.n_expert * n_expert_used
                      if isinstance(m, QuantExpertStack) else nbytes(m))
    return resident, per_token


def serve(label: str, path, kv, launches: dict, lens: tuple | None = None,
          short: int | None = None, n_gen: int = 64, prefill_len: int | None = None,
          graph: bool = False, engine=None, repeat: bool = True) -> dict:
    """Serves the GGUF at `path` through Engine: one warm-up generation,
    then three prompts and the second again (not with `repeat` False),
    `n_gen` greedy tokens each
    (the decode chunk as CUDA-graph replays); a profiled chunk of replays;
    launch counts against the expected count per
    forward of each MoE regime. The prompts are "hello world", its words
    six times and 512 word tokens (10, 307 and 512 tokens), or, with
    `lens`, BOS and word tokens to those lengths. With `short`, one prompt
    of that many word tokens and 16 greedy tokens (16 decode steps) instead
    (a model cut to a few layers: its TTFT says little); with `prefill_len`
    as well, a profiled prefill of that many word tokens. With `graph`,
    the graph phase (`graph_decode`) on the same engine. With `engine` (an
    Engine already loaded from `path`), that engine on a new cache of `kv`
    (its load and load peak are the caller's)."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    n_gen = 16 if short else n_gen
    chunk = 16 if short else 32
    kv_name = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}.get(kv, "q8_0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # just before the main path
    if engine is None:
        eng = Engine(path, max_seq=4096, kv_dtype=kv)
        load_peak = torch.cuda.max_memory_allocated() / 2**30
    else:
        eng = engine
        eng.new_cache(kv_dtype=kv)
        load_peak = None  # the caller's
    resident, per_token = plane_bytes(eng.params, max(eng.hp.n_expert_used, 1))
    log(f"[{label}] kv={kv_name}: {eng.hp.n_layer} layers loaded in {eng.perf.t_load_s:.1f}s "
        + (f"(peak memory {load_peak:.2f} GiB); " if load_peak is not None else "(before); ")
        + f"planes resident {resident / 2**30:.2f} GiB; one decode token streams "
        f"{per_token / 1e9:.3f} GB of planes, a bound of "
        f"{per_token / PEAK_BYTES * 1e3:.3f} ms per token")
    tok = eng.tokenizer
    words = "the quick brown fox jumps over the lazy dog hello world".split()
    space = "Ġ" if tok.vocab.model == "gpt2" else "▁"  # a word's leading space in the vocab

    def word_ids(n: int) -> list[int]:
        return [tok.vocab.special.bos] + [tok.vocab.token_to_id[space + words[i % len(words)]]
                                          for i in range(n - 1)]

    if short:
        prompts = [word_ids(short)]
    elif lens is None:
        prompts = [tok.tokenize("hello world"), tok.tokenize(" ".join(words * 6)), word_ids(512)]
    else:
        prompts = [word_ids(n) for n in lens]
    expect(short or len(prompts[2]) == 512, "the long prompt has 512 tokens")
    rows: list[int] = []  # the rows of each forward: its prefill bucket, 1 at decode

    def count(n_prompt: int, n_decode: int):
        rows.append(bucket_rows(n_prompt))
        rows.extend([1] * n_decode)

    # one short generation first, at the prompts' chunk: lazy set-up
    # (allocator, first launches, the decode graph's capture) is paid once
    # per process, not per request
    n_decode = eng.perf.n_decode  # a passed engine's earlier steps aside
    eng.generate_tokens_device(prompts[0], 8, temp=0.0, stop_on_eog=False, chunk=chunk)
    count(len(prompts[0]), eng.perf.n_decode - n_decode)
    per_prompt = []
    for i, ids in enumerate(prompts if short or not repeat else prompts + [prompts[1]]):
        eng.reset()
        p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
        out = eng.generate_tokens_device(ids, n_gen, temp=0.0, stop_on_eog=False, chunk=chunk)
        ttft = eng.perf.t_prefill_s - p0[0]
        dec_s, dec_n = eng.perf.t_decode_s - p0[1], eng.perf.n_decode - p0[2]
        count(len(ids), dec_n)
        expect(len(out) == n_gen, f"prompt {i}: {len(out)} tokens generated")
        expect(all(0 <= t < eng.hp.n_vocab for t in out), "token ids in range")
        per_prompt.append(dict(n_prompt=len(ids), ttft_s=ttft, decode_tok_s=dec_n / dec_s,
                               out=out))
        log(f"[{label}] kv={kv_name} prompt {i} ({len(ids)} tok, bucket {bucket_rows(len(ids))}): "
            f"TTFT {ttft * 1e3:.1f} ms ({len(ids) / ttft:.1f} tok/s prefill), decode "
            f"{dec_n / dec_s:.2f} tok/s over {dec_n} steps, first ids {out[:6]}, text "
            f"{tok.detokenize(out[:12])!r}")
    if not short and repeat:
        expect(per_prompt[3]["out"] == per_prompt[1]["out"], "greedy output is deterministic")
    prof = profile_decode(eng, eng.decode_runner(SamplingParams(), chunk), prompts[0], chunk)
    count(len(prompts[0]), prof["steps"])
    expect(sum(prof["reduce_launches"].values()) == 0,
           f"{label}: no reduction kernel in the decode profile ({prof['reduce_launches']})")
    busy = sum(prof["device_ms_per_token"].values())
    wall = 1e3 / float(np.median([p["decode_tok_s"] for p in per_prompt]))
    log(f"[{label}] kv={kv_name} profile of {chunk} decode steps as graph replays: device ms "
        "per decode token "
        f"{ {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} } = "
        f"{busy:.3f} ms busy of {wall:.3f} ms per token unprofiled (median rate) "
        f"(idle share {1 - busy / wall:.3f}); reduction launches {prof['reduce_launches']}; "
        f"top {prof['top']}"
        if busy > 0 else f"[{label}] kv={kv_name} profile: no device time recorded "
        "(device busy share not measured)")
    graph_run = graph_decode(label, kv_name, eng, word_ids, count, prof) if graph else None
    prefill_prof = None
    if not short or prefill_len:
        long_ids = word_ids(prefill_len) if short else prompts[2]
        prefill_prof = profile_prefill(eng, long_ids)
        count(len(long_ids), 0)
        busy_p = sum(prefill_prof["device_ms"].values())
        log(f"[{label}] kv={kv_name} profile: one {len(long_ids)}-token prefill, device ms "
            f"{ {k: round(v, 3) for k, v in prefill_prof['device_ms'].items()} } = "
            f"{busy_p:.3f} ms busy of {prefill_prof['wall_ms']:.3f} ms wall (profiled) "
            f"(idle share {1 - busy_p / prefill_prof['wall_ms']:.3f}); launches "
            f"{prefill_prof['launches']}")
    eng.reset()
    logits = eng.prefill(prompts[0])
    count(len(prompts[0]), 0)
    expect(logits.shape == (eng.hp.n_vocab,) and bool(np.isfinite(logits).all()),
           "final logits finite, [n_vocab]")
    torch.cuda.synchronize()
    got = read_launches()  # just after the main path
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{label}] kv={kv_name}: load {eng.perf.t_load_s:.1f}s, peak memory {peak:.2f} GiB")
    per = per_forward_launches(eng.params)
    check_launches(f"{label} kv={kv_name}", got, per, rows, kv_name,
                   flash_decode_forwards(eng.hp, rows))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    run = dict(model=label, kv=kv_name, n_layer=eng.hp.n_layer, load_s=eng.perf.t_load_s,
               load_peak_gib=load_peak, peak_gib=peak, resident_gib=resident / 2**30,
               decode_plane_gb=per_token / 1e9,
               decode_bound_ms=per_token / PEAK_BYTES * 1e3,
               ttft_ms=[p["ttft_s"] * 1e3 for p in per_prompt],
               n_prompt=[p["n_prompt"] for p in per_prompt],
               decode_tok_s=[p["decode_tok_s"] for p in per_prompt],
               launches=got, per_forward=per, forwards=len(rows),
               prefill_forwards={r: rows.count(r) for r in sorted(set(rows)) if r > 1},
               device_ms_per_token=prof["device_ms_per_token"],
               decode_reduce_launches=prof["reduce_launches"],
               idle_share=(1 - busy / wall) if busy > 0 else None, prefill_profile=prefill_prof,
               graph=graph_run)
    if not short:
        run["pp512_tok_s"] = 512 / per_prompt[2]["ttft_s"]
    del eng
    gc.collect()  # an engine and its graph runners refer to each other
    torch.cuda.empty_cache()
    return run


GRAPH_CHUNK = 32  # decode steps a chunk (the Engine's default)
GRAPH_TAIL = 6  # steps after the second chunk in the ids check
EAGER_PROFILE_STEPS = 8  # eager steps profiled as the yardstick's busy time


def time_runs(eng, runner, prompt, runs: int, eager: bool = False) -> float:
    """Wall ms a decode step over `runs` chunks of `run_steps` after a
    prefill of `prompt` (ids read back once a chunk, as generate does)."""
    import torch

    _start(eng, runner, prompt)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(runs):
            run_steps(runner, runner.chunk, eager)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (runs * runner.chunk)


def _decode_summary(prof: dict, wall_ms: float) -> dict:
    """Busy and idle a token of a decode profile against a wall time; where
    the profiler listed no kernel, the CUDA-event span stands for busy."""
    busy = sum(prof["device_ms_per_token"].values())
    listed = busy > 0
    busy = busy if listed else prof["event_span_ms_per_token"]
    return dict(wall_ms=wall_ms, tok_s=1e3 / wall_ms, busy_ms=busy,
                busy_from="profiler" if listed else "CUDA-event span (profiler listed no kernel)",
                idle_share=1 - busy / wall_ms, device_ms_per_token=prof["device_ms_per_token"],
                event_span_ms_per_token=prof["event_span_ms_per_token"])


def graph_decode(label: str, kv_name: str, eng, word_ids, count, graph_prof: dict) -> dict:
    """The decode chunk as CUDA-graph replays, on a served engine:
    1. greedy ids: a prompt of max_seq − 2·GRAPH_CHUNK − GRAPH_TAIL word
       tokens, generate_tokens_device to the context end (two chunks of
       replays and a tail of one-step replays) against a decode_step +
       argmax loop on the same engine;
    2. the launches one replay adds against per_forward_launches;
    3. the graph's capture seconds and pool bytes;
    4. decode wall ms a token, in turns (eager, graph, graph, eager) after
       a 10-token prompt: the runner's steps without a graph (the eager
       yardstick, one chunk a turn) and its replays (two chunks a turn);
    5. busy and idle a token: the replays' from `graph_prof` (serve's
       profile of one chunk of replays), the eager steps' from a profile of
       EAGER_PROFILE_STEPS of them;
    6. temp 0.8: two runs from one seed give the same ids.
    `count(n_prompt, n_decode)` books every forward for check_launches."""
    from tpullm_torch.ops.sampling_ops import SamplingParams

    tag = f"[{label}] kv={kv_name} graph:"
    chunk, sp = GRAPH_CHUNK, SamplingParams()
    ids = word_ids(eng.max_seq - 2 * chunk - GRAPH_TAIL)
    eng.reset()
    ref = [int(np.argmax(eng.prefill(ids)))]
    while eng.n_past < eng.max_seq:
        ref.append(int(np.argmax(eng.decode_step(ref[-1]))))
    count(len(ids), len(ref) - 1)
    eng.reset()
    got = eng.generate_tokens_device(ids, 10 ** 6, stop_on_eog=False, chunk=chunk, to_end=True)
    count(len(ids), len(got) - 1)
    runner = eng.decode_runner(sp, chunk)
    log(f"{tag} {len(got) - 1} decode steps from a {len(ids)}-token prompt to n_past = "
        f"{eng.n_past} ({runner.replays} replays so far): ids "
        f"{'equal to' if got == ref else 'DIFFERENT from'} the decode_step loop's")
    expect(len(got) - 1 == 2 * chunk + GRAPH_TAIL and eng.n_past == eng.max_seq,
           f"{label}: two chunks and a tail of {GRAPH_TAIL}")
    expect(got == ref, f"{label}: graph ids equal the decode_step loop's (first difference "
           f"at {next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)})")

    per = per_forward_launches(eng.params)
    one = runner.launches_per_replay()
    want = {"qmm": per["qmm"], "qmm_tc": 0, "qmm_stack": 0, "qmm_gather": per["experts"],
            "qmm_grouped": 0, "dequant_routes": 0, "flash": per["flash"],
            "flash_decode": per["flash"],
            "attn_dense_routes": 0, "attn_ring_routes": 0}
    log(f"{tag} launches per replay (one token) {one}; capture {runner.capture_s:.3f} s, "
        f"graph pool {runner.pool_bytes / 2**20:.1f} MiB")
    expect(one == want, f"{label}: launches per replay {one} = per forward {want}")

    prompt = word_ids(10)
    walls = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        runs = 1 if mode == "eager" else 2
        walls[mode].append(time_runs(eng, runner, prompt, runs, eager=mode == "eager"))
        count(len(prompt), runs * chunk)
    e_prof = profile_decode(eng, runner, prompt, EAGER_PROFILE_STEPS, eager=True)
    count(len(prompt), EAGER_PROFILE_STEPS)
    out = dict(ids_equal=got == ref, decode_steps=len(got) - 1, launches_per_replay=one,
               capture_s=runner.capture_s, pool_bytes=runner.pool_bytes,
               eager_wall_ms=walls["eager"], graph_wall_ms=walls["graph"],
               graph=_decode_summary(graph_prof, float(np.mean(walls["graph"]))),
               eager=_decode_summary(e_prof, float(np.mean(walls["eager"]))))
    for mode in ("eager", "graph"):
        r = out[mode]
        log(f"{tag} {mode}: wall {r['wall_ms']:.3f} ms a token ({r['tok_s']:.2f} tok/s; turns "
            f"{', '.join(f'{w:.3f}' for w in walls[mode])}), busy {r['busy_ms']:.3f} ms "
            f"({r['busy_from']}; event span {r['event_span_ms_per_token']:.3f}), idle "
            f"{r['idle_share']:.3f}; by family "
            f"{ {k: round(v, 4) for k, v in r['device_ms_per_token'].items()} }")

    sampled = []
    for _ in range(2):
        eng.reset()
        n0 = eng.perf.n_decode
        sampled.append(eng.generate_tokens_device(prompt, 48, temp=0.8, seed=11,
                                                  stop_on_eog=False, chunk=chunk))
        count(len(prompt), eng.perf.n_decode - n0)
    log(f"{tag} temp 0.8, seed 11, two runs: {sampled[0][:12]}… "
        f"{'the same' if sampled[0] == sampled[1] else 'DIFFERENT'}")
    expect(sampled[0] == sampled[1] and len(sampled[0]) == 48,
           f"{label}: sampled graph runs from one seed agree")
    out["sampled_equal"] = True
    return out


def _synth_writer(tmp: Path, shape: str, ftype: str, n_layer: int | None, vocab: str):
    """The path of `synthesize`'s GGUF and its writer (nothing drawn yet),
    after a check that the disk holds it with 2 GB to spare."""
    from tpullm_torch.models.synth import synthetic_writer

    path = tmp / f"{shape}-{ftype.lower()}{f'-{n_layer}l' if n_layer else ''}-{vocab}.gguf"
    writer = synthetic_writer(path, shape=shape, seed=0, ftype=ftype, n_layer=n_layer,
                              vocab=vocab)
    need, free = writer.payload_bytes(), shutil.disk_usage(tmp).free
    expect(free > need + 2e9, f"{free / 1e9:.1f} GB free in {tmp} holds the "
           f"{need / 1e9:.1f} GB {shape} {ftype} GGUF with 2 GB to spare")
    return path, writer


def synthesize(tmp: Path, label: str, shape: str, ftype: str, n_layer: int | None = None,
               vocab: str = "spm") -> Path:
    """A synthetic GGUF of `shape` at preset `ftype` in `tmp` (with n_layer
    layers where given): the file an earlier phase kept for this one
    (KEPT), or the one a child of AHEAD writes, where one was started for
    it, else written here; then the next jobs of AHEAD_QUEUE start
    (`ahead_top_up`)."""
    job = (shape, ftype, n_layer, vocab)
    child = AHEAD.pop(job, None)
    kept = KEPT.pop(job, None)
    if kept is not None and kept.exists():  # written for an earlier phase and kept
        path = kept
    elif child is not None:
        path = _synth_wait(label, child)
    else:
        if job in AHEAD_QUEUE:  # needed before its turn came
            AHEAD_QUEUE.remove(job)
        path, writer = _synth_writer(tmp, shape, ftype, n_layer, vocab)
        t0 = time.perf_counter()
        writer.write()
        log(f"[{label}] synthesized {path.stat().st_size / 2**30:.2f} GiB {shape} {ftype}"
            f"{f' ({n_layer} layers)' if n_layer else ''} GGUF ({vocab} vocab) in "
            f"{time.perf_counter() - t0:.1f}s")
    ahead_top_up(tmp)
    return path


# the recurrent phase's card models and their depths (Falcon-Mamba-7B and
# Mamba-Codestral-7B of 64, Jamba-Mini-1.5 of 32: one whole period, attention
# at 4, experts on the odd layers; Granite-4.0-H-Tiny of 40: its first
# attention layer at 5)
RECURRENT_LAYERS = {"falcon-mamba-7b": 8, "mamba-codestral-7b": 8, "jamba-mini-1.5": 8,
                    "granite-4.0-h-tiny": 8}
# (label, shape, ftype, n_layer) of the presets' and the i-quants' runs
PRESET_JOBS = (*((f"8b-{ftype}", "llama-3-8b", ftype, 4)
                 for ftype in ("Q2_K", "IQ4_XS", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "IQ4_NL",
                               "Q3_K_M")),
               ("mixtral-MXFP4_MOE", "mixtral-8x7b", "MXFP4_MOE", 4))
IQUANT_JOBS = (*((f"8b-{ftype}", "llama-3-8b", ftype, 4)
                 for ftype in ("IQ1_S", "IQ3_XXS", "IQ2_XXS", "IQ2_XS", "IQ2_M", "IQ1_M",
                               "IQ3_M", "TQ1_0", "TQ2_0")),
               ("mixtral-IQ2_XXS", "mixtral-8x7b", "IQ2_XXS", 4),
               ("8b-grouped", "llama-3-8b", "Q4_K_M", 4))
# the main path's files in the order the run takes them (shape, ftype,
# n_layer, vocab): `synthesize` takes each from a child process started up to
# SYNTH_AHEAD files before its turn (AHEAD)
AHEAD_JOBS = (("llama-3-8b", "Q4_K_M", None, "bpe"), ("mixtral-8x7b", "Q4_K_M", 4, "spm"),
              ("llama-3-8b", "Q4_K_M", 4, "spm"),
              *((shape, ftype, n_layer, "spm")
                for _, shape, ftype, n_layer in (*PRESET_JOBS, *IQUANT_JOBS)),
              ("gemma-3-4b", "Q4_K_M", 12, "spm"),
              ("deepseek-v2-lite", "Q4_K_M", 9, "spm"), ("qwen3-30b-a3b", "Q4_K_M", 8, "bpe"),
              ("qwen2.5-7b", "Q4_K_M", 4, "bpe"), ("olmoe-1b-7b", "Q4_K_M", None, "bpe"),
              ("phi-3.5-moe", "Q4_K_M", 8, "spm"), ("phi-3.5-moe", "Q4_K_M", 1, "spm"),
              ("llama-4-scout", "Q4_K_M", 4, "bpe"),
              *((shape, "Q4_K_M", n, "spm") for shape, n in RECURRENT_LAYERS.items()),
              ("phi-3-mini-4k", "Q4_K_M", 16, "spm"), ("phi-2", "Q4_K_M", 8, "bpe"),
              ("phi-2", "Q4_K_M", 1, "bpe"), ("qwen-7b", "Q4_K_M", 2, "bpe"),
              ("minicpm3-4b", "Q4_K_M", 12, "spm"), ("plm-1.8b", "Q4_K_M", 8, "bpe"),
              ("qwen3-vl-8b", "Q4_K_M", 8, "bpe"), ("qwen2-vl-7b", "Q4_K_M", 4, "bpe"),
              ("qwen3-vl-30b-a3b", "Q4_K_M", 4, "bpe"), ("apertus-8b", "Q4_K_M", 4, "bpe"),
              ("afm-4.5b", "Q4_K_M", 4, "bpe"), ("llama-embed-8b", "Q4_K_M", 4, "bpe"),
              ("falcon-7b", "Q4_K_M", 4, "bpe"), ("pythia-6.9b", "Q4_K_M", 4, "bpe"),
              ("bloom-7b1", "Q4_K_M", None, "bpe"), ("bloom-7b1", "Q4_K_M", 1, "bpe"),
              ("mpt-7b", "Q4_K_M", 4, "bpe"), ("gpt2", "Q4_K_M", None, "bpe"),
              ("starcoder-15b", "Q4_K_M", 4, "bpe"))
AHEAD_QUEUE: list = []  # jobs not started yet
AHEAD: dict = {}  # job → its child (`_synth_child`), started and not yet taken
KEPT: dict = {}  # job → a file a phase keeps for a later one (the server's Mixtral)


def ahead_top_up(tmp: Path) -> None:
    """Starts the next jobs of AHEAD_QUEUE while fewer than SYNTH_AHEAD files
    are started and not yet taken (a job whose file is started and not yet
    taken waits: one path, one writer)."""
    while AHEAD_QUEUE and len(AHEAD) < SYNTH_AHEAD and AHEAD_QUEUE[0] not in AHEAD:
        job = AHEAD_QUEUE.pop(0)
        AHEAD[job] = _synth_child(tmp, *job)


# a child's synthesis: make_synthetic_llama_gguf on the JSON of its arguments
SYNTH_CHILD = ("import json, sys; from tpullm_torch.models.synth import "
               "make_synthetic_llama_gguf; make_synthetic_llama_gguf(**json.loads(sys.argv[1]))")
# files synthesized at once ahead of the caller: a 4-layer 8B took 4–6 s
# in a child and 3–4 s on the card, Mixtral at MXFP4_MOE 14 s
SYNTH_AHEAD = 3


def _synth_child(tmp: Path, shape: str, ftype: str, n_layer: int | None,
                 vocab: str = "spm") -> tuple:
    """Starts a child process writing the GGUF `synthesize` would write;
    (its path, the process, the start time)."""
    path, _ = _synth_writer(tmp, shape, ftype, n_layer, vocab)
    args = dict(path=str(path), shape=shape, seed=0, ftype=ftype, n_layer=n_layer, vocab=vocab)
    proc = subprocess.Popen([sys.executable, "-c", SYNTH_CHILD, json.dumps(args)], cwd=ROOT)
    return path, proc, time.perf_counter()


def _synth_wait(label: str, child: tuple) -> Path:
    """The file of a `_synth_child` once the child has written it."""
    path, proc, t0 = child
    t_wait = time.perf_counter()
    rc = proc.wait()
    expect(rc == 0, f"[{label}] the synthesis child exited with {rc}")
    log(f"[{label}] synthesized {path.name} ({path.stat().st_size / 2**30:.2f} GiB) in a child "
        f"process: {time.perf_counter() - t0:.1f}s, of which {time.perf_counter() - t_wait:.1f}s "
        "waited for")
    return path


def _end_children(children) -> None:
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


# mixed scripts, digits, contractions and a special token, for the BPE vocab
MIXED_SENTENCE = ("Hello, wörld! It's 12345 naïve 漢字とカタカナ, русский текст, ١٢٣ "
                  "— done.<|eot_id|>\n")


def bpe_round_trip(path):
    """The 8B's byte-level BPE vocab as a Llama-3 GGUF carries it, and
    MIXED_SENTENCE through the port's tokenizer and back."""
    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.tokenizer import BPETokenizer, from_gguf

    t0 = time.perf_counter()
    tok = from_gguf(GGUFReader(path))
    v = tok.vocab
    ids = tok.tokenize(MIXED_SENTENCE, add_special=True, parse_special=True)
    back = tok.detokenize(ids, remove_special=True, unparse_special=True)
    log(f"[slice] vocab: model {v.model!r}, pre {v.pre!r}, {v.n_tokens} tokens, "
        f"{len(v.merges)} merges, bos {v.special.bos}, eot {v.special.eot}; "
        f"{MIXED_SENTENCE!r} → {len(ids)} ids {ids} → {back!r} "
        f"({'round trip exact' if back == MIXED_SENTENCE else 'ROUND TRIP DIFFERS'}; "
        f"{time.perf_counter() - t0:.1f}s)")
    expect(isinstance(tok, BPETokenizer) and (v.model, v.pre) == ("gpt2", "llama-bpe")
           and v.n_tokens == 128256, "the 8B carries a gpt2 / llama-bpe vocab of 128256")
    expect(ids[0] == v.special.bos and ids[-2] == v.special.eot, "bos first, <|eot_id|> parsed")
    expect(back == MIXED_SENTENCE, "the mixed-script sentence round-trips")


def phase_slice(tmp: Path, launches: dict) -> tuple[list[dict], Path]:
    """Llama-3-8B Q4_K_M on Llama-3's byte-level BPE vocab with a bf16 KV
    cache and the graph phase (a q8 cache serves in the server,
    speculative and moe families phases); the file is kept for the tools
    phase."""
    import torch

    path = synthesize(tmp, "slice", "llama-3-8b", "Q4_K_M", vocab="bpe")
    bpe_round_trip(path)
    return [serve("slice", path, torch.bfloat16, launches, graph=True)], path


TOOLS_CTX = 2048  # the cli's context
TOOLS_PROMPT = "The history of the quick brown fox, told in twelve short chapters:"
# the cli completion's Sampler chain, as its flags build it
TOOLS_SAMPLING = ["--temp", "0.8", "--seed", "1", "--repeat-penalty", "1.1"]
TOOLS_TOKENS = 64  # tokens of the completion, and of the decode_step timings
PPL_WINDOWS = 2  # the smoke's time: the KLD base file, written compressed, grows with them
BENCH_ARGS = ["-p", "512", "-n", "128", "-d", "4096", "-ctk", "bf16,f16,f32,q8_0", "-r", "1",
              "-o", "jsonl", "-c", "4864"]


def run_tool(main, argv: list[str], stdin: str | None = None) -> tuple[int, str, str, float]:
    """A tool's main(argv) in this process, as a user's command line runs
    it: its stdout and stderr captured, stdin read from `stdin`; then its
    engine's garbage (an engine and its graphs form a cycle) collected and
    the allocator's cache emptied. Returns (exit code, stdout, stderr,
    seconds)."""
    import contextlib
    import io

    import torch

    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        sys.stdin = saved
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return rc, out.getvalue(), err.getvalue(), seconds


def _decode_costs(eng, ids: list[int]) -> dict:
    """On one engine, TOOLS_TOKENS tokens of the cli's completion loop taken
    apart: decode_step (the logits graph's replay and the logits read
    back) against the eager step with the same read-back (`_decode_logits`,
    the same tokens at the same positions, logits compared), and the host
    Sampler chain of the cli's flags alone, ms a token each; then a
    profiled chunk of 16 decode_steps: device busy a token against the
    unprofiled decode_step's wall, the idle share (the profiled wall,
    which the profiler's host cost stretches, beside it)."""
    import torch

    from tpullm_torch.runtime.sampling import Sampler, SamplerParams

    eng.reset()
    eng.prefill(ids)
    for t in (1, 2, 3):  # the logits graph's capture, outside the timing
        eng.decode_step(t)
    sampler = Sampler(SamplerParams(temp=0.8, seed=1, penalty_repeat=1.1, penalty_last_n=64))
    eng.reset()
    logits = eng.prefill(ids)
    toks, rows, t_step, t_sample = [], [], 0.0, 0.0
    for _ in range(TOOLS_TOKENS):
        t0 = time.perf_counter()
        tok = sampler.sample(logits)
        sampler.accept(tok)
        t1 = time.perf_counter()
        logits = eng.decode_step(tok)
        t_step += time.perf_counter() - t1
        t_sample += t1 - t0
        toks.append(tok)
        rows.append(logits)
    eng.reset()
    eng.prefill(ids)
    torch.cuda.synchronize()
    t_eager, worst = 0.0, 0.0
    with torch.inference_mode():
        for tok, row in zip(toks, rows):
            t0 = time.perf_counter()
            got = eng._decode_logits(torch.tensor([tok], device=eng.device)).cpu().numpy()
            t_eager += time.perf_counter() - t0
            worst = max(worst, float(np.abs(got - row).max()))
    eng.reset()
    eng.prefill(ids)
    torch.cuda.synchronize()

    def chunk():
        t0 = time.perf_counter()
        for tok in toks[:16]:
            eng.decode_step(tok)
        return time.perf_counter() - t0

    wall, prof = profiled(chunk)
    busy = sum(us for _, us, _ in device_events(prof)) / 1e3
    graph_ms = t_step * 1e3 / TOOLS_TOKENS
    return dict(graph_ms=graph_ms, eager_ms=t_eager * 1e3 / TOOLS_TOKENS,
                sampler_ms=t_sample * 1e3 / TOOLS_TOKENS, max_abs_diff_graph_eager=worst,
                profiled_wall_ms=wall * 1e3 / 16, profiled_busy_ms=busy / 16,
                idle_share=1 - busy / 16 / graph_ms)


def window_nll(eng, corpus: Path) -> tuple[list[float], float]:
    """Perplexity's windows (PPL_WINDOWS of 512 tokens of `corpus`, the NLL
    over each window's second half, its targets gathered on the device by
    the tool's own `_target_logprobs`) on `eng`: ms of each window, and the
    mean NLL a token (nats, the ln of the PPL, finite where the PPL passes
    f64)."""
    import torch

    from tpullm_torch.tools.perplexity import _target_logprobs

    ids = eng.tokenizer.tokenize(corpus.read_text(encoding="utf-8"), add_special=True)
    nll, count, ms = 0.0, 0, []
    for wi in range(PPL_WINDOWS):
        window = ids[wi * 512:(wi + 1) * 512]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.reset()
        lps = _target_logprobs(eng.prefill_all_logits_device(window), range(256, 511),
                               window[257:])
        ms.append(1e3 * (time.perf_counter() - t0))
        nll -= sum(lps)
        count += len(lps)
    return ms, nll / count


def phase_tools(path: Path, tmp: Path, launches: dict) -> dict:
    """The tools a llama.cpp user runs, through their main()s, on the 8B
    Q4_K_M (full width and depth, the BPE vocab): cli completion through the
    host Sampler (and its costs taken apart, `_decode_costs`), the prompt
    cache run twice, a two-turn chat through stdin, tokenize against the
    engine's tokenizer, perplexity over SURVEY.md (PPL_WINDOWS windows of
    512) with the kernels and with dense bf16 weights (the tool's PPL; for
    the kernels also the mean NLL a token on this engine, its log, which
    stays finite where the random weights' PPL passes f64), the KLD of the
    kernels against a base recorded by dense, the launches and time of
    each window, and the bench
    sweep over the four cache types. Launch counts
    are read over the whole phase, the flash f16 and f32 kernels' among
    them."""
    import ast
    import re

    import torch

    from tpullm_torch.chat import apply_chat_template
    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.tools import bench, cli, perplexity, tokenize

    m = ["-m", str(path)]
    out: dict = {}
    reset_launches()  # just before the main path
    # 1. completion, the host Sampler chain on decode_step's logits
    rc, text, err, secs = run_tool(cli.main, m + ["-p", TOOLS_PROMPT, "-n", str(TOOLS_TOKENS),
                                                  *TOOLS_SAMPLING, "-v", "-c", str(TOOLS_CTX)])
    perf = re.search(r"prompt (\d+) tok ([\d.]+) t/s \| gen (\d+) tok ([\d.]+) t/s", err)
    expect(rc == 0 and text.startswith(TOOLS_PROMPT) and perf is not None,
           f"cli completion: rc {rc}, perf line in {err[-300:]!r}")
    out["cli"] = dict(seconds=secs, prompt_tok_s=float(perf.group(2)),
                      gen_tokens=int(perf.group(3)), gen_tok_s=float(perf.group(4)),
                      text_chars=len(text) - len(TOOLS_PROMPT))
    log(f"[tools] cli completion -n {TOOLS_TOKENS} {' '.join(TOOLS_SAMPLING)}: {secs:.1f}s with "
        f"the load; gen {perf.group(3)} tok at {perf.group(4)} tok/s; text "
        f"{text[len(TOOLS_PROMPT):][:60]!r}")

    eng = Engine(path, max_seq=TOOLS_CTX)
    ids = eng.tokenizer.tokenize(TOOLS_PROMPT, add_special=True, parse_special=True)
    costs = _decode_costs(eng, ids)
    out["decode"] = costs
    log(f"[tools] decode_step {costs['graph_ms']:.3f} ms a token (logits graph, logits read "
        f"back) against the eager step {costs['eager_ms']:.3f} ms; host Sampler chain "
        f"{costs['sampler_ms']:.3f} ms a token; logits graph vs eager max |d| "
        f"{costs['max_abs_diff_graph_eager']:.3g}; profiled chunk of 16: busy "
        f"{costs['profiled_busy_ms']:.3f} ms a token, idle {costs['idle_share']:.3f} of the "
        f"unprofiled decode_step (profiled wall {costs['profiled_wall_ms']:.3f} ms)")
    expect(costs["max_abs_diff_graph_eager"] == 0.0,
           "decode_step's logits (graph) equal the eager step's")

    # 2. the prompt cache, twice at temp 0
    cache = tmp / "session.npz"
    cache.unlink(missing_ok=True)
    pc = m + ["-p", TOOLS_PROMPT, "-n", "32", "--temp", "0", "-c", str(TOOLS_CTX),
              "--prompt-cache", str(cache)]
    first, second = run_tool(cli.main, pc), run_tool(cli.main, pc)
    reused = re.search(r"reused (\d+) tokens", second[2])
    log(f"[tools] prompt cache: first run {first[3]:.1f}s ({first[2].strip()!r}), second "
        f"{second[3]:.1f}s ({second[2].strip()!r}); stdout "
        f"{'equal' if first[1] == second[1] else 'DIFFERENT'}")
    expect(first[0] == second[0] == 0 and "saved" in first[2] and reused is not None
           and first[1] == second[1], "the prompt cache is reused and the output repeats")
    out["prompt_cache"] = dict(reused=int(reused.group(1)), first_s=first[3],
                               second_s=second[3])

    # 3. chat: two scripted turns through stdin, against the same
    # conversation rendered and answered greedily on this engine
    turns = ["Hello there!", "Tell me one more thing."]
    rc, text, err, secs = run_tool(cli.main, m + ["--chat", "-n", "16", "--temp", "0", "-c",
                                                  str(TOOLS_CTX)],
                                   stdin="\n".join(turns) + "\n\n")
    want, msgs = "> ", []
    for user in turns:
        msgs.append({"role": "user", "content": user})
        eng.reset()
        prompt = apply_chat_template(eng.tokenizer.vocab.chat_template, msgs)
        toks = eng.generate_tokens(eng.tokenizer.tokenize(prompt, add_special=True,
                                                          parse_special=True), 16)
        answer = "".join(eng.tokenizer.detokenize([t]) for t in toks)
        msgs.append({"role": "assistant", "content": answer})
        want += answer + "\n> "
    log(f"[tools] chat, two turns through stdin in {secs:.1f}s: {text!r:.120}")
    expect(rc == 0 and text == want, f"chat: the two greedy answers of the rendered "
           f"conversation, got {text!r}, want {want!r}")

    # 4. tokenize against the engine's tokenizer
    rc, text, _, _ = run_tool(tokenize.main, m + ["-p", MIXED_SENTENCE, "--ids"])
    want = eng.tokenizer.tokenize(MIXED_SENTENCE, add_special=True, parse_special=True)
    expect(rc == 0 and ast.literal_eval(text.strip()) == want,
           "tpullm-torch-tokenize's ids equal the engine tokenizer's")
    log(f"[tools] tokenize: {len(want)} ids, equal to the engine's tokenizer")

    # 5. perplexity over SURVEY.md: each window's time and launches and the
    # mean NLL on this engine, then the tool with the kernels and with dense
    # weights (its own load), and the KLD of the kernels against a base
    # recorded by dense
    corpus = ROOT / "SURVEY.md"
    per = per_forward_launches(eng.params)
    before = (sum(qmm.TC_LAUNCHES.values()), qmm.TC_LAUNCHES["Q6_K"], flash.launch_total("bf16"),
              flash.launch_total("bf16", "decode"), sum(qmm.LAUNCHES.values()))
    window_ms, nll_auto = window_nll(eng, corpus)
    after = (sum(qmm.TC_LAUNCHES.values()), qmm.TC_LAUNCHES["Q6_K"], flash.launch_total("bf16"),
             flash.launch_total("bf16", "decode"), sum(qmm.LAUNCHES.values()))
    d = [b - a for a, b in zip(before, after)]
    log(f"[tools] perplexity windows of 512: {[round(w, 2) for w in window_ms]} ms; launches "
        f"over {PPL_WINDOWS} windows: qmm_tc {d[0]} (Q6_K {d[1]}), flash {d[2]} (decode regime "
        f"{d[3]}), CUDA-core qmm {d[4]}; per forward {per}")
    expect(d[0] == per["qmm"] * PPL_WINDOWS and d[4] == 0 and d[2] == per["flash"] * PPL_WINDOWS
           and d[3] == 0 and d[1] >= PPL_WINDOWS,
           "each window's forward ran every linear and the Q6_K head on qmm_tc and flash in "
           "its prefill regime")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ppl_args = m + ["-f", str(corpus), "-c", "512", "--max-windows", str(PPL_WINDOWS), "--json"]
    ppl = {}
    for mode in ("auto", "dense"):
        rc, text, _, secs = run_tool(perplexity.main, ppl_args + ["--mode", mode])
        ppl[mode] = dict(json.loads(text), seconds=secs)
        expect(rc == 0 and ppl[mode]["n_tokens"] == 255 * PPL_WINDOWS,
               f"perplexity {mode}: {ppl[mode]}")
    expect(ppl["auto"]["ppl"] == np.inf if nll_auto >= np.log(np.finfo(np.float64).max)
           else np.isclose(ppl["auto"]["ppl"], np.exp(nll_auto), rtol=1e-3, atol=0.0),
           "the tool's PPL with the kernels is exp of the windows' mean NLL (inf past f64; "
           "rtol 1e-3: the tool's engine holds 512 positions, this one TOOLS_CTX, so "
           "attention sums another number of masked keys)")
    base = tmp / "kld_base.npz"
    rc, _, _, base_s = run_tool(perplexity.main, ppl_args + ["--mode", "dense",
                                                             "--kl-divergence-base", str(base)])
    expect(rc == 0 and base.exists(), "the dense run recorded the KLD base")
    rc, text, _, kld_s = run_tool(perplexity.main, ppl_args + ["--kl-divergence", str(base)])
    kld = json.loads(text)
    base.unlink()
    expect(rc == 0 and kld["kld"] >= 0 and kld["n_tokens"] == 512 * PPL_WINDOWS,
           f"KLD of the kernels against dense: {kld}")
    out["perplexity"] = dict(window_ms=window_ms, nll_auto=nll_auto, auto=ppl["auto"],
                             dense=ppl["dense"], kld=kld, kld_base_s=base_s, kld_s=kld_s)
    log(f"[tools] perplexity, SURVEY.md, {PPL_WINDOWS} windows of 512: PPL auto (the kernels) "
        f"{ppl['auto']['ppl']:.6g} ({ppl['auto']['seconds']:.1f}s), dense (bf16 weights, "
        f"torch.matmul) {ppl['dense']['ppl']:.6g} ({ppl['dense']['seconds']:.1f}s); mean NLL a "
        f"token (ln PPL) auto {nll_auto:.4f} nats; KLD of auto "
        f"against the dense base {kld['kld']:.6g}, same top {kld['same_top_p']:.4f} over "
        f"{kld['n_tokens']} tokens (base recorded in {base_s:.1f}s, KLD run {kld_s:.1f}s)")

    # 6. the bench sweep
    rc, text, _, secs = run_tool(bench.main, m + BENCH_ARGS)
    rows = [json.loads(line) for line in text.splitlines() if line.strip()]
    expect(rc == 0 and len(rows) == 4 and all(r["pp_ts"] > 0 and r["tg_ts"] > 0 for r in rows),
           f"bench: 4 rows with pp and tg rates, got {rows}")
    out["bench"] = dict(seconds=secs, rows=rows)
    for r in rows:
        log(f"[tools] bench kv={r['type_kv']} d={r['n_depth']}: pp{r['n_prompt']} "
            f"{r['pp_ts']} ± {r['pp_stddev']} tok/s, tg{r['n_gen']} {r['tg_ts']} ± "
            f"{r['tg_stddev']} tok/s")
    torch.cuda.synchronize()
    got = read_launches()  # just after the main path
    for fmt in FLASH_FORMATS:
        key = f"flash_{fmt}"
        expect(got[key + ".decode"] > 0 and got[key] - got[key + ".decode"] > 0,
               f"tools: {key} launched in both regimes")
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
           "tools: no call through the dequantize or dense-attention routes")
    log(f"[tools] launches over the phase: {got}; {secs:.1f}s for the bench")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = got
    return out


SERVE_SLOTS = 4
SERVE_CTX = 4096
# the burst: (route, prompt words, max_tokens, temperature, seed); 4 streamed
# chats and 4 completions, prompts of 32 to 1024 tokens, greedy and seeded
SERVE_BURST = (("/v1/chat/completions", 24, 64, 0.0, None),
               ("/v1/chat/completions", 300, 128, 0.8, 11),
               ("/v1/chat/completions", 640, 192, 0.0, None),
               ("/v1/chat/completions", 960, 256, 0.8, 12),
               ("/v1/completions", 31, 256, 0.8, 13),
               ("/v1/completions", 255, 192, 0.0, None),
               ("/v1/completions", 511, 128, 0.8, 14),
               ("/v1/completions", 1023, 64, 0.0, None))
SERVE_STEPS = 32  # decode steps a timing, and of the q8 and Mixtral runs
TEACHER_STEPS = 16  # teacher-forced decode steps a slot against Engine
TEACHER_LENS = (40, 200, 700, 1000)  # the slots' prompts in that check
SERVE_NMSE_BOUND = 1e-3  # batched logits against Engine.decode_step's


def _word_ids(tok, n: int) -> list[int]:
    """BOS and n − 1 word tokens (each word one token with its space)."""
    words = "the quick brown fox jumps over the lazy dog hello world".split()
    space = "Ġ" if tok.vocab.model == "gpt2" else "▁"
    return [tok.vocab.special.bos] + [tok.vocab.token_to_id[space + words[i % len(words)]]
                                      for i in range(n - 1)]


def _words(n: int) -> str:
    words = "the quick brown fox jumps over the lazy dog hello world".split()
    return " ".join(words[i % len(words)] for i in range(n))


def _http_request(port: int, route: str, body: dict, timeout: float = 600.0) -> dict:
    """One POST through http.client: status, the JSON body (or, streamed,
    the SSE payloads and the client's time to the first one), seconds."""
    import http.client

    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", route, json.dumps(body), {"Content-Type": "application/json"})
        r = c.getresponse()
        out = {"status": r.status}
        if body.get("stream"):
            events, first = [], None
            for line in r:
                if line.startswith(b"data: "):
                    first = first or time.perf_counter() - t0
                    events.append(line[6:].strip().decode())
            out.update(events=events, client_ttft_s=first)
        else:
            out["json"] = json.loads(r.read())
    finally:
        c.close()
    out["seconds"] = time.perf_counter() - t0
    return out


def _burst(port: int, tok) -> tuple[list[dict], float]:
    """SERVE_BURST sent at once, a thread a request; (results, wall s)."""
    import threading

    results: list = [None] * len(SERVE_BURST)

    def send(i, route, words, n, temp, seed):
        body = {"max_tokens": n, "temperature": temp, **({"seed": seed} if seed else {})}
        if route == "/v1/chat/completions":
            body.update(messages=[{"role": "user", "content": _words(words)}], stream=True)
        else:
            body["prompt"] = _words(words)
        try:
            results[i] = _http_request(port, route, body)
        except Exception as e:  # reported by the check below
            results[i] = {"error": repr(e)}
        results[i].update(route=route, words=words, max_tokens=n, temp=temp, seed=seed)

    threads = [threading.Thread(target=send, args=(i, *req)) for i, req in enumerate(SERVE_BURST)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    expect(not any(t.is_alive() for t in threads), "every request of the burst returned")
    for r in results:
        expect("error" not in r and r["status"] == 200, f"request {r.get('route')}: {r}")
        if r["route"] == "/v1/chat/completions":
            expect(r["events"][-1] == "[DONE]", f"{r['route']}: the stream ends with [DONE]")
            final = json.loads(r["events"][-2])
            r["stats"], r["finish_reason"] = final["timings"], final["choices"][0]["finish_reason"]
            r["text"] = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                                for e in r["events"][:-2])
        else:
            r["stats"] = r["json"]["timings"]
            r["finish_reason"] = r["json"]["choices"][0]["finish_reason"]
            r["text"] = r["json"]["choices"][0]["text"]
        st = r["stats"]
        expect(st["predicted_n"] > 0 and r["finish_reason"] in ("stop", "length"),
               f"{r['route']} generated: {st}")
        expect(r["finish_reason"] == "stop" or st["predicted_n"] == r["max_tokens"],
               f"{r['route']}: {st['predicted_n']} of {r['max_tokens']} tokens")
        expect(st["prompt_n"] >= 32 and st["prompt_n"] <= 1024 + 64,
               f"{r['route']}: a prompt of {st['prompt_n']} tokens")
    return results, wall


def _batch_launches(eng) -> dict:
    """The launches one batched decode step makes (one forward at M =
    n_slots: every 2-D qmm on CUDA cores, flash in its decode regime, the
    gather for each expert stack)."""
    per = per_forward_launches(eng.params)
    return {"qmm": per["qmm"], "qmm_tc": 0, "qmm_stack": 0, "qmm_gather": per["experts"],
            "qmm_grouped": 0, "dequant_routes": 0, "flash": per["flash"],
            "flash_decode": per["flash"],
            "attn_dense_routes": 0, "attn_ring_routes": 0}


def _step_ms(eng, active, prompt: list[int], greedy: bool = True) -> float:
    """Wall ms a batched decode step with the slots `active` generating
    (the step runs over the first max(active) + 1 slots, the others among
    them idle at −1), over SERVE_STEPS steps after a joint prefill."""
    import torch

    for s in range(eng.n_slots):
        eng.free_slot(s)
    eng.prefill_slots({s: prompt for s in active})
    cur = {s: 5 for s in active}
    step = eng.decode_batch_greedy if greedy else \
        (lambda c: {s: int(np.argmax(r)) for s, r in eng.decode_batch(c).items()})
    cur = step(cur)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        cur = step(cur)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / SERVE_STEPS


def _profile_step(eng, prompt: list[int], steps: int = 8) -> dict:
    """Device ms a batched greedy step by kernel family (torch.profiler,
    `profiled`) with every slot generating."""
    import torch

    for s in range(eng.n_slots):
        eng.free_slot(s)
    eng.prefill_slots({s: prompt for s in range(eng.n_slots)})
    cur = {s: 5 for s in range(eng.n_slots)}
    torch.cuda.synchronize()

    def run():
        c = cur
        for _ in range(steps):
            c = eng.decode_batch_greedy(c)

    _, prof = profiled(run)
    fam = {"qmm": 0.0, "qmm_stack": 0.0, "qmm_gather": 0.0, "flash": 0.0, "other": 0.0}
    for key, us, _ in device_events(prof):
        fam[_family(key)] += us
    return {k: v / 1e3 / steps for k, v in fam.items()}


def teacher_forced(label: str, eng, single, prompts: list[list[int]], steps: int,
                   refs: tuple | None = None, bound: float = SERVE_NMSE_BOUND,
                   hold_prefill: bool = True) -> dict:
    """Each slot s of the BatchEngine prefills prompts[s] (one joint round)
    and is fed, step by step in one batched step, the greedy ids of the
    single-stream Engine on the same prompt; each slot's logits held
    against Engine's (prefill, then decode_step) within `bound`; without
    `hold_prefill` the joint round's rows are reported and the batched
    steps held. Reports the greedy ids that agree, and where they part,
    the step and Engine's top-2 margin. `refs`: Engine's (logits, ids)
    from engine_refs, taken before (`single` is then not used)."""
    ref_logits, ref_ids = refs or engine_refs(single, prompts, steps)
    for s in range(eng.n_slots):
        eng.free_slot(s)
    got = eng.prefill_slots(dict(enumerate(prompts)))
    worst, agree, parted, prefill_errs = 0.0, 0, [], []
    for step in range(steps + 1):
        if step:
            got = eng.decode_batch({s: ref_ids[s][step - 1] for s in range(len(prompts))})
        for s in range(len(prompts)):
            ref = ref_logits[s][step]
            err = float(np.mean((got[s].astype(np.float64) - ref) ** 2)
                        / np.mean(ref.astype(np.float64) ** 2))
            if step == 0:
                prefill_errs.append(err)
            if step or hold_prefill:
                worst = max(worst, err)
            if int(np.argmax(got[s])) == ref_ids[s][step]:
                agree += 1
            else:
                top2 = np.sort(ref)[-2:]
                parted.append(dict(slot=s, step=step, margin=float(top2[1] - top2[0])))
    n = (steps + 1) * len(prompts)
    log(f"[{label}] teacher-forced on Engine's greedy ids, {len(prompts)} slots × {steps + 1} "
        f"positions (prompts of {[len(p) for p in prompts]} tokens): worst NMSE {worst:.2e} "
        f"(bound {bound}{'' if hold_prefill else ', the batched steps'}); the joint round's "
        f"rows {[f'{e:.2e}' for e in prefill_errs]}; greedy ids agree {agree}/{n}; parted at "
        f"{parted}")
    expect(worst <= bound, f"{label}: batched logits against Engine's, NMSE {worst:.3e} "
           f"<= {bound}")
    return dict(worst_nmse=worst, prefill_nmse=prefill_errs, ids_agree=agree, positions=n,
                parted=parted)


def engine_refs(single, prompts: list[list[int]], steps: int) -> tuple[list, list]:
    """The single-stream Engine's logits (prefill, then `steps` decode
    steps) and greedy ids on each prompt, for teacher_forced."""
    ref_logits, ref_ids = [], []
    for p in prompts:
        single.reset()
        rows = [single.prefill(p)]
        ids = [int(np.argmax(rows[0]))]
        for _ in range(steps):
            rows.append(single.decode_step(ids[-1]))
            ids.append(int(np.argmax(rows[-1])))
        ref_logits.append(rows)
        ref_ids.append(ids)
    return ref_logits, ref_ids


def phase_server(path: Path, tmp: Path, launches: dict) -> dict:
    """Continuous batching on the 8B Q4_K_M (full depth; the slice's file):
    tpullm-torch-server's app (BatchEngine of SERVE_SLOTS slots, context
    SERVE_CTX, bf16 cache; its decode graphs captured on the scheduler's
    thread at start) on 127.0.0.1 in this process, SERVE_BURST sent at
    once through http.client (each request's TTFT and rate, the aggregate
    generated rate); then on the same engine the graph's ms a step at 1, 2
    and 4 slots generating (ids read back; at 4 also the logits), the
    launches a replay, a profiled step by kernel family, and the batched
    logits teacher-forced against the single-stream Engine; a q8-cache
    engine at 4 slots for SERVE_STEPS steps (both on the server engine's
    Model: no second load of the 8B); Mixtral Q4_K_M with 4 layers at
    4 slots (one joint prefill round, SERVE_STEPS batched steps
    teacher-forced against its Engine: the gather regime); and
    tpullm-torch-batched-bench -npp 128 -ntg 64 -npl 1,2,4,8 on the 8B."""
    import torch

    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.server.api import make_app, serve
    from tpullm_torch.tools import batched_bench

    out: dict = {}
    torch.cuda.empty_cache()
    reset_launches()  # just before the main path
    app, sched = make_app(path, n_slots=SERVE_SLOTS, max_seq=SERVE_CTX, prefill_chunk=512)
    eng = sched.engine
    httpd = serve(app, "127.0.0.1", 0)
    try:
        t0 = time.perf_counter()
        sched.precompile(background=False)
        out["capture_s"] = time.perf_counter() - t0
        expect(all(r.graph is not None for r in eng._runners.values())
               and len(eng._runners) == SERVE_SLOTS,
               "the decode graph of every width captured on the scheduler's thread")
        results, wall = _burst(httpd.server_address[1], eng.tokenizer)
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    expect(not sched._thread.is_alive(), "the scheduler's thread stopped")
    gen_total = sum(r["stats"]["predicted_n"] for r in results)
    out["burst"] = [dict(route=r["route"], prompt_n=r["stats"]["prompt_n"],
                         predicted_n=r["stats"]["predicted_n"], temp=r["temp"],
                         finish=r["finish_reason"], ttft_ms=r["stats"]["ttft_ms"],
                         client_ttft_ms=(r["client_ttft_s"] * 1e3 if r.get("client_ttft_s")
                                         else None),
                         seconds=r["seconds"],
                         tok_s=r["stats"]["predicted_n"] / max(
                             (r["stats"]["total_ms"] - r["stats"]["ttft_ms"]) / 1e3, 1e-9))
                    for r in results]
    out.update(burst_wall_s=wall, generated=gen_total, aggregate_tok_s=gen_total / wall,
               load_s=eng.perf.t_load_s)
    for b, r in zip(out["burst"], results):
        log(f"[server] {b['route']} prompt {b['prompt_n']} tok, temp {b['temp']}: "
            f"{b['predicted_n']} tokens ({b['finish']}), TTFT {b['ttft_ms']:.1f} ms after "
            f"admission" + (f", {b['client_ttft_ms']:.1f} ms at the client"
                            if b['client_ttft_ms'] else "")
            + f", {b['tok_s']:.1f} tok/s, {b['seconds']:.2f} s in all; text "
            f"{r['text'][:48]!r}")
    log(f"[server] 8 requests on {SERVE_SLOTS} slots: {gen_total} tokens generated in "
        f"{wall:.2f} s, {gen_total / wall:.1f} tok/s in aggregate; load {eng.perf.t_load_s:.1f} s, "
        f"graphs captured in {out['capture_s']:.2f} s")

    want = _batch_launches(eng)
    for width, r in sorted(eng._runners.items()):
        one = r.launches_per_replay()
        log(f"[server] launches per replay (width {width}): {one}; capture "
            f"{r.capture_s:.3f} s, pool {r.pool_bytes / 2**20:.1f} MiB")
        expect(one == want, f"server: launches per replay {one} = one forward's {want}")
    out["launches_per_replay"] = want
    prompt = _word_ids(eng.tokenizer, 128)
    out["step_ms"] = {n: _step_ms(eng, range(n), prompt) for n in (1, 2, 4)}
    out["step_ms_last_slot"] = _step_ms(eng, [SERVE_SLOTS - 1], prompt)
    out["step_ms_logits_4"] = _step_ms(eng, range(4), prompt, greedy=False)
    out["agg_tok_s"] = {n: n * 1e3 / ms for n, ms in out["step_ms"].items()}
    log(f"[server] batched graph, ms a step by active slots 0..n−1 (greedy ids, 128-token "
        f"prompts): {out['step_ms']} → {out['agg_tok_s']} tok/s in aggregate; one slot "
        f"active in the last slot (the full width) {out['step_ms_last_slot']:.3f} ms; the "
        f"logits read back at 4 slots ([4, V]) {out['step_ms_logits_4']:.3f} ms")
    out["profile"] = _profile_step(eng, prompt)
    busy = sum(out["profile"].values())
    log(f"[server] profiled step at {eng.n_slots} slots, device ms by family "
        f"{ {k: round(v, 4) for k, v in out['profile'].items()} } = {busy:.3f} ms busy of "
        f"{out['step_ms'][4]:.3f} ms a step")

    model = eng.model  # the single-stream and q8 engines share its weights
    single = Engine(model, max_seq=SERVE_CTX)
    out["teacher"] = teacher_forced("server", eng, single,
                                    [_word_ids(eng.tokenizer, n) for n in TEACHER_LENS],
                                    TEACHER_STEPS)
    del single, eng, sched, app
    gc.collect()
    torch.cuda.empty_cache()

    q8 = BatchEngine(model, n_slots=SERVE_SLOTS, max_seq=SERVE_CTX, kv_dtype="q8_0")
    q8_ms = _step_ms(q8, range(SERVE_SLOTS), prompt)
    one = q8.runner(SERVE_SLOTS).launches_per_replay()
    expect(one == _batch_launches(q8), f"q8 server engine: launches per replay {one}")
    ids = q8.decode_batch_greedy({s: 7 for s in range(SERVE_SLOTS)})
    expect(all(0 <= t < q8.hp.n_vocab for t in ids.values()), "q8 ids in range")
    out["q8_step_ms"] = q8_ms
    log(f"[server] q8 cache, {SERVE_SLOTS} slots, {SERVE_STEPS} steps: {q8_ms:.3f} ms a step "
        f"({SERVE_SLOTS * 1e3 / q8_ms:.1f} tok/s in aggregate); launches per replay {one}")
    del q8, model
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    got = read_launches()  # the 8B's part of the phase
    expect(got["qmm_tc"] > 0 and got["qmm_q4k"] > 0 and got["qmm_q6k"] > 0
           and got["flash_bf16.decode"] > 0 and got["flash_bf16"] > got["flash_bf16.decode"]
           and got["flash_q8.decode"] > 0 and got["dequant_routes"] == 0
           and got["attn_dense_routes"] == 0, f"server: the 8B's launches {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v

    mpath = synthesize(tmp, "server-mixtral", "mixtral-8x7b", "Q4_K_M", n_layer=4)
    reset_launches()
    meng = BatchEngine(mpath, n_slots=SERVE_SLOTS, max_seq=SERVE_CTX)
    msingle = Engine(mpath, max_seq=SERVE_CTX)
    out["mixtral"] = teacher_forced("server-mixtral", meng, msingle,
                                    [_word_ids(meng.tokenizer, n) for n in (33, 100, 250, 500)],
                                    SERVE_STEPS)
    one = meng.runner(SERVE_SLOTS).launches_per_replay()
    expect(one == _batch_launches(meng), f"mixtral batched step: launches per replay {one}")
    out["mixtral"]["step_ms"] = _step_ms(meng, range(SERVE_SLOTS),
                                         _word_ids(meng.tokenizer, 64))
    torch.cuda.synchronize()
    got = read_launches()
    expect(got["qmm_stack"] > 0 and got["qmm_gather"] > 0, f"server-mixtral: launches {got}")
    log(f"[server-mixtral] 4 layers, {SERVE_SLOTS} slots: launches per replay {one}; "
        f"{out['mixtral']['step_ms']:.3f} ms a step; launches {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    del meng, msingle
    gc.collect()
    torch.cuda.empty_cache()
    KEPT[("mixtral-8x7b", "Q4_K_M", 4, "spm")] = mpath  # the mixtral phase serves it again

    reset_launches()
    rc, text, err, secs = run_tool(batched_bench.main, ["-m", str(path), "-npp", "128",
                                                        "-ntg", "64", "-npl", "1,2,4,8",
                                                        "-c", "2048", "-o", "json"])
    expect(rc == 0, f"batched-bench rc {rc}: {err[-300:]}")
    out["batched_bench"] = json.loads(text)
    expect([r["b"] for r in out["batched_bench"]] == [1, 2, 4, 8], "batched-bench rows")
    for r in out["batched_bench"]:
        log(f"[server] batched-bench pp 128 tg 64 B {r['b']}: pp {r['pp_ts']} tok/s, tg "
            f"{r['tg_ts']} tok/s, total {r['total_ts']} tok/s")
    log(f"[server] batched-bench {secs:.1f} s")
    got = read_launches()
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return out


# the verify shapes: single-stream verification at the cli's --draft-max 5
# (6 tokens in the prefill bucket of VERIFY_T rows) deep in the context, and
# a batched verify of SERVE_SLOTS slots × VERIFY_ROWS (the server's
# --draft-max 8 + 1) with an idle slot and a slot at the start of its cache
VERIFY_T = 8
VERIFY_OFFSET = 2500
VERIFY_ROWS = 9
VERIFY_OFFSETS = (-1, 0, 2500, 100)
SPEC_DRAFT = 5  # the cli's --draft-max default
SPEC_SERVER_DRAFT = 8  # the server's --draft-max default
SPEC_TOKENS = 128  # greedy tokens of each single-stream run
SPEC_PROMPT = 256  # word tokens of its prompt (the words repeat: n-grams recur)
SPEC_TIMED = 20  # calls a replay timing
# the server's requests: (prompt words, max_tokens), sent at once, greedy
SPEC_REQUESTS = ((31, 128), (120, 128), (300, 96), (700, 64))


def phase_verify_kernels(dev, results: dict, verify: dict):
    """The kernels at the shapes speculative verification gives them, each
    against its plain version: flash at B = 1 and offset VERIFY_OFFSET for
    T = 1 and 4 (the decode regime: 4 × 32/8 = 16 query rows a KV head)
    and T = VERIFY_T (the prefill regime), and at B = SERVE_SLOTS, T =
    VERIFY_ROWS with offsets VERIFY_OFFSETS (an idle slot: its rows exactly
    0), bf16 and q8 caches, the 8B's heads, S = 4096; qmm at M = VERIFY_T
    and VERIFY_ROWS (CUDA cores) and qmm_tc at M = SERVE_SLOTS ×
    VERIFY_ROWS for the 8B's Q4_K gate_up and Q6_K down. Rows go to
    `results` (the kernels line's errors) and to `verify` by kernel."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    gen = torch.Generator(dev).manual_seed(13)
    for fmt, key in zip(("bf16", "q8"), ("flash_bf16", "flash_q8")):
        bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
        for T, offsets in ((1, (VERIFY_OFFSET,)), (4, (VERIFY_OFFSET,)),
                           (VERIFY_T, (VERIFY_OFFSET,)), (VERIFY_ROWS, VERIFY_OFFSETS)):
            row = _flash_case(dev, gen, fmt=fmt, B=len(offsets), T=T, H=32, Hkv=8, D=128,
                              S=4096, offsets=offsets, timed=True)
            row["case"] = f"{fmt} T={T} B={len(offsets)} offsets {list(offsets)} S=4096 (verify)"
            expect(row["finite"] and row["idle_zero"], f"flash {row['case']}: finite, idle rows 0")
            expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                   f"flash {row['case']} NMSE {row['nmse']:.3e}, own order "
                   f"{row['nmse_own_order']:.3e} <= {bound}")
            results[key].append(row)
            verify.setdefault(key, []).append(row)
            log(f"[verify] {key} {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} (own "
                f"order {row['nmse_own_order']:.2e}), kernel {row['ms']:.4f} ms bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain {row['plain_ms']:.3f} ms "
                f"sdpa {row['library_ms']:.4f} ms")
    for fmt, name, K, N in (("Q4_K", "gate_up", 4096, 28672), ("Q6_K", "down", 14336, 4096)):
        gtype, key = GGMLType[fmt], QMM_KEYS[fmt]
        planes = _random_planes(gtype, N, K, gen, dev)
        plane_b = sum(t.numel() * t.element_size() for t in planes.values())
        w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
        for M in (VERIFY_T, VERIFY_ROWS, SERVE_SLOTS * VERIFY_ROWS):
            tc = M >= qmm.TC_MIN_M
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            row = _held_row("verify", "qmm_tc" if tc else key, f"{fmt} {name} M={M} (verify)",
                            lambda x=x: qmm.qmm(x, planes, gtype, N, K),
                            lambda x=x: qmm.qmm_reference(x, planes, gtype, N, K),
                            lambda x=x: torch.matmul(x, w_lib),
                            M * K * 2 + plane_b + M * N * 2, 2.0 * M * K * N, 20)
            results["qmm_tc" if tc else key].append(row)
            verify.setdefault("qmm_tc" if tc else key, []).append(row)
        del planes, w_lib, x
    torch.cuda.empty_cache()


# Qwen3-30B-A3B's experts: 128 of them, gate and up 2048 → 768, down 768 → 2048
QWEN_EXPERTS = 128
QWEN_EXPERT_SHAPES = (("Q4_K", "gate", 2048, 768), ("Q6_K", "down", 768, 2048))
QWEN_GATHER_TOKENS = (1, 4, 16)  # tokens whose top-8 the gather takes: T = 8, 32, 128 rows
QWEN_TOP_K = 8
# the GQA shapes of the Qwen phase: Qwen3-30B-A3B's 32 heads over 4 (a group of 8) and
# Qwen2.5-7B's 28 over 4 (a group of 7: decode rows T·7 cross DECODE_ROWS at T = 3)
QWEN_HEADS = ((32, 4), (28, 4))
# the Qwen 2-D linears at their Q4_K_M types (fused as the loader fuses them
# where the types agree): Qwen2.5-7B's at K = 3584 (14 chunks of 256) and
# its down at K = 18944 (74 chunks: split unevenly below 16 rows; Q6_K or
# Q4_K by layer), its head; Qwen3-30B-A3B's fused qkv, wo and head
QWEN_QMM_SHAPES = (("Q4_K", "qwen2.5-7b qkv", 3584, 4608), ("Q4_K", "qwen2.5-7b wo", 3584, 3584),
                   ("Q4_K", "qwen2.5-7b gate_up", 3584, 37888),
                   ("Q6_K", "qwen2.5-7b down", 18944, 3584),
                   ("Q4_K", "qwen2.5-7b down", 18944, 3584),
                   ("Q6_K", "qwen2.5-7b head", 3584, 152064),
                   ("Q4_K", "qwen3-30b-a3b qkv", 2048, 5120),
                   ("Q4_K", "qwen3-30b-a3b wo", 4096, 2048),
                   ("Q6_K", "qwen3-30b-a3b head", 2048, 151936))
QWEN_QMM_ROWS = (1, 512)


def qmm_at_shapes(tag: str, dev, gen, shapes, rows_m, results: dict, out: dict):
    """qmm at each (format, name, K, N) of `shapes` and M in `rows_m` (the
    CUDA-core kernel below 16 rows, the tensor-core kernel from 16; one
    launch of the regime's counter a call, its K split logged), against its
    plain version and timed beside its bound and torch.matmul on the planes
    dequantized to bf16; rows go to `results` and `out` by kernel."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for fmt, name, K, N in shapes:
        gtype = GGMLType[fmt]
        planes = _random_planes(gtype, N, K, gen, dev)
        plane_b = sum(t.numel() * t.element_size() for t in planes.values())
        w_lib = qmatmul.dequant_planes(planes, gtype, N, K, dtype=torch.bfloat16)
        for M in rows_m:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            tc = M >= qmm.TC_MIN_M
            tm, split, per = (qmm.plan if tc else qmm.gemv_plan)(M, K, N, n_sm)
            before = (qmm.LAUNCHES[fmt], qmm.TC_LAUNCHES[fmt])
            qmm.qmm(x, planes, gtype, N, K)
            torch.cuda.synchronize()
            expect((qmm.LAUNCHES[fmt], qmm.TC_LAUNCHES[fmt])
                   == (before[0] + (not tc), before[1] + tc),
                   f"qmm {fmt} {name} M={M}: one launch of the {'tensor' if tc else 'CUDA'}-core "
                   "kernel")
            key = "qmm_tc" if tc else QMM_KEYS[fmt]
            row = _held_row(
                tag, key, f"{fmt} {name} K={K} N={N} M={M} (K split {split} × {per} chunks)",
                lambda: qmm.qmm(x, planes, gtype, N, K),
                lambda: qmm.qmm_reference(x, planes, gtype, N, K),
                lambda: torch.matmul(x, w_lib),
                M * K * 2 + plane_b + M * N * 2, 2.0 * M * K * N, 5 if tc else 20)
            results.setdefault(key, []).append(row)
            out.setdefault(key, []).append(row)
        del planes, w_lib, x
        torch.cuda.empty_cache()


def phase_qwen_kernels(dev, results: dict, qwen: dict):
    """The kernels at the Qwen shapes, each against its plain version and
    timed as in phase 3: qmm_gather over QWEN_EXPERTS experts (Q4_K gate
    2048 → 768, Q6_K down 768 → 2048) at 1, 4 and 16 tokens' top-8 (T = 8,
    32 and 128 rows: the bit-set path of csrc/qmm_moe.cu, past 32 experts),
    and ids outside 0..E-1 giving NaN rows; qmm_stack over the 128 experts
    at M = 512 (the gate on a shared x, the down on each expert's own x);
    qmm at QWEN_QMM_SHAPES, M in QWEN_QMM_ROWS (the CUDA-core kernel at 1,
    the tensor-core kernel at 512; one launch of the regime's counter a
    call, its K split logged);
    flash at D = 128 with H / Hkv of QWEN_HEADS, bf16 and q8 caches: the
    decode regime at T = 1 (B = 2, kv 38 / 3001), the prefill regime at T =
    512 (offsets 0 / 2500), and for the group of 7 T = 2 (14 rows: decode)
    and T = 3 (21 rows: prefill) at offset 2500. Rows go to `results` (the
    kernels line's errors) and to `qwen` by kernel."""
    import torch

    gen = torch.Generator(dev).manual_seed(16)
    qmm_at_shapes("qwen", dev, gen, QWEN_QMM_SHAPES, QWEN_QMM_ROWS, results, qwen)
    expert_rows("qwen", dev, gen, QWEN_EXPERTS, QWEN_TOP_K,
                [(fmt, name, K, N, name == "gate") for fmt, name, K, N in QWEN_EXPERT_SHAPES],
                QWEN_GATHER_TOKENS, results, qwen, invalid_ids=True)
    flash_at_heads("qwen", dev, gen, QWEN_HEADS, results, qwen)


def expert_rows(tag: str, dev, gen, E: int, top_k: int, shapes, gather_tokens, results: dict,
                out: dict, invalid_ids: bool = False):
    """The expert kernels over E experts at each (format, name, K, N,
    shared) of `shapes`, against their plain versions and timed beside
    their bounds and a library call: qmm_gather at each count of
    `gather_tokens` tokens' top_k (distinct experts a token: T = tokens ·
    top_k rows; past 32 experts the bit-set path of csrc/qmm_moe.cu), and
    with `invalid_ids` ids outside 0..E-1 giving NaN rows; qmm_stack at M =
    512 on a shared x (ops/moe.py feeds the gate and up one x) or on each
    expert's own (the down, and every projection of weight_before_ffn).
    Rows go to `results` and `out` by kernel."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops import qmatmul
    from tpullm_torch.ops.kernels import qmm

    M = 512
    for fmt, name, K, N, shared in shapes:
        gtype = GGMLType[fmt]
        planes = _random_stack(gtype, N, K, gen, dev, n_expert=E)
        expert_b = sum(t.numel() * t.element_size() for t in planes.values()) / E
        w_lib = torch.stack([qmatmul.dequant_planes({k: v[e] for k, v in planes.items()},
                                                    gtype, N, K, dtype=torch.bfloat16)
                             for e in range(E)])  # [E, K, N]
        rows = []
        for n_tok in gather_tokens:
            T = n_tok * top_k  # each token's top-k: distinct experts
            x = torch.randn(T, K, generator=gen, device=dev).to(torch.bfloat16)
            ids = torch.stack([torch.randperm(E, generator=gen, device=dev)[:top_k]
                               for _ in range(n_tok)]).reshape(T).int()
            n_unique = int(torch.unique(ids).numel())
            rows.append(("qmm_gather", _held_row(
                tag, "qmm_gather",
                f"{fmt} {name} E={E} T={T} ({n_tok} tokens × top-{top_k})",
                lambda x=x, ids=ids: qmm.qmm_gather(x, ids, planes, gtype, N, K),
                lambda x=x, ids=ids: qmm.qmm_gather_reference(x, ids, planes, gtype, N, K),
                lambda x=x, ids=ids: torch.bmm(x[:, None, :], w_lib[ids.long()])[:, 0],
                x.numel() * 2 + T * 4 + n_unique * expert_b + T * N * 2, 2.0 * T * K * N,
                20 if T < 128 else 5)))
        if invalid_ids:
            x = torch.randn(40, K, generator=gen, device=dev).to(torch.bfloat16)
            ids = torch.randint(0, E, (40,), generator=gen, device=dev, dtype=torch.int32)
            ids[3], ids[17] = E, -1
            valid = (ids >= 0) & (ids < E)
            got = qmm.qmm_gather(x, ids, planes, gtype, N, K)
            ref = qmm.qmm_gather_reference(x[valid], ids[valid], planes, gtype, N, K)
            torch.cuda.synchronize()
            err = nmse(got[valid].float(), ref.float())
            expect(bool(torch.isnan(got[~valid].float()).all()),
                   f"qmm_gather {fmt} {name} E={E}: NaN rows for ids outside the stack")
            expect(err <= QMM_NMSE_BOUND, f"qmm_gather {fmt} {name} E={E} beside invalid ids: "
                   f"NMSE {err:.3e} <= {QMM_NMSE_BOUND}")
            log(f"[{tag}] qmm_gather {fmt} {name} E={E} T=40, ids {E} and -1 at rows 3, 17: "
                f"NaN rows; the others nmse {err:.2e}")
        x = torch.randn(*((M, K) if shared else (E, M, K)), generator=gen,
                        device=dev).to(torch.bfloat16)
        rows.append(("qmm_stack", _held_row(
            tag, "qmm_stack", f"{fmt} {name} E={E} M={M} {'shared' if shared else 'batched'}",
            lambda: qmm.qmm_stack(x, planes, gtype, N, K),
            lambda: qmm.qmm_stack_reference(x, planes, gtype, N, K),
            lambda: torch.matmul(x, w_lib),
            x.numel() * 2 + E * expert_b + E * M * N * 2, 2.0 * E * M * K * N, 3)))
        for key, row in rows:
            results[key].append(row)
            out.setdefault(key, []).append(row)
        del planes, w_lib, x
        torch.cuda.empty_cache()


def flash_at_heads(tag: str, dev, gen, heads, results: dict, out: dict):
    """Flash at D = 128 with each (H, Hkv) of `heads`, bf16 and q8 caches,
    against its plain version and timed beside its bound and SDPA: the
    decode regime at T = 1 (B = 2, kv 38 / 3001), the prefill regime at T
    = 512 (offsets 0 / 2500), and for a group of 7 T = 2 (14 rows: decode)
    and T = 3 (21 rows: prefill) at offset 2500. Rows go to `results` and
    `out` by kernel."""
    import torch

    for H, Hkv in heads:
        for fmt, key in (("bf16", "flash_bf16"), ("q8", "flash_q8")):
            bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
            cases = [(1, (37, 3000)), (512, (0, 2500))]
            if H // Hkv == 7:
                cases += [(2, (2500,)), (3, (2500,))]
            for T, offsets in cases:
                row = _flash_case(dev, gen, fmt=fmt, B=len(offsets), T=T, H=H, Hkv=Hkv, D=128,
                                  S=4096, offsets=offsets, timed=True)
                row["case"] = f"{fmt} T={T} B={len(offsets)} H={H}/{Hkv} offsets {list(offsets)}"
                expect(row["finite"], f"flash {row['case']}: finite")
                expect(row["regime"] == ("decode" if T * H // Hkv <= 16 else "prefill"),
                       f"flash {row['case']}: the {row['regime']} regime")
                expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                       f"flash {row['case']} NMSE {row['nmse']:.3e}, own order "
                       f"{row['nmse_own_order']:.3e} <= {bound}")
                results[key].append(row)
                out.setdefault(key, []).append(row)
                log(f"[{tag}] {key} {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} "
                    f"(own order {row['nmse_own_order']:.2e}) kernel {row['ms']:.4f} ms bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain {row['plain_ms']:.3f} "
                    f"ms sdpa {row['library_ms']:.4f} ms")
    torch.cuda.empty_cache()


# the MoE families' shapes (the moe families phase): the 2-D linears at their
# Q4_K_M types (q|k|v fused where the types agree): OLMoE-1B-7B's (K = 2048),
# Phi-3.5-MoE's (K = 4096), Llama-4-Scout's (K = 5120; its shared expert's
# gate and up, K = 8192 its down) and each head
MOE_FAMILY_QMM_SHAPES = (
    ("Q4_K", "olmoe-1b-7b q|k|v", 2048, 6144), ("Q4_K", "olmoe-1b-7b wo", 2048, 2048),
    ("Q6_K", "olmoe-1b-7b head", 2048, 50304),
    ("Q4_K", "phi-3.5-moe q|k|v", 4096, 6144), ("Q4_K", "phi-3.5-moe wo", 4096, 4096),
    ("Q6_K", "phi-3.5-moe head", 4096, 32064),
    ("Q4_K", "llama-4-scout q|k|v", 5120, 7168), ("Q4_K", "llama-4-scout wo", 5120, 5120),
    ("Q4_K", "llama-4-scout shexp gate", 5120, 8192),
    ("Q4_K", "llama-4-scout shexp down", 8192, 5120),
    ("Q6_K", "llama-4-scout head", 5120, 202048))
MOE_FAMILY_QMM_ROWS = (1, 512)
# (E, top-k, shapes (format, name, K, N, shared x), gather tokens): OLMoE's 64
# experts of 1024 (T = 8 and 128 rows of the gather's bit-set path), Scout's 16
# of 8192 at top-1 (T = 1 and 16; every projection on each expert's own
# scaled x at prefill: weight_before_ffn)
MOE_FAMILY_EXPERTS = (
    (64, 8, (("Q4_K", "olmoe gate", 2048, 1024, True), ("Q4_K", "olmoe down", 1024, 2048, False)),
     (1, 16)),
    (16, 1, (("Q4_K", "scout gate", 5120, 8192, False),), (1, 16)))
# the heads of the three at D = 128: OLMoE's 16 on 16 (R = 1), Phi-3.5-MoE's 32
# on 8 (R = 4), Scout's 40 on 8 (R = 5)
MOE_FAMILY_HEADS = ((16, 16), (32, 8), (40, 8))


def phase_moe_family_kernels(dev, results: dict, fam: dict):
    """The kernels at the MoE families' shapes, each against its plain
    version and timed beside its bound and library call: qmm at
    MOE_FAMILY_QMM_SHAPES (M = 1 on CUDA cores, 512 on the tensor cores),
    the gather and the stack at MOE_FAMILY_EXPERTS, flash at
    MOE_FAMILY_HEADS. Rows go to `results` and to `fam` by kernel."""
    import torch

    gen = torch.Generator(dev).manual_seed(22)
    qmm_at_shapes("moe families", dev, gen, MOE_FAMILY_QMM_SHAPES, MOE_FAMILY_QMM_ROWS,
                  results, fam)
    for E, top_k, shapes, tokens in MOE_FAMILY_EXPERTS:
        expert_rows("moe families", dev, gen, E, top_k, shapes, tokens, results, fam)
    flash_at_heads("moe families", dev, gen, MOE_FAMILY_HEADS, results, fam)


def verify_launches(eng, rows: int, T: int) -> dict:
    """The launches one verify forward of `rows` rows in all (T a slot)
    makes, by COUNT_NAMES: every 2-D qmm, the head on every row among
    them, on the tensor cores from TC_MIN_M rows and on CUDA cores below;
    each expert stack gathered up to the gather threshold; flash once a
    layer, in the regime T·H/Hkv picks."""
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import flash, qmm

    per = per_forward_launches(eng.params)
    tc = rows >= qmm.TC_MIN_M
    stack = rows > moe._GATHER_MAX_TOKENS
    decode = flash.regime(T, eng.hp.n_head, eng.hp.n_head_kv) == "decode"
    return {"qmm": 0 if tc else per["qmm"], "qmm_tc": per["qmm"] if tc else 0,
            "qmm_stack": per["experts"] if stack else 0,
            "qmm_gather": 0 if stack else per["experts"], "qmm_grouped": 0,
            "dequant_routes": 0, "flash": per["flash"],
            "flash_decode": per["flash"] if decode else 0,
            "attn_dense_routes": 0, "attn_ring_routes": 0}


def count_forwards(eng):
    """A context manager: the forwards `eng` runs in Python meanwhile (an
    eager step, or a graph's capture; a replay runs none), as a list of
    their token shapes."""
    import contextlib
    import dataclasses

    @contextlib.contextmanager
    def counting():
        calls, arch = [], eng.arch

        def forward(*a, **kw):
            calls.append(tuple(a[2].shape))
            return arch.forward(*a, **kw)

        eng.arch = dataclasses.replace(arch, forward=forward)
        try:
            yield calls
        finally:
            eng.arch = arch
    return counting()


def spec_teacher_forced(label: str, eng, prompt: list[int], out: list[int],
                        plain: list[int], k: int) -> dict:
    """The speculative run's ids `out` fed teacher-forced after `prompt`
    twice: a decode_step a token (the plain path's logits), and in verify
    forwards of k + 1 tokens (the speculative path's shape); every verify
    row held against its decode_step row within SERVE_NMSE_BOUND. Reports
    the rows whose argmax part, and the first position where `out` parts
    from the plain greedy ids `plain`, each with the decode_step row's
    top-2 margin."""
    eng.reset()
    first = eng.prefill(prompt)
    dec = [first] + [eng.decode_step(t) for t in out[:-1]]
    eng.reset()
    eng.prefill(prompt)
    ver = [first]
    for i in range(0, len(out) - 1, k + 1):
        ver.extend(eng.verify_logits(out[i:i + k + 1][: len(out) - 1 - i]))
    worst, parted = 0.0, []

    def margin(row):
        top2 = np.sort(row)[-2:]
        return float(top2[1] - top2[0])

    for step, (v, d) in enumerate(zip(ver, dec)):
        worst = max(worst, float(np.mean((v.astype(np.float64) - d) ** 2)
                                 / np.mean(d.astype(np.float64) ** 2)))
        if int(np.argmax(v)) != int(np.argmax(d)):
            parted.append(dict(step=step, margin=margin(d)))
    first_diff = next((i for i, (a, b) in enumerate(zip(out, plain)) if a != b), None)
    res = dict(worst_nmse=worst, rows=len(ver), parted=parted, ids_equal=out == plain,
               first_diff=first_diff,
               first_diff_margin=margin(dec[first_diff]) if first_diff is not None else None)
    log(f"[{label}] teacher-forced on the speculative ids: {len(ver)} verify rows against "
        f"decode_step's, worst NMSE {worst:.2e} (bound {SERVE_NMSE_BOUND}); argmax parted at "
        f"{parted}; ids equal to plain greedy: {out == plain}"
        + (f" (first parting at {first_diff}, top-2 margin {res['first_diff_margin']:.4g})"
           if first_diff is not None else ""))
    expect(worst <= SERVE_NMSE_BOUND, f"{label}: verify rows against decode_step's, NMSE "
           f"{worst:.3e} <= {SERVE_NMSE_BOUND}")
    return res


def _replay_ms(eng, prompt: list[int], k: int) -> dict:
    """At n_past = len(prompt): the verify graph of k + 1 tokens (its
    bucket) and the logits graph of one token, each as the host calls it
    (run(): inputs loaded, one replay; wall ms) and as a bare replay on the
    device (CUDA events around SPEC_TIMED replays)."""
    import torch

    eng.reset()
    eng.prefill(prompt)
    n = eng.n_past
    vr, lr = eng.verify_runner(eng._bucket(k + 1)), eng.logits_runner()
    seq = prompt[-(k + 1):]

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPEC_TIMED):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SPEC_TIMED

    def device(graph):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(SPEC_TIMED):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / SPEC_TIMED

    with torch.inference_mode():
        out = dict(verify_wall_ms=wall(lambda: vr.run(seq, n)),
                   decode_wall_ms=wall(lambda: lr.run(seq[0], n)))
        out.update(verify_device_ms=device(vr.graph), decode_device_ms=device(lr.graph),
                   verify_rows=vr.rows)
    eng.reset()
    return out


def _spec_run(label: str, eng, spec, prompt: list[int], plain: list[int], plain_s: float,
              draft=None) -> dict:
    """One timed generate_speculative of SPEC_TOKENS greedy tokens (its
    graphs captured by a warm-up run before): ids against the plain greedy
    ids (teacher-forced where they part), the verify rounds as replays of
    the target's verify graph (one forward's launches each), no eager
    forward on the target but its prompt's, none on the draft but its
    prompt's and its graphs' first runs."""
    import contextlib

    import torch

    from tpullm_torch.runtime.speculative import generate_speculative

    eng.reset()
    replays = {r: v.replays for r, v in eng._verify_runners.items()}
    d_runners = (len(draft._runners) + len(draft._verify_runners)
                 + (draft._logits_runner is not None)) if draft is not None else 0
    with count_forwards(eng) as t_fw, (count_forwards(draft) if draft is not None
                                       else contextlib.nullcontext([])) as d_fw:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = generate_speculative(eng, spec, prompt, SPEC_TOKENS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    new = sum(r not in replays for r in eng._verify_runners)
    done = sum(v.replays - replays.get(r, 0) for r, v in eng._verify_runners.items()) + new
    expect(st.n_rounds - 1 <= done <= st.n_rounds,
           f"{label}: {done} verify forwards for {st.n_rounds} rounds")
    expect(len(t_fw) <= 1 + 2 * new,
           f"{label}: the target's forwards in Python {len(t_fw)} (its prompt, and the first "
           f"run and capture of {new} new verify graphs)")
    if draft is not None:
        d_new = (len(draft._runners) + len(draft._verify_runners)
                 + (draft._logits_runner is not None)) - d_runners
        expect(len(d_fw) <= 1 + 2 * d_new,
               f"{label}: the draft's forwards in Python {len(d_fw)} (its prompt, and the first "
               f"run and capture of {d_new} new graphs) over {st.n_rounds} rounds")
    for rows, r in eng._verify_runners.items():
        want = verify_launches(eng, rows, rows)
        expect(r.graph is not None and r.launches_per_replay() == want,
               f"{label}: verify graph of {rows} rows launches {r.launches_per_replay()} a "
               f"replay = one forward's {want}")
    tf = spec_teacher_forced(label, eng, prompt, out, plain, spec.n_draft)
    res = dict(rounds=st.n_rounds, drafted=st.n_drafted, accepted=st.n_accepted,
               accept_rate=st.accept_rate, generated=len(out), seconds=secs,
               tok_s=len(out) / secs, plain_tok_s=len(plain) / plain_s, teacher=tf,
               target_python_forwards=len(t_fw),
               draft_python_forwards=len(d_fw) if draft is not None else None)
    log(f"[{label}] {st.n_rounds} rounds, {st.n_drafted} drafted, {st.n_accepted} accepted "
        f"(acceptance {st.accept_rate:.3f}), {len(out)} tokens: {res['tok_s']:.1f} tok/s against "
        f"{res['plain_tok_s']:.1f} for the plain graph decode (both with the {len(prompt)}-token "
        f"prompt's prefill); forwards run in Python: target {len(t_fw)}"
        + (f", draft {len(d_fw)}" if draft is not None else ""))
    return res


def _spec_burst(port: int, tok) -> list[dict]:
    """SPEC_REQUESTS sent at once (greedy completions), a thread a request."""
    import threading

    results: list = [None] * len(SPEC_REQUESTS)

    def send(i, words, n):
        try:
            results[i] = _http_request(port, "/v1/completions",
                                       {"prompt": _words(words), "max_tokens": n,
                                        "temperature": 0.0})
        except Exception as e:  # reported by the check below
            results[i] = {"error": repr(e)}

    threads = [threading.Thread(target=send, args=(i, *req))
               for i, req in enumerate(SPEC_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    expect(not any(t.is_alive() for t in threads), "every speculative request returned")
    for r in results:
        expect("error" not in r and r["status"] == 200, f"speculative request: {r}")
    return [dict(text=r["json"]["choices"][0]["text"],
                 n=r["json"]["usage"]["completion_tokens"], seconds=r["seconds"])
            for r in results]


def _metrics(port: int) -> dict:
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", "/metrics")
        text = c.getresponse().read().decode()
    finally:
        c.close()
    return {k: float(v) for k, v in (line.split() for line in text.splitlines()
                                     if line and not line.startswith("#"))}


def _verify_step_ms(eng, prompt: list[int]) -> dict:
    """Wall ms of a batched verify step (every slot, VERIFY_ROWS tokens,
    ids read back) against a batched greedy decode step, all slots at
    len(prompt)."""
    import torch

    for s in range(eng.n_slots):
        eng.free_slot(s)
    eng.prefill_slots({s: prompt for s in range(eng.n_slots)})
    seqs = {s: prompt[-VERIFY_ROWS:] for s in range(eng.n_slots)}

    def wall(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPEC_TIMED):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SPEC_TIMED

    def decode():
        eng.decode_batch_greedy({s: 5 for s in range(eng.n_slots)})
        for s in range(eng.n_slots):
            eng.n_past[s] -= 1

    return dict(verify_ms=wall(lambda: eng.verify_batch_greedy(seqs, VERIFY_ROWS)),
                decode_ms=wall(decode))


def phase_speculative(path: Path, tmp: Path, launches: dict) -> dict:
    """Speculative decoding on the 8B Q4_K_M (full depth; the slice's
    file): (a) generate_speculative with NgramSpeculator (--draft-max 5),
    greedy, SPEC_TOKENS tokens after a repetitive prompt of SPEC_PROMPT
    word tokens, bf16 and q8 caches: ids against the plain graph decode's,
    the verify rows teacher-forced against decode_step's, rounds, drafts,
    acceptance, ms a verify replay against a decode replay, tok/s against
    the plain graph decode; (b) the same with a draft Engine on the same
    file (acceptance ≥ 0.9); (c) tpullm-torch-server's app with 4 slots,
    plain, then --spec-type ngram_simple, then --draft-model (the same
    file), SPEC_REQUESTS at once: the same texts, the /metrics counters,
    each verify graph's launches a replay, one verify step's launches read
    around it, and a verify step's ms against a decode step's; (e)
    tpullm-torch-lookup create, stats and run."""
    import torch

    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.speculative import (DraftModelSpeculator, NgramSpeculator,
                                                  generate_speculative)
    from tpullm_torch.server.api import make_app, serve
    from tpullm_torch.tools import lookup

    out: dict = {}
    torch.cuda.empty_cache()
    reset_launches()  # just before the main path
    # (a) and (b): single stream
    for kv in (torch.bfloat16, "q8_0"):
        kv_name = "bf16" if kv is torch.bfloat16 else "q8_0"
        label = f"spec-ngram {kv_name}"
        eng = Engine(path, max_seq=SERVE_CTX, kv_dtype=kv)
        prompt = _word_ids(eng.tokenizer, SPEC_PROMPT)
        eng.generate_tokens_device(prompt, 32)  # warm-up: the decode graph
        eng.reset()
        generate_speculative(eng, NgramSpeculator(n_draft=SPEC_DRAFT), prompt, 32)
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = eng.generate_tokens_device(prompt, SPEC_TOKENS)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        expect(len(plain) > 0, f"{label}: plain greedy ran {len(plain)} tokens")
        res = _spec_run(label, eng, NgramSpeculator(n_draft=SPEC_DRAFT), prompt, plain, plain_s)
        res.update(_replay_ms(eng, prompt, SPEC_DRAFT))
        log(f"[{label}] verify graph ({res['verify_rows']} rows) {res['verify_wall_ms']:.3f} ms a "
            f"run ({res['verify_device_ms']:.3f} ms a bare replay on the device) against the "
            f"logits graph's decode {res['decode_wall_ms']:.3f} ms ({res['decode_device_ms']:.3f}"
            f" ms): a verify costs {res['verify_device_ms'] / res['decode_device_ms']:.2f} "
            "decode steps")
        out[label] = res
        if kv_name == "bf16":
            label = "spec-draft bf16"
            draft = Engine(eng.model, max_seq=SERVE_CTX)  # the target's weights
            generate_speculative(eng, DraftModelSpeculator(draft, n_draft=SPEC_DRAFT), prompt, 32)
            draft.reset()
            res = _spec_run(label, eng, DraftModelSpeculator(draft, n_draft=SPEC_DRAFT), prompt,
                            plain, plain_s, draft=draft)
            expect(res["accept_rate"] >= 0.9,
                   f"{label}: the target as its own draft accepts {res['accept_rate']:.3f} >= 0.9")
            out[label] = res
            del draft
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # (c): the server
    texts = {}
    for mode, kw in (("plain", {}),
                     ("ngram_simple", dict(spec_type="ngram_simple", n_draft=SPEC_SERVER_DRAFT)),
                     ("draft", dict(draft_model_path=path, n_draft=SPEC_SERVER_DRAFT))):
        app, sched = make_app(path, n_slots=SERVE_SLOTS, max_seq=SERVE_CTX, prefill_chunk=512,
                              **kw)
        eng = sched.engine
        httpd = serve(app, "127.0.0.1", 0)
        try:
            sched.precompile(background=False)
            t0 = time.perf_counter()
            got = _spec_burst(httpd.server_address[1], eng.tokenizer)
            wall = time.perf_counter() - t0
            metrics = _metrics(httpd.server_address[1])
        finally:
            httpd.shutdown()
            httpd.server_close()
            sched.stop()
        expect(not sched._thread.is_alive(), f"server {mode}: the scheduler's thread stopped")
        texts[mode] = [r["text"] for r in got]
        gen = sum(r["n"] for r in got)
        res = dict(generated=gen, wall_s=wall, aggregate_tok_s=gen / wall,
                   drafted=sched.n_spec_drafted, accepted=sched.n_spec_accepted,
                   metrics={k: v for k, v in metrics.items() if "spec" in k})
        if mode != "plain":
            expect(metrics["tpullm_spec_tokens_drafted_total"] > 0
                   and metrics["tpullm_spec_tokens_accepted_total"] > 0
                   and metrics["tpullm_spec_accept_rate"] > 0,
                   f"server {mode}: /metrics spec counters {res['metrics']}")
            expect(texts[mode] == texts["plain"],
                   f"server {mode}: the texts of the plain scheduler")
            expect(len(eng._verify_runners) == SERVE_SLOTS
                   and all(r.graph is not None for r in eng._verify_runners.values()),
                   f"server {mode}: a verify graph captured a width, {list(eng._verify_runners)}")
            for (width, rows), r in sorted(eng._verify_runners.items()):
                want = verify_launches(eng, width * rows, rows)
                expect(r.launches_per_replay() == want,
                       f"server {mode}: verify graph ({width} slots × {rows} rows) launches "
                       f"{r.launches_per_replay()} a replay = one forward's {want}")
            res["verify_replays"] = {f"{w}x{r}": v.replays
                                     for (w, r), v in eng._verify_runners.items()}
            # one verify step's launches, read around it
            torch.cuda.synchronize()
            before = read_launches()
            eng.verify_step({s: [5] for s in range(SERVE_SLOTS)}, VERIFY_ROWS)
            torch.cuda.synchronize()
            after = read_launches()
            one = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
            want = verify_launches(eng, SERVE_SLOTS * VERIFY_ROWS, VERIFY_ROWS)
            cc = sum(one.get(k, 0) for k in QMM_KEYS.values())
            expect(one.get("qmm_tc", 0) == want["qmm_tc"] and cc == want["qmm"]
                   and one.get("flash_bf16", 0) == want["flash"]
                   and one.get("flash_bf16.decode", 0) == want["flash_decode"],
                   f"server {mode}: one verify step launched {one}, one forward's {want}")
            res["one_verify_step_launches"] = one
            if mode == "ngram_simple":
                res.update(_verify_step_ms(eng, _word_ids(eng.tokenizer, 128)))
                log(f"[spec-server] batched verify step, {SERVE_SLOTS} slots × {VERIFY_ROWS} rows "
                    f"(ids read back): {res['verify_ms']:.3f} ms against a batched greedy decode "
                    f"step's {res['decode_ms']:.3f} ms")
        out[f"server {mode}"] = res
        log(f"[spec-server] {mode}: {len(got)} requests, {gen} tokens in {wall:.2f} s "
            f"({gen / wall:.1f} tok/s in aggregate); drafted {sched.n_spec_drafted}, accepted "
            f"{sched.n_spec_accepted}; /metrics {res['metrics']}")
        del app, sched, eng
        gc.collect()
        torch.cuda.empty_cache()

    # (e): tpullm-torch-lookup
    corpus = tmp / "lookup_corpus.txt"
    corpus.write_text((ROOT / "SURVEY.md").read_text(encoding="utf-8")[:20000], encoding="utf-8")
    static = tmp / "lookup_static.npz"
    rc, text, err, secs = run_tool(lookup.main, ["create", "-m", str(path), "-f", str(corpus),
                                                 "-o", str(static)])
    expect(rc == 0 and "n-grams" in text and static.exists(), f"lookup create: {rc} {err[-300:]}")
    log(f"[lookup] create {secs:.1f}s: {text.strip()}")
    rc, text, err, _ = run_tool(lookup.main, ["stats", str(static)])
    expect(rc == 0 and "2-grams" in text, f"lookup stats: {rc} {text!r}")
    log(f"[lookup] stats: {' / '.join(text.strip().splitlines())}")
    rc, text, err, secs = run_tool(lookup.main, ["run", "-m", str(path), "-p", _words(64), "-n",
                                                 "64", "-c", "2048", "--static", str(static)])
    last = err.strip().splitlines()[-1] if err.strip() else ""
    expect(rc == 0 and text.strip() and last.startswith("n_drafted="),
           f"lookup run: {rc} {err[-300:]}")
    out["lookup"] = dict(run_seconds=secs, line=last)
    log(f"[lookup] run 64 tokens with the static cache, {secs:.1f}s with the load: {last}")

    torch.cuda.synchronize()
    got = read_launches()
    expect(got["qmm_tc"] > 0 and got["qmm_q4k"] > 0 and got["flash_bf16"] > 0
           and got["flash_q8"] > 0 and got["dequant_routes"] == 0
           and got["attn_dense_routes"] == 0, f"speculative: launches {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return out


# the Engine options on the 8B (the slice's file): context, prompts, tokens
OPT_CTX = 4096
OPT_PROMPT = 512  # word tokens before each option's greedy run
OPT_GEN = 64  # greedy tokens on the decode graph
OPT_TEACHER = 32  # positions teacher-forced, the logits graph against the eager step
OPT_NMSE_BOUND = 1e-3  # graph against eager (the same kernels; a captured step)
OPT_PROFILE_STEPS = 16  # decode replays profiled a run
# an option's logits against the plain engine's, teacher-forced on the
# option's ids: NMSE above it (graph against eager reads 0 on these paths)
OPT_ACTS_FLOOR = 1e-4
LORA_RANK = 16
LORA_STEMS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up", "ffn_down")
CVEC_STRENGTH = 0.5
SELF_EXTEND_N = 4
SELF_EXTEND_PROMPT = 2560
CVEC_PAIRS = (("I love this day, it is wonderful", "I hate this day, it is terrible"),
              ("She smiled with joy", "She frowned with anger"),
              ("What a delightful surprise", "What a dreadful surprise"),
              ("The team celebrated the win", "The team mourned the loss"))


def write_lora(path: Path, out: Path, seed: int = 5) -> dict:
    """A rank-LORA_RANK adapter on every LORA_STEMS projection of every
    layer of the GGUF at `path`, from `seed`: A ~ N(0, 1/n_in) (x A has unit
    rows), B ~ N(0, 0.5²/rank), alpha = rank (scale 1): each linear moves
    by ≈ 0.5 of a unit output (0.1 moved the logits by NMSE 5.3e-05 only)."""
    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.models.lora import save_lora_gguf

    rng = np.random.default_rng(seed)
    tensors = {}
    for name, info in GGUFReader(path).tensors.items():
        parts = name.split(".")
        if parts[0] == "blk" and parts[2] in LORA_STEMS:
            n_out, n_in = info.shape[1], info.shape[0]
            tensors[name] = (
                rng.standard_normal((LORA_RANK, n_in), dtype=np.float32) * n_in ** -0.5,
                rng.standard_normal((n_out, LORA_RANK), dtype=np.float32) * 0.5 / LORA_RANK ** 0.5)
    t0 = time.perf_counter()
    save_lora_gguf(out, tensors, alpha=float(LORA_RANK))
    return dict(tensors=len(tensors), mib=out.stat().st_size / 2**20, write_s=time.perf_counter() - t0)


def _eager_logits(eng, prompt: list[int], ids: list[int]) -> list:
    """_teacher_logits through the eager step (_decode_logits) in place of
    the logits graph."""
    import torch

    eng.reset()
    rows = [eng.prefill(prompt)]
    with torch.inference_mode():
        for t in ids[:-1]:
            tok = torch.tensor([t], dtype=torch.int64, device=eng.device)
            rows.append(eng._decode_logits(tok).float().cpu().numpy())
    return rows


def option_run(label: str, eng, prompt: list[int], profile: bool = False) -> tuple[dict, list]:
    """One Engine option on the 8B: a warm-up, then `prompt` and OPT_GEN
    greedy tokens on the decode graph (TTFT, decode tok/s, the card's peak
    GiB); the launches of a decode replay against one forward's
    (per_forward_launches); the logits teacher-forced on the first
    OPT_TEACHER ids through the logits graph against the eager step (NMSE ≤
    OPT_NMSE_BOUND, the same argmax, and the graph's argmax the decode
    graph's ids); with `profile`, OPT_PROFILE_STEPS replays of the decode
    graph profiled (device ms a token by kernel family, the 12 costliest
    kernels: where an option's extra time goes, against the slice phase's
    profile of the plain 8B). Returns the run and the graph's rows."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams

    eng.generate_tokens_device(prompt[:64], 8, stop_on_eog=False)  # the decode graph
    eng.reset()
    p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
    ids = eng.generate_tokens_device(prompt, OPT_GEN, stop_on_eog=False)
    torch.cuda.synchronize()
    ttft = (eng.perf.t_prefill_s - p0[0]) * 1e3
    rate = (eng.perf.n_decode - p0[2]) / (eng.perf.t_decode_s - p0[1])
    one = eng.decode_runner(SamplingParams(), 32).launches_per_replay()
    per = per_forward_launches(eng.params)
    expect(len(ids) == OPT_GEN and one.get("qmm") == per["qmm"] and one.get("qmm_tc", 0) == 0
           and one.get("flash") == per["flash"] == one.get("flash_decode")
           and not one.get("dequant_routes") and not one.get("attn_dense_routes"),
           f"{label}: a decode replay's launches {one}, one forward's {per}")
    t_ids = ids[:OPT_TEACHER]
    graph = _teacher_logits(eng, prompt, t_ids)
    eager = _eager_logits(eng, prompt, t_ids)
    errs = [_nmse_np(a, b) for a, b in zip(graph, eager)]
    same = sum(int(np.argmax(a) == np.argmax(b)) for a, b in zip(graph, eager))
    expect(max(errs) <= OPT_NMSE_BOUND and same == len(graph),
           f"{label}: graph against eager NMSE {max(errs):.3e}, same argmax {same}/{len(graph)}")
    expect([int(np.argmax(r)) for r in graph] == t_ids,
           f"{label}: the logits graph's argmax are the decode graph's greedy ids")
    run = dict(load_s=eng.perf.t_load_s, ttft_ms=ttft, decode_tok_s=rate,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches_per_decode=one,
               graph_vs_eager_nmse=max(errs), same_argmax=same, positions=len(graph),
               teacher_ids=t_ids, report=eng.report())
    log(f"[options] {label}: engine made in {eng.perf.t_load_s:.2f}s; {len(prompt)}-token prompt, "
        f"TTFT {ttft:.1f} ms, {OPT_GEN} greedy tokens at {rate:.2f} tok/s on the decode graph; "
        f"peak {run['peak_gib']:.2f} GiB; launches a decode replay {one}; teacher-forced "
        f"{len(graph)} positions, graph against eager NMSE worst {max(errs):.2e} (bound "
        f"{OPT_NMSE_BOUND}), same argmax {same}/{len(graph)}; {eng.report()}")
    if profile:
        prof = profile_decode(eng, eng.decode_runner(SamplingParams(), 32), prompt,
                              OPT_PROFILE_STEPS, n_top=12)
        run.update(device_ms_per_token=prof["device_ms_per_token"],
                   event_span_ms_per_token=prof["event_span_ms_per_token"],
                   top_kernels=prof["top"])
        log(f"[options] {label}: a profiled decode token (the graph, {OPT_PROFILE_STEPS} "
            f"replays): device ms by family "
            f"{ {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} }, CUDA-event "
            f"span {prof['event_span_ms_per_token']:.4f} ms; costliest kernels {prof['top']}")
    return run, graph


def residual_rms(eng, toks: list[int]) -> list[float]:
    """The RMS of the residual stream after each layer of the llama graph
    over `toks` (a throwaway forward from slot 0; n_past 0 after)."""
    import torch

    from tpullm_torch.models import llama

    states: list = []
    eng.reset()
    with torch.inference_mode():
        llama.forward(eng.hp, eng.params, eng._padded(toks), eng._positions(0, len(toks)),
                      eng.cache, 0, return_hidden=True, layer_states=states)
        out = [float(x[0, :len(toks)].float().pow(2).mean().sqrt()) for x in states]
    eng.reset()
    return out


def _get_json(port: int, route: str):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", route)
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


class _EngineScheduler:
    """A stand-in scheduler for the HTTP app's read-only routes over one
    Engine (GET /lora-adapters reads `engine.lora_info`)."""

    def __init__(self, engine):
        self.engine = engine


def phase_engine_options(path: Path, tmp: Path, launches: dict) -> dict:
    """The Engine's options on the 8B Q4_K_M (the slice's file):
    1. tpullm-torch-cvector-generator's main() in this process (`run_tool`),
       CVEC_PAIRS (4 prompt pairs), --method pca:
       its file and seconds (a dense bf16 load of the 8B);
    2. one Model loaded unfused (load s, peak GiB) and shared by: an Engine
       with a synthetic LoRA adapter (write_lora: rank 16 on all 7
       projections of the 32 layers), an Engine with a synthetic control
       vector at CVEC_STRENGTH, an Engine with the generated vector (its
       logits finite), then a plain Engine, which fuses the Model (the
       adapter engines keep their unfused copies of its tree), and an
       Engine with grp_attn_n SELF_EXTEND_N on a SELF_EXTEND_PROMPT-token
       prompt: option_run each (the adapter's decode replay 7 qmm a layer
       plus the head, the plain one's the fused count); the adapter's, the
       vectors' and self-extend's logits against the plain engine's
       teacher-forced on the same ids (NMSE above OPT_ACTS_FLOOR: they
       act); self-extend's flash launches, of a decode replay and of its
       prompt's prefill, those of the plain engine;
    3. GET /lora-adapters on the HTTP app over the adapter's Engine;
    4. the cli with --grp-attn-n 4: 16 greedy tokens, the self-extend
       Engine's."""
    import torch

    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.model import Model
    from tpullm_torch.server.api import Server, serve
    from tpullm_torch.tools import cli, cvector
    from tpullm_torch.tools.cvector import save_control_vector

    out: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    # 1. the generator, its main() in this process (run_tool)
    pos, neg, gen_cv = tmp / "cv_pos.txt", tmp / "cv_neg.txt", tmp / "cv_generated.gguf"
    pos.write_text("\n".join(p for p, _ in CVEC_PAIRS) + "\n")
    neg.write_text("\n".join(n for _, n in CVEC_PAIRS) + "\n")
    rc, text, err, secs = run_tool(cvector.main, [
        "-m", str(path), "--positive-file", str(pos), "--negative-file", str(neg), "-o",
        str(gen_cv), "--method", "pca"])
    out["cvector_generator"] = dict(rc=rc, seconds=secs, stdout=text.strip()[-300:])
    log(f"[options] tpullm-torch-cvector-generator ({len(CVEC_PAIRS)} pairs, pca): rc {rc} in "
        f"{secs:.1f}s: {text.strip()[-200:]} {err.strip()[-300:] if rc else ''}")
    expect(rc == 0 and gen_cv.exists() and "wrote" in text,
           "tpullm-torch-cvector-generator wrote its file")
    # the adapter and the synthetic vector
    ad = tmp / "lora-r16.gguf"
    out["adapter"] = write_lora(path, ad)
    log(f"[options] adapter {out['adapter']}")
    reset_launches()  # just before the main path
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(path)
    torch.cuda.synchronize()
    out["model"] = dict(load_s=time.perf_counter() - t0, fused=model.is_fused,
                        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
    log(f"[options] the 8B loaded unfused in {out['model']['load_s']:.1f}s, peak "
        f"{out['model']['peak_gib']:.2f} GiB above the baseline of {base / 2**30:.2f} GiB")
    prompt = _word_ids(model.tokenizer, OPT_PROMPT)
    rows = {}
    torch.cuda.reset_peak_memory_stats()
    lora_eng = Engine(model, max_seq=OPT_CTX, lora=[(str(ad), 1.0)])
    out["lora"], rows["lora"] = option_run("lora r16", lora_eng, prompt, profile=True)
    expect(out["lora"]["launches_per_decode"].get("qmm") == 7 * model.hp.n_layer + 1,
           "lora: 7 qmm a layer and the head a decode replay")
    httpd = serve(Server(_EngineScheduler(lora_eng)).app, "127.0.0.1", 0)
    try:
        status, body = _get_json(httpd.server_address[1], "/lora-adapters")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[options] GET /lora-adapters: {status} {body}")
    expect(status == 200 and body == [{"id": 0, "path": str(ad), "scale": 1.0}],
           f"/lora-adapters lists the adapter: {status} {body}")
    out["lora"]["route"] = body
    # the synthetic vector: a direction a layer of N(0, 1) components scaled
    # to 0.25 of the RMS of that layer's residual stream (the adapter
    # engine's, over 64 prompt tokens): at CVEC_STRENGTH it adds 0.125 of
    # the stream's RMS a component (the random 8B's stream is large: fixed
    # N(0, 1) and N(0, 8²) vectors vanish in its bf16 rounding)
    rms = residual_rms(lora_eng, prompt[:64])
    out["residual_rms"] = rms
    log(f"[options] residual stream RMS by layer (the adapter engine, 64 tokens): "
        f"{[round(r, 1) for r in rms]}")
    cv = save_control_vector(tmp / "cv_synthetic.gguf", 0.25 * np.asarray(rms, np.float32)[:, None]
                             * np.random.default_rng(6).standard_normal(
                                 (model.hp.n_layer, model.hp.n_embd), dtype=np.float32))
    torch.cuda.reset_peak_memory_stats()
    cvec_eng = Engine(model, max_seq=OPT_CTX, control_vectors=[(str(cv), CVEC_STRENGTH)])
    out["cvec"], rows["cvec"] = option_run(f"cvec ×{CVEC_STRENGTH}", cvec_eng, prompt)
    gen_eng = Engine(model, max_seq=1024, control_vectors=[(str(gen_cv), 1.0)])
    gen_logits = gen_eng.prefill(prompt)
    expect(np.isfinite(gen_logits).all(), "the generated control vector: finite logits")
    del gen_eng
    torch.cuda.reset_peak_memory_stats()
    plain = Engine(model, max_seq=OPT_CTX)
    expect(model.is_fused, "the plain engine fused the shared Model")
    out["plain"], _ = option_run("plain (fused)", plain, prompt)
    for name in ("lora", "cvec"):
        ids = out[name]["teacher_ids"]
        errs = [_nmse_np(a, b) for a, b in zip(rows[name], _teacher_logits(plain, prompt, ids))]
        out[name]["vs_plain_nmse"] = float(np.mean(errs))
        log(f"[options] {name} against the plain engine on its ids: NMSE mean "
            f"{np.mean(errs):.3e} (floor {OPT_ACTS_FLOOR}); first ids {ids[:8]}")
        expect(np.mean(errs) > OPT_ACTS_FLOOR, f"{name}: the option acts on the logits")
    del lora_eng, cvec_eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    se = Engine(model, max_seq=OPT_CTX, grp_attn_n=SELF_EXTEND_N)
    long = _word_ids(model.tokenizer, SELF_EXTEND_PROMPT)
    out["self_extend"], rows["se"] = option_run(f"self-extend {SELF_EXTEND_N}", se, long)
    ref = _teacher_logits(plain, long, out["self_extend"]["teacher_ids"])
    out["self_extend"]["vs_plain_nmse"] = float(np.mean([_nmse_np(a, b)
                                                         for a, b in zip(rows["se"], ref)]))
    expect(out["self_extend"]["vs_plain_nmse"] > OPT_ACTS_FLOOR, "self-extend acts on the logits")
    one_se, one_plain = out["self_extend"]["launches_per_decode"], out["plain"]["launches_per_decode"]
    pre = {}
    for name, e in (("self_extend", se), ("plain", plain)):
        e.reset()
        snap = _snapshot()
        e.prefill(long)
        torch.cuda.synchronize()
        pre[name] = _launch_delta(snap)
    log(f"[options] self-extend against plain: decode replay {one_se} / {one_plain}; the "
        f"{SELF_EXTEND_PROMPT}-token prefill {pre['self_extend']} / {pre['plain']}; logits "
        f"NMSE mean {out['self_extend']['vs_plain_nmse']:.3e}")
    expect(one_se == one_plain and pre["self_extend"] == pre["plain"]
           and pre["plain"]["flash"] == model.hp.n_layer,
           "self-extend: the flash (and every other) launches of the plain engine")
    out["self_extend"]["prefill_launches"] = pre["self_extend"]
    # 4. the cli
    argv = ["-m", str(path), "-p", TOOLS_PROMPT, "-n", "16", "--temp", "0", "-c", str(OPT_CTX),
            "--grp-attn-n", str(SELF_EXTEND_N), "--no-display-prompt"]
    rc, text, err, secs = run_tool(cli.main, argv)
    ids = se.tokenizer.tokenize(TOOLS_PROMPT, add_special=True, parse_special=True)
    se.reset()
    want = "".join(se.tokenizer.detokenize([t])
                   for t in se.generate_tokens_device(ids, 16, stop_on_eog=False))
    log(f"[options] tpullm-torch --grp-attn-n {SELF_EXTEND_N}: rc {rc} in {secs:.1f}s (its load "
        f"included): {text.strip()[:120]!r}; the engine's {want[:120]!r}")
    expect(rc == 0 and text.rstrip("\n") == want, "the cli with --grp-attn-n: the engine's text")
    out["cli"] = dict(rc=rc, seconds=secs, equal=text.rstrip("\n") == want)
    del se, plain, model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got = read_launches()  # just after the main path
    expect(got["qmm_tc"] > 0 and got["qmm_q4k"] > 0 and got["flash_bf16"] > 0
           and got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
           f"engine options: launches {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    for f in (ad, Path(cv), gen_cv):
        f.unlink()
    return out


# Gemma-3-4B (google/gemma-3-4b-it text_config) at Q4_K_M on the iSWA ring
GEMMA_CTX = 4096  # max_seq: the ring is R = round_up(1023 + 1024, 128) = 2048 slots
# Gemma-3-4B's depth on the card (of 34: the smoke's time): two of its six-layer
# patterns, the global layers 5 and 11
GEMMA_LAYERS = 12
GEMMA_LENS = (512, 2560)  # prompts; 2560 wraps the ring, its prefill three chunks of ≤ 1024
GEMMA_GEN = 64  # greedy tokens a prompt
GEMMA_RING = 2048
GEMMA_SLOTS = 4
# ring against swa_full, teacher-forced on the same ids over the 2560-token
# prompt and its 64 tokens: the ring's layers run attention_reference in
# f32, swa_full's the flash kernel (p to bf16 as two terms); both hold bf16
# K/V and round their outputs to bf16 alike
GEMMA_RING_NMSE_BOUND = 1e-3


def _nmse_np(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((got - ref) ** 2) / max(np.mean(ref * ref), 1e-300))


def _teacher_logits(eng, prompt: list[int], ids: list[int]) -> list:
    """Logits of `prompt`'s last row and of decode_step over ids[:-1] (the
    logits graph), teacher-forced: len(ids) rows."""
    eng.reset()
    rows = [eng.prefill(prompt)]
    for t in ids[:-1]:
        rows.append(eng.decode_step(t))
    return rows


def gemma_launch_want(eng, rows: int) -> dict:
    """One gemma forward's launches by COUNT_NAMES at `rows` rows (1: a
    decode step): every 2-D qmm of the layers (the tied head is a plain
    product), flash on the global layers (every layer without the ring) in
    the regime T·H/Hkv picks, the ring's layers through attention_ring."""
    from tpullm_torch.ops.kernels import flash, qmm

    per = per_forward_launches(eng.params)
    n_ring = sum(eng.hp.is_swa(i) for i in range(eng.hp.n_layer)) if eng.ring else 0
    n_flash = eng.hp.n_layer - n_ring
    tc = rows >= qmm.TC_MIN_M
    decode = flash.regime(rows, eng.hp.n_head, eng.hp.n_head_kv) == "decode"
    return {"qmm": 0 if tc else per["qmm_layers"], "qmm_tc": per["qmm_layers"] if tc else 0,
            "qmm_stack": 0, "qmm_gather": 0, "qmm_grouped": 0, "dequant_routes": 0,
            "flash": n_flash, "flash_decode": n_flash if decode else 0,
            "attn_dense_routes": 0, "attn_ring_routes": n_ring}


def _launch_delta(before: list) -> dict:
    """The launches since `before` (a snapshot of launch_counts()) by
    count_summary's names."""
    from tpullm_torch.runtime.graph import count_summary, launch_counts

    return count_summary([{k: c[k] - b[k] for k in c} for c, b in zip(launch_counts(), before)])


def _snapshot() -> list:
    from tpullm_torch.runtime.graph import launch_counts

    return [dict(c) for c in launch_counts()]


def embedding_peak(path: Path) -> dict:
    """The card's peak GiB above the baseline of load_embedding (row
    chunks of EMBEDDING_CHUNK_ROWS) on the model's tied table."""
    import torch

    from tpullm_torch.gguf.reader import GGUFReader
    from tpullm_torch.models.weights import EMBEDDING_CHUNK_ROWS, load_embedding

    info = GGUFReader(path).tensors["token_embd.weight"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    w = load_embedding(info, torch.device("cuda"))
    torch.cuda.synchronize()
    out = dict(peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
               table_gib=w.numel() * w.element_size() / 2**30, s=time.perf_counter() - t0)
    del w
    log(f"[gemma] embedding {info.ggml_type.name} {tuple(info.shape)}: peak above the "
        f"baseline {out['peak_gib']:.2f} GiB in chunks of {EMBEDDING_CHUNK_ROWS} rows (the "
        f"bf16 table {out['table_gib']:.2f} GiB) in {out['s']:.2f} s")
    return out


def _prefill_split(eng, toks: list[int]) -> tuple[float, list]:
    """A prefill of `toks` after a reset: its wall ms to the last row's
    logits on the host, and each forward's (rows, ms), the card
    synchronized around each."""
    import dataclasses

    import torch

    orig, split = eng.arch.forward, []

    def forward(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        split.append((a[2].shape[1], round((time.perf_counter() - t) * 1e3, 1)))
        return out

    eng.reset()
    eng.arch = dataclasses.replace(eng.arch, forward=forward)
    try:
        t0 = time.perf_counter()
        eng.prefill(toks)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng.arch = dataclasses.replace(eng.arch, forward=orig)
    return ms, split


def gemma_run(label: str, eng, word_ids) -> dict:
    """One cache kind of an Engine on Gemma-3-4B: a warm-up generation;
    each prompt of GEMMA_LENS prefilled twice, the first its chunk shapes'
    first run (cold), with each forward's ms; then each prompt and
    GEMMA_GEN greedy tokens (the decode graph), TTFT (warm) and decode
    tok/s; one prefill forward's and one decode replay's launches against
    gemma_launch_want; the ids of the 2560-token prompt's generation."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams

    before = _snapshot()
    eng.generate_tokens_device(word_ids(16), 8, stop_on_eog=False)
    out = dict(kv=label, ttft_ms={}, decode_tok_s={}, ids={}, prefill_ms={})
    for n in GEMMA_LENS:
        cold, warm = _prefill_split(eng, word_ids(n)), _prefill_split(eng, word_ids(n))
        out["prefill_ms"][n] = dict(cold=cold, warm=warm)
        log(f"[gemma] {label} prompt {n}: prefill cold {cold[0]:.1f} ms (forwards of rows, ms "
            f"{cold[1]}), warm {warm[0]:.1f} ms ({warm[1]})")
    for n in GEMMA_LENS:
        eng.reset()
        p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
        ids = eng.generate_tokens_device(word_ids(n), GEMMA_GEN, stop_on_eog=False)
        ttft = eng.perf.t_prefill_s - p0[0]
        rate = (eng.perf.n_decode - p0[2]) / (eng.perf.t_decode_s - p0[1])
        expect(len(ids) == GEMMA_GEN and all(0 <= t < eng.hp.n_vocab for t in ids),
               f"gemma {label}: {GEMMA_GEN} ids in range from the {n}-token prompt")
        out["ttft_ms"][n], out["decode_tok_s"][n], out["ids"][n] = ttft * 1e3, rate, ids
        log(f"[gemma] {label} prompt {n}: TTFT (warm) {ttft * 1e3:.1f} ms, decode {rate:.2f} tok/s "
            f"(graph), first ids {ids[:6]}")
    runner = eng.decode_runner(SamplingParams(), 32)
    one = runner.launches_per_replay()
    want = gemma_launch_want(eng, 1)
    log(f"[gemma] {label} launches per decode replay {one}")
    expect(one == want, f"gemma {label}: launches per decode replay {one} = {want}")
    eng.reset()
    snap = _snapshot()
    eng.prefill(word_ids(512))
    torch.cuda.synchronize()
    got = _launch_delta(snap)
    want = gemma_launch_want(eng, 512)
    log(f"[gemma] {label} launches of one 512-token prefill forward {got}")
    expect(got == want, f"gemma {label}: one prefill forward's launches {got} = {want}")
    out["launches_per_decode"], out["launches_per_prefill"] = one, got
    prof = profile_decode(eng, runner, word_ids(512), 32)
    out["device_ms_per_token"] = prof["device_ms_per_token"]
    out["event_span_ms_per_token"] = prof["event_span_ms_per_token"]
    log(f"[gemma] {label}: a decode token's device ms by family (32 graph replays after a "
        f"512-token prompt) { {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} } "
        f"(event span {prof['event_span_ms_per_token']:.3f} ms)")
    out["run_launches"] = _launch_delta(before)
    return out


# n-gram speculation on Gemma-3-4B's ring: drafts a round, tokens, and the
# speculative Scheduler's requests (prompt word tokens) and their tokens
GEMMA_SPEC_DRAFT = 4  # verify forwards of 5 tokens: the bucket of 8 rows
GEMMA_SPEC_TOKENS = 64
GEMMA_SPEC_LENS = (300, 900, 1700, 2300)
GEMMA_SPEC_GEN = 32
# a rejected draft then a decode against an engine that never saw the draft:
# the same forwards at the same offsets, the rejected rows masked
GEMMA_ROLLBACK_NMSE_BOUND = 1e-6


def _drain_ids(req, timeout: float = 600.0) -> list[int]:
    """A scheduler request's token ids, read from its event queue to its end."""
    toks = []
    while True:
        ev = req.out.get(timeout=timeout)
        if ev[0] != "token":
            return toks
        toks.append(ev[1])


class WrongDrafts:
    """A speculator that knows the target's greedy ids (`refs`: (prompt,
    ids) pairs) and drafts them with the second draft replaced by another
    id: a round of two drafts or more accepts the first and rejects the
    rest, so every round is a verify forward followed by a rollback. The
    context's prompt picks the reference; an unknown context drafts
    nothing."""

    def __init__(self, refs, k: int):
        self.refs = [(list(p), list(ids)) for p, ids in refs]
        self.k, self.ctx = k, []

    def resync(self, ctx):
        self.ctx = list(ctx)

    def propose(self, cur: int, max_tokens: int) -> list[int]:
        for prompt, ids in self.refs:
            if len(self.ctx) > len(prompt) and self.ctx[:len(prompt)] == prompt:
                g = len(self.ctx) - len(prompt)  # tokens generated; the last is `cur`
                out = ids[g:g + min(self.k, max_tokens)]
                if len(out) > 1:
                    out[1] = out[1] - 1 if out[1] else 1
                return out
        return []


class wrong_drafts_in_scheduler:
    """server/scheduler.py's speculator factory replaced, for a `with`
    block, by WrongDrafts over `refs`: the speculative Scheduler's slots
    then draft a wrong token every round."""

    def __init__(self, refs, k: int):
        self.refs, self.k = refs, k

    def __enter__(self):
        from tpullm_torch.server import scheduler

        self.before = scheduler.make_speculator
        scheduler.make_speculator = lambda *a, **kw: WrongDrafts(self.refs, self.k)

    def __exit__(self, *exc):
        from tpullm_torch.server import scheduler

        scheduler.make_speculator = self.before


def gemma_ring_speculation(eng, word_ids) -> dict:
    """n-gram speculation on the ring Engine (bf16, 2048 slots): a warm-up,
    then plain greedy decoding and generate_speculative, GEMMA_SPEC_TOKENS
    tokens each after the 2560-token prompt (it wraps the ring; its 11
    words repeat, so n-grams draft): the ids equal, the rounds, drafts and
    acceptance, tok/s of both (each with its prompt's prefill); the verify
    graph's launches a replay (flash on the global layers, attention_ring
    on the others) and its ms against a decode replay's; WrongDrafts on the
    same prompt (a rejection every round): the plain greedy ids, fewer
    drafts accepted than drafted; the verify rows
    teacher-forced on the speculative ids against a swa_full Engine's
    (NMSE ≤ GEMMA_RING_NMSE_BOUND); a rejected draft then a decode against
    an Engine that never saw the draft (NMSE ≤ GEMMA_ROLLBACK_NMSE_BOUND)."""
    import torch

    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.speculative import NgramSpeculator, generate_speculative

    k = GEMMA_SPEC_DRAFT
    prompt = word_ids(GEMMA_LENS[-1])
    eng.reset()
    generate_speculative(eng, NgramSpeculator(n_draft=k), word_ids(64), 16)  # warm-up
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = eng.generate_tokens_device(prompt, GEMMA_SPEC_TOKENS, stop_on_eog=False)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    eng.reset()
    before = _snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, st = generate_speculative(eng, NgramSpeculator(n_draft=k), prompt, GEMMA_SPEC_TOKENS,
                                   stop_on_eog=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run_launches = _launch_delta(before)
    first = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b), None)
    out = dict(rounds=st.n_rounds, drafted=st.n_drafted, accepted=st.n_accepted,
               accept_rate=st.accept_rate, generated=len(got), tok_s=len(got) / secs,
               plain_tok_s=len(plain) / plain_s, ids_equal=got == plain, first_diff=first,
               run_launches=run_launches)
    log(f"[gemma spec] ring bf16: {st.n_rounds} rounds, {st.n_drafted} drafted, "
        f"{st.n_accepted} accepted (acceptance {st.accept_rate:.3f}; random weights: the "
        f"acceptance is their loops'), {len(got)} tokens: {out['tok_s']:.1f} tok/s against "
        f"{out['plain_tok_s']:.1f} for plain greedy decoding (both with the "
        f"{len(prompt)}-token prompt's prefill); ids equal to plain greedy: {got == plain}"
        + (f" (first differ at {first})" if first is not None else "")
        + f"; the run's launches {run_launches}")
    expect(got == plain and len(got) == GEMMA_SPEC_TOKENS,
           f"gemma ring speculation: the plain greedy ids (first differ at {first})")
    expect(st.n_drafted > 0 and st.n_accepted > 0, "gemma ring speculation: drafts accepted")
    eng.reset()
    wrong, wst = generate_speculative(eng, WrongDrafts([(prompt, plain)], k), prompt,
                                      GEMMA_SPEC_TOKENS, stop_on_eog=False)
    out["wrong_drafts"] = dict(rounds=wst.n_rounds, drafted=wst.n_drafted,
                               accepted=wst.n_accepted, ids_equal=wrong == plain)
    log(f"[gemma spec] wrong drafts on the ring: {wst.n_rounds} rounds, {wst.n_drafted} "
        f"drafted, {wst.n_accepted} accepted (a rejection and a rollback every round); ids "
        f"equal to plain greedy: {wrong == plain}")
    expect(wrong == plain and 0 < wst.n_accepted < wst.n_drafted,
           f"gemma ring speculation with rejected drafts: the plain greedy ids "
           f"({wst.n_accepted} of {wst.n_drafted} accepted)")
    rows = eng._bucket(k + 1)
    vr = eng._verify_runners[rows]
    one, want = vr.launches_per_replay(), gemma_launch_want(eng, rows)
    log(f"[gemma spec] verify graph of {rows} rows: launches a replay {one} (flash on the "
        f"{one.get('flash')} global layers, attention_ring on {one.get('attn_ring_routes')})")
    expect(vr.graph is not None and one == want,
           f"gemma ring speculation: a verify replay's launches {one} = {want}")
    out["verify_launches"] = one
    out.update(_replay_ms(eng, prompt, k))
    log(f"[gemma spec] verify graph ({out['verify_rows']} rows) {out['verify_device_ms']:.3f} ms "
        f"a bare replay ({out['verify_wall_ms']:.3f} ms a run) against the logits graph's "
        f"{out['decode_device_ms']:.3f} ms ({out['decode_wall_ms']:.3f}): a verify costs "
        f"{out['verify_device_ms'] / out['decode_device_ms']:.2f} decode steps")

    full = Engine(eng.model, max_seq=GEMMA_CTX, swa_full=True)

    def verify_rows(e):
        e.reset()
        rows = [e.prefill(prompt)]
        for i in range(0, len(got) - 1, k + 1):
            rows.extend(e.verify_logits(got[i:min(i + k + 1, len(got) - 1)]))
        return rows

    errs = [_nmse_np(a, b) for a, b in zip(verify_rows(eng), verify_rows(full))]
    out["verify_vs_swa_full_nmse"] = max(errs)
    log(f"[gemma spec] the ring's verify rows against swa_full's, teacher-forced on the "
        f"{len(errs)} speculative positions: worst NMSE {max(errs):.2e} mean "
        f"{np.mean(errs):.2e} (bound {GEMMA_RING_NMSE_BOUND})")
    expect(max(errs) <= GEMMA_RING_NMSE_BOUND,
           f"gemma ring speculation: verify rows against swa_full NMSE {max(errs):.3e}")
    del full
    fresh = Engine(eng.model, max_seq=GEMMA_CTX)  # a second ring on the same weights
    for e in (eng, fresh):
        e.reset()
        e.prefill(prompt)
    drafts = [plain[0]] + [t for t in word_ids(8)[1:] if t != plain[1]][:k]
    eng.verify_ids(drafts)
    eng.n_past -= k  # the drafts rejected, the pending token kept
    fresh.verify_ids(drafts[:1])
    a, b = eng.decode_step(plain[1]), fresh.decode_step(plain[1])
    err, diff = _nmse_np(a, b), float(np.abs(a - b).max())
    out.update(rollback_nmse=err, rollback_max_abs=diff)
    log(f"[gemma spec] {k} drafts rejected on the ring, then a decode: against an engine that "
        f"never saw them NMSE {err:.2e}, max abs {diff:.3g} (bound "
        f"{GEMMA_ROLLBACK_NMSE_BOUND})")
    expect(err <= GEMMA_ROLLBACK_NMSE_BOUND and int(np.argmax(a)) == int(np.argmax(b)),
           f"gemma ring speculation: the decode after a rejected draft, NMSE {err:.3e}")
    del fresh
    eng.reset()
    return out


def gemma_spec_scheduler(be, word_ids) -> dict:
    """The 4-slot ring BatchEngine under the plain Scheduler and then the
    speculative one (spec_type ngram_simple, GEMMA_SPEC_DRAFT drafts), and
    the speculative one again with WrongDrafts (a rejection every round, so
    each batched verify on the ring is followed by rollbacks):
    GEMMA_SPEC_LENS requests at once, GEMMA_SPEC_GEN greedy tokens each;
    the ids equal, drafts and acceptance, the wall of each."""
    from tpullm_torch.runtime.sampling import SamplerParams
    from tpullm_torch.server.scheduler import GenRequest, Scheduler

    prompts = [word_ids(n) for n in GEMMA_SPEC_LENS]

    def run(sched):
        for s in range(be.n_slots):
            be.free_slot(s)
        reqs = [sched.submit(GenRequest(prompt_ids=p, max_tokens=GEMMA_SPEC_GEN,
                                        sampling=SamplerParams(temp=0.0))) for p in prompts]
        t0 = time.perf_counter()
        sched.start()
        try:
            ids = [_drain_ids(r) for r in reqs]
        finally:
            sched.stop()
        return ids, time.perf_counter() - t0

    plain, plain_s = run(Scheduler(be))
    spec = Scheduler(be, spec_type="ngram_simple", n_draft=GEMMA_SPEC_DRAFT)
    got, spec_s = run(spec)
    out = dict(ids_equal=got == plain, drafted=spec.n_spec_drafted,
               accepted=spec.n_spec_accepted, plain_s=plain_s, spec_s=spec_s,
               verify_graphs=sorted(f"{w}x{r}" for w, r in be._verify_runners))
    log(f"[gemma spec] the speculative Scheduler on the 4-slot ring BatchEngine: "
        f"{len(prompts)} requests of {GEMMA_SPEC_GEN} greedy tokens, drafted "
        f"{spec.n_spec_drafted}, accepted {spec.n_spec_accepted}, {spec_s:.2f} s against the "
        f"plain Scheduler's {plain_s:.2f} s; ids equal: {got == plain}; verify graphs "
        f"{out['verify_graphs']}")
    expect(got == plain and all(len(t) == GEMMA_SPEC_GEN for t in got),
           "gemma: the speculative Scheduler on the ring gives the plain Scheduler's ids")
    expect(spec.n_spec_drafted > 0 and spec.n_spec_accepted > 0,
           "gemma: the speculative Scheduler drafted and accepted")
    wrong = Scheduler(be, spec_type="ngram_simple", n_draft=GEMMA_SPEC_DRAFT)
    with wrong_drafts_in_scheduler(list(zip(prompts, plain)), GEMMA_SPEC_DRAFT):
        got_w, wrong_s = run(wrong)
    out["wrong_drafts"] = dict(ids_equal=got_w == plain, drafted=wrong.n_spec_drafted,
                               accepted=wrong.n_spec_accepted, spec_s=wrong_s)
    log(f"[gemma spec] the speculative Scheduler with wrong drafts: drafted "
        f"{wrong.n_spec_drafted}, accepted {wrong.n_spec_accepted}, {wrong_s:.2f} s; ids equal "
        f"to the plain Scheduler's: {got_w == plain}")
    expect(got_w == plain and 0 < wrong.n_spec_accepted < wrong.n_spec_drafted,
           f"gemma: the speculative Scheduler with rejected drafts gives the plain Scheduler's "
           f"ids ({wrong.n_spec_accepted} of {wrong.n_spec_drafted} accepted)")
    return out


def phase_gemma(tmp: Path, launches: dict) -> dict:
    """Gemma-3-4B Q4_K_M at full width with GEMMA_LAYERS = 12 of its 34 layers
    (head dim 256, 5 of 6 layers on a 1024-token window, vocab 262144, tied head),
    synthesized from seed 0:
    1. the tied Q6_K embedding's load peak in row chunks;
    2. Engine with the bf16 ring (R = 2048), with swa_full=True and with a
       q8 cache (the q8 cache keeps every layer in full, windows in flash):
       prompts of 512 and 2560 tokens (the longer wraps the ring; on the
       ring three prefill chunks), each prefilled cold and warm with its
       forwards' ms, then 64 greedy tokens each on the decode graph; TTFT
       (warm), decode tok/s; launches of a decode replay and of a
       prefill forward (the ring: flash on the global layers, attention_ring
       on the others; otherwise flash on every layer); a decode token's
       device time by family, attention_ring's share timed as its call at the decode shape; the ring engine also
       runs f16 and f32 rings (flash at D = 256 on every cache format);
    3. ring against swa_full, teacher-forced on the ring's greedy ids over
       the 2560-token prompt: logits NMSE ≤ GEMMA_RING_NMSE_BOUND; each
       run's greedy ids and where they part; each run teacher-forced
       against dense bf16 weights on the same cache kind, NMSE printed;
    4. a state file of the ring engine saved and restored (the ring and
       its slot positions), the continuation's logits equal;
    5. a BatchEngine of 4 slots on the ring (prefill chunk 512), its
       batched logits teacher-forced against Engine.decode_step, then a
       slot freed (its ring marked empty) and admitted again, then the
       speculative Scheduler on it (gemma_spec_scheduler);
    6. ring speculation on the bf16 ring Engine (gemma_ring_speculation)."""
    import torch

    from tpullm_torch.ops import attention
    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime import state
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import SWACache

    path = synthesize(tmp, "gemma", "gemma-3-4b", "Q4_K_M", n_layer=GEMMA_LAYERS)
    emb = embedding_peak(path)
    result = dict(embedding=emb, runs={})
    tf = {}
    reset_launches()  # just before the main path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(path, max_seq=GEMMA_CTX)
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    hp = eng.hp
    log(f"[gemma] {hp.arch}: {hp.n_layer} layers, n_embd {hp.n_embd}, heads {hp.n_head}/"
        f"{hp.n_head_kv} of {hp.head_dim}, window {hp.sliding_window} (global layers "
        f"{[i for i in range(hp.n_layer) if not hp.is_swa(i)]}), vocab {hp.n_vocab}; loaded "
        f"in {eng.perf.t_load_s:.1f}s, peak {load_peak:.2f} GiB")
    expect(isinstance(eng.cache, SWACache) and eng.cache.ring_len == GEMMA_RING
           and eng.prefill_cap == 1024, "gemma: the ring of 2048 slots, prefill chunks of 1024")

    def word_ids(n):
        return _word_ids(eng.tokenizer, n)

    prompt = word_ids(GEMMA_LENS[-1])
    run = gemma_run("ring bf16", eng, word_ids)
    run.update(load_s=eng.perf.t_load_s, load_peak_gib=load_peak)
    ids = run["ids"][GEMMA_LENS[-1]]
    tf["ring"] = _teacher_logits(eng, prompt, ids)
    # attention_ring's share of a decode token: its call at the decode shape
    g = torch.Generator("cuda").manual_seed(3)
    q = torch.randn(1, 1, hp.n_head, hp.head_dim, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(1, hp.n_head_kv, GEMMA_RING, hp.head_dim, generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    mask = torch.ones(1, 1, GEMMA_RING, dtype=torch.bool, device="cuda")
    ring_call = time_ms(lambda: attention.attention_reference(q, k, v, mask, 0.0625), 20)
    n_ring = sum(hp.is_swa(i) for i in range(hp.n_layer))
    run["attn_ring_ms_per_token"] = ring_call * n_ring
    log(f"[gemma] ring bf16: attention_ring at the decode shape (the full ring) "
        f"{ring_call:.4f} ms a call × {n_ring} = {ring_call * n_ring:.3f} ms of 'other'")
    # state file: the ring and its slot positions round trip
    eng.reset()
    sp = word_ids(512)
    eng.prefill(sp)
    f = tmp / "gemma-state.npz"
    t0 = time.perf_counter()
    state.save_state(eng, f, tokens=sp)
    want = [eng.decode_step(t) for t in (5, 6)]
    eng.reset()
    t1 = time.perf_counter()
    expect(state.load_state(eng, f) == sp and eng.n_past == 512, "gemma: the state restores")
    got = [eng.decode_step(t) for t in (5, 6)]
    err = max(_nmse_np(a, b) for a, b in zip(got, want))
    log(f"[gemma] state file of the ring engine ({f.stat().st_size / 2**20:.1f} MiB, saved in "
        f"{t1 - t0:.1f}s with two steps): the continuation after the restore NMSE {err:.2e}")
    expect(err <= 1e-10, f"gemma: the restored ring continues as saved (NMSE {err:.3e})")
    f.unlink()
    result["state_nmse"] = err
    result["speculation"] = gemma_ring_speculation(eng, word_ids)
    # the other cache formats on the ring: flash at D = 256 on f16 and f32
    for kv in ("f16", "f32"):
        eng.new_cache(kv_dtype=kv)
        eng.generate_tokens_device(word_ids(512), 16, stop_on_eog=False)
        log(f"[gemma] {kv} ring: 512-token prompt and 16 tokens; flash {kv} launches at D = 256 "
            f"{ {k: v for k, v in flash.LAUNCHES.items() if k.startswith(kv + '.d256')} }")
    result["runs"]["ring"] = run
    eng.new_cache(kv_dtype=torch.bfloat16)  # the serving check's single-stream Engine

    for name, kw in (("swa_full", dict(swa_full=True)), ("q8", dict(kv_dtype="q8_0"))):
        e = Engine(eng.model, max_seq=GEMMA_CTX, **kw)  # the ring engine's weights
        expect(not isinstance(e.cache, SWACache), f"gemma {name}: a full cache")
        r = gemma_run(name, e, word_ids)
        tf[name] = _teacher_logits(e, prompt, ids)
        result["runs"][name] = r
        del e
        torch.cuda.empty_cache()

    a, b = result["runs"]["ring"]["ids"], result["runs"]["swa_full"]["ids"]
    for n in GEMMA_LENS:
        part = next((i for i, (x, y) in enumerate(zip(a[n], b[n])) if x != y), None)
        log(f"[gemma] greedy ids from the {n}-token prompt, ring {a[n][:12]}… swa_full "
            f"{b[n][:12]}…: {'equal' if part is None else f'first differ at {part}'}")
    ring_err = max(_nmse_np(x, y) for x, y in zip(tf["ring"], tf["swa_full"]))
    log(f"[gemma] ring against swa_full, teacher-forced on {len(ids)} positions after the "
        f"2560-token prompt: worst NMSE {ring_err:.2e} (bound {GEMMA_RING_NMSE_BOUND})")
    expect(ring_err <= GEMMA_RING_NMSE_BOUND, f"gemma: ring against swa_full NMSE {ring_err:.3e}")
    result["ring_vs_swa_full_nmse"] = ring_err

    dense = Engine(path, max_seq=GEMMA_CTX, mode="dense")
    result["dense_nmse"] = {}
    for name, kw in (("ring", dict(kv_dtype=torch.bfloat16, swa_full=False)),
                     ("swa_full", dict(kv_dtype=torch.bfloat16, swa_full=True)),
                     ("q8", dict(kv_dtype="q8_0", swa_full=False))):
        dense.new_cache(**kw)
        rows = _teacher_logits(dense, prompt, ids)
        errs = [_nmse_np(x, y) for x, y in zip(tf[name], rows)]
        same = sum(int(np.argmax(x) == np.argmax(y)) for x, y in zip(tf[name], rows))
        expect(all(np.isfinite(r).all() for r in rows), f"gemma dense {name}: finite logits")
        result["dense_nmse"][name] = dict(worst=max(errs), mean=float(np.mean(errs)),
                                          same_top=same, positions=len(rows))
        log(f"[gemma] {name}: the kernels against dense bf16 weights, teacher-forced: NMSE "
            f"worst {max(errs):.2e} mean {np.mean(errs):.2e}, same argmax {same}/{len(rows)}")
    del dense, tf
    torch.cuda.empty_cache()

    be = BatchEngine(eng.model, n_slots=GEMMA_SLOTS, max_seq=GEMMA_CTX, prefill_chunk=512)
    single = eng
    expect(isinstance(be.cache, SWACache) and be.cache.ring_len == 1536,
           "gemma serving: a ring of 1536 slots a slot (window and a chunk of 512)")
    lens = (40, 700, 1300, 2000)
    prompts = [word_ids(n) for n in lens]
    be.precompile()
    result["serving"] = teacher_forced("gemma serving", be, single, prompts, 16)
    be.free_slot(2)
    expect(int(be.cache.slot_pos[2].max()) == -1, "gemma serving: the freed slot's ring is empty")
    single.reset()
    ref = single.prefill(prompts[0])
    got = be.prefill_slots({2: prompts[0]})[2]
    err = _nmse_np(got, ref)
    log(f"[gemma serving] slot 2 freed and admitted with the {lens[0]}-token prompt: NMSE "
        f"against Engine {err:.2e}")
    expect(err <= SERVE_NMSE_BOUND, f"gemma serving: the re-admitted slot NMSE {err:.3e}")
    result["serving"]["readmitted_nmse"] = err
    result["spec_scheduler"] = gemma_spec_scheduler(be, word_ids)
    del be, single, eng
    torch.cuda.empty_cache()
    got = read_launches()  # just after the main path
    log(f"[gemma] launches of the phase {got}")
    expect(got["attn_dense_routes"] == 0, "gemma: no call through the dense attention route")
    for fmt in FLASH_FORMATS:
        for r in ("decode", "prefill"):
            expect(got[f"flash_{fmt}.d256.{r}"] > 0,
                   f"gemma: flash {fmt} at D = 256 launched in the {r} regime")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["launches"] = got
    path.unlink()
    return result


# DeepSeek-V2-Lite's MLA attention: 16 query heads on the latent's one KV
# head, Dk = kv_lora_rank + n_rot = 576, Dv = kv_lora_rank = 512, bf16;
# MiniCPM3-4B's: 40 heads on the latent 256 + 32 (R = 40 query rows at T = 1)
MLA_HEADS = dict(H=16, Hkv=1, Dk=576, Dv=512, S=4096)
MLA_SCALE = 192 ** -0.5  # the per-head key width's (qk_nope 128 + rope 64)
MLA288_HEADS = dict(H=40, Hkv=1, Dk=288, Dv=256, S=4096)
MLA288_SCALE = 96 ** -0.5  # MiniCPM3's per-head key width (qk_nope 64 + rope 32)
# the decompressed form's heads: PLM / DeepSeek-V2's 16 of (192, 128) and
# MiniCPM3's 40 of (96, 64), one KV head a query head
DKDV_HEADS = {(192, 128): dict(H=16, Hkv=16), (96, 64): dict(H=40, Hkv=40)}


def _latent_prefill_ms(q, c, dv: int, off, scale) -> float:
    """The latent form's prefill kernel timed at a call the wrapper sends
    to the decode regime (the C entry's max_splits 0 picks the prefill
    kernel at any R): the same inputs, a launch the counts do not see."""
    import torch

    from tpullm_torch.ops.kernels import _build, flash

    B, T, H, D = q.shape
    out = torch.empty((B, T, H, dv), dtype=q.dtype, device=q.device)
    fn = _build.bind("flash_latent", "tpullm_flash_latent_bf16", flash._LATENT_ARGS)

    def call():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), c.data_ptr(), off.data_ptr(), out.data_ptr(), None, None,
                        B, T, H, c.shape[1], c.shape[2], D, dv, float(scale), 0, stream),
                     "flash latent prefill kernel at a decode shape")
        return out
    ref = flash.flash_reference(q, c, c[..., :dv], off, scale)
    err = nmse(call().float(), ref.float())
    expect(err <= FLASH_NMSE_BOUND, f"the latent prefill kernel at a decode shape: NMSE {err:.3e}")
    return time_ms(call, 20)


def _flash_mla_case(dev, gen, *, B, T, offsets, H, Hkv, Dk, Dv, S, scale=MLA_SCALE) -> dict:
    """The latent form (v = k[..., :Dv]) on random bf16 inputs against its
    plain version and the plain version of its own order, one counted
    launch a call, timed beside its bound and SDPA (enable_gqa, the values
    a copy of the latent's prefix); in the decode regime also the prefill
    kernel at the same call."""
    import torch
    import torch.nn.functional as F

    from tpullm_torch.ops.kernels import flash

    q = torch.randn(B, T, H, Dk, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(B, Hkv, S, Dk, generator=gen, device=dev).to(torch.bfloat16)
    v = c[..., :Dv]
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)

    def kernel():
        return flash.flash_attention(q, c, v, off, scale)

    def plain():
        return flash.flash_reference(q, c, v, off, scale)
    decode = flash.regime(T, H, Hkv, latent=True) == "decode"
    got = counted_call(f"bf16.{flash.dims_key(Dk, Dv)}.{'decode' if decode else 'prefill'}",
                       kernel)
    ref = plain()
    torch.cuda.synchronize()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    own = (flash.flash_split_reference(q, c, v, off, scale, n_sm=n_sm, p_terms=2) if decode
           else flash.flash_prefill_reference(q, c, v, off, scale))
    idle = [b for b, o in enumerate(offsets) if o < 0]
    row = dict(regime="decode" if decode else "prefill", nmse=nmse(got.float(), ref.float()),
               nmse_own_order=nmse(got.float(), own.float()),
               max_abs_err=float((got.float() - ref.float()).abs().max()),
               finite=bool(torch.isfinite(got.float()).all()),
               idle_zero=not bool(got[idle, 0].float().any()), rows=T * H // Hkv)
    del own
    # the work this run's data needs: the valid keys' latent rows read once
    # (decode), 2·(Dk + Dv) FLOP a visible (query, key) pair a head
    q_pos = np.asarray(offsets)[:, None] + np.arange(T)[None]
    visible = float(np.clip(q_pos + 1, 0, S).sum())
    kv_len = float(np.clip(np.asarray(offsets) + T, 0, S).sum())
    n_bytes = q.numel() * 2 + B * T * H * Dv * 2 + kv_len * Hkv * Dk * 2
    bms, by = bound_ms(n_bytes, 2.0 * (Dk + Dv) * H * visible)
    pos = torch.arange(S, device=dev)
    q_at = (off[:, None] + torch.arange(T, device=dev))[..., None]
    mask = (pos[None, None, :] <= q_at)[:, None]  # [B, 1, T, S]
    qt, vt = q.transpose(1, 2), v.contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, c, vt, attn_mask=mask, scale=scale,
                                              enable_gqa=True)
    row.update(ms=time_ms(kernel, 20), eager_ms=time_ms(kernel, 20, graph=False),
               plain_ms=time_ms(plain, 2, 1, graph=False), bound_ms=bms, bound_by=by,
               library_ms=time_ms(library, 20), visible_pairs_per_head=visible)
    if decode:
        row["prefill_kernel_ms"] = _latent_prefill_ms(q, c, Dv, off, scale)
    return row


def phase_flash_mla(dev, results: dict):
    """Flash's latent form at DeepSeek-V2-Lite's attention (MLA_HEADS, S =
    4096): the decode regime at T = 1, B = 2 with kv 38 / 3001 and B = 1
    with kv 20, an idle slot (offset −1), and at T = 2 and 4 (R = 32, 64:
    two and four row groups); the prefill regime at T = 512 with offsets 0
    / 2500 and in a joint round (B = 4, T = 8, two idle); at MiniCPM3-4B's
    (MLA288_HEADS): the decode regime at T = 1 (R = 40: three row groups,
    the last of 8 rows; B = 2, kv 38 / 3001, and B = 1, kv 20), the
    prefill regime at T = 2 (R = 80), 512 and in a joint round; each
    against its plain version and that of its own order (NMSE within
    FLASH_NMSE_BOUND), timed beside its bound and SDPA, the decode cases
    also the prefill kernel at the same call; rows under FLASH_MLA_KEY and
    FLASH_MLA288_KEY."""
    import torch

    gen = torch.Generator(dev).manual_seed(11)
    v2 = [("T=1 B=2 kv=38/3001 S=4096", dict(B=2, T=1, offsets=(37, 3000))),
          ("T=1 B=1 kv=20 S=4096", dict(B=1, T=1, offsets=(19,))),
          ("T=1 B=2 idle/kv=501 S=4096", dict(B=2, T=1, offsets=(-1, 500))),
          ("T=2 B=2 kv=39/3002 S=4096", dict(B=2, T=2, offsets=(37, 3000))),
          ("T=4 B=2 kv=41/3004 S=4096", dict(B=2, T=4, offsets=(37, 3000))),
          ("T=512 B=2 offsets=0/2500 S=4096", dict(B=2, T=512, offsets=(0, 2500))),
          ("T=8 B=4 offsets=-1/0/2500/-1 S=4096", dict(B=4, T=8, offsets=(-1, 0, 2500, -1)))]
    mc3 = [(f"d288v256 H=40 {label}", kw) for label, kw in (
        ("T=1 B=2 kv=38/3001 S=4096", dict(B=2, T=1, offsets=(37, 3000))),
        ("T=1 B=1 kv=20 S=4096", dict(B=1, T=1, offsets=(19,))),
        ("T=2 B=2 kv=39/3002 S=4096", dict(B=2, T=2, offsets=(37, 3000))),
        ("T=512 B=2 offsets=0/2500 S=4096", dict(B=2, T=512, offsets=(0, 2500))),
        ("T=8 B=4 offsets=-1/0/2500/-1 S=4096", dict(B=4, T=8, offsets=(-1, 0, 2500, -1))))]
    cases = ([(FLASH_MLA_KEY, label, dict(MLA_HEADS, scale=MLA_SCALE, **kw)) for label, kw in v2]
             + [(FLASH_MLA288_KEY, label, dict(MLA288_HEADS, scale=MLA288_SCALE, **kw))
                for label, kw in mc3])
    for key, label, kw in cases:
        row = _flash_mla_case(dev, gen, **kw)
        row["case"] = label
        expect(row["finite"] and row["idle_zero"], f"flash mla {label}: finite, idle rows 0")
        expect(row["nmse"] <= FLASH_NMSE_BOUND and row["nmse_own_order"] <= FLASH_NMSE_BOUND,
               f"flash mla {label} NMSE {row['nmse']:.3e}, against the plain version of its "
               f"own order {row['nmse_own_order']:.3e} <= {FLASH_NMSE_BOUND}")
        results.setdefault(key, []).append(row)
        extra = (f"; the prefill kernel at this call {row['prefill_kernel_ms']:.4f} ms"
                 if "prefill_kernel_ms" in row else "")
        log(f"[flash mla] {label} (R = {row['rows']}, {row['regime']}): nmse {row['nmse']:.2e} "
            f"max|d| {row['max_abs_err']:.3g} (own order {row['nmse_own_order']:.2e}) kernel "
            f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) plain {row['plain_ms']:.3f} ms sdpa (enable_gqa) "
            f"{row['library_ms']:.4f} ms{extra}")
    torch.cuda.empty_cache()


def phase_flash_dkdv(dev, results: dict):
    """Flash at key width ≠ value width (the library flash_dkdv), each KV
    format: (192, 128) at 16 heads on 16 (PLM, DeepSeek-V2 decompressed)
    and (96, 64) at 40 on 40 (MiniCPM3 decompressed), the decode regime at
    T = 1 (B = 2, kv 38 / 3001) and the prefill regime at T = 512 (offsets
    0 / 2500), S = 4096; each against its plain version and that of its own
    order, one counted launch a call, timed beside its bound and SDPA on
    the cache's dtype; rows under flash_<fmt>_d<Dk>v<Dv>."""
    import torch

    gen = torch.Generator(dev).manual_seed(19)
    for (d, dv), heads in DKDV_HEADS.items():
        for fmt in FLASH_FORMATS:
            key = f"flash_{fmt}_d{d}v{dv}"
            bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
            for label, kw in ((f"{fmt} T=1 B=2 S=4096 D={d}/{dv}",
                               dict(T=1, B=2, offsets=(37, 3000))),
                              (f"{fmt} T=512 B=2 S=4096 D={d}/{dv}",
                               dict(T=512, B=2, offsets=(0, 2500)))):
                row = _flash_case(dev, gen, fmt=fmt, D=d, DV=dv, S=4096, timed=True, **heads,
                                  **kw)
                row["case"] = label
                expect(row["finite"], f"flash {label} finite")
                expect(row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                       f"flash {label} NMSE {row['nmse']:.3e}, against the plain version of "
                       f"its own order {row['nmse_own_order']:.3e} <= {bound}")
                results.setdefault(key, []).append(row)
                log(f"[flash dkdv] {label} ({row['regime']}): nmse {row['nmse']:.2e} max|d| "
                    f"{row['max_abs_err']:.3g} (own order {row['nmse_own_order']:.2e}) kernel "
                    f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}) plain "
                    f"{row['plain_ms']:.3f} ms sdpa {row['library_ms']:.4f} ms")
    torch.cuda.empty_cache()


DS2_CTX = 4096  # max_seq
DS2_LAYERS = 9  # of DeepSeek-V2-Lite's 27: the dense lead and 8 MoE layers
DS2_LENS = (512, 2560)  # prompts
DS2_GEN = 64  # greedy tokens a prompt
DS2_SLOTS = 4
DS2_TEACHER = 32  # teacher-forced positions against dense weights (after the 512 prompt)


def moe_launch_want(eng, rows: int) -> dict:
    """One MoE forward's launches by COUNT_NAMES at `rows` rows (1: a
    decode step; deepseek2 and the qwen-moe graph): every quantized 2-D
    linear the kernels take through qmm (qmm_tc from 16 rows but the head,
    on the last row), the others (deepseek2's dense lead's K = 10944 down)
    through the dequantize route; the packed expert stacks through
    qmm_gather (≤ 16 rows) or qmm_stack, the dense ones (deepseek2's K =
    1408 down) through no kernel; flash once a layer in the regime
    T·H/kv_heads picks (the engine's cache: the MLA latent one KV head and
    its own decode rows, else hp.n_head_kv); the head through qmm unless it
    is tied (a plain product) or no kernel takes it (Falcon-7B's K = 4544:
    the dequantize route)."""
    from tpullm_torch.models.weights import FusedLinear, QuantExpertStack, QuantLinear
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.kvcache import MLACache

    def base(m):
        return m.base if isinstance(m, FusedLinear) else m

    quant = [base(m) for layer in eng.params["layers"] for m in layer.values()
             if isinstance(base(m), QuantLinear)]
    taken = sum(qmm.takes(m.n_in, m.n_out) for m in quant)
    stacks = sum(isinstance(m, QuantExpertStack) for layer in eng.params["layers"]
                 for m in layer.values())
    tc = rows >= qmm.TC_MIN_M
    gather = rows <= moe._GATHER_MAX_TOKENS
    latent = isinstance(eng.cache, MLACache)
    kv_heads = 1 if latent else eng.hp.n_head_kv
    decode = flash.regime(rows, eng.hp.n_head, kv_heads, latent) == "decode"
    L = len(eng.params["layers"])
    head = per_forward_launches(eng.params)["head"]
    out = eng.params["output"]
    head_taken = head and qmm.takes(out.n_in, out.n_out)
    return {"qmm": (0 if tc else taken) + head_taken, "qmm_tc": taken if tc else 0,
            "qmm_stack": 0 if gather else stacks, "qmm_gather": stacks if gather else 0,
            "qmm_grouped": 0, "dequant_routes": len(quant) - taken + head - head_taken,
            "flash": L,
            "flash_decode": L if decode else 0, "attn_dense_routes": 0, "attn_ring_routes": 0}


def ds2_run(label: str, eng, word_ids, tag: str = "deepseek2") -> dict:
    """Engine on an MLA model (DeepSeek-V2-Lite; `tag` names the phase in
    its lines): a warm-up generation; each prompt of
    DS2_LENS prefilled cold and warm with each forward's ms; each prompt and
    DS2_GEN greedy tokens on the decode graph: TTFT (warm), decode tok/s;
    the launches of a decode replay and of a 512-token prefill forward
    against moe_launch_want; a decode token's and a 512-token prefill's
    device ms by family."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams

    eng.generate_tokens_device(word_ids(16), 8, stop_on_eog=False)
    out = dict(kv=label, ttft_ms={}, decode_tok_s={}, ids={}, prefill_ms={})
    for n in DS2_LENS:
        cold, warm = _prefill_split(eng, word_ids(n)), _prefill_split(eng, word_ids(n))
        out["prefill_ms"][n] = dict(cold=cold, warm=warm)
        log(f"[{tag}] {label} prompt {n}: prefill cold {cold[0]:.1f} ms (forwards of rows, "
            f"ms {cold[1]}), warm {warm[0]:.1f} ms ({warm[1]})")
    for n in DS2_LENS:
        eng.reset()
        p0 = (eng.perf.t_prefill_s, eng.perf.t_decode_s, eng.perf.n_decode)
        ids = eng.generate_tokens_device(word_ids(n), DS2_GEN, stop_on_eog=False)
        ttft = eng.perf.t_prefill_s - p0[0]
        rate = (eng.perf.n_decode - p0[2]) / (eng.perf.t_decode_s - p0[1])
        expect(len(ids) == DS2_GEN and all(0 <= t < eng.hp.n_vocab for t in ids),
               f"{tag} {label}: {DS2_GEN} ids in range from the {n}-token prompt")
        out["ttft_ms"][n], out["decode_tok_s"][n], out["ids"][n] = ttft * 1e3, rate, ids
        log(f"[{tag}] {label} prompt {n}: TTFT (warm) {ttft * 1e3:.1f} ms, decode "
            f"{rate:.2f} tok/s (graph), first ids {ids[:6]}")
    runner = eng.decode_runner(SamplingParams(), 32)
    one = runner.launches_per_replay()
    want = moe_launch_want(eng, 1)
    log(f"[{tag}] {label} launches per decode replay {one}")
    expect(one == want, f"{tag} {label}: launches per decode replay {one} = {want}")
    eng.reset()
    snap = _snapshot()
    eng.prefill(word_ids(512))
    torch.cuda.synchronize()
    got = _launch_delta(snap)
    want = moe_launch_want(eng, 512)
    log(f"[{tag}] {label} launches of one 512-token prefill forward {got}")
    expect(got == want, f"{tag} {label}: one prefill forward's launches {got} = {want}")
    out["launches_per_decode"], out["launches_per_prefill"] = one, got
    prof = profile_decode(eng, runner, word_ids(512), 32)
    out["device_ms_per_token"] = prof["device_ms_per_token"]
    out["event_span_ms_per_token"] = prof["event_span_ms_per_token"]
    out["decode_top"] = prof["top"]
    log(f"[{tag}] {label}: a decode token's device ms by family (32 graph replays after a "
        f"512-token prompt) { {k: round(v, 4) for k, v in prof['device_ms_per_token'].items()} } "
        f"(event span {prof['event_span_ms_per_token']:.3f} ms); top {prof['top']}")
    pre = profile_prefill(eng, word_ids(512))
    out["prefill_profile"] = pre
    log(f"[{tag}] {label}: a 512-token prefill's device ms by family "
        f"{ {k: round(v, 3) for k, v in pre['device_ms'].items()} }, wall {pre['wall_ms']:.1f} ms, "
        f"kernels {pre['launches']}")
    return out


def phase_deepseek2(tmp: Path, launches: dict) -> dict:
    """DeepSeek-V2-Lite Q4_K_M at full width with DS2_LAYERS of its 27 layers (MLA with
    kv_lora_rank 512 + 64 rope dims, 16 heads, 64 routed experts top-6 and
    2 shared, one dense lead layer, vocab 102400), synthesized from seed 0:
    1. Engine on the bf16 latent at context 4096 (ds2_run): load s and peak
       GiB, prompts of 512 and 2560 tokens cold and warm, 64 greedy tokens
       each on the decode graph, TTFT (warm), decode tok/s, launches per
       forward (flash's latent form once a layer in both regimes, the
       expert kernels of the packed gate/up stacks, one dequantize-route
       call: the dense lead's K = 10944 down), device ms by family;
    2. the latent's bytes a position against the decompressed cache's;
    3. the kernels against dense bf16 weights, teacher-forced on the
       packed run's greedy ids after the 512-token prompt: NMSE, and the
       greedy ids equal;
    4. an MLA state file saved and restored, the continuation equal;
    5. a BatchEngine of 4 slots on the latent, its batched logits
       teacher-forced against Engine.decode_step (NMSE ≤ SERVE_NMSE_BOUND)."""
    import torch

    from tpullm_torch.models.deepseek2 import mla_dims
    from tpullm_torch.models.weights import QuantExpertStack
    from tpullm_torch.ops.kernels import qmm
    from tpullm_torch.runtime import state
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import MLACache

    path = synthesize(tmp, "deepseek2", "deepseek-v2-lite", "Q4_K_M", n_layer=DS2_LAYERS)
    result: dict = {}
    reset_launches()  # just before the main path
    gc.collect()  # earlier phases' engines and graph runners, in reference cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(path, max_seq=DS2_CTX)
    load_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    hp = eng.hp
    layers = eng.params["layers"]
    dense_stacks = sum(isinstance(v, torch.Tensor) and v.dim() == 3 and k.endswith("_exps")
                       for layer in layers for k, v in layer.items())
    packed_stacks = sum(isinstance(v, QuantExpertStack) for layer in layers for v in layer.values())
    log(f"[deepseek2] {hp.arch}: {hp.n_layer} layers, n_embd {hp.n_embd}, {hp.n_head} heads, "
        f"kv_lora {hp.n_lora_kv} + rope {hp.rope.dims}, experts {hp.n_expert} top-"
        f"{hp.n_expert_used} + {hp.n_expert_shared} shared, vocab {hp.n_vocab}; loaded in "
        f"{eng.perf.t_load_s:.1f}s, peak {load_peak:.2f} GiB above the baseline of "
        f"{base / 2**30:.2f} GiB; {eng.report()}; expert stacks "
        f"packed {packed_stacks}, dense at load (K = {hp.n_ff_exp}: no kernel takes it) "
        f"{dense_stacks}")
    expect(isinstance(eng.cache, MLACache) and eng.cache.c.dtype == torch.bfloat16,
           "deepseek2: the bf16 latent cache")
    expect(packed_stacks == 2 * (hp.n_layer - 1) and dense_stacks == hp.n_layer - 1,
           "deepseek2: gate/up stacks packed, the K = 1408 down stacks dense")
    Dk, Dv, _, _ = mla_dims(hp)
    latent_b = hp.n_layer * eng.cache.c.shape[-1] * 2
    full_b = hp.n_layer * hp.n_head * (Dk + Dv) * 2
    log(f"[deepseek2] the latent: {latent_b} B a position against {full_b} B decompressed "
        f"({full_b / latent_b:.2f}×)")
    result.update(load_s=eng.perf.t_load_s, load_peak_gib=load_peak, latent_bytes=latent_b,
                  decompressed_bytes=full_b)

    def word_ids(n):
        return _word_ids(eng.tokenizer, n)

    before = _snapshot()
    run = ds2_run("bf16 latent", eng, word_ids)
    result["run"] = run
    routes = _launch_delta(before)
    log(f"[deepseek2] the run's launches {routes}; dequantize-route calls by format "
        f"{ {k: v for k, v in qmm.DEQUANT_ROUTES.items() if v} } (the dense lead's K = "
        f"{hp.n_ff} down, one a forward); dense down-expert stacks {dense_stacks} (no kernel, "
        f"a plain product on weights dequantized at load)")

    # the kernels against dense bf16 weights, teacher-forced on the run's ids
    prompt = word_ids(DS2_LENS[0])
    ids = run["ids"][DS2_LENS[0]][:DS2_TEACHER]
    packed_rows = _teacher_logits(eng, prompt, ids)
    dense = Engine(path, max_seq=DS2_CTX, mode="dense")
    dense_rows = _teacher_logits(dense, prompt, ids)
    del dense
    torch.cuda.empty_cache()
    errs = [_nmse_np(a, b) for a, b in zip(packed_rows, dense_rows)]
    same = sum(int(np.argmax(a) == np.argmax(b)) for a, b in zip(packed_rows, dense_rows))
    margins = [float(np.diff(np.sort(b)[-2:])[0]) for b in dense_rows]
    result["dense"] = dict(worst=max(errs), mean=float(np.mean(errs)), same_top=same,
                           positions=len(ids), min_margin=min(margins))
    log(f"[deepseek2] the kernels against dense bf16 weights, teacher-forced on {len(ids)} "
        f"positions after the {DS2_LENS[0]}-token prompt: NMSE worst {max(errs):.2e} mean "
        f"{np.mean(errs):.2e}, same argmax {same}/{len(ids)} (dense top-2 margin at least "
        f"{min(margins):.3g})")
    expect(all(np.isfinite(r).all() for r in dense_rows), "deepseek2 dense: finite logits")
    expect(same == len(ids), f"deepseek2: greedy ids equal dense weights' ({same}/{len(ids)})")

    # state file: the latent round trip
    eng.reset()
    eng.prefill(prompt)
    f = tmp / "deepseek2-state.npz"
    t0 = time.perf_counter()
    state.save_state(eng, f, tokens=prompt)
    t1 = time.perf_counter()
    want = [eng.decode_step(t) for t in (5, 6)]
    eng.reset()
    expect(state.load_state(eng, f) == prompt and eng.n_past == len(prompt),
           "deepseek2: the MLA state restores")
    got = [eng.decode_step(t) for t in (5, 6)]
    err = max(_nmse_np(a, b) for a, b in zip(got, want))
    log(f"[deepseek2] MLA state file ({f.stat().st_size / 2**20:.1f} MiB for {len(prompt)} "
        f"positions, saved in {t1 - t0:.2f}s): the continuation after the restore NMSE {err:.2e}")
    expect(err <= 1e-10, f"deepseek2: the restored latent continues as saved (NMSE {err:.3e})")
    f.unlink()
    result["state_nmse"] = err

    be = BatchEngine(eng.model, n_slots=DS2_SLOTS, max_seq=DS2_CTX, prefill_chunk=512)
    expect(isinstance(be.cache, MLACache), "deepseek2 serving: the latent cache")
    be.precompile()
    prompts = [word_ids(n) for n in (40, 700, 1300, 2000)]
    result["serving"] = teacher_forced("deepseek2 serving", be, eng, prompts, 16)
    del be, eng
    torch.cuda.empty_cache()
    got = read_launches()  # just after the main path
    log(f"[deepseek2] launches of the phase {got}")
    expect(got["attn_dense_routes"] == 0, "deepseek2: no call through the dense attention route")
    for r in ("decode", "prefill"):
        expect(got[f"flash_bf16.d576v512.{r}"] > 0,
               f"deepseek2: flash's latent form launched in the {r} regime")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["launches"] = got
    path.unlink()
    return result


# deepseek2's MLA aliases on the card (phase_mla_models)
MLA_CTX = 4096  # max_seq
PLM_LAYERS = 8  # PLM-1.8B's depth on the card (of 32)
# MiniCPM3-4B's depth on the card (full width; of 62: all of them made the
# phase 77 s, against its budget of about 60; 24 until the engine options
# phase came)
MINICPM3_LAYERS = 12
MLA_DENSE_POSITIONS = 32  # positions teacher-forced against dense weights
MLA_SLOT_LENS = (40, 700, 1300)  # the BatchEngine round's prompts (its slot 3 idle)
MLA_SLOT_STEPS = 16  # teacher-forced batched steps against Engine
MLA_BRIEF = (64, 16)  # the decompressed form's runs: prompt tokens, greedy tokens
# the decompressed form's logits against the absorbed form's on the same ids:
# the two round differently (the absorbed form's wk_b / wv_b products in bf16
# on dense weights, the decompressed form's through the packed wkv_b and
# per-head K/V), so they are held to SERVE_NMSE_BOUND, the bound of every
# other comparison of two computations of one model on the card
MLA_FORMS_NMSE_BOUND = SERVE_NMSE_BOUND


class mla_form:
    """TPULLM_MLA for a `with` block: "absorbed" (the default) or
    "decompressed" (0); the form is read when a model loads and when its
    cache is made."""

    def __init__(self, form: str):
        self.value = "0" if form == "decompressed" else "1"

    def __enter__(self):
        import os

        self.before = os.environ.get("TPULLM_MLA")
        os.environ["TPULLM_MLA"] = self.value

    def __exit__(self, *exc):
        import os

        if self.before is None:
            os.environ.pop("TPULLM_MLA", None)
        else:
            os.environ["TPULLM_MLA"] = self.before


def mla_absorbed_run(label: str, path: Path, launches: dict, dense: bool) -> tuple:
    """An MLA alias on its bf16 latent at full width: load s and peak GiB;
    ds2_run (prompts DS2_LENS cold and warm, DS2_GEN greedy tokens each on
    the decode graph, TTFT, decode tok/s, launches per decode replay and
    per 512-token prefill forward against moe_launch_want, device ms by
    family); flash's latent form once a layer in both regimes (the decode
    regime at T = 1), no counted route; with `dense`, the kernels against
    dense bf16 weights (`against_dense`, MLA_DENSE_POSITIONS positions).
    Returns (result, the Engine, the latent's launch key)."""
    import torch

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import MLACache

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # just before the main path
    eng = Engine(path, max_seq=MLA_CTX)
    load_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    hp = eng.hp
    L = len(eng.params["layers"])
    resident, per_token = plane_bytes(eng.params, 1)
    dk, dv = hp.n_lora_kv + hp.rope.dims, hp.n_lora_kv
    key = f"bf16.{flash.dims_key(dk, dv)}"
    log(f"[mla] {label}: arch {hp.arch}, {L} layers, n_embd {hp.n_embd}, {hp.n_head} heads on "
        f"the latent {hp.n_lora_kv} + rope {hp.rope.dims} (heads {hp.head_dim} / "
        f"{hp.head_dim_v}), q LoRA {hp.n_lora_q}, n_ff {hp.n_ff}, vocab {hp.n_vocab}, "
        f"multipliers {hp.embd_scale:.4g} / {hp.residual_scale:.4g} / {hp.logit_scale:.4g}, "
        f"head {'tied' if eng.params['output'] is None else 'untied'}; loaded in "
        f"{eng.perf.t_load_s:.1f}s, peak {load_peak:.2f} GiB above the {base / 2**30:.2f} GiB "
        f"earlier phases hold; {eng.report()}; planes resident {resident / 2**30:.2f} GiB, a "
        f"decode token streams {per_token / 1e9:.3f} GB (bound "
        f"{per_token / PEAK_BYTES * 1e3:.3f} ms)")
    expect(isinstance(eng.cache, MLACache) and eng.cache.c.dtype == torch.bfloat16
           and eng.cache.c.shape[-1] == dk, f"{label}: the bf16 latent of {dk}")
    result = dict(load_s=eng.perf.t_load_s, load_peak_gib=load_peak, n_layer=L,
                  resident_gib=resident / 2**30, decode_plane_gb=per_token / 1e9,
                  decode_bound_ms=per_token / PEAK_BYTES * 1e3)

    def word_ids(n):
        return _word_ids(eng.tokenizer, n)

    result["run"] = run = ds2_run("bf16 latent", eng, word_ids, tag=label)
    expect(run["launches_per_decode"].get("flash_decode") == L,
           f"{label}: a decode step's attention in the latent's decode regime "
           f"({run['launches_per_decode']})")
    if dense:
        result["dense"] = against_dense(label, path, MLA_CTX, MLA_DENSE_POSITIONS)
    torch.cuda.synchronize()
    got = read_launches()  # just after the main path
    log(f"[mla] {label}: launches of the absorbed run {got}")
    expect(got["attn_dense_routes"] == 0 and got["dequant_routes"] == 0,
           f"{label}: no call through the dense attention or the dequantize route")
    for r in ("decode", "prefill"):
        expect(got[f"flash_{key}.{r}"] > 0, f"{label}: flash's latent form {key} launched in "
               f"the {r} regime")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["launches"] = got
    return result, eng, key


def mla_decompressed_runs(label: str, path: Path, launches: dict, forms_ref: tuple) -> dict:
    """The decompressed form (TPULLM_MLA=0) of an MLA alias at full width,
    loaded once: per-head caches of bf16, q8, f16 and f32, each a
    MLA_BRIEF run on the decode graph (flash at (Dk, Dv) of the heads once
    a layer in both regimes, one launch a layer a forward, no counted
    route); on bf16 first the logits teacher-forced on `forms_ref` (prompt,
    ids, the absorbed form's rows) against the absorbed form's (NMSE ≤
    MLA_FORMS_NMSE_BOUND)."""
    import torch

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import KVCache, QuantKVCache

    out: dict = {"runs": []}
    with mla_form("decompressed"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = Engine(path, max_seq=MLA_CTX)
        hp, L = eng.hp, len(eng.params["layers"])
        dk, dv = hp.head_dim, hp.head_dim_v
        expect(isinstance(eng.cache, KVCache) and eng.cache.k.shape[-1] == dk
               and eng.cache.v.shape[-1] == dv, f"{label} decompressed: K {dk}, V {dv} a head")
        prompt, ids, absorbed_rows = forms_ref
        rows = _teacher_logits(eng, prompt, ids)
        errs = [_nmse_np(a, b) for a, b in zip(rows, absorbed_rows)]
        same = sum(int(np.argmax(a) == np.argmax(b)) for a, b in zip(rows, absorbed_rows))
        out.update(load_s=time.perf_counter() - t0, forms_worst=max(errs),
                   forms_mean=float(np.mean(errs)), forms_same_top=same, forms_positions=len(ids))
        log(f"[mla] {label} decompressed (heads {dk} / {dv}, {hp.n_head_kv} KV heads): loaded "
            f"in {out['load_s']:.1f}s; against the absorbed form teacher-forced on {len(ids)} "
            f"positions after a {len(prompt)}-token prompt: NMSE worst {max(errs):.2e} mean "
            f"{np.mean(errs):.2e} (bound {MLA_FORMS_NMSE_BOUND}), same argmax "
            f"{same}/{len(ids)}")
        expect(max(errs) <= MLA_FORMS_NMSE_BOUND, f"{label}: the decompressed form against the "
               f"absorbed one, NMSE {max(errs):.3e} <= {MLA_FORMS_NMSE_BOUND}")
        for kv in (torch.bfloat16, "q8_0", torch.float16, torch.float32):
            fmt = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}.get(kv, "q8")
            eng.new_cache(kv_dtype=kv)
            expect(isinstance(eng.cache, QuantKVCache) == (fmt == "q8"),
                   f"{label} decompressed: the {fmt} cache")
            n_prompt, n_gen = MLA_BRIEF
            n_decode = eng.perf.n_decode
            reset_launches()  # just before the main path
            got_ids = eng.generate_tokens_device(_word_ids(eng.tokenizer, n_prompt), n_gen,
                                                 temp=0.0, stop_on_eog=False, chunk=n_gen)
            torch.cuda.synchronize()
            got = read_launches()  # just after the main path
            steps = eng.perf.n_decode - n_decode
            k = f"flash_{fmt}.{flash.dims_key(dk, dv)}"
            dec, pre = got[f"{k}.decode"], got[f"{k}.prefill"]
            log(f"[mla] {label} decompressed kv={fmt}: {n_prompt}-token prompt, {len(got_ids)} "
                f"greedy ids {got_ids[:6]}; {k} launches decode {dec}, prefill {pre} ({steps} "
                f"decode steps); dense-route calls {got['attn_dense_routes']}")
            expect(len(got_ids) == n_gen and pre == L and dec == L * steps > 0
                   and got["attn_dense_routes"] == 0 and got["dequant_routes"] == 0,
                   f"{label} decompressed {fmt}: {k} {L} a forward in both regimes ({pre} "
                   f"prefill, {dec} decode over {steps} steps), no counted route")
            for key, v in got.items():
                launches[key] = launches.get(key, 0) + v
            out["runs"].append(dict(kv=fmt, ids=got_ids, launches_decode=dec,
                                    launches_prefill=pre))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_mla_models(tmp: Path, launches: dict) -> dict:
    """deepseek2's MLA aliases, synthesized from seed 0 at Q4_K_M:
    1. tiny-minicpm3 (the latent 256 + 32 under 40 heads: R = 40 at T = 1;
       heads 96 / 64) and tiny-plm (512 + 64; 192 / 128) on the card
       against the CPU, each in both forms (tiny_card_vs_cpu);
    2. MiniCPM3-4B at full width (MINICPM3_LAYERS layers) on the bf16
       latent (mla_absorbed_run, with the check against dense weights),
       then its decompressed form on bf16, q8, f16 and f32 caches
       (mla_decompressed_runs);
    3. PLM-1.8B at full width with PLM_LAYERS of its 32 layers on the bf16
       latent (the ReLU² FFN),
       a BatchEngine of 4 slots on its Model (slot 3 idle) teacher-forced
       against Engine.decode_step, then its decompressed form;
    each step's seconds logged; no call through a counted route."""
    import torch

    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.batch_engine import BatchEngine

    result: dict = {}
    t_phase = time.perf_counter()

    def step(what):
        log(f"[mla] {what} at {time.perf_counter() - t_phase:.1f}s into the phase")

    reset_launches()  # just before the main path
    long = " ".join(["the quick brown fox jumps over the lazy dog hello world"] * 3)
    for form in ("absorbed", "decompressed"):
        with mla_form(form):
            for shape in ("tiny-minicpm3", "tiny-plm"):
                gpu, cpu = tiny_card_vs_cpu(f"mla {form}", tmp, shape, "Q4_K_M",
                                            torch.bfloat16, long)
                del gpu, cpu
    got = read_launches()  # just after the main path
    for k in ("bf16.d288v256", "bf16.d576v512", "bf16.d96v64", "bf16.d192v128"):
        for r in ("decode", "prefill"):
            expect(got[f"flash_{k}.{r}"] > 0, f"mla tiny: flash {k} launched in the {r} regime")
    expect(got["attn_dense_routes"] == 0 and got["dequant_routes"] == 0,
           "mla tiny: no counted route")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    step("tiny shapes, both forms")

    def forms_ref(eng) -> tuple:
        """A prompt, the absorbed engine's greedy ids on it and its rows
        teacher-forced on them: what the decompressed form is held to."""
        prompt = _word_ids(eng.tokenizer, MLA_BRIEF[0])
        eng.reset()
        ids = eng.generate_tokens_device(prompt, MLA_BRIEF[1], temp=0.0, stop_on_eog=False,
                                         chunk=MLA_BRIEF[1])
        return prompt, ids, _teacher_logits(eng, prompt, ids)

    label = "minicpm3-4b" + (f"-{MINICPM3_LAYERS}l" if MINICPM3_LAYERS else "")
    path = synthesize(tmp, "mla", "minicpm3-4b", "Q4_K_M", n_layer=MINICPM3_LAYERS)
    res, eng, _ = mla_absorbed_run(label, path, launches, dense=True)
    ref = forms_ref(eng)
    del eng
    step(f"{label} on the latent")
    res["decompressed"] = mla_decompressed_runs(label, path, launches, ref)
    result["minicpm3-4b"] = res
    path.unlink()
    step(f"{label} decompressed")

    label = "plm-1.8b"
    path = synthesize(tmp, "mla", "plm-1.8b", "Q4_K_M", n_layer=PLM_LAYERS, vocab="bpe")
    res, eng, key = mla_absorbed_run(label, path, launches, dense=False)
    ref = forms_ref(eng)
    prompts = [_word_ids(eng.tokenizer, n) for n in MLA_SLOT_LENS]
    eng.new_cache(kv_dtype=torch.bfloat16)
    refs = engine_refs(eng, prompts, MLA_SLOT_STEPS)
    model = eng.model  # the BatchEngine shares the Engine's weights (no second load)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # just before the batched path
    be = BatchEngine(model, n_slots=4, max_seq=MLA_CTX, prefill_chunk=512)
    be.precompile()
    serving = teacher_forced(f"{label} serving", be, None, prompts, MLA_SLOT_STEPS, refs=refs)
    del be, model
    gc.collect()
    torch.cuda.empty_cache()
    got = read_launches()  # just after the batched path
    log(f"[mla] {label}: launches of the BatchEngine round (3 slots fed, 1 idle) {got}")
    expect(got[f"flash_{key}.decode"] > 0 and got[f"flash_{key}.prefill"] > 0
           and got["qmm_tc"] > 0 and got["attn_dense_routes"] == 0,
           f"{label} serving: the latent form in both regimes, qmm_tc, no dense route")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    serving["launches"] = got
    res["serving"] = serving
    step(f"{label} on the latent, 4 slots")
    res["decompressed"] = mla_decompressed_runs(label, path, launches, ref)
    result["plm-1.8b"] = res
    path.unlink()
    step(f"{label} decompressed")
    expect(not any(qmm.DEQUANT_ROUTES.values()) and not any(flash.ATTN_DENSE_ROUTES.values()),
           f"mla models: no dequantize-route or dense-attention call ({qmm.DEQUANT_ROUTES}, "
           f"{flash.ATTN_DENSE_ROUTES})")
    return result


QWEN_CTX = 4096  # max_seq
# prompts of the Qwen3-30B-A3B serve: 16 tokens (a gather-regime prefill: 128
# rows of qmm_gather), 2560 (one forward at the 4096 bucket, every expert on
# every token) and 512, then on the bf16 cache 2560 again (warm, and the
# determinism check)
QWEN_LENS = (16, 2560, 512)
QWEN_SLOT_LENS = (40, 200, 500)  # the BatchEngine round's prompts (its slot 3 idle)
QWEN_TEACHER = 8  # teacher-forced batched steps against Engine
QWEN7B_LAYERS = 4  # Qwen2.5-7B's depth on the card (full width)
# Qwen3-30B-A3B's depth on the card (full width; of 48: the smoke's time
# limit; 24 since the mla models phase, 8 since the engine options phase)
QWEN3_LAYERS = 8
QWEN_TEACHER_7B = 16  # its positions teacher-forced against dense weights


def phase_qwen(tmp: Path, launches: dict) -> dict:
    """The Qwen families (arch qwen3moe, the qwen-moe graph; arch qwen2, an
    alias of the llama graph), synthesized from seed 0 on Qwen's BPE (pre
    "qwen2"):
    1. tiny-qwen3moe (a 30-token prompt: every expert; a 7-token one, q8:
       the gather), tiny-qwen2moe and tiny-qwen2 on the card against the
       CPU (tiny_card_vs_cpu);
    2. Qwen3-30B-A3B Q4_K_M at full width, QWEN3_LAYERS of its 48 layers
       (n_embd 2048, 32 heads over 4 of 128, 128 experts top-8 of 768,
       vocab 151936): the
       bytes earlier phases leave on the card, load s and peak GiB above
       them, the planes a decode token streams; `serve` on a bf16 cache
       (prompts QWEN_LENS, 64 greedy tokens each on the decode
       graph: TTFT, decode tok/s, launches per regime, device ms by family
       of a decode token and of a 512-token prefill); a decode replay's and
       a 512-token prefill forward's launches against moe_launch_want;
    3. a BatchEngine of 4 slots, slot 3 idle, teacher-forced on Engine's
       greedy ids (its references taken before the Engine is released);
    4. no call through the dequantize or the dense attention route in the
       phase (qmm.DEQUANT_ROUTES and flash.ATTN_DENSE_ROUTES do not move);
    5. Qwen2.5-7B Q4_K_M at full width, QWEN7B_LAYERS layers: `serve` (a
       512-token prompt, 16 greedy tokens, a profiled prefill); then the
       kernels at its shapes (K = 3584 and 18944, q/k/v biases) against
       dense bf16 weights, teacher-forced on QWEN_TEACHER_7B positions of
       the packed engine's greedy ids after a 512-token prompt: logits
       within SERVE_NMSE_BOUND and the same argmax."""
    import torch

    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    reset_launches()  # just before the main path (each serve resets them again)
    long = " ".join(["the quick brown fox jumps over the lazy dog hello world"] * 3)
    for shape, kv, prompt in (("tiny-qwen3moe", torch.bfloat16, long),
                              ("tiny-qwen3moe", "q8_0", "hello world the quick fox"),
                              ("tiny-qwen2moe", torch.bfloat16, long),
                              ("tiny-qwen2", torch.bfloat16, long)):
        gpu, cpu = tiny_card_vs_cpu("qwen", tmp, shape, "Q4_K_M", kv, prompt)
        del gpu, cpu

    def expect_no_routes(label):
        expect(not any(qmm.DEQUANT_ROUTES.values()) and not any(flash.ATTN_DENSE_ROUTES.values()),
               f"{label}: no dequantize-route or dense-attention call since the counts were set "
               f"to 0 ({qmm.DEQUANT_ROUTES}, {flash.ATTN_DENSE_ROUTES})")
    expect_no_routes("qwen tiny")

    path = synthesize(tmp, "qwen", "qwen3-30b-a3b", "Q4_K_M", n_layer=QWEN3_LAYERS,
                      vocab="bpe")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    log(f"[qwen] the card holds {base / 2**30:.2f} GiB of earlier phases' tensors before the "
        f"load")
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(path, max_seq=QWEN_CTX)
    load_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    hp = eng.hp
    resident, per_token = plane_bytes(eng.params, hp.n_expert_used)
    log(f"[qwen] {hp.arch}: {hp.n_layer} layers, n_embd {hp.n_embd}, {hp.n_head} heads over "
        f"{hp.n_head_kv} of {hp.head_dim}, experts {hp.n_expert} top-{hp.n_expert_used} of "
        f"{hp.n_ff_exp}, vocab {hp.n_vocab}, rope {hp.rope.style} θ {hp.rope.freq_base}; "
        f"loaded in {eng.perf.t_load_s:.1f}s, peak {load_peak:.2f} GiB above the baseline; "
        f"{eng.report()}; planes resident {resident / 2**30:.2f} GiB, a decode token streams "
        f"{per_token / 1e9:.3f} GB (bound {per_token / PEAK_BYTES * 1e3:.3f} ms)")
    expect(hp.arch == "qwen3moe" and hp.rope.style == "neox" and hp.n_expert == 128,
           "qwen: Qwen3-30B-A3B's hparams (qwen3moe, NEOX RoPE, 128 experts)")
    result.update(load_s=eng.perf.t_load_s, load_peak_gib=load_peak, baseline_gib=base / 2**30,
                  resident_gib=resident / 2**30, decode_plane_gb=per_token / 1e9,
                  decode_bound_ms=per_token / PEAK_BYTES * 1e3)

    runs = []
    for kv in (torch.bfloat16,):  # its q8 cache: OLMoE's and phi's q8 runs hold D = 128
        run = serve("qwen3-30b-a3b", path, kv, launches, lens=QWEN_LENS, engine=eng,
                    repeat=kv is torch.bfloat16)
        expect(run["launches"]["qmm_stack"] > 0 and run["launches"]["qmm_gather"] > 0,
               f"qwen {run['kv']}: qmm_stack and qmm_gather launched")
        runs.append(run)
        run.update(moe_launch_checks("qwen", f"kv={run['kv']}", eng))
    result["runs"] = runs

    prompts = [_word_ids(eng.tokenizer, n) for n in QWEN_SLOT_LENS]
    eng.new_cache(kv_dtype=torch.bfloat16)
    refs = engine_refs(eng, prompts, QWEN_TEACHER)
    model = eng.model  # the BatchEngine shares the Engine's weights (no second load)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # just before the batched path
    be = BatchEngine(model, n_slots=4, max_seq=QWEN_CTX, prefill_chunk=512)
    be.precompile()
    result["serving"] = teacher_forced("qwen serving", be, None, prompts, QWEN_TEACHER,
                                       refs=refs)
    del be, model
    gc.collect()
    torch.cuda.empty_cache()
    got = read_launches()  # just after the batched path
    log(f"[qwen] launches of the BatchEngine round (3 slots fed, 1 idle) {got}")
    expect(got["qmm_stack"] > 0 and got["qmm_gather"] > 0 and got["flash_bf16.decode"] > 0
           and got["flash_bf16"] > got["flash_bf16.decode"],
           "qwen serving: qmm_stack (the joint round), qmm_gather and flash's decode regime "
           "(the batched steps) and its prefill regime launched")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["serving"]["launches"] = got
    expect_no_routes("qwen serving")
    path.unlink()

    path = synthesize(tmp, "qwen", "qwen2.5-7b", "Q4_K_M", n_layer=QWEN7B_LAYERS, vocab="bpe")
    result["qwen2.5-7b"] = serve(f"qwen2.5-7b-{QWEN7B_LAYERS}l", path, torch.bfloat16, launches,
                                 short=512, prefill_len=512)
    result["qwen2.5-7b"]["dense"] = against_dense("qwen2.5-7b", path, QWEN_CTX,
                                                  QWEN_TEACHER_7B)
    expect_no_routes("qwen2.5-7b")
    path.unlink()
    return result


def against_dense(label: str, path: Path, max_seq: int, positions: int,
                  engine=None) -> dict:
    """The kernels against dense bf16 weights on one file: the packed
    Engine's (`engine`, or one loaded here) `positions` greedy ids after a
    512-token prompt, then both Engines' logits teacher-forced on them,
    within SERVE_NMSE_BOUND, and at every position the packed argmax a
    maximum of the dense row (where it parts: the dense top-2 margin and
    the packed logits' largest deviation there, reported)."""
    import torch

    from tpullm_torch.runtime.engine import Engine

    eng = engine or Engine(path, max_seq=max_seq)
    eng.reset()
    prompt = _word_ids(eng.tokenizer, 512)
    ids = eng.generate_tokens_device(prompt, positions, temp=0.0, stop_on_eog=False,
                                     chunk=positions)
    expect(len(ids) == positions, f"{label}: {len(ids)} greedy ids")
    packed_rows = _teacher_logits(eng, prompt, ids)
    del eng
    dense = Engine(path, max_seq=max_seq, mode="dense")
    dense_rows = _teacher_logits(dense, prompt, ids)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    errs = [_nmse_np(a, b) for a, b in zip(packed_rows, dense_rows)]
    # the packed argmax is a dense one: a maximum of the dense row, which
    # the bf16 head can hold at several ids at once (an exact tie)
    same = sum(int(b[np.argmax(a)] == b.max()) for a, b in zip(packed_rows, dense_rows))
    ties = [int((b == b.max()).sum()) for b in dense_rows]
    margins = [float(np.diff(np.sort(b)[-2:])[0]) for b in dense_rows]
    parted = [dict(position=i, margin=margins[i], deviation=float(np.abs(a - b).max()))
              for i, (a, b) in enumerate(zip(packed_rows, dense_rows))
              if b[np.argmax(a)] != b.max()]
    log(f"[{label}] the kernels against dense bf16 weights, teacher-forced on {len(ids)} "
        f"positions after a 512-token prompt: NMSE worst {max(errs):.2e} mean "
        f"{np.mean(errs):.2e}, the packed argmax a dense maximum at {same}/{len(ids)} (dense "
        f"top-2 margin at least {min(margins):.3g}; ids tied at the dense maximum: at most "
        f"{max(ties)}); parted at {parted}")
    expect(all(np.isfinite(r).all() for r in packed_rows + dense_rows),
           f"{label}: finite logits, packed and dense")
    expect(max(errs) <= SERVE_NMSE_BOUND,
           f"{label}: NMSE against dense weights {max(errs):.3e} <= {SERVE_NMSE_BOUND}")
    expect(same == len(ids), f"{label}: the packed argmax a dense maximum at every position "
           f"({same}/{len(ids)})")
    return dict(worst=max(errs), mean=float(np.mean(errs)), same_top=same, positions=len(ids),
                min_margin=min(margins), max_tied=max(ties), parted=parted)


MOE_FAMILY_CTX = 4096  # max_seq of the three (Scout's cache within one chunk of 8192)
PHIMOE_LAYERS = 8  # Phi-3.5-MoE's depth on the card (of 32)
SCOUT_LAYERS = 4  # Llama-4-Scout's depth on the card (of 48)
# OLMoE's serve: 16 tokens (a gather-regime prefill: 128 rows of qmm_gather),
# 2560 and 512, then 2560 again on the bf16 cache
OLMOE_LENS = (16, 2560, 512)
OLMOE_SLOT_LENS = (40, 200, 500)  # the BatchEngine round's prompts (its slot 3 idle)
# The random OLMoE's prefill rows are chaotic: its q/k norms of unit weight give
# all but one-hot attention, and a router near-tie of the 8th expert moves a row
# by NMSE 1e-4 in one layer. The 40-token prompt's last row ends in the opposite
# sign (NMSE 3.996 against Engine's) when its joint round runs at another row
# count, and so does Engine itself at another bucket in layer 2 (NMSE 0.31 there,
# back to 5.9e-5 at the head); the slots of one joint forward are bit-equal
# (PERF.md §6). The batched steps are held to SERVE_NMSE_BOUND, the joint round's
# rows reported.
OLMOE_TEACHER = 8  # teacher-forced batched steps against Engine
PHIMOE_DENSE_POSITIONS = 16  # positions teacher-forced against dense weights
# Phi-3.5-MoE's depth where it is held against dense weights: the random stack of
# LayerNorms with biases amplifies the bf16 rounding with depth (NMSE 3.8e-4 at 1
# layer, 3.3e-4 at 2, 9.58e-4 at 8 on the H100, PERF.md §6; at 2 layers a dense
# top-2 near-tie parts one argmax), as Phi-2's does
PHIMOE_DENSE_LAYERS = 1
TINY_CHUNKED_LAYERS = 3  # tiny-llama4's chunked layers (of 4; layer 3 NoPE)


SPARSEMIXER_EPS = 0.01  # route_sparsemixer's jitter_eps: the band is 2·eps relative


def sparsemixer_choices(logits):
    """route_sparsemixer's discrete choices on router logits [N, E] (the
    same f32 steps): (the two experts [N, 2], each round's band [N, 2, E],
    each row's margin [N]: the least relative distance of a logit to a
    round's band edge or, for an expert not chosen, to the round's
    maximum)."""
    import torch
    import torch.nn.functional as F

    s = logits.float()
    scores, sels, bands, margins = s, [], [], []
    for _ in range(2):
        m = scores.max(-1, keepdim=True).values
        sel = torch.argmax(scores, -1)
        rel = (m - s) / torch.maximum(s.abs(), m)
        chosen = F.one_hot(sel, s.shape[-1]).bool()
        bands.append(~(rel > 2.0 * SPARSEMIXER_EPS))
        other = ~chosen & (scores > -1e29)  # the experts this round could still take
        margins.append(torch.where(other, torch.minimum((rel - 2.0 * SPARSEMIXER_EPS).abs(),
                                                        rel.clamp(min=0)),
                                   float("inf")).min(-1).values)
        sels.append(sel)
        scores = torch.where(chosen, -1e30, s)
    return torch.stack(sels, -1), torch.stack(bands, 1), torch.minimum(*margins)


def sparsemixer_forced(logits, sel, band):
    """route_sparsemixer's weights on `logits` under given choices (the
    experts `sel` [N, 2] and each round's `band` [N, 2, E])."""
    import torch
    import torch.nn.functional as F

    s = logits.float()
    scores, ws = s, []
    for r in range(2):
        gates = torch.softmax(torch.where(band[:, r], scores, -1e30), -1)
        ws.append(gates.gather(-1, sel[:, r:r + 1])[:, 0])
        scores = torch.where(F.one_hot(sel[:, r], s.shape[-1]).bool(), -1e30, s)
    return torch.stack(ws, -1), sel.to(torch.int32)


def sparsemixer_against_dense(label: str, path: Path, max_seq: int, positions: int) -> dict:
    """PhiMoE's kernels against dense bf16 weights under one set of routing
    choices: sparsemixer's band is a step, and the packed and the dense
    engines' bf16 activations put a router logit near its edge on either
    side, so each engine routing on its own parts where the kernels are
    right. The packed Engine's `positions` greedy ids after a 512-token
    prompt (its decode graph); then both Engines teacher-forced
    on them with eager steps, the packed engine's choices recorded
    (`sparsemixer_choices`) and imposed on the dense engine's own router
    logits (`sparsemixer_forced`): logits within SERVE_NMSE_BOUND and the
    packed argmax a dense maximum at every position. Reported: the routed
    rows where the dense engine's own choices part, and the largest margin
    (`sparsemixer_choices`) among them."""
    import torch

    from tpullm_torch.models import phi3
    from tpullm_torch.runtime.engine import Engine

    eng = Engine(path, max_seq=max_seq)
    prompt = _word_ids(eng.tokenizer, 512)
    ids = eng.generate_tokens_device(prompt, positions, temp=0.0, stop_on_eog=False,
                                     chunk=positions)
    expect(len(ids) == positions, f"{label}: {len(ids)} greedy ids")
    route = phi3.route_sparsemixer
    record, flips = [], []

    def recording(logits):
        record.append(sparsemixer_choices(logits))
        w, idx = route(logits)
        expect(bool(torch.equal(idx.long(), record[-1][0])),
               f"{label}: sparsemixer_choices gives route_sparsemixer's experts")
        return w, idx

    def forcing(logits):
        sel, band, margin = record[len(flips)]
        own_sel, own_band, _ = sparsemixer_choices(logits)
        parted = (own_sel != sel).any(-1) | (own_band != band).any(-1).any(-1)
        flips.append((int(parted.sum()), float(margin[parted].max()) if parted.any() else 0.0))
        return sparsemixer_forced(logits, sel, band)

    def teacher(e):
        e.reset()
        with torch.inference_mode():
            rows = [e.prefill(prompt)]
            for t in ids[:-1]:
                rows.append(e._decode_logits(torch.tensor(t, device=e.device)).float().cpu()
                            .numpy())
        return rows

    try:
        phi3.route_sparsemixer = recording
        packed_rows = teacher(eng)
        del eng
        gc.collect()
        dense = Engine(path, max_seq=max_seq, mode="dense")
        phi3.route_sparsemixer = forcing
        dense_rows = teacher(dense)
    finally:
        phi3.route_sparsemixer = route
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    errs = [_nmse_np(a, b) for a, b in zip(packed_rows, dense_rows)]
    same = sum(int(b[np.argmax(a)] == b.max()) for a, b in zip(packed_rows, dense_rows))
    parted = [dict(position=i, margin=float(np.diff(np.sort(b)[-2:])[0]),
                   deviation=float(np.abs(a - b).max()))
              for i, (a, b) in enumerate(zip(packed_rows, dense_rows))
              if b[np.argmax(a)] != b.max()]
    n_rows = sum(rec[0].shape[0] for rec in record)
    n_parted = sum(n for n, _ in flips)
    worst_margin = max(m for _, m in flips)
    log(f"[{label}] the kernels against dense bf16 weights under the packed engine's sparsemixer "
        f"choices, teacher-forced on {len(ids)} positions after a 512-token prompt: NMSE worst "
        f"{max(errs):.2e} mean {np.mean(errs):.2e}, the packed argmax a dense maximum at "
        f"{same}/{len(ids)} (parted at {parted}); routing on its own the dense engine parts "
        f"at {n_parted} of "
        f"{n_rows} routed rows (calls × rows), the largest margin among them {worst_margin:.4f}")
    expect(all(np.isfinite(r).all() for r in packed_rows + dense_rows),
           f"{label}: finite logits, packed and dense")
    expect(max(errs) <= SERVE_NMSE_BOUND,
           f"{label}: NMSE against dense weights {max(errs):.3e} <= {SERVE_NMSE_BOUND}")
    expect(same == len(ids), f"{label}: the packed argmax a dense maximum at every position "
           f"({same}/{len(ids)})")
    return dict(worst=max(errs), mean=float(np.mean(errs)), same_top=same, positions=len(ids),
                parted=parted, routed_rows=n_rows, parted_rows=n_parted,
                parted_margin=worst_margin)


def moe_launch_checks(tag: str, label: str, eng, chunk: int = 32) -> dict:
    """A decode replay's (of the runner `serve` ran: chunk 32, or 16 after a
    `short` serve) and a 512-token prefill forward's launches against
    moe_launch_want; `tag` names the phase in the lines."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams

    one = eng.decode_runner(SamplingParams(), chunk).launches_per_replay()
    want = moe_launch_want(eng, 1)
    log(f"[{tag}] {label} launches per decode replay {one}")
    expect(one == want, f"{tag} {label}: launches per decode replay {one} = {want}")
    eng.reset()
    snap = _snapshot()
    eng.prefill(_word_ids(eng.tokenizer, 512))
    torch.cuda.synchronize()
    got = _launch_delta(snap)
    want = moe_launch_want(eng, 512)
    log(f"[{tag}] {label} launches of one 512-token prefill forward {got}")
    expect(got == want, f"{tag} {label}: one prefill forward's launches {got} = {want}")
    return dict(launches_per_decode=one, launches_per_prefill=got)


def stack_share(run: dict) -> float:
    """qmm_stack's share of a serve's profiled 512-token prefill device time."""
    ms = run["prefill_profile"]["device_ms"]
    return ms["qmm_stack"] / sum(ms.values())


def phase_moe_families(tmp: Path, launches: dict) -> dict:
    """Three MoE families, synthesized from seed 0 (written ahead by child
    processes, AHEAD_JOBS):
    1. tiny-olmoe, tiny-phimoe and tiny-llama4 on the card against the CPU
       (tiny_card_vs_cpu) on a 52-token prompt (every expert: qmm_stack) and
       a 10-token one (qmm_gather); tiny-llama4's chunk of 16 in a 256-slot
       cache takes the dense chunk route: flash.ATTN_DENSE_ROUTES moves
       by TINY_CHUNKED_LAYERS a forward, and by nothing else in the phase;
    2. OLMoE-1B-7B Q4_K_M at full width and depth (64 experts top-8, q/k
       norms over the projection): `serve` on a bf16 cache (prompts
       OLMOE_LENS: TTFT, decode tok/s, device ms by family, the 512-token
       prefill's qmm_stack share) and a q8 cache; a decode replay's and a
       512-token prefill's launches against moe_launch_want; a 4-slot
       BatchEngine, slot 3 idle, teacher-forced on Engine's greedy ids (the
       batched steps held, the joint round's rows reported:
       OLMOE_SLOT_LENS);
    3. Phi-3.5-MoE Q4_K_M at full width, PHIMOE_LAYERS of 32 layers
       (sparsemixer top-2 of 16, LayerNorms with biases, a biased head):
       `serve` on bf16, launches; with PHIMOE_DENSE_LAYERS layers the
       logits against dense bf16 weights teacher-forced under the packed
       engine's routing choices (sparsemixer_against_dense);
    4. Llama-4-Scout Q4_K_M at full width, SCOUT_LAYERS of 48 layers (a
       cache of MOE_FAMILY_CTX ≤ its chunk: flash on every layer): `serve`
       on bf16, launches, the shared expert's and the routed experts'
       (qmm_gather, top-1) ms a decode token as graph replays;
    5. no dequantize route anywhere in the phase."""
    import torch

    from tpullm_torch.models.llama import silu_glu
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    t_phase = time.perf_counter()

    def step(what):
        result.setdefault("seconds", {})[what] = time.perf_counter() - t_phase
        log(f"[moe families] {what} at {time.perf_counter() - t_phase:.1f}s into the phase")

    reset_launches()  # just before the main path (each serve resets them again)
    # 52 tokens of the tiny vocab (every expert: qmm_stack) and 10 (qmm_gather)
    long = "the lazy dog jumps over the quick brown fox hello world"
    for shape in ("tiny-olmoe", "tiny-phimoe", "tiny-llama4"):
        for prompt in (long, "hello world"):
            gpu, cpu = tiny_card_vs_cpu("moe families", tmp, shape, "Q4_K_M", torch.bfloat16,
                                        prompt)
            if shape == "tiny-llama4" and prompt is long:
                ids = gpu.tokenizer.tokenize(prompt)
                before = sum(flash.ATTN_DENSE_ROUTES.values())
                gpu.reset()
                gpu.prefill(ids)
                gpu.decode_step(5)
                torch.cuda.synchronize()
                moved = sum(flash.ATTN_DENSE_ROUTES.values()) - before
                log(f"[moe families] tiny-llama4 (chunk {gpu.hp.sliding_window}, cache "
                    f"{gpu.cache.max_len}): a prefill and a decode step moved the dense chunk "
                    f"route by {moved}")
                expect(moved == 2 * TINY_CHUNKED_LAYERS,
                       f"tiny-llama4: the dense chunk route {moved} = 2 forwards × "
                       f"{TINY_CHUNKED_LAYERS} chunked layers")
                result["tiny_llama4_chunk_routes"] = moved
            del gpu, cpu
    expect(not any(qmm.DEQUANT_ROUTES.values()), "moe families tiny: no dequantize route")
    gc.collect()
    step("the tiny models done")

    def expect_no_routes(label):
        expect(not any(qmm.DEQUANT_ROUTES.values()) and not any(flash.ATTN_DENSE_ROUTES.values()),
               f"{label}: no dequantize-route or dense-attention call since the counts were set "
               f"to 0 ({qmm.DEQUANT_ROUTES}, {flash.ATTN_DENSE_ROUTES})")

    # 2. OLMoE-1B-7B at full depth
    path = synthesize(tmp, "moe families", "olmoe-1b-7b", "Q4_K_M", vocab="bpe")
    torch.cuda.empty_cache()
    eng = Engine(path, max_seq=MOE_FAMILY_CTX)
    hp = eng.hp
    log(f"[moe families] olmoe: {hp.n_layer} layers, n_embd {hp.n_embd}, {hp.n_head} heads over "
        f"{hp.n_head_kv}, experts {hp.n_expert} top-{hp.n_expert_used} of {hp.n_ff}, vocab "
        f"{hp.n_vocab}, rope {hp.rope.style}; loaded in {eng.perf.t_load_s:.1f}s; {eng.report()}")
    expect(hp.arch == "olmoe" and hp.rope.style == "neox" and hp.n_expert == 64
           and eng.params["layers"][0]["q_norm"].shape[-1] == hp.n_embd,
           "olmoe: OLMoE-1B-7B's hparams (NEOX RoPE, 64 experts, q norm over the projection)")
    runs = []
    for kv in (torch.bfloat16, "q8_0"):
        run = serve("olmoe-1b-7b", path, kv, launches, lens=OLMOE_LENS, engine=eng,
                    repeat=kv is torch.bfloat16)
        run.update(moe_launch_checks("moe families", f"olmoe kv={run['kv']}", eng))
        run["prefill_stack_share"] = stack_share(run)
        log(f"[moe families] olmoe kv={run['kv']}: qmm_stack {run['prefill_stack_share']:.3f} of "
            "the 512-token prefill's device time (all 64 experts on every token)")
        runs.append(run)
    result["olmoe"] = runs
    prompts = [_word_ids(eng.tokenizer, n) for n in OLMOE_SLOT_LENS]
    eng.new_cache(kv_dtype=torch.bfloat16)
    refs = engine_refs(eng, prompts, OLMOE_TEACHER)
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # just before the batched path
    be = BatchEngine(model, n_slots=4, max_seq=MOE_FAMILY_CTX, prefill_chunk=512)
    be.precompile()
    result["olmoe_serving"] = teacher_forced("olmoe serving", be, None, prompts, OLMOE_TEACHER,
                                             refs=refs, hold_prefill=False)
    del be, model
    gc.collect()
    torch.cuda.empty_cache()
    got = read_launches()  # just after the batched path
    log(f"[moe families] launches of the OLMoE BatchEngine round (3 slots fed, 1 idle) {got}")
    expect(got["qmm_stack"] > 0 and got["qmm_gather"] > 0 and got["flash_bf16.decode"] > 0,
           "olmoe serving: qmm_stack (the joint round), qmm_gather and flash's decode regime "
           "(the batched steps) launched")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["olmoe_serving"]["launches"] = got
    expect_no_routes("olmoe serving")
    path.unlink()
    step("OLMoE-1B-7B done")

    # 3. Phi-3.5-MoE with PHIMOE_LAYERS layers
    path = synthesize(tmp, "moe families", "phi-3.5-moe", "Q4_K_M", n_layer=PHIMOE_LAYERS)
    eng = Engine(path, max_seq=MOE_FAMILY_CTX)
    hp = eng.hp
    expect(hp.arch == "phimoe" and hp.n_expert_used == 2
           and eng.params["layers"][0]["attn_norm_b"] is not None
           and eng.params["output_b"] is not None,
           "phimoe: sparsemixer's top-2, LayerNorm biases, the head's bias")
    run = serve(f"phi-3.5-moe-{PHIMOE_LAYERS}l", path, torch.bfloat16, launches, short=512,
                prefill_len=512, engine=eng)
    run.update(moe_launch_checks("moe families", "phi-3.5-moe", eng, chunk=16))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    reset_launches()
    path = synthesize(tmp, "moe families", "phi-3.5-moe", "Q4_K_M",
                      n_layer=PHIMOE_DENSE_LAYERS)
    run["dense"] = sparsemixer_against_dense(f"phi-3.5-moe-{PHIMOE_DENSE_LAYERS}l", path,
                                             MOE_FAMILY_CTX, PHIMOE_DENSE_POSITIONS)
    expect_no_routes("phi-3.5-moe")
    result["phimoe"] = run
    path.unlink()
    step("Phi-3.5-MoE done")

    # 4. Llama-4-Scout with SCOUT_LAYERS layers
    path = synthesize(tmp, "moe families", "llama-4-scout", "Q4_K_M", n_layer=SCOUT_LAYERS,
                      vocab="bpe")
    eng = Engine(path, max_seq=MOE_FAMILY_CTX)
    hp = eng.hp
    expect(hp.arch == "llama4" and hp.sliding_window == 8192 and hp.n_expert_used == 1
           and eng.cache.max_len <= hp.sliding_window,
           "llama4: Scout's chunk of 8192 above the cache (flash on every layer), top-1")
    run = serve(f"llama-4-scout-{SCOUT_LAYERS}l", path, torch.bfloat16, launches, short=512,
                prefill_len=512, engine=eng)
    run.update(moe_launch_checks("moe families", "llama-4-scout", eng, chunk=16))
    run["prefill_stack_share"] = stack_share(run)
    expect(run["launches"]["flash_bf16"] > 0 and run["launches"]["attn_dense_routes"] == 0,
           "llama-4-scout: every layer on flash, no dense chunk route")
    layer = eng.params["layers"][0]
    gen = torch.Generator(eng.device).manual_seed(4)
    x = (torch.randn(1, hp.n_embd, generator=gen, device=eng.device) * 0.5).to(torch.bfloat16)
    with torch.inference_mode():
        w, idx = moe.route(x.float() @ layer["router"].w.float(), 1, gating="sigmoid")
        shexp_ms = time_ms(lambda: layer["w_down_shexp"](silu_glu(layer["w_gate_shexp"](x),
                                                                  layer["w_up_shexp"](x))), 50)
        gather_ms = time_ms(lambda: moe.moe_ffn(x, w, idx, layer["w_gate_exps"],
                                                layer["w_up_exps"], layer["w_down_exps"],
                                                weight_before_ffn=True), 50)
    sh_bytes = sum(b.numel() * b.element_size() for key in ("w_gate_shexp", "w_up_shexp",
                                                            "w_down_shexp")
                   for b in layer[key].buffers())
    ex_bytes = sum(b.numel() * b.element_size() / hp.n_expert
                   for key in ("w_gate_exps", "w_up_exps", "w_down_exps")
                   for b in layer[key].buffers())
    run.update(shexp_ms=shexp_ms, shexp_bound_ms=sh_bytes / PEAK_BYTES * 1e3,
               gather_ms=gather_ms, gather_bound_ms=ex_bytes / PEAK_BYTES * 1e3)
    log(f"[moe families] llama-4-scout a decode token's layer: the shared expert {shexp_ms:.4f} "
        f"ms (bound {run['shexp_bound_ms']:.4f} ms), the routed expert (qmm_gather, top-1, "
        f"weight before the FFN) {gather_ms:.4f} ms (bound {run['gather_bound_ms']:.4f} ms); "
        f"the 512-token prefill's qmm_stack share {run['prefill_stack_share']:.3f}")
    del eng, layer
    gc.collect()
    torch.cuda.empty_cache()
    expect_no_routes("llama-4-scout")
    result["llama4"] = run
    path.unlink()
    step("Llama-4-Scout done")
    return result


# the recurrent models' shapes (the recurrent phase): the 2-D linears at
# their Q4_K_M types: Falcon-Mamba-7B's ssm_in, ssm_x (N = dt rank 256 + 2 ·
# 16), ssm_dt (K = 256) and ssm_out and its head; Mamba-Codestral-7B's ssm_in
# (N = 2 · 8192 + 2 · 8 · 128 + 128); Jamba-Mini-1.5's attention and dense FFN;
# Granite-4.0-H-Tiny's ssm_in, ssm_out, attention and shared expert
RECURRENT_QMM_SHAPES = (
    ("Q4_K", "falcon-mamba ssm_in", 4096, 16384), ("Q4_K", "falcon-mamba ssm_x", 8192, 288),
    ("Q4_K", "falcon-mamba ssm_dt", 256, 8192), ("Q4_K", "falcon-mamba ssm_out", 8192, 4096),
    ("Q6_K", "falcon-mamba head", 4096, 65024),
    ("Q4_K", "codestral ssm_in", 4096, 18560),
    ("Q4_K", "jamba q", 4096, 4096), ("Q4_K", "jamba k", 4096, 1024),
    ("Q4_K", "jamba gate|up", 4096, 28672), ("Q6_K", "jamba down", 14336, 4096),
    ("Q4_K", "granite ssm_in", 1536, 6448), ("Q4_K", "granite ssm_out", 3072, 1536),
    ("Q4_K", "granite q", 1536, 1536), ("Q4_K", "granite k", 1536, 512),
    ("Q4_K", "granite shexp gate", 1536, 1024), ("Q4_K", "granite shexp down", 1024, 1536))
RECURRENT_QMM_ROWS = (1, 512)
# Jamba-Mini-1.5's 16 experts of 14336 at top-2, Granite-4.0-H-Tiny's 64 of 512
# at top-6: the gather at a decode token and at 8 tokens, the stack at 512
RECURRENT_EXPERTS = (
    (16, 2, (("Q4_K", "jamba gate", 4096, 14336, True),
             ("Q6_K", "jamba down", 14336, 4096, False)), (1, 8)),
    (64, 6, (("Q4_K", "granite gate", 1536, 512, True),
             ("Q4_K", "granite down", 512, 1536, False)), (1, 2)))
# Jamba's 32 heads on 8 (R = 4), Granite's 12 on 4 (R = 3), both at D = 128
RECURRENT_HEADS = ((32, 8), (12, 4))


def phase_recurrent_kernels(dev, results: dict, rec: dict):
    """The kernels at the recurrent models' shapes, each against its plain
    version and timed beside its bound and library call: qmm at
    RECURRENT_QMM_SHAPES (M = 1 on CUDA cores, 512 on the tensor cores),
    the gather and the stack at RECURRENT_EXPERTS, flash at
    RECURRENT_HEADS. Rows go to `results` and to `rec` by kernel."""
    import torch

    gen = torch.Generator(dev).manual_seed(23)
    qmm_at_shapes("recurrent", dev, gen, RECURRENT_QMM_SHAPES, RECURRENT_QMM_ROWS, results, rec)
    for E, top_k, shapes, tokens in RECURRENT_EXPERTS:
        expert_rows("recurrent", dev, gen, E, top_k, shapes, tokens, results, rec)
    flash_at_heads("recurrent", dev, gen, RECURRENT_HEADS, results, rec)


RECURRENT_CTX = 4096  # max_seq of the four
RECURRENT_LENS = (512, 600)  # TTFT prompts: one ladder chunk; 512, 32, 32, 8, 8, 8
RECURRENT_GEN = 64  # decode steps timed through the decode graph (two chunks of 32)
RECURRENT_PROFILE_STEPS = 16  # decode replays profiled
RECURRENT_DENSE_POSITIONS = 16  # positions teacher-forced against dense weights
RECURRENT_SLOT_LENS = (40, 600, 200)  # Jamba's 4-slot BatchEngine: slots 0-2; 3 idle
RECURRENT_TEACHER = 8  # teacher-forced batched steps against Engine
# the tiny shapes of the names no card model runs (tests/test_torch_cuda.py
# holds all eight card against CPU)
RECURRENT_TINY = ("tiny-mamba", "tiny-nemotron-h", "tiny-nemotron-h-moe", "tiny-falcon-h1")


def recurrent_launch_want(eng, rows: int) -> dict:
    """One recurrent forward's launches by COUNT_NAMES at `rows` rows (1: a
    decode step): every quantized 2-D linear of the layers through qmm
    (qmm_tc from 16 rows), the expert stacks through qmm_gather (≤ 16 rows)
    or qmm_stack, flash once an attention layer (the HybridCache's K/V
    layers; none on a RecurrentCache) in the regime T·H/Hkv picks; the
    head through qmm on the last row unless it is tied (a plain product).
    The conv and the scan launch no kernel of the port's: plain torch."""
    from tpullm_torch.models.weights import FusedLinear, QuantExpertStack, QuantLinear
    from tpullm_torch.ops import moe
    from tpullm_torch.ops.kernels import flash, qmm

    def base(m):
        return m.base if isinstance(m, FusedLinear) else m

    quant = [base(m) for layer in eng.params["layers"] for m in layer.values()
             if isinstance(base(m), QuantLinear)]
    stacks = sum(isinstance(m, QuantExpertStack) for layer in eng.params["layers"]
                 for m in layer.values())
    tc, gather = rows >= qmm.TC_MIN_M, rows <= moe._GATHER_MAX_TOKENS
    n_attn = eng.cache.k.shape[0] if hasattr(eng.cache, "k") else 0
    decode = n_attn and flash.regime(rows, eng.hp.n_head, eng.hp.n_head_kv) == "decode"
    head = int(isinstance(eng.params["output"], QuantLinear))
    return {"qmm": (0 if tc else len(quant)) + head, "qmm_tc": len(quant) if tc else 0,
            "qmm_stack": 0 if gather else stacks, "qmm_gather": stacks if gather else 0,
            "qmm_grouped": 0, "dequant_routes": 0, "flash": n_attn,
            "flash_decode": n_attn if decode else 0, "attn_dense_routes": 0,
            "attn_ring_routes": 0}


def _mixer_ms(eng, rows: int) -> float:
    """Device ms of one mixer layer's conv and scan (plain torch) at `rows`
    tokens, as graph replays on random inputs of the layer's widths: what
    'other' holds of the SSM layers, per layer."""
    import torch

    from tpullm_torch.models import mamba

    hp, dev = eng.hp, eng.device
    layer = next(la for la in eng.params["layers"] if la.get("ssm_in") is not None)
    gen = torch.Generator(dev).manual_seed(rows)
    D, S, G, W = hp.ssm_d_inner, hp.ssm_d_state, hp.ssm_n_group, layer["conv_w"].shape[0]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    x, st = rand(1, rows, W), rand(1, W, hp.ssm_d_conv - 1)
    if G:
        H = hp.ssm_dt_rank
        args = (rand(1, rows, H, D // H), rand(1, rows, H, scale=0.05).abs(), layer["A_log"],
                rand(1, rows, G, S), rand(1, rows, G, S), rand(1, H, D // H, S))

        def step():
            mamba.causal_conv(x, st, layer["conv_w"], layer["conv_b"])
            mamba.ssd_scan(*args, G)
    else:
        args = (rand(1, rows, D), rand(1, rows, D, scale=0.05).abs(), layer["A_log"],
                rand(1, rows, S), rand(1, rows, S), rand(1, D, S))

        def step():
            mamba.causal_conv(x, st, layer["conv_w"], layer["conv_b"])
            mamba.selective_scan(*args)
    with torch.inference_mode():
        return time_ms(step, 5 if rows > 1 else 50)


def recurrent_run(label: str, path: Path, launches: dict, slots: bool = False) -> dict:
    """One card model through Engine (bf16): its launches (a decode
    replay's and a 512-token prefill's, each against recurrent_launch_want,
    and the 600-token prompt's six ladder forwards against their sum); TTFT
    of RECURRENT_LENS (each timed warm, after one run) and decode tok/s of
    RECURRENT_GEN greedy steps through the decode graph; a decode token's
    and a 512-token prefill's device time by kernel family, beside the
    conv and scan's ms (`_mixer_ms`) times the mixer layers; the ladder's
    tail (a profiled 600-token prefill less the 512's): its wall against
    its device busy time, the rest the host's; with `slots` the 4-slot
    BatchEngine (`recurrent_slots`); then the same file against dense bf16
    weights (against_dense on the packed engine's ids)."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine, recurrent_chunks

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # just before the main path
    eng = Engine(path, max_seq=RECURRENT_CTX)
    hp = eng.hp
    n_mix = eng.cache.ssm.shape[0]
    log(f"[recurrent] {label}: {hp.arch}, {hp.n_layer} layers ({n_mix} mixers), n_embd "
        f"{hp.n_embd}, d_inner {hp.ssm_d_inner}, state {hp.ssm_d_state}, dt rank/heads "
        f"{hp.ssm_dt_rank}, groups {hp.ssm_n_group}, experts {hp.n_expert} top-"
        f"{hp.n_expert_used}, vocab {hp.n_vocab}; loaded in {eng.perf.t_load_s:.1f}s; "
        f"{eng.report()}")
    out = dict(arch=hp.arch, layers=hp.n_layer, mixers=n_mix, load_s=eng.perf.t_load_s,
               cache=eng.report().split("| cache ")[1])
    words = _word_ids(eng.tokenizer, max(RECURRENT_LENS))
    eng.generate_tokens_device(words[:512], 8, stop_on_eog=False)  # warm-up
    runner = eng.decode_runner(SamplingParams(), 32)
    one, want = runner.launches_per_replay(), recurrent_launch_want(eng, 1)
    log(f"[recurrent] {label} launches per decode replay {one}")
    expect(one == want, f"{label}: launches per decode replay {one} = {want}")
    ttft = {}
    for n in RECURRENT_LENS:
        for _ in range(2):  # the second, warm, is kept
            eng.reset()
            torch.cuda.synchronize()
            snap = _snapshot()
            t0 = time.perf_counter()
            logits = eng.prefill(words[:n])
            ttft[n] = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in _launch_delta(snap).items() if v}
        chunks = recurrent_chunks(n, eng.prefill_cap)
        want = {}
        for c in chunks:
            for k, v in recurrent_launch_want(eng, c).items():
                want[k] = want.get(k, 0) + v
        want = {k: v for k, v in want.items() if v}
        log(f"[recurrent] {label} {n}-token prompt in chunks {chunks}: TTFT {ttft[n]:.2f} ms, "
            f"launches {got}")
        expect(got == want, f"{label}: the {n}-token prefill's launches {got} = {want}")
        expect(bool(np.isfinite(logits).all()) and logits.shape == (hp.n_vocab,),
               f"{label}: finite logits of the vocab's width")
    out.update(ttft_ms=ttft, launches_per_decode=one)
    _start(eng, runner, words[:512])
    t0 = time.perf_counter()
    ids = run_steps(runner, 32) + run_steps(runner, 32)
    dt = time.perf_counter() - t0
    out["decode_tok_s"] = RECURRENT_GEN / dt
    expect(len(ids) == RECURRENT_GEN, f"{label}: {len(ids)} greedy ids")
    prof = profile_decode(eng, runner, words[:512], RECURRENT_PROFILE_STEPS)
    pre = profile_prefill(eng, words[:512])
    # the ladder's tail: the 88 tokens past 512 (five chunks), wall against device busy
    pre600 = profile_prefill(eng, words[:600])
    tail_wall = pre600["wall_ms"] - pre["wall_ms"]
    tail_busy = sum(pre600["device_ms"].values()) - sum(pre["device_ms"].values())
    mixer = {rows: _mixer_ms(eng, rows) * n_mix for rows in (1, 512)}
    out.update(decode_profile=prof, prefill_profile=pre, prefill_600_profile=pre600,
               conv_scan_ms=mixer, tail_wall_ms=tail_wall, tail_busy_ms=tail_busy)
    log(f"[recurrent] {label}: the ladder's tail (600 − 512 tokens, chunks "
        f"{recurrent_chunks(600, eng.prefill_cap)[1:]}): wall {tail_wall:.3f} ms, device busy "
        f"{tail_busy:.3f} ms, host {tail_wall - tail_busy:.3f} ms (profiled: 512 wall "
        f"{pre['wall_ms']:.3f}, 600 wall {pre600['wall_ms']:.3f}; 600 busy by family "
        f"{pre600['device_ms']})")
    log(f"[recurrent] {label}: decode {out['decode_tok_s']:.1f} tok/s (graph replays); a decode "
        f"token's device ms by family {prof['device_ms_per_token']} (event span "
        f"{prof['event_span_ms_per_token']:.3f} ms); a 512-token prefill's {pre['device_ms']} "
        f"(wall {pre['wall_ms']:.1f} ms); the conv and scan of the {n_mix} mixers alone: "
        f"{mixer[1]:.4f} ms a decode token, {mixer[512]:.3f} ms a 512-token chunk; top "
        f"{prof['top'][:5]}")
    expect(prof["reduce_launches"] == dict.fromkeys(REDUCTION_KERNELS, 0),
           f"{label}: no reduction kernel in a decode step")
    if slots:
        out["slots"] = recurrent_slots(label, eng)
    del runner
    got = read_launches()  # just after the main path
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0
           and got["attn_ring_routes"] == 0, f"{label}: no counted route ({got})")
    out["launches"] = got
    out["dense"] = against_dense(label, path, RECURRENT_CTX, RECURRENT_DENSE_POSITIONS,
                                 engine=eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_slots(label: str, eng) -> dict:
    """Jamba's 4-slot BatchEngine on the Engine's Model: the slots'
    prefill of RECURRENT_SLOT_LENS (one slot after another, each chunk a
    forward of its own row at its exact length) timed beside Engine's
    prefills of the same prompts; slots 0-2 teacher-forced on Engine's
    greedy ids (the batched steps' logits held within SERVE_NMSE_BOUND),
    slot 3 idle; then slot 2's
    conv/ssm state and K/V rows kept bit for bit through slot 0's new
    prefill and the decode steps of slots 0 and 1; a freed slot reads zero;
    the batched decode step's launches against recurrent_launch_want."""
    import torch

    from tpullm_torch.runtime.batch_engine import BatchEngine

    prompts = [_word_ids(eng.tokenizer, n) for n in RECURRENT_SLOT_LENS]
    refs = engine_refs(eng, prompts, RECURRENT_TEACHER)
    be = BatchEngine(eng.model, n_slots=4, max_seq=RECURRENT_CTX, prefill_chunk=512)
    be.precompile()
    # the slots' prefill (one row a forward) timed beside Engine's of the same prompts
    times = {}
    for _ in range(2):  # the second, warm, is kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            eng.reset()
            eng.prefill(p)
        torch.cuda.synchronize()
        times["engine"] = (time.perf_counter() - t0) * 1e3
        for s in range(be.n_slots):
            be.free_slot(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.prefill_slots(dict(enumerate(prompts)))
        torch.cuda.synchronize()
        times["slots"] = (time.perf_counter() - t0) * 1e3
    log(f"[recurrent] {label} slots: prefill of {RECURRENT_SLOT_LENS} in 3 of 4 slots "
        f"{times['slots']:.2f} ms, Engine's of the same prompts one after another "
        f"{times['engine']:.2f} ms (ratio {times['slots'] / times['engine']:.3f})")
    out = teacher_forced(f"{label} slots", be, None, prompts, RECURRENT_TEACHER, refs=refs)
    out.update(prefill_ms=times["slots"], engine_prefill_ms=times["engine"])
    c = be.cache
    keep = [a[:, 2].clone() for a in (c.conv, c.ssm, c.k, c.v)]
    be.free_slot(0)
    be.prefill_slots({0: prompts[0]})
    snap = _snapshot()
    for t in (5, 6, 7):
        be.decode_batch({0: t, 1: t})
    torch.cuda.synchronize()
    step = _launch_delta(snap)
    same = all(torch.equal(a, b[:, 2]) for a, b in zip(keep, (c.conv, c.ssm, c.k, c.v)))
    be.free_slot(1)
    zero = not c.conv[:, 1].any() and not c.ssm[:, 1].any()
    want = {k: 3 * v for k, v in recurrent_launch_want(be, 1).items() if v}
    step = {k: v for k, v in step.items() if v}
    log(f"[recurrent] {label} slots: slot 2 idle through a prefill and 3 decode steps: state "
        f"and K/V {'bit-for-bit the same' if same else 'CHANGED'}; freed slot 1 reads "
        f"{'zero' if zero else 'NONZERO'}; 3 batched steps (width 2) launched {step}")
    expect(same, f"{label}: an idle slot's conv/ssm state and K/V kept bit for bit")
    expect(zero, f"{label}: a freed slot's state reads zero")
    expect(step == want, f"{label}: the batched decode steps' launches {step} = {want}")
    out.update(idle_kept=same, freed_zero=zero, step_launches=step)
    del be
    return out


def phase_recurrent(tmp: Path, launches: dict) -> dict:
    """The recurrent-state archs, synthesized from seed 0 (written ahead by
    child processes, AHEAD_JOBS):
    1. the tiny shapes of the four names no card model below runs (mamba,
       nemotron_h, nemotron_h_moe, falcon-h1) on the card against the CPU
       (tiny_card_vs_cpu: a 13-token prompt, the ladder's 8 and 1);
    2. Falcon-Mamba-7B, Mamba-Codestral-7B, Jamba-Mini-1.5 and
       Granite-4.0-H-Tiny Q4_K_M at full width, RECURRENT_LAYERS deep
       (recurrent_run: launches, TTFT, decode tok/s, the device time by
       kernel family, against dense bf16 weights), Jamba also on a 4-slot
       BatchEngine (recurrent_slots);
    3. no dequantize route and no dense attention anywhere in the phase."""
    import torch

    from tpullm_torch.ops.kernels import flash, qmm

    result: dict = {}
    t_phase = time.perf_counter()
    reset_launches()  # just before the main path (each run resets them again)
    prompt = "the the the the"  # 13 tokens of the tiny vocab
    for shape in RECURRENT_TINY:
        gpu, cpu = tiny_card_vs_cpu("recurrent", tmp, shape, "Q4_K_M", torch.bfloat16, prompt)
        expect(len(gpu.tokenizer.tokenize(prompt)) == 13, "the tiny prompt: 13 tokens")
        del gpu, cpu
    gc.collect()
    got = read_launches()
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    result["seconds"] = {"tiny": time.perf_counter() - t_phase}
    for shape, n_layer in RECURRENT_LAYERS.items():
        path = synthesize(tmp, "recurrent", shape, "Q4_K_M", n_layer=n_layer)
        result[shape] = recurrent_run(f"{shape}-{n_layer}l", path, launches,
                                      slots=shape == "jamba-mini-1.5")
        path.unlink()
        result["seconds"][shape] = time.perf_counter() - t_phase
        log(f"[recurrent] {shape} done at {time.perf_counter() - t_phase:.1f}s into the phase")
    expect(not any(qmm.DEQUANT_ROUTES.values()) and not any(flash.ATTN_DENSE_ROUTES.values()),
           f"recurrent: no dequantize-route or dense-attention call ({qmm.DEQUANT_ROUTES}, "
           f"{flash.ATTN_DENSE_ROUTES})")
    return result


PHI3_CTX = 4096  # Phi-3-mini-4k's context
PHI2_CTX = 2048  # Phi-2's
# the serves' prompts: 16 tokens, the long one (Phi-3: 2560, past the
# window of 2047; Phi-2: 1536, inside its context) and 512, then on the bf16
# cache the long one again (warm, the determinism check)
PHI3_LENS = (16, 2560, 512)
PHI2_LENS = (16, 1536, 512)
PHI_SLOT_LENS = (40, 200, 500)  # the BatchEngine round's prompts (its slot 3 idle)
PHI_TEACHER = 8  # teacher-forced batched steps against Engine
PHI2_LAYERS = 8  # Phi-2's depth on the card (of 32: the smoke's time limit)
PHI3_LAYERS = 16  # Phi-3-mini's depth on the card (of 32: the smoke's time)
# Phi-2's depth against dense weights: the synthetic Phi-2 amplifies any
# rounding with depth, in the JAX package as in the port
# (tests/torch_phi2_depth.py; on the card at 32 layers NMSE 8.6e-2), so
# the kernels are held against dense weights on one layer, which runs
# every linear shape of the model
PHI2_DENSE_LAYERS = 1
QWEN1_LAYERS = 2  # Qwen-7B's depth on the card (full width)
PHI_DENSE_POSITIONS = 16  # positions teacher-forced against dense weights
PHI_BRIEF = (64, 16)  # the f16 and f32 caches' runs: prompt tokens, greedy tokens


def phase_phi(tmp: Path, launches: dict) -> dict:
    """The Phi families and Qwen (v1), synthesized from seed 0 at Q4_K_M:
    1. tiny-phi3 (head dim 96, window 16), tiny-phi2 (head dim 80) and
       tiny-qwen on the card against the CPU (tiny_card_vs_cpu);
    2. Phi-3-mini-4k at full width, PHI3_LAYERS of its 32 layers (n_embd 3072, 32
       heads on 32 of 96, a window of 2047 on every layer of a full cache,
       vocab 32064), context 4096: load s and peak GiB; `serve` on a bf16
       and a q8 cache (prompts PHI3_LENS: TTFT, 64 greedy tokens on the
       decode graph, launches per regime: flash at d96 32 a forward, device
       ms by family of a decode token and of a 512-token prefill), a decode
       replay's and a 512-token prefill forward's launches; brief runs on
       f16 and f32 caches (`brief`); a BatchEngine of 4 slots, slot 3 idle,
       teacher-forced against Engine;
    3. Phi-2 at full width (PHI2_LAYERS layers), context 2048, served the
       same way (flash at d80); at PHI2_DENSE_LAYERS teacher-forced against
       dense bf16 weights (`against_dense`);
    4. Qwen-7B (v1) at full width with QWEN1_LAYERS layers: served, and
       teacher-forced against dense bf16 weights;
    each step's seconds logged;
    no call through the dequantize or the dense attention route in the
    phase (qmm.DEQUANT_ROUTES and flash.ATTN_DENSE_ROUTES stay 0)."""
    import torch

    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    reset_launches()  # just before the main path (each serve resets them again)
    long = " ".join(["the quick brown fox jumps over the lazy dog hello world"] * 3)
    for shape in ("tiny-phi3", "tiny-phi2", "tiny-qwen"):
        gpu, cpu = tiny_card_vs_cpu("phi", tmp, shape, "Q4_K_M", torch.bfloat16, long)
        del gpu, cpu

    def expect_no_routes(label):
        expect(not any(qmm.DEQUANT_ROUTES.values()) and not any(flash.ATTN_DENSE_ROUTES.values()),
               f"{label}: no dequantize-route or dense-attention call since the counts were set "
               f"to 0 ({qmm.DEQUANT_ROUTES}, {flash.ATTN_DENSE_ROUTES})")
    expect_no_routes("phi tiny")

    t_phase = time.perf_counter()

    def step(what):
        log(f"[phi] {what} at {time.perf_counter() - t_phase:.1f}s into the phase")

    def brief(label, eng, kv):
        """The main path on a cache of `kv` (f16, f32): a PHI_BRIEF prompt
        and its greedy tokens on the decode graph; flash at the model's
        head dim launched in both regimes, one launch a layer a forward, no
        counted route."""
        fmt = {torch.float16: "f16", torch.float32: "f32"}[kv]
        eng.new_cache(kv_dtype=kv)
        n_prompt, n_gen = PHI_BRIEF
        n_decode = eng.perf.n_decode
        reset_launches()  # just before the main path
        out = eng.generate_tokens_device(_word_ids(eng.tokenizer, n_prompt), n_gen, temp=0.0,
                                         stop_on_eog=False, chunk=n_gen)
        torch.cuda.synchronize()
        got = read_launches()  # just after the main path
        d, L = eng.hp.head_dim, len(eng.params["layers"])
        steps = eng.perf.n_decode - n_decode
        dec, pre = got[f"flash_{fmt}.d{d}.decode"], got[f"flash_{fmt}.d{d}.prefill"]
        log(f"[{label}] kv={fmt}: {n_prompt}-token prompt, {len(out)} greedy ids {out[:6]}; "
            f"flash d{d} launches decode {dec}, prefill {pre} ({steps} decode steps)")
        expect(len(out) == n_gen and pre == L and dec == L * steps > 0
               and got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
               f"{label} {fmt}: flash at d{d} {L} a forward in both regimes ({pre} prefill, "
               f"{dec} decode over {steps} steps), no counted route")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return dict(kv=fmt, ids=out, launches_decode=dec, launches_prefill=pre)

    def served(label, shape, ctx, lens, n_layer=None, vocab="spm"):
        """Serves one model on bf16 and q8 caches (prompts `lens`) and
        briefly on f16 and f32; returns (result, path, the Engine)."""
        path = synthesize(tmp, "phi", shape, "Q4_K_M", n_layer=n_layer, vocab=vocab)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(path, max_seq=ctx)
        load_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        hp = eng.hp
        resident, per_token = plane_bytes(eng.params, 1)
        log(f"[{label}] {hp.arch}: {hp.n_layer} layers, n_embd {hp.n_embd}, {hp.n_head} heads "
            f"over {hp.n_head_kv} of {hp.head_dim} (rope {hp.rope.style}, {hp.rope.dims} dims, "
            f"θ {hp.rope.freq_base}), window {hp.sliding_window}, n_ff {hp.n_ff}, vocab "
            f"{hp.n_vocab}; loaded in {eng.perf.t_load_s:.1f}s, peak {load_peak:.2f} GiB above "
            f"the {base / 2**30:.2f} GiB earlier phases hold; {eng.report()}; planes resident "
            f"{resident / 2**30:.2f} GiB, a decode token streams {per_token / 1e9:.3f} GB "
            f"(bound {per_token / PEAK_BYTES * 1e3:.3f} ms)")
        out = dict(load_s=eng.perf.t_load_s, load_peak_gib=load_peak,
                   resident_gib=resident / 2**30, decode_plane_gb=per_token / 1e9,
                   decode_bound_ms=per_token / PEAK_BYTES * 1e3, runs=[])
        d = hp.head_dim
        for kv in (torch.bfloat16, "q8_0"):
            run = serve(label, path, kv, launches, engine=eng, lens=lens,
                        repeat=kv is torch.bfloat16)
            fmt = "q8" if kv == "q8_0" else run["kv"]
            expect(run["launches"][f"flash_{fmt}.d{d}.decode"] > 0
                   and run["launches"][f"flash_{fmt}.d{d}.prefill"] > 0,
                   f"{label} {run['kv']}: flash at d{d} launched in both regimes")
            one = eng.decode_runner(SamplingParams(), 32).launches_per_replay()
            want = moe_launch_want(eng, 1)
            eng.reset()
            snap = _snapshot()
            eng.prefill(_word_ids(eng.tokenizer, 512))
            torch.cuda.synchronize()
            got = _launch_delta(snap)
            want_p = moe_launch_want(eng, 512)
            log(f"[{label}] kv={run['kv']} launches per decode replay {one}; of one "
                f"512-token prefill forward {got}")
            expect(one == want, f"{label} {run['kv']}: launches per decode replay {one} = "
                   f"{want}")
            expect(got == want_p, f"{label} {run['kv']}: one prefill forward's launches "
                   f"{got} = {want_p}")
            run.update(launches_per_decode=one, launches_per_prefill=got)
            out["runs"].append(run)
            step(f"{label} served on {run['kv']}")
        out["brief"] = [brief(label, eng, kv) for kv in (torch.float16, torch.float32)]
        step(f"{label} brief f16 and f32 runs")
        expect_no_routes(label)
        return out, path, eng

    # Phi-3-mini at full width, its BatchEngine round
    result["phi-3-mini-4k"], path, eng = served(f"phi-3-mini-4k-{PHI3_LAYERS}l", "phi-3-mini-4k",
                                                PHI3_CTX, PHI3_LENS, n_layer=PHI3_LAYERS)
    prompts = [_word_ids(eng.tokenizer, n) for n in PHI_SLOT_LENS]
    eng.new_cache(kv_dtype=torch.bfloat16)
    refs = engine_refs(eng, prompts, PHI_TEACHER)
    model = eng.model  # the BatchEngine shares the Engine's weights (no second load)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # just before the batched path
    be = BatchEngine(model, n_slots=4, max_seq=PHI3_CTX, prefill_chunk=512)
    be.precompile()
    serving = teacher_forced("phi-3-mini-4k serving", be, None, prompts, PHI_TEACHER, refs=refs)
    del be, model
    gc.collect()
    torch.cuda.empty_cache()
    got = read_launches()  # just after the batched path
    log(f"[phi-3-mini-4k] launches of the BatchEngine round (3 slots fed, 1 idle) {got}")
    expect(got["flash_bf16.d96.decode"] > 0 and got["flash_bf16.d96.prefill"] > 0
           and got["qmm_tc"] > 0, "phi-3-mini-4k serving: flash at d96 in both regimes "
           "(the batched steps, the joint round) and qmm_tc launched")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    serving["launches"] = got
    result["phi-3-mini-4k"]["serving"] = serving
    expect_no_routes("phi-3-mini-4k serving")
    path.unlink()
    step("phi-3-mini-4k BatchEngine round")

    # Phi-2 at full width: served, then against dense weights
    label = f"phi-2-{PHI2_LAYERS}l"
    result["phi-2"], path, eng = served(label, "phi-2", PHI2_CTX, PHI2_LENS,
                                        n_layer=PHI2_LAYERS, vocab="bpe")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    path = synthesize(tmp, "phi", "phi-2", "Q4_K_M", n_layer=PHI2_DENSE_LAYERS, vocab="bpe")
    result["phi-2"]["dense"] = against_dense(f"phi-2-{PHI2_DENSE_LAYERS}l", path, PHI2_CTX,
                                             PHI_DENSE_POSITIONS)
    expect_no_routes(label)
    path.unlink()
    step("phi-2 against dense weights")

    # Qwen-7B (v1) at full width, QWEN1_LAYERS layers
    label = f"qwen-7b-{QWEN1_LAYERS}l"
    path = synthesize(tmp, "phi", "qwen-7b", "Q4_K_M", n_layer=QWEN1_LAYERS, vocab="bpe")
    result["qwen-7b"] = serve(label, path, torch.bfloat16, launches, short=512, prefill_len=512)
    result["qwen-7b"]["dense"] = against_dense(label, path, PHI3_CTX, PHI_DENSE_POSITIONS)
    expect_no_routes(label)
    path.unlink()
    step("qwen-7b served and against dense weights")
    return result


# Falcon-7B's attention at a decode token: 71 query heads on one KV head of
# 64 (R = 71: five row groups of flash's decode regime); B = 2 at kv 38 /
# 3001 (the decode cases of every earlier head dim) and B = 1 at kv 1024
FALCON_HEADS = dict(H=71, Hkv=1, D=64, S=4096)
FALCON_FLASH_CASES = ((2, (37, 3000)), (1, (1023,)))
# the FFN linears of Apertus-8B (gateless xIELU: up 4096 → 21504, down
# 21504 → 4096) and AFM-4.5B (gateless ReLU²: 2560 → 18432, 18432 → 2560) at
# their Q4_K_M types
OPTION_QMM_SHAPES = (("Q4_K", "apertus-8b up", 4096, 21504),
                     ("Q6_K", "apertus-8b down", 21504, 4096),
                     ("Q4_K", "afm-4.5b up", 2560, 18432),
                     ("Q6_K", "afm-4.5b down", 18432, 2560))
OPTION_QMM_ROWS = (1, 512)


def _dense_prefill_ms(q, k, v, off, scale) -> float:
    """flash's prefill kernel timed at a call the wrapper sends to the
    decode regime (the C entry's max_splits 0 takes it at any R: the route
    a decode token of more than 16 rows took before the row groups); the
    same inputs, a launch the counts do not see."""
    import torch

    from tpullm_torch.ops.kernels import _build, flash

    B, T, H, D = q.shape
    out = torch.empty((B, T, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    fmt = flash.DENSE_FORMATS[k.dtype]
    fn = _build.bind(flash._library(D, v.shape[-1]), f"tpullm_flash_{fmt}", flash._DENSE_ARGS)

    def call():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(), None, None,
                        out.data_ptr(), None, None, B, T, H, k.shape[1], k.shape[2], D,
                        v.shape[-1], float(scale), 0.0, 0, 0, stream),
                     "flash prefill kernel at a decode shape")
        return out
    ref = flash.flash_reference(q, k, v, off, scale)
    err = nmse(call().float(), ref.float())
    expect(err <= FLASH_NMSE_BOUND, f"flash's prefill kernel at a decode shape: NMSE {err:.3e}")
    return time_ms(call, 20)


def phase_option_kernels(dev, results: dict, options: dict):
    """The kernels at this slice's new shapes, each against its plain
    version and timed as in phase 3: flash at Falcon-7B's decode token
    (FALCON_HEADS: 71 heads on one KV head of 64, R = 71) on every cache
    format, B = 2 at kv 38 / 3001 and B = 1 at kv 1024 (the decode regime
    in five row groups, one launch a call, against flash_reference and the
    split plan's plain version), beside flash's prefill kernel at the same
    call (bf16, f16, f32: the route of such a token before the row groups;
    q8 in the same way through dequantized bf16 K/V); qmm at
    OPTION_QMM_SHAPES, M in OPTION_QMM_ROWS (`qmm_at_shapes`). Rows go to
    `results` and `options` by kernel."""
    import torch

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.kvcache import QuantKVCache

    gen = torch.Generator(dev).manual_seed(29)
    for fmt in FLASH_FORMATS:
        key = f"flash_{fmt}_d64"
        for B, offsets in FALCON_FLASH_CASES:
            kv = "/".join(str(o + 1) for o in offsets)
            row = _flash_case(dev, gen, fmt=fmt, B=B, T=1, offsets=offsets, timed=True,
                              **FALCON_HEADS)
            expect(row["regime"] == "decode", f"{key}: R = 71 takes the decode regime")
            bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
            expect(row["finite"] and row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                   f"{key} B={B}: NMSE {row['nmse']:.3e} (own order "
                   f"{row['nmse_own_order']:.3e}) <= {bound}")
            # the prefill kernel at the same call (q8: on the codes dequantized to bf16)
            H, D, S = FALCON_HEADS["H"], FALCON_HEADS["D"], FALCON_HEADS["S"]
            q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
            dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
                  "q8": torch.bfloat16}[fmt]
            k = torch.randn(B, 1, S, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, 1, S, D, generator=gen, device=dev).to(dt)
            if fmt == "q8":
                (k_q, k_s), (v_q, v_s) = QuantKVCache._quantize(k), QuantKVCache._quantize(v)
                k = (k_q.float() * k_s[..., None]).to(torch.bfloat16)
                v = (v_q.float() * v_s[..., None]).to(torch.bfloat16)
            off = torch.tensor(offsets, dtype=torch.int32, device=dev)
            row["prefill_kernel_ms"] = _dense_prefill_ms(q, k, v, off, D ** -0.5)
            row.update(case=f"{fmt} H=71 T=1 B={B} kv={kv} S={S} D=64", rows=71)
            log(f"[option kernels] flash {row['case']} ({row['regime']}, 5 row groups): nmse "
                f"{row['nmse']:.2e} (own order {row['nmse_own_order']:.2e}) max|d| "
                f"{row['max_abs_err']:.3g}; {row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) "
                f"vs bound {row['bound_ms']:.4f} ({row['bound_by']}), the prefill kernel at "
                f"this call {row['prefill_kernel_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
                f"SDPA {row['library_ms']:.4f} ms")
            results.setdefault(key, []).append(row)
            del q, k, v
    qmm_at_shapes("option kernels", dev, gen, OPTION_QMM_SHAPES, OPTION_QMM_ROWS, results,
                  options)
    torch.cuda.empty_cache()


def phase_fit(path: Path, tmp: Path) -> dict:
    """tpullm-torch-fit-params on the 8B Q4_K_M (the slice's file) at -c
    FIT_CTX on the card's free memory: its fitted context, then an Engine
    made at it, a 512-token prompt and 16 greedy tokens on the decode
    graph: the predicted weights + cache bytes against
    torch.cuda.max_memory_allocated over the Engine's load and run, within
    FIT_TOLERANCE."""
    import torch

    from tpullm_torch.runtime import fit
    from tpullm_torch.runtime.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    rc, text, err, secs = run_tool(fit.main, ["-m", str(path), "-c", str(FIT_CTX)])
    log(f"[fit] tpullm-torch-fit-params -c {FIT_CTX} (free {free / 2**30:.2f} GiB): rc {rc} in "
        f"{secs:.1f}s:\n{text.strip()}")
    expect(rc == 0 and "fitted:" in text, f"fit: the tool fitted the 8B (rc {rc}) {err[-300:]}")
    res = fit.fit_params(path, want_seq=FIT_CTX)
    expect(f"-c {res.max_seq} -np {res.n_slots}" in text, "fit: the tool's line is fit_params'")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(path, max_seq=res.max_seq)
    out_ids = eng.generate_tokens_device(_word_ids(eng.tokenizer, 512), 16, temp=0.0,
                                         stop_on_eog=False, chunk=16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ratio = res.predicted_bytes / peak
    out = dict(ctx=res.max_seq, slots=res.n_slots, weight_bytes=res.weight_bytes,
               kv_bytes_per_token=res.kv_bytes_per_token, predicted_bytes=res.predicted_bytes,
               peak_bytes=peak, predicted_over_peak=ratio, free_bytes=free, tool_s=secs,
               load_s=eng.perf.t_load_s)
    log(f"[fit] an Engine at the fitted -c {res.max_seq}: loaded in {eng.perf.t_load_s:.1f}s, "
        f"{len(out_ids)} greedy ids; predicted {res.predicted_bytes / 2**30:.3f} GiB (weights "
        f"{res.weight_bytes / 2**30:.3f} + cache {res.kv_bytes_per_token} B × {res.max_seq}), "
        f"max_memory_allocated {peak / 2**30:.3f} GiB: predicted / peak {ratio:.4f}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    expect(abs(ratio - 1.0) <= FIT_TOLERANCE,
           f"fit: predicted {res.predicted_bytes} B within {FIT_TOLERANCE:.0%} of the peak {peak} B")
    return out


FIT_CTX = 262144  # the context asked of tpullm-torch-fit-params on the 8B
FIT_TOLERANCE = 0.10  # its weights + cache against the Engine's peak
LLAMA_OPT_CTX = 4096  # the llama options phase's context
OPT_MODEL_LAYERS = 4  # the depth of its models but Qwen3-VL-8B
QWEN3VL_LAYERS = 8  # Qwen3-VL-8B's depth on the card (of 36; deepstack after layers 0-2)
FALCON_LAYERS = 4  # Falcon-7B's and Pythia-6.9B's depth on the card (of 32)
FALCON_CTX = 2048  # their context (falcon-7b's and pythia's 2048 positions)


def _model_brief(label: str, eng, launches: dict, n_prompt: int = 64, n_gen: int = 16,
                 kv: str | None = None) -> dict:
    """A model's main path on the engine's cache: an n_prompt-token prompt
    and n_gen greedy tokens on the decode graph (a first run, untimed and
    uncounted, captures the graph); the launches of a decode replay against
    `moe_launch_want(eng, 1)` and of the timed run by kernel; that run's
    decode tok/s; finite logits of a decode_step."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.kvcache import describe

    if kv is not None:
        eng.new_cache(kv_dtype=kv)
    prompt = _word_ids(eng.tokenizer, n_prompt)
    eng.generate_tokens_device(prompt, n_gen, temp=0.0, stop_on_eog=False, chunk=n_gen)
    eng.reset()
    n_decode, t_decode = eng.perf.n_decode, eng.perf.t_decode_s
    reset_launches()  # just before the main path
    t0 = time.perf_counter()
    ids = eng.generate_tokens_device(prompt, n_gen, temp=0.0, stop_on_eog=False, chunk=n_gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()  # just after the main path
    steps = eng.perf.n_decode - n_decode
    tok_s = steps / max(eng.perf.t_decode_s - t_decode, 1e-9)
    one = eng.decode_runner(SamplingParams(), n_gen).launches_per_replay()
    want = moe_launch_want(eng, 1)
    logits = eng.decode_step(ids[-1])
    log(f"[{label}] cache {describe(eng.cache)}: {n_prompt}-token prompt, {len(ids)} greedy ids "
        f"{ids[:6]}… in {wall:.2f}s, decode {tok_s:.2f} tok/s over {steps} graph steps; "
        f"launches per decode replay {one}; of the run "
        f"{ {k: v for k, v in got.items() if v and not k.startswith('flash_') } } flash "
        f"{ {k: v for k, v in got.items() if v and k.startswith('flash_') and k.count('.') == 2} }")
    expect(len(ids) == n_gen and np.isfinite(logits).all(), f"{label}: {n_gen} ids, finite logits")
    expect(one == want, f"{label}: launches per decode replay {one} = {want}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    return dict(ids=ids, decode_tok_s=tok_s, steps=steps, wall_s=wall, launches=got,
                launches_per_decode=one)


def _embeddings_input(eng, n: int, gen) -> tuple:
    """An image's input: n rows of the model's own embedding table (random
    ids: the magnitudes of real inputs), its [3, n] grid positions (t fixed
    at the text's end, h and w over a 16-column grid) and three deepstack
    residuals of the same rows' scale."""
    import torch

    rows = torch.randint(0, eng.hp.n_vocab, (4, n), generator=gen)
    table = eng.params["tok_embd"]
    emb = table[rows[0].to(table.device)].float().cpu().numpy()
    ds = table[rows[1:].to(table.device)].float().cpu().numpy()
    start = eng.n_past
    pos = np.stack([np.full(n, start), start + np.arange(n) // 16, start + np.arange(n) % 16])
    return emb, pos.astype(np.int32), ds


def vl_embeddings(label: str, eng, dense, deepstack: bool, n: int = 256) -> dict:
    """prefill_embeddings of an n-row image after a 32-token text prompt, on
    the packed Engine and on `dense` (the same file at dense bf16 weights,
    torch.matmul: the plain route), then two decode steps on each: logits
    NMSE within SERVE_NMSE_BOUND, finite, n_past advanced by n."""
    import torch

    rows = {}
    for name, e in (("packed", eng), ("dense", dense)):
        e.reset()
        e.prefill(_word_ids(e.tokenizer, 32))
        emb, pos, ds = _embeddings_input(e, n, torch.Generator().manual_seed(31))
        t0 = time.perf_counter()
        first = e.prefill_embeddings(emb, pos, ds if deepstack else None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        expect(e.n_past == 32 + n, f"{label} {name}: n_past {e.n_past} after the image")
        rows[name] = [first] + [e.decode_step(t) for t in (5, 6)]
        rows[name + "_s"] = secs
    errs = [_nmse_np(a, b) for a, b in zip(rows["packed"], rows["dense"])]
    log(f"[{label}] prefill_embeddings of a {n}-row image ([3, {n}] grid positions"
        f"{', 3 deepstack residuals' if deepstack else ''}) after 32 text tokens in "
        f"{rows['packed_s'] * 1e3:.1f} ms (dense weights {rows['dense_s'] * 1e3:.1f} ms), then 2 "
        f"decode steps: NMSE against dense bf16 weights {['%.2e' % x for x in errs]}")
    expect(all(np.isfinite(r).all() for r in rows["packed"] + rows["dense"]),
           f"{label}: finite logits after the image")
    expect(max(errs) <= SERVE_NMSE_BOUND, f"{label}: prefill_embeddings against dense weights "
           f"NMSE {max(errs):.3e} <= {SERVE_NMSE_BOUND}")
    return dict(rows=n, deepstack=deepstack, nmse=errs, ms=rows["packed_s"] * 1e3,
                dense_ms=rows["dense_s"] * 1e3)


def phase_llama_options(tmp: Path, launches: dict) -> dict:
    """The llama graph's options at published widths, synthesized from seed
    0 at Q4_K_M:
    1. Qwen3-VL-8B (arch qwen3vl, IMROPE [24, 20, 20]) at full width with
       QWEN3VL_LAYERS of its 36 layers, context LLAMA_OPT_CTX: load s and peak GiB; text
       on the decode graph (`_model_brief`: 512-token prompt, 64 greedy
       tokens, a decode replay's launches), a decode token profiled by
       family; prefill_embeddings of a
       256-row image with its grid positions and three deepstack
       residuals, then two decode steps, against the same calls on the file
       at dense bf16 weights (`vl_embeddings`);
    2. Qwen2-VL-7B (qwen2vl, contiguous [16, 24, 24]) with 4 layers: text,
       and an image with positions against dense weights;
    3. Qwen3-VL-30B-A3B (qwen3vlmoe) with 4 layers: text (the gather and
       stack regimes of the experts);
    4. Apertus-8B (xIELU, qk norms) and AFM-4.5B (arcee, ReLU²) with 4
       layers: text;
    5. llama-embed on the llama-3-8b shape with 4 layers: Engine.embed
       (its vector unchanged by a prefill before it) and /v1/embeddings of
       tpullm-torch-server's app (a BatchEngine of 2 slots) equal to it;
    every 2-D linear through qmm (no dequantize route: every K a whole
    number of 256-blocks), flash at d128, no dense attention route."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.server.api import make_app, serve

    result: dict = {}
    t_phase = time.perf_counter()

    def step(what):
        log(f"[llama options] {what} at {time.perf_counter() - t_phase:.1f}s into the phase")

    def no_routes(label, got):
        expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0
               and got["flash_bf16.d128.decode"] > 0 and got["flash_bf16.d128.prefill"] > 0
               and got["qmm_tc"] > 0,
               f"{label}: qmm on every linear (no dequantize route), flash at d128 in both "
               "regimes, no dense attention")

    def load(label, shape, n_layer=None):
        path = synthesize(tmp, "llama options", shape, "Q4_K_M", n_layer=n_layer, vocab="bpe")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(path, max_seq=LLAMA_OPT_CTX)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        hp = eng.hp
        log(f"[{label}] {hp.arch}: {hp.n_layer} layers, n_embd {hp.n_embd}, heads {hp.n_head} "
            f"over {hp.n_head_kv} of {hp.head_dim}, n_ff {hp.n_ff}, vocab {hp.n_vocab}, rope "
            f"{hp.rope.style} sections {hp.rope.sections} interleaved "
            f"{hp.rope.mrope_interleaved}, xielu {hp.xielu is not None}, causal {hp.causal}; "
            f"loaded in {eng.perf.t_load_s:.1f}s, peak {peak:.2f} GiB")
        return path, eng, dict(load_s=eng.perf.t_load_s, load_peak_gib=peak)

    # 1. Qwen3-VL-8B with QWEN3VL_LAYERS layers
    path, eng, out = load("qwen3-vl-8b", "qwen3-vl-8b", QWEN3VL_LAYERS)
    out["text"] = _model_brief("qwen3-vl-8b", eng, launches, 512, 64)
    no_routes("qwen3-vl-8b", out["text"]["launches"])
    out["decode_profile"] = profile_decode(eng, eng.decode_runner(SamplingParams(), 64),
                                           _word_ids(eng.tokenizer, 512), 16)
    log(f"[qwen3-vl-8b] a decode token by family (16 replays of the captured graph): "
        f"{out['decode_profile']['device_ms_per_token']}, event span "
        f"{out['decode_profile']['event_span_ms_per_token']:.3f} ms, top "
        f"{out['decode_profile']['top'][:6]}")
    step("qwen3-vl-8b text")
    dense = Engine(path, max_seq=LLAMA_OPT_CTX, mode="dense")
    out["image"] = vl_embeddings("qwen3-vl-8b", eng, dense, deepstack=True)
    del dense, eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    result["qwen3-vl-8b"] = out
    step("qwen3-vl-8b image against dense weights")

    # 2.-4. the 4-layer cuts
    for label, shape in (("qwen2-vl-7b", "qwen2-vl-7b"), ("qwen3-vl-30b-a3b", "qwen3-vl-30b-a3b"),
                         ("apertus-8b", "apertus-8b"), ("afm-4.5b", "afm-4.5b")):
        label = f"{label}-{OPT_MODEL_LAYERS}l"
        path, eng, out = load(label, shape, OPT_MODEL_LAYERS)
        out["text"] = _model_brief(label, eng, launches)
        got = out["text"]["launches"]
        no_routes(label, got)
        if shape == "qwen3-vl-30b-a3b":
            expect(got["qmm_gather"] > 0 and got["qmm_stack"] > 0,
                   f"{label}: the experts in the gather and the stack regimes")
        if shape == "qwen2-vl-7b":
            dense = Engine(path, max_seq=LLAMA_OPT_CTX, mode="dense")
            out["image"] = vl_embeddings(label, eng, dense, deepstack=False)
            del dense
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        path.unlink()
        result[shape] = out
        step(label)

    # 5. llama-embed: Engine.embed and /v1/embeddings
    label = f"llama-embed-{OPT_MODEL_LAYERS}l"
    path, eng, out = load(label, "llama-embed-8b", OPT_MODEL_LAYERS)
    expect(not eng.hp.causal and eng.hp.pooling == "mean", f"{label}: non-causal, mean pooling")
    text = "the quick brown fox jumps over the lazy dog"
    reset_launches()  # just before the main path
    v1 = eng.embed(text)
    eng.prefill(_word_ids(eng.tokenizer, 300))
    v2 = eng.embed(text)
    got = read_launches()  # just after the main path
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    model = eng.model
    del eng
    gc.collect()
    app, sched = make_app(model, n_slots=2, max_seq=LLAMA_OPT_CTX, prefill_chunk=512)
    httpd = serve(app, "127.0.0.1", 0)
    try:
        resp = _http_request(httpd.server_address[1], "/v1/embeddings",
                             {"input": [text, "hello world"]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        sched.stop()
    del app, sched, model
    gc.collect()
    torch.cuda.empty_cache()
    vec = np.asarray(resp["json"]["data"][0]["embedding"], np.float32)
    err = float(np.abs(vec - v1).max())
    log(f"[{label}] Engine.embed: a {v1.shape[0]}-wide vector (norm {np.linalg.norm(v1):.4f}), "
        f"after a 300-token prefill max|Δ| {np.abs(v2 - v1).max():.3g}; /v1/embeddings "
        f"{resp['status']} in {resp['seconds'] * 1e3:.1f} ms, max|Δ| against Engine.embed "
        f"{err:.3g}; launches {got}")
    expect(np.isfinite(v1).all() and np.array_equal(v1, v2),
           f"{label}: the vector finite and unchanged by an earlier prefill")
    expect(resp["status"] == 200 and len(resp["json"]["data"]) == 2 and err <= 1e-2,
           f"{label}: /v1/embeddings equal to Engine.embed (max|Δ| {err:.3g})")
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0 and got["qmm_tc"] > 0,
           f"{label}: qmm on every linear, no counted route")
    out.update(embed_dim=int(v1.shape[0]), server_max_abs=err, server_ms=resp["seconds"] * 1e3)
    path.unlink()
    result["llama-embed"] = out
    step(label)
    return result


def phase_falcon(tmp: Path, launches: dict) -> dict:
    """The falcon family, synthesized from seed 0 at Q4_K_M:
    1. Falcon-7B at full width with FALCON_LAYERS layers (71 heads on one
       KV head of 64, n_embd 4544): `_model_brief` on bf16, f16, f32 and q8
       caches: each decode token's flash launches in the decode regime (row
       groups), none in the prefill regime at T = 1; q|k|v, wo, up and the
       head through the counted dequantize route (K = 4544), ffn_down
       through qmm (K = 18176); a decode token profiled by family;
    2. Pythia-6.9B (gptneox: parallel residual, 32 rotary dims, biases)
       with FALCON_LAYERS layers: the same on a bf16 cache, every linear
       through qmm."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    path = synthesize(tmp, "falcon", "falcon-7b", "Q4_K_M", n_layer=FALCON_LAYERS, vocab="bpe")
    gc.collect()
    torch.cuda.empty_cache()
    eng = Engine(path, max_seq=FALCON_CTX)
    hp = eng.hp
    L = len(eng.params["layers"])
    log(f"[falcon-7b] {hp.arch}: {L} layers, n_embd {hp.n_embd}, {hp.n_head} heads over "
        f"{hp.n_head_kv} of {hp.head_dim} (R = {hp.n_head // hp.n_head_kv} a decode token), "
        f"rope {hp.rope.style} {hp.rope.dims}, n_ff {hp.n_ff}, vocab {hp.n_vocab}; loaded in "
        f"{eng.perf.t_load_s:.1f}s")
    out = dict(load_s=eng.perf.t_load_s, runs=[])
    for kv in ("bf16", "f16", "f32", "q8_0"):
        fmt = "q8" if kv == "q8_0" else kv
        run = _model_brief(f"falcon-7b-{L}l", eng, launches, kv=kv)
        got, steps = run["launches"], run["steps"]
        dec, pre = got[f"flash_{fmt}.d64.decode"], got[f"flash_{fmt}.d64.prefill"]
        per = run["launches_per_decode"]
        expect(pre == L and dec == L * steps and per.get("flash_decode") == L and per.get("flash") == L,
               f"falcon-7b {fmt}: flash at d64 in the decode regime at every decode token "
               f"({dec} over {steps} steps), the prefill regime only in the prompt's forward "
               f"({pre})")
        expect(per.get("dequant_routes") == 3 * L + 1 and per.get("qmm") == L
               and got["attn_dense_routes"] == 0,
               f"falcon-7b {fmt}: q|k|v, wo, up and the head through the dequantize route, "
               f"ffn_down through qmm, a decode replay ({per})")
        run["kv"] = fmt
        out["runs"].append(run)
    run = _model_brief(f"falcon-7b-{L}l", eng, launches, kv="bf16")  # its graph captured
    out["decode_profile"] = profile_decode(eng, eng.decode_runner(SamplingParams(), 16),
                                           _word_ids(eng.tokenizer, 64), 16)
    log(f"[falcon-7b] a decode token by family (bf16, {L} layers): "
        f"{out['decode_profile']['device_ms_per_token']}, top {out['decode_profile']['top'][:4]}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    result["falcon-7b"] = out

    path = synthesize(tmp, "falcon", "pythia-6.9b", "Q4_K_M", n_layer=FALCON_LAYERS,
                      vocab="bpe")
    eng = Engine(path, max_seq=FALCON_CTX)
    hp = eng.hp
    log(f"[pythia-6.9b] {hp.arch}: n_embd {hp.n_embd}, {hp.n_head} heads of {hp.head_dim}, "
        f"rope {hp.rope.style} {hp.rope.dims} dims, parallel residual {hp.par_residual}; loaded "
        f"in {eng.perf.t_load_s:.1f}s")
    run = _model_brief(f"pythia-6.9b-{FALCON_LAYERS}l", eng, launches)
    got = run["launches"]
    expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0 and got["qmm_tc"] > 0
           and got["flash_bf16.d128.decode"] > 0,
           "pythia-6.9b: every linear through qmm, flash at d128, no counted route")
    result["pythia-6.9b"] = dict(load_s=eng.perf.t_load_s, **run)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    return result


# ALiBi at BLOOM-7B1's and MPT-7B's attention: 32 heads on 32 of head dim
# 128, the slopes of max bias 8; a decode token at kv 20 and 3001 (R = 1:
# the decode regime split over the keys), and a 512-token prefill
ALIBI_HEADS = dict(B=1, H=32, Hkv=32, D=128, S=4096)
ALIBI_CASES = (("T=1 kv=20", 1, (19,)), ("T=1 kv=3001", 1, (3000,)), ("T=512", 512, (2500,)))


def phase_alibi_kernels(dev, results: dict, alibi_rows: dict):
    """flash with ALiBi at ALIBI_HEADS, each case against the plain version
    and its own order's plain version, timed as in phase 3 beside the
    bound and SDPA with the float bias as its mask: on every cache format
    at kv 3001, and on bf16 at kv 20 and T = 512. Rows go to `results` and
    `alibi_rows` by kernel."""
    import torch

    from tpullm_torch.ops.attention import alibi_slopes

    gen = torch.Generator(dev).manual_seed(31)
    slopes = alibi_slopes(ALIBI_HEADS["H"], 8.0, dev)
    for fmt, key in zip(FLASH_FORMATS, FLASH_KEYS):
        bound = FLASH_Q8_NMSE_BOUND if fmt == "q8" else FLASH_NMSE_BOUND
        for label, T, offsets in ALIBI_CASES:
            if fmt != "bf16" and label != "T=1 kv=3001":
                continue
            row = _flash_case(dev, gen, fmt=fmt, T=T, offsets=offsets, alibi=True,
                              slopes=slopes, timed=True, **ALIBI_HEADS)
            row["case"] = f"{fmt} alibi {label} B=1 H=32/32 S=4096 D=128"
            want = "decode" if T == 1 else "prefill"
            expect(row["regime"] == want, f"flash {row['case']}: the {want} regime")
            expect(row["finite"] and row["nmse"] <= bound and row["nmse_own_order"] <= bound,
                   f"flash {row['case']}: NMSE {row['nmse']:.3e} (own order "
                   f"{row['nmse_own_order']:.3e}) <= {bound}")
            log(f"[alibi kernels] flash {row['case']} ({row['regime']}): nmse {row['nmse']:.2e} "
                f"(own order {row['nmse_own_order']:.2e}) max|d| {row['max_abs_err']:.3g}; "
                f"{row['ms']:.4f} ms (eager {row['eager_ms']:.4f}) vs bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']}), plain {row['plain_ms']:.3f} ms, "
                f"SDPA with the bias {row['library_ms']:.4f} ms")
            results.setdefault(key, []).append(row)
            alibi_rows.setdefault(key, []).append(row)
    torch.cuda.empty_cache()


# the 2-D linears of BLOOM-7B1 and MPT-7B (the same widths: n_embd 4096,
# n_ff 16384), StarCoder-15.5B (6144, q|k|v 6144 + 2·128, n_ff 24576) and
# GPT-2 (768, 3072) at Q4_K_M, (format, name, K, N): the fused attn_qkv at
# Q5_K, wo and up at Q4_K, the down projections at the recipe's Q6_K
# (use_more_bits layers) and Q4_K, StarCoder's own Q6_K head (BLOOM's,
# MPT's and GPT-2's heads are tied: a plain product)
BLOOM_GPT2_QMM_SHAPES = (("Q5_K", "bloom-7b1|mpt-7b qkv", 4096, 12288),
                         ("Q4_K", "bloom-7b1|mpt-7b wo", 4096, 4096),
                         ("Q4_K", "bloom-7b1|mpt-7b up", 4096, 16384),
                         ("Q6_K", "bloom-7b1|mpt-7b down", 16384, 4096),
                         ("Q4_K", "bloom-7b1|mpt-7b down", 16384, 4096),
                         ("Q5_K", "starcoder-15b qkv", 6144, 6400),
                         ("Q4_K", "starcoder-15b wo", 6144, 6144),
                         ("Q4_K", "starcoder-15b up", 6144, 24576),
                         ("Q6_K", "starcoder-15b down", 24576, 6144),
                         ("Q4_K", "starcoder-15b down", 24576, 6144),
                         ("Q6_K", "starcoder-15b head", 6144, 49152),
                         ("Q5_K", "gpt2 qkv", 768, 2304),
                         ("Q4_K", "gpt2 wo", 768, 768),
                         ("Q4_K", "gpt2 up", 768, 3072),
                         ("Q6_K", "gpt2 down", 3072, 768),
                         ("Q4_K", "gpt2 down", 3072, 768))
BLOOM_GPT2_QMM_ROWS = (1, 2, 512)  # a decode step, the 2-slot BatchEngine step, a prefill


def phase_bloom_gpt2_kernels(dev, results: dict, rows: dict):
    """qmm at BLOOM_GPT2_QMM_SHAPES, M in BLOOM_GPT2_QMM_ROWS
    (`qmm_at_shapes`): the linears of the bloom and gpt2 phases' models."""
    import torch

    qmm_at_shapes("bloom gpt2", dev, torch.Generator(dev).manual_seed(37),
                  BLOOM_GPT2_QMM_SHAPES, BLOOM_GPT2_QMM_ROWS, results, rows)


def phase_conformance(dev) -> dict:
    """tpullm_torch/tools/conformance.py's sweep on the card (the
    hand-written kernels: every plane format through qmm at 1, 9, 16 and
    128 rows, the expert gather and stack, flash on every cache format and
    head-dim form in both regimes, the row groups, the latent forms, sinks
    and ALiBi): no failed case, every NMSE under its bound."""
    from tpullm_torch.tools import conformance

    summary = conformance.run_sweep(device=dev)
    log(f"[conformance] {summary['cases']} cases, {summary['passed']} passed in "
        f"{summary['t_s']}s; max NMSE qmm {summary['max_nmse_qmm']}, flash "
        f"{summary['max_nmse_flash']}; failed {summary['failed'][:8]}")
    expect(not summary["failed"] and not summary["skipped"]
           and summary["max_nmse_qmm"] <= conformance.QMM_NMSE_BOUND
           and summary["max_nmse_flash"] <= conformance.FLASH_Q8_NMSE_BOUND,
           f"conformance: {len(summary['failed'])} failed cases, {summary['skipped']} skipped")
    return summary


GGUF_SPLIT_TENSORS = 16  # tensors a shard of the split 4-layer 8B (4 shards)


def _file_sha256(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def phase_gguf(tmp: Path) -> dict:
    """The GGUF tools on Llama-3-8B Q4_K_M with 4 layers: tpullm-torch-gguf-
    split into shards of GGUF_SPLIT_TENSORS tensors; an Engine on shard 1
    (the reader takes in the other shards) against one on the whole file:
    the same greedy ids on the decode graph and the same prompt logits;
    tpullm-torch-gguf-hash of both: the same model digest and UUID;
    tpullm-torch-gguf-convert-endian to big and back: the whole file byte
    for byte."""
    import torch

    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.tools import gguf_endian, gguf_hash, gguf_split

    out: dict = {}
    path = synthesize(tmp, "gguf", "llama-3-8b", "Q4_K_M", n_layer=4)
    split_dir = tmp / "split"
    split_dir.mkdir()
    rc, text, err, secs = run_tool(gguf_split.main, ["--split-max-tensors",
                                                     str(GGUF_SPLIT_TENSORS), str(path),
                                                     str(split_dir / "llama")])
    shards = sorted(split_dir.glob("llama-*-of-*.gguf"))
    log(f"[gguf] tpullm-torch-gguf-split: rc {rc} in {secs:.1f}s, {text.strip()}; shards "
        f"{[(p.name, round(p.stat().st_size / 2**20, 1)) for p in shards]} MiB")
    expect(rc == 0 and len(shards) > 1 and shards[0].name.endswith(f"-of-{len(shards):05d}.gguf"),
           "gguf: the split wrote its shards")
    runs = {}
    for name, p in (("whole", path), ("split", shards[0])):
        eng = Engine(p, max_seq=1024)
        prompt = _word_ids(eng.tokenizer, 200)
        ids = eng.generate_tokens_device(prompt, 16, temp=0.0, stop_on_eog=False, chunk=16)
        eng.reset()
        runs[name] = (ids, eng.prefill(prompt), eng.perf.t_load_s)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    err_logits = nmse(torch.from_numpy(runs["split"][1]), torch.from_numpy(runs["whole"][1]))
    log(f"[gguf] Engine on shard 1 (loaded in {runs['split'][2]:.1f}s; the whole file "
        f"{runs['whole'][2]:.1f}s): greedy ids {runs['split'][0][:6]}… equal "
        f"{runs['split'][0] == runs['whole'][0]}, prompt logits NMSE {err_logits:.3e}")
    expect(runs["split"][0] == runs["whole"][0] and err_logits <= 1e-6,
           "gguf: the split model's greedy ids and logits are the whole file's")
    digests = {}
    for name, p in (("whole", path), ("split", shards[0])):
        rc, text, err, secs = run_tool(gguf_hash.main, ["--sha256", "--no-layer", str(p)])
        digests[name] = [ln.split("\t")[:2] for ln in text.strip().splitlines()]
        log(f"[gguf] tpullm-torch-gguf-hash --sha256 --no-layer {p.name}: rc {rc} in "
            f"{secs:.1f}s: {digests[name]}")
        expect(rc == 0, f"gguf: the hash tool on {p.name}")
    expect(digests["split"] == digests["whole"], "gguf: the split model hashes as the whole")
    be = tmp / "be.gguf"
    rc1, t1, _, s1 = run_tool(gguf_endian.main, [str(path), "big", "-o", str(be), "-q"])
    sha_be = _file_sha256(be)
    rc2, t2, _, s2 = run_tool(gguf_endian.main, [str(be), "little", "-q"])
    same = _file_sha256(be) == _file_sha256(path)
    log(f"[gguf] tpullm-torch-gguf-convert-endian to big ({s1:.1f}s: {t1.strip()}) and back "
        f"({s2:.1f}s: {t2.strip()}): the big file's sha256 {sha_be[:16]}…, back equal to the "
        f"source {same}")
    expect(rc1 == rc2 == 0 and same and sha_be != _file_sha256(path),
           "gguf: the endian round trip is byte-equal")
    out.update(shards=len(shards), logits_nmse=err_logits, ids=runs["split"][0],
               digest=digests["whole"], endian_s=(s1, s2), split_load_s=runs["split"][2])
    be.unlink()
    shutil.rmtree(split_dir)
    path.unlink()
    return out


BLOOM_CTX = 2048  # bloom-7b1's and mpt-7b's 2048 positions
MPT_LAYERS = 4  # MPT-7B's depth on the card (of 32)
BLOOM_SLOT_LENS = (40, 300)  # the 2-slot BatchEngine round's prompts
BLOOM_TEACHER = 8  # teacher-forced batched steps against Engine
BLOOM_DENSE_LAYERS = 1  # BLOOM-7B1's depth where the 2-slot step is held to SERVE_NMSE_BOUND
BLOOM_TIE_MARGIN = 0.05  # Engine's top-2 gap under which a batched argmax may part
# BLOOM-7B1 at full depth: the bound of the 2-slot step's logits against
# Engine's, and of Engine's own logits in the other valid orders of
# BLOOM_ORDERS; the random LayerNorm-with-bias model amplifies any change of
# summation order with depth (tests/torch_alibi_depth.py), so the bound is
# set from the readings of both at 30 layers on the H100: the step 0.182,
# Engine in the 2-slot plans 0.1819 and on 66 SMs 0.1773 (PERF.md §6)
BLOOM_DEPTH_NMSE_BOUND = 0.3
# Engine's kernels planned for another order of their sums, each a valid
# plan: as the 2-slot BatchEngine plans them (the joint prefill round's
# tensor-core K split for twice the rows; qmm's CUDA-core plan and flash's
# key splits for 2 rows and B = 2, the same as one's at these lengths), and
# for a card of half the SMs (every split of qmm and flash)
BLOOM_ORDERS = {"2-slot plans": dict(rows=2), "66 SMs": dict(n_sm=66)}
HEAD_KERNEL = r"gemm|gemv|nvjet|xmma|cutlass"  # a library product's kernel names


def aten_products(fn) -> dict:
    """fn() under a dispatch mode that counts the aten products it calls
    (mm, addmm, bmm, baddbmm, matmul, linear by name): the port's linears
    run through qmm's ctypes calls, so what shows is a plain product."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear"):
                counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def _head_share(prof: dict) -> float:
    """Device ms a token of the library products among a decode profile's
    top kernels (the tied head's torch.matmul)."""
    import re

    return sum(ms for name, ms, _ in prof["top"] if re.search(HEAD_KERNEL, name, re.I))


def order_witness(eng, prompts: list[list[int]], refs: tuple, rows: int = 1,
                  n_sm: int | None = None) -> float:
    """Engine's own logits, teacher-forced on its greedy ids `refs` (from
    engine_refs) as teacher_forced feeds the BatchEngine, with its kernels
    planned for another order of their sums: qmm's tensor-core plan for
    `rows` times the rows, its CUDA-core plan and flash's key splits for at
    least `rows` rows / batches, and every plan for `n_sm` SMs; eager steps
    (the captured graphs keep their own plans). Returns the worst NMSE
    against `refs`' logits."""
    import torch

    from tpullm_torch.ops.kernels import _build, flash, qmm

    ref_logits, ref_ids = refs
    saved = (qmm.plan, qmm.gemv_plan, flash.max_splits, _build.n_sm)
    plan, gemv_plan, max_splits, real_sm = saved
    qmm.plan = lambda M, K, N, sm, batches=1: plan(M * rows, K, N, sm, batches)
    qmm.gemv_plan = lambda M, K, N, sm: gemv_plan(max(M, rows), K, N, sm)
    flash.max_splits = lambda B, Hkv, S, sm: max_splits(max(B, rows), Hkv, S, sm)
    _build.n_sm = (lambda d: n_sm) if n_sm else real_sm
    worst = 0.0
    try:
        with torch.inference_mode():
            for s, p in enumerate(prompts):
                eng.reset()
                got = [eng.prefill(p)]
                for step in range(len(ref_ids[s]) - 1):
                    tok = torch.tensor(ref_ids[s][step], device=eng.device)
                    got.append(eng._decode_logits(tok).float().cpu().numpy())
                worst = max(worst, *(_nmse_np(g, r) for g, r in zip(got, ref_logits[s])))
    finally:
        qmm.plan, qmm.gemv_plan, flash.max_splits, _build.n_sm = saved
    return worst


def phase_bloom(tmp: Path, launches: dict) -> dict:
    """The ALiBi family, synthesized from seed 0 at Q4_K_M:
    1. BLOOM-7B1 at full width and depth (30 layers, 32 heads of 128, the
       250880-token head tied to the embedding): `_model_brief` on bf16 and
       q8 caches: every linear through qmm (no dequantize route), flash at
       d128 with ALiBi in the decode regime at every decode token and in
       the prefill regime in the prompt's forward, no dense attention; the
       head one torch.matmul a step (counted at the aten level); a decode
       token profiled by family, the head's share beside qmm's; a 2-slot
       BatchEngine teacher-forced against Engine: its logits within
       BLOOM_DEPTH_NMSE_BOUND at full depth, as Engine's own are in the
       other orders of BLOOM_ORDERS (`order_witness`), its greedy ids where
       Engine's top two are apart; within SERVE_NMSE_BOUND on
       BLOOM_DENSE_LAYERS layers;
    2. MPT-7B with MPT_LAYERS layers (no biases, ALiBi 8 from its key) on a
       bf16 cache: the same launch checks."""
    import torch

    from tpullm_torch.ops.sampling_ops import SamplingParams
    from tpullm_torch.runtime.batch_engine import BatchEngine
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    path = synthesize(tmp, "bloom", "bloom-7b1", "Q4_K_M", vocab="bpe")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(path, max_seq=BLOOM_CTX)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    hp = eng.hp
    L = len(eng.params["layers"])
    log(f"[bloom-7b1] {hp.arch}: {L} layers, n_embd {hp.n_embd}, {hp.n_head} heads over "
        f"{hp.n_head_kv} of {hp.head_dim}, ALiBi max bias {hp.max_alibi_bias}, n_ff {hp.n_ff}, "
        f"vocab {hp.n_vocab} (head tied: {eng.params['output'] is None}); loaded in "
        f"{eng.perf.t_load_s:.1f}s, peak {peak:.2f} GiB")
    expect(eng.params["output"] is None and hp.max_alibi_bias == 8.0,
           "bloom-7b1: the head tied to the embedding, ALiBi 8 without a key")
    out = dict(load_s=eng.perf.t_load_s, load_peak_gib=peak, runs=[])

    def flash_checks(label, fmt, run, n_layer):
        got, steps, per = run["launches"], run["steps"], run["launches_per_decode"]
        dec, pre = got[f"flash_{fmt}.d128.decode"], got[f"flash_{fmt}.d128.prefill"]
        expect(dec == n_layer * steps and pre == n_layer and per.get("flash_decode") == n_layer,
               f"{label} {fmt}: flash at d128 in the decode regime at every decode token "
               f"({dec} over {steps} steps), the prefill regime in the prompt's forward ({pre})")
        expect(got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0
               and per.get("qmm") == 4 * n_layer and got["qmm_tc"] > 0,
               f"{label} {fmt}: q|k|v, wo, up and down through qmm (a decode replay {per}), no "
               "counted route")

    for kv in ("bf16", "q8_0"):
        fmt = "q8" if kv == "q8_0" else kv
        run = _model_brief(f"bloom-7b1-{fmt}", eng, launches, kv=kv)
        flash_checks("bloom-7b1", fmt, run, L)
        run["kv"] = fmt
        out["runs"].append(run)
    eng.new_cache(kv_dtype="bf16")
    eng.prefill(_word_ids(eng.tokenizer, 64))
    token = torch.tensor(5, device=eng.device)
    products = aten_products(lambda: eng._decode_logits(token))
    log(f"[bloom-7b1] aten products in an eager decode step: {products}")
    expect(sum(products.values()) == 1, f"bloom-7b1: the tied head is the step's one plain "
           f"product ({products})")
    run = _model_brief("bloom-7b1-bf16", eng, launches, kv="bf16")  # its graph captured
    prof = profile_decode(eng, eng.decode_runner(SamplingParams(), 16),
                          _word_ids(eng.tokenizer, 64), 16, n_top=12)
    head_ms = _head_share(prof)
    table_gb = eng.params["tok_embd"].numel() * 2 / 1e9
    out.update(decode_profile=prof, head_ms=head_ms, head_bound_ms=table_gb * 1e9 / PEAK_BYTES
               * 1e3, head_bytes_gb=table_gb)
    log(f"[bloom-7b1] a decode token by family (bf16, 16 replays): "
        f"{prof['device_ms_per_token']}, event span {prof['event_span_ms_per_token']:.3f} ms; "
        f"the tied head's product {head_ms:.4f} ms a token (its {table_gb:.3f} GB table at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s: {out['head_bound_ms']:.4f} ms) beside qmm "
        f"{prof['device_ms_per_token']['qmm']:.4f} ms; top {prof['top'][:6]}")
    expect(head_ms > 0, "bloom-7b1: the head's product shows in the decode profile")
    prompts = [_word_ids(eng.tokenizer, n) for n in BLOOM_SLOT_LENS]
    refs = engine_refs(eng, prompts, BLOOM_TEACHER)
    be = BatchEngine(eng.model, n_slots=2, max_seq=BLOOM_CTX, prefill_chunk=512)
    # the 2-slot step's rows differ from Engine's only in the kernels'
    # summation orders (qmm's plan by M, flash's key splits by B), which the
    # random LayerNorm-with-bias model amplifies with depth in both packages
    # (tests/torch_alibi_depth.py): at full depth the step is held to
    # BLOOM_DEPTH_NMSE_BOUND, and so is Engine itself in other valid orders
    witness = {name: order_witness(eng, prompts, refs, **plan)
               for name, plan in BLOOM_ORDERS.items()}
    log(f"[bloom-7b1] Engine against itself in other orders of its sums, teacher-forced on its "
        f"greedy ids: worst NMSE {witness} (bound {BLOOM_DEPTH_NMSE_BOUND})")
    expect(max(witness.values()) <= BLOOM_DEPTH_NMSE_BOUND,
           f"bloom-7b1: Engine in other orders within {BLOOM_DEPTH_NMSE_BOUND} ({witness})")
    tf = teacher_forced("bloom-7b1 serving", be, None, prompts, BLOOM_TEACHER, refs=refs,
                        bound=BLOOM_DEPTH_NMSE_BOUND)
    expect(all(p["margin"] < BLOOM_TIE_MARGIN for p in tf["parted"]),
           f"bloom-7b1 serving: the greedy ids agree but where Engine's top two lie within "
           f"{BLOOM_TIE_MARGIN} ({tf['parted']})")
    out.update(serving=tf, order_witness=witness)
    del be, eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    path = synthesize(tmp, "bloom", "bloom-7b1", "Q4_K_M", n_layer=BLOOM_DENSE_LAYERS,
                      vocab="bpe")
    eng = Engine(path, max_seq=BLOOM_CTX)
    refs = engine_refs(eng, prompts, BLOOM_TEACHER)
    be = BatchEngine(eng.model, n_slots=2, max_seq=BLOOM_CTX, prefill_chunk=512)
    out["serving_1l"] = teacher_forced(f"bloom-7b1-{BLOOM_DENSE_LAYERS}l serving", be, None,
                                       prompts, BLOOM_TEACHER, refs=refs)
    del be, eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    result["bloom-7b1"] = out

    path = synthesize(tmp, "bloom", "mpt-7b", "Q4_K_M", n_layer=MPT_LAYERS, vocab="bpe")
    eng = Engine(path, max_seq=BLOOM_CTX)
    hp = eng.hp
    log(f"[mpt-7b] {hp.arch}: n_embd {hp.n_embd}, {hp.n_head} heads of {hp.head_dim}, ALiBi "
        f"max bias {hp.max_alibi_bias}, clamp_kqv {hp.clamp_kqv}; loaded in "
        f"{eng.perf.t_load_s:.1f}s")
    run = _model_brief(f"mpt-7b-{MPT_LAYERS}l", eng, launches)
    flash_checks("mpt-7b", "bf16", run, MPT_LAYERS)
    result["mpt-7b"] = dict(load_s=eng.perf.t_load_s, **run)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    return result


GPT2_CTX = 2048  # past GPT-2's 1024 positions: the clamp's run
GPT2_PROMPT = 1100  # its prompt: a bucket of 2048 rows, 76 of its tokens past the table
STARCODER_LAYERS = 4  # StarCoder-15.5B's depth on the card (of 40)


def phase_gpt2(tmp: Path, launches: dict) -> dict:
    """Learned positions, synthesized from seed 0 at Q4_K_M:
    1. GPT-2 at full width and depth (12 layers, heads of 64, 1024
       positions) at context GPT2_CTX: a GPT2_PROMPT-token prompt (its
       bucket, and its last tokens, past the position table: clamped to
       its last row, no device assert) and 16 greedy tokens on the decode
       graph; teacher-forced on those ids, the eager step's argmax and the
       logits graph's are the same ids, the logits graph within
       OPT_NMSE_BOUND of the eager step; every linear through qmm, flash
       at d64;
    2. StarCoder-15.5B with STARCODER_LAYERS layers (48 query heads on one
       KV head): flash at d128 in the decode regime's row groups at every
       decode token (R = 48), the prompt's forward in the prefill regime."""
    import torch

    from tpullm_torch.ops.kernels import flash
    from tpullm_torch.runtime.engine import Engine

    result: dict = {}
    path = synthesize(tmp, "gpt2", "gpt2", "Q4_K_M", vocab="bpe")
    eng = Engine(path, max_seq=GPT2_CTX)
    hp = eng.hp
    L = len(eng.params["layers"])
    log(f"[gpt2] {hp.arch}: {L} layers, n_embd {hp.n_embd}, {hp.n_head} heads of "
        f"{hp.head_dim}, {eng.params['pos_embd'].shape[0]} positions, vocab {hp.n_vocab}; "
        f"loaded in {eng.perf.t_load_s:.1f}s")
    run = _model_brief("gpt2", eng, launches, n_prompt=GPT2_PROMPT, n_gen=16)
    got, steps = run["launches"], run["steps"]
    expect(eng.n_past - 1 > hp.n_ctx_train and got["flash_bf16.d64.decode"] == L * steps
           and got["dequant_routes"] == 0 and got["attn_dense_routes"] == 0,
           f"gpt2: a run past its {hp.n_ctx_train} positions (n_past {eng.n_past}), flash at d64 "
           "in the decode regime at every decode token, every linear through qmm")
    n_past = eng.n_past
    prompt, ids = _word_ids(eng.tokenizer, GPT2_PROMPT), run["ids"]
    graph, eager = _teacher_logits(eng, prompt, ids), _eager_logits(eng, prompt, ids)
    worst = max(_nmse_np(a, b) for a, b in zip(graph, eager))
    argmax = {name: [int(np.argmax(r)) for r in rows]
              for name, rows in (("logits graph", graph), ("eager", eager))}
    log(f"[gpt2] past the position table, teacher-forced on the decode graph's ids {ids}: the "
        f"logits graph against the eager step NMSE worst {worst:.2e} (bound {OPT_NMSE_BOUND}); "
        f"argmax {argmax}")
    expect(worst <= OPT_NMSE_BOUND and all(a == ids for a in argmax.values()),
           "gpt2: past the position table the decode graph's ids are the eager step's and the "
           "logits graph's argmax, the logits graph within the bound of the eager step")
    result["gpt2"] = dict(load_s=eng.perf.t_load_s, n_past=n_past, graph_vs_eager_nmse=worst,
                          **run)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()

    path = synthesize(tmp, "gpt2", "starcoder-15b", "Q4_K_M", n_layer=STARCODER_LAYERS,
                      vocab="bpe")
    eng = Engine(path, max_seq=GPT2_CTX)
    hp = eng.hp
    R = hp.n_head // hp.n_head_kv
    log(f"[starcoder-15b] {hp.arch}: n_embd {hp.n_embd}, {hp.n_head} heads over "
        f"{hp.n_head_kv} of {hp.head_dim} (R = {R} a decode token: "
        f"{flash.regime(1, hp.n_head, hp.n_head_kv)} regime), vocab {hp.n_vocab}; loaded in "
        f"{eng.perf.t_load_s:.1f}s")
    run = _model_brief(f"starcoder-15b-{STARCODER_LAYERS}l", eng, launches)
    got, steps, per = run["launches"], run["steps"], run["launches_per_decode"]
    expect(R == 48 and got["flash_bf16.d128.decode"] == STARCODER_LAYERS * steps
           and got["flash_bf16.d128.prefill"] == STARCODER_LAYERS
           and per.get("flash_decode") == STARCODER_LAYERS and got["dequant_routes"] == 0
           and got["attn_dense_routes"] == 0,
           f"starcoder-15b: flash at d128 in the row groups at every decode token (R = {R}), "
           "the prefill regime in the prompt's forward, every linear through qmm")
    result["starcoder-15b"] = dict(load_s=eng.perf.t_load_s, **run)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    return result


def phase_presets(tmp: Path, launches: dict) -> list[dict]:
    """Llama-3-8B with 4 layers (one prompt, 16 decode steps) at Q2_K,
    IQ4_XS, Q4_0, Q4_1, Q5_0, Q5_1, IQ4_NL and Q3_K_M (a bf16 KV cache;
    the q8 cache's flash runs in the server, speculative and moe families
    phases); Mixtral-8x7B at MXFP4_MOE with 4 layers, a 64-token prompt (the
    all-experts regime) and its decode (gather). Each file is written ahead
    by a child process (AHEAD_JOBS)."""
    import torch

    runs = []
    for label, shape, ftype, n_layer in PRESET_JOBS:
        path = synthesize(tmp, label, shape, ftype, n_layer=n_layer)
        runs.append(serve(label, path, torch.bfloat16, launches, short=64))
        path.unlink()
    got = runs[-1]["launches"]
    expect(got.get("qmm_stack.MXFP4", 0) > 0 and got.get("qmm_gather.MXFP4", 0) > 0
           and got["qmm_q8_0"] > 0,
           "mixtral MXFP4_MOE ran MXFP4 through qmm_stack and qmm_gather, Q8_0 through qmm")
    return runs


def phase_iquants(tmp: Path, launches: dict) -> list[dict]:
    """Llama-3-8B with 4 layers (one prompt, 16 decode steps) at IQ1_S,
    IQ3_XXS (between them IQ1_S, IQ2_XXS, IQ2_S, IQ3_XXS and an IQ3_S
    embedding), IQ2_XXS, IQ2_XS, IQ2_M, IQ1_M, IQ3_M, TQ1_0 and TQ2_0 (the
    IQ1_S and IQ3_XXS runs were at full depth before the tools phase
    joined the smoke, and were cut to keep its time); Mixtral-8x7B at
    IQ2_XXS with 4 layers (a 64-token prompt through qmm_stack, decode
    through qmm_gather); the 8B at Q4_K_M with 4 layers and
    qmm.GROUPED_TYPES = {Q4_K, Q6_K} (`grouped_run`). Each file is written
    ahead by a child process (AHEAD_JOBS)."""
    import torch

    runs = []
    for label, shape, ftype, n_layer in IQUANT_JOBS:
        path = synthesize(tmp, label, shape, ftype, n_layer=n_layer)
        if label == "8b-grouped":
            runs.append(grouped_run(path, launches))
        else:
            runs.append(serve(label, path, torch.bfloat16, launches, short=64))
        path.unlink()
    got = runs[-2]["launches"]
    expect(got.get("qmm_stack.IQ2_XXS", 0) > 0 and got.get("qmm_gather.IQ2_XXS", 0) > 0
           and got["qmm_iq2_xxs"] > 0,
           "mixtral IQ2_XXS ran IQ2_XXS through qmm_stack, qmm_gather and qmm")
    return runs


def grouped_run(path: Path, launches: dict) -> dict:
    """The 8B at Q4_K_M (`path`) served with qmm.GROUPED_TYPES = {Q4_K,
    Q6_K}: every 2-D launch goes through qmm_grouped, its 512-token
    prefill's kernels by name."""
    import torch

    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops.kernels import qmm

    expect(not qmm.GROUPED_TYPES, "qmm.GROUPED_TYPES is empty (TPULLM_QMM_GROUPED unset)")
    qmm.GROUPED_TYPES.update({GGMLType.Q4_K, GGMLType.Q6_K})
    try:
        run = serve("8b-Q4_K_M-grouped", path, torch.bfloat16, launches, short=64,
                    prefill_len=512)
    finally:
        qmm.GROUPED_TYPES.clear()
    expect(run["launches"]["qmm_grouped"] > 0 and run["launches"]["qmm_tc"] == 0
           and sum(run["launches"][k] for k in QMM_KEYS.values()) == 0,
           "the grouped run's 2-D launches all went through qmm_grouped")
    # the 512-token prefill's 2-D qmm kernels by name: each layer's linears
    # on the grouped tensor-core kernel, the head (its last row only) on the
    # gemv body, and no other. The trace names the kernels; it can drop a
    # launch (two runs on the H100 each lost one qmm_grouped_tc_kernel event),
    # never add one, so its counts are held as upper bounds, and the
    # wrappers' count of the forward's qmm_grouped launches (each one of the
    # two kernels) as the total: together the exact split
    per = run["per_forward"]
    two_d = {k: n for k, n in run["prefill_profile"]["launches"].items()
             if k not in REDUCTION_KERNELS and not k.startswith(("qmm_stack", "qmm_gather", "flash"))}
    want = {"qmm_grouped_tc_kernel": per["qmm_layers"], "qmm_grouped_gemv_kernel": per["head"]}
    counted = run["prefill_profile"]["counted"]
    expect(set(two_d) == set(want) and all(two_d[k] <= want[k] for k in want)
           and counted.get("qmm_grouped") == per["qmm"] and not counted.get("qmm_tc")
           and not any(counted.get(k) for k in QMM_KEYS.values()),
           f"the grouped run's 512-token prefill ran the 2-D kernels {two_d} (traced) and "
           f"{counted} (counted), not {want}")
    return run


def phase_mixtral(tmp: Path, launches: dict) -> dict:
    """Mixtral-8x7B Q4_K_M (the 8-expert recipe) at full width with 4
    layers (cut from 32 to keep the run in its time), with a bf16 KV
    cache."""
    import torch

    path = synthesize(tmp, "mixtral", "mixtral-8x7b", "Q4_K_M", n_layer=4)
    run = serve("mixtral", path, torch.bfloat16, launches, graph=True)
    expect(run["launches"]["qmm_stack"] > 0 and run["launches"]["qmm_gather"] > 0
           and run["launches"]["qmm_q5k"] > 0 and run["launches"]["qmm_q8_0"] > 0,
           "mixtral ran the stack, gather, Q5_K and Q8_0 kernels")
    path.unlink()
    return run


def phase_routes(dev, tmp: Path):
    """The shapes the kernels do not take, on the card: the tiny model with
    a 250-token Q6_K head (N % 4 != 0) against the same model on the CPU,
    every head call through the dequantize-then-matmul route; one
    attention_cached call at head dims (112, 112), which no kernel
    instantiates, through the dense path, against attention_reference."""
    import torch

    from tpullm_torch.models.synth import make_synthetic_llama_gguf
    from tpullm_torch.ops import attention
    from tpullm_torch.ops.kernels import flash, qmm
    from tpullm_torch.runtime.engine import Engine
    from tpullm_torch.runtime.kvcache import KVCache

    path = make_synthetic_llama_gguf(tmp / "tiny-v250.gguf", shape="tiny", seed=0, n_vocab=250)
    gpu = Engine(path, max_seq=256)
    cpu = Engine(path, device="cpu", max_seq=256)
    ids = gpu.tokenizer.tokenize("hello world the quick brown fox")
    reset_launches()
    errs = [nmse(torch.from_numpy(gpu.prefill(ids)), torch.from_numpy(cpu.prefill(ids)))]
    for tok in (100, 17, 42, 249, 5):
        errs.append(nmse(torch.from_numpy(gpu.decode_step(tok)),
                         torch.from_numpy(cpu.decode_step(tok))))
    gpu.reset()
    cpu.reset()
    a = gpu.generate_tokens_device(ids, 16, chunk=8)
    b = cpu.generate_tokens_device(ids, 16, chunk=8)
    torch.cuda.synchronize()
    forwards = 2 + gpu.perf.n_decode  # two prefills; the decode steps and generated ids
    got = read_launches()
    log(f"[routes] tiny, 250-token head: logits NMSE card vs cpu max {max(errs):.2e}; greedy "
        f"{'equal' if a == b else 'DIFFERENT'}; {forwards} forwards, dequantize route "
        f"{dict((k, v) for k, v in qmm.DEQUANT_ROUTES.items() if v)}, launches {got}")
    expect(max(errs) <= 1e-3, f"250-token head: logits NMSE {max(errs):.3e} <= 1e-3")
    expect(a == b, f"250-token head: greedy ids card {a} vs cpu {b}")
    expect(qmm.DEQUANT_ROUTES["Q6_K"] == got["dequant_routes"] == forwards,
           f"250-token head: {got['dequant_routes']} dequantize-route calls = {forwards} heads")
    expect(got["attn_dense_routes"] == 0, "250-token head: attention on the kernel")

    reset_launches()
    g = torch.Generator(dev).manual_seed(5)
    B, T, H, Hkv, S, D, DV = 1, 24, 8, 2, 96, 112, 112
    expect(not flash.takes(D, DV), f"head dims {D} / {DV}: no kernel takes them")
    cache = KVCache(torch.randn(1, B, Hkv, S, D, generator=g, device=dev).to(torch.bfloat16),
                    torch.randn(1, B, Hkv, S, DV, generator=g, device=dev).to(torch.bfloat16))
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    off = torch.tensor([40], dtype=torch.int32, device=dev)
    out = attention.attention_cached(q, cache, 0, D ** -0.5, off)
    pos = 40 + torch.arange(T, device=dev)[None]
    ref = attention.attention_reference(q, cache.k[0], cache.v[0],
                                        attention.causal_mask(pos, S, 40 + T), D ** -0.5)
    err = nmse(out.float(), flash.flash_reference(q, cache.k[0], cache.v[0], off,
                                                  D ** -0.5).float())
    log(f"[routes] attention at head dims {D} / {DV}: dense route calls "
        f"{dict(flash.ATTN_DENSE_ROUTES)}, flash launches {flash.launch_total()}; NMSE against "
        f"the flash plain version {err:.2e}")
    expect(out.shape == (B, T, H, DV), f"head dims {D} / {DV}: output {tuple(out.shape)}")
    expect(nmse(out.float(), ref.float()) <= 1e-10,
           f"head dims {D} / {DV}: the dense path is attention_reference")
    expect(flash.ATTN_DENSE_ROUTES["bf16"] == 1 and sum(flash.LAUNCHES.values()) == 0,
           f"head dims {D} / {DV}: one counted dense-route call, no flash launch")
    expect(err <= FLASH_NMSE_BOUND, f"head dims {D} / {DV}: NMSE {err:.3e} <= {FLASH_NMSE_BOUND}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "tpullm_torch" / "csrc").is_dir():
        print(f"chip_smoke: tpullm_torch is not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f}s")
        return out

    smi = timed("card", phase_card)
    ptxas = timed("build", phase_build)
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="tpullm_torch_smoke_") as tmp, \
            contextlib.ExitStack() as ahead:
        # the main path's files, written by children ahead of their turn (the
        # kernel phases leave the host's cores to them)
        ahead.callback(lambda: _end_children(AHEAD.values()))
        AHEAD_QUEUE.extend(AHEAD_JOBS)
        ahead_top_up(Path(tmp))
        results: dict = {}
        timed("qmm", phase_qmm, dev, results)
        timed("grouped", phase_grouped, dev, results)
        timed("moe kernels", phase_moe_kernels, dev, results)
        timed("flash", phase_flash, dev, results)
        timed("flash d256", phase_flash256, dev, results)
        timed("flash mla", phase_flash_mla, dev, results)
        timed("flash dkdv", phase_flash_dkdv, dev, results)
        phi: dict = {}
        timed("phi kernels", phase_phi_kernels, dev, results, phi)
        batched: dict = {}
        timed("batched kernels", phase_batched_kernels, dev, results, batched)
        verify: dict = {}
        timed("verify kernels", phase_verify_kernels, dev, results, verify)
        qwen: dict = {}
        timed("qwen kernels", phase_qwen_kernels, dev, results, qwen)
        unfused: dict = {}
        timed("unfused kernels", phase_unfused_kernels, dev, results, unfused)
        gemma_k: dict = {}
        timed("gemma kernels", phase_gemma_kernels, dev, results, gemma_k)
        opt_k: dict = {}
        timed("option kernels", phase_option_kernels, dev, results, opt_k)
        alibi_k: dict = {}
        timed("alibi kernels", phase_alibi_kernels, dev, results, alibi_k)
        bloom_gpt2_k: dict = {}
        timed("bloom gpt2 kernels", phase_bloom_gpt2_kernels, dev, results, bloom_gpt2_k)
        fam_k: dict = {}
        timed("moe family kernels", phase_moe_family_kernels, dev, results, fam_k)
        rec_k: dict = {}
        timed("recurrent kernels", phase_recurrent_kernels, dev, results, rec_k)
        conformance = timed("conformance", phase_conformance, dev)
        timed("tiny", phase_tiny, dev, Path(tmp))
        runs, slice_path = timed("slice", phase_slice, Path(tmp), launches)
        tools = timed("tools", phase_tools, slice_path, Path(tmp), launches)
        server = timed("server", phase_server, slice_path, Path(tmp), launches)
        spec = timed("speculative", phase_speculative, slice_path, Path(tmp), launches)
        options = timed("engine options", phase_engine_options, slice_path, Path(tmp),
                        launches)
        fit_run = timed("fit", phase_fit, slice_path, Path(tmp))
        slice_path.unlink()
        gguf_run = timed("gguf", phase_gguf, Path(tmp))
        runs += timed("presets", phase_presets, Path(tmp), launches)
        runs += timed("i-quants", phase_iquants, Path(tmp), launches)
        runs.append(timed("mixtral", phase_mixtral, Path(tmp), launches))
        gemma = timed("gemma", phase_gemma, Path(tmp), launches)
        ds2 = timed("deepseek2", phase_deepseek2, Path(tmp), launches)
        qwen_run = timed("qwen", phase_qwen, Path(tmp), launches)
        fam_run = timed("moe families", phase_moe_families, Path(tmp), launches)
        rec_run = timed("recurrent", phase_recurrent, Path(tmp), launches)
        phi_run = timed("phi", phase_phi, Path(tmp), launches)
        mla_run = timed("mla models", phase_mla_models, Path(tmp), launches)
        llama_opts = timed("llama options", phase_llama_options, Path(tmp), launches)
        falcon_run = timed("falcon", phase_falcon, Path(tmp), launches)
        bloom_run = timed("bloom", phase_bloom, Path(tmp), launches)
        gpt2_run = timed("gpt2", phase_gpt2, Path(tmp), launches)
        timed("routes", phase_routes, dev, Path(tmp))
    log("[runs] summary " + json.dumps({"runs": runs, "tools": tools, "server": server,
                                        "speculative": spec, "options": options,
                                        "gemma": gemma,
                                        "deepseek2": ds2, "qwen": qwen_run, "phi": phi_run,
                                        "mla": mla_run, "fit": fit_run,
                                        "llama_options": llama_opts, "falcon": falcon_run,
                                        "gguf": gguf_run, "bloom": bloom_run,
                                        "gpt2": gpt2_run, "moe_families": fam_run,
                                        "recurrent": rec_run},
                                       default=str))
    for fmt in FLASH_FORMATS:
        for d in (256, 96, 80, 64):
            launches[f"flash_{fmt}_d{d}"] = (launches[f"flash_{fmt}.d{d}.decode"]
                                             + launches[f"flash_{fmt}.d{d}.prefill"])
    for d, dv in DKDV_DIMS:
        for fmt in FLASH_FORMATS:
            launches[f"flash_{fmt}_d{d}v{dv}"] = (launches[f"flash_{fmt}.d{d}v{dv}.decode"]
                                                 + launches[f"flash_{fmt}.d{d}v{dv}.prefill"])
    for key in (FLASH_MLA_KEY, FLASH_MLA288_KEY):
        dims = key.split("_")[-1]
        launches[key] = (launches[f"flash_bf16.{dims}.decode"]
                         + launches[f"flash_bf16.{dims}.prefill"])
    grouped_prefill_launches = next(r["prefill_profile"]["launches"] for r in runs
                                    if r["model"] == "8b-Q4_K_M-grouped")

    kernels = []
    for key in KERNELS:
        rows = results[key]
        rep = next(r for r in rows if r["case"] == REPRESENTATIVE[key])
        entry = dict(
            name=key, route="cuda", source=SOURCES[key], replaces=REPLACES[key],
            launches=launches[key], max_abs_err=max(r["max_abs_err"] for r in rows),
            max_nmse=max(r["nmse"] for r in rows), case=rep["case"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"])
        if key == "qmm_grouped":
            entry["bodies"] = {"M < 16": "qmm_grouped_gemv_kernel (csrc/qmm_gemv.cuh)",
                               "M >= 16": "qmm_grouped_tc_kernel (csrc/qmm_tc.cuh)"}
            entry["qmm_ms_same_planes"] = rep["qmm_ms"]
            entry["grouped_run_prefill_launches"] = grouped_prefill_launches
            for r in rows:  # the gemv body at M = 8, the tensor-core body from 16
                if r["case"].startswith("Q4_K") and r["case"] != rep["case"]:
                    m = r["case"].split("M=")[1]
                    tag = f"m{m}" if " gate_up " in r["case"] else f"down_m{m}"
                    entry.update({f"{tag}_ms": r["ms"], f"{tag}_qmm_ms": r["qmm_ms"],
                                  f"{tag}_bound_ms": r["bound_ms"],
                                  f"{tag}_library_ms": r["library_ms"],
                                  f"{tag}_split": r["split"]})
        if key == "qmm_gather":
            for r in rows:
                if r["case"].startswith("Q4_K gate T=32"):
                    tag = "t32_one_expert" if "one expert" in r["case"] else "t32"
                    entry.update({f"{tag}_ms": r["ms"], f"{tag}_bound_ms": r["bound_ms"],
                                  f"{tag}_library_ms": r["library_ms"]})
        if key == "qmm_tc":
            entry["cuda_core_ms_same_planes"] = rep["cuda_core_ms"]
            entry["formats_held"] = sorted({r["case"].split()[0] for r in rows})
        if key in ("qmm_tc", "qmm_grouped"):
            entry["launches_by_format"] = {k.split(".")[1]: v for k, v in launches.items()
                                           if k.startswith(key + ".")}
        if key in ("qmm_stack", "qmm_gather"):
            entry["formats_held"] = sorted({r["case"].split()[0] for r in rows})
            entry["launches_by_format"] = {k.split(".")[1]: v for k, v in launches.items()
                                           if k.startswith(key + ".")}
        if "cold_ms" in rep:
            entry["cold_ms"] = rep["cold_ms"]
        if key in FLASH256_KEYS:
            # the decode regime at B = 2 (representative) and B = 1 in the
            # window, the prefill regime beside it; launches from the Gemma phase
            fmt = key.split("_")[1]
            win = next(r for r in rows if r["case"].startswith(f"{fmt} T=1 B=1 window="))
            pre = next(r for r in rows if r["case"] == f"{fmt} T=512 B=2 S=4096 D=256")
            entry.update(verify=[{k: r[k] for k in ("case", "regime", "nmse", "ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms")}
                                 for r in rows
                                 if r["case"].startswith(f"{fmt} T={GEMMA_VERIFY_ROWS} ")],
                         window_case=win["case"], window_ms=win["ms"],
                         window_bound_ms=win["bound_ms"], window_library_ms=win["library_ms"],
                         prefill_case=pre["case"], prefill_ms=pre["ms"],
                         prefill_plain_ms=pre["plain_ms"], prefill_bound_ms=pre["bound_ms"],
                         prefill_bound_by=pre["bound_by"], prefill_library_ms=pre["library_ms"],
                         launches_decode=launches[f"flash_{fmt}.d256.decode"],
                         launches_prefill=launches[f"flash_{fmt}.d256.prefill"],
                         registers=ptxas.get(
                             f"flash_decode_kernel<256,256,{FLASH_FORMATS.index(fmt)}>"),
                         prefill_registers=ptxas.get(
                             f"flash_prefill_kernel<256,256,{FLASH_FORMATS.index(fmt)}>"))
        elif key in FLASH_NARROW_KEYS:
            # the decode regime at B = 2 (representative), the Phi shapes (32
            # heads on 32: R = 1, 9, 16; Phi-3's 2560-token windowed prefill)
            # and the prefill regime at T = 512; launches from the phi phase
            fmt, d = key.split("_")[1], int(key.split("_d")[1])
            pre = next(r for r in rows if r["case"] == f"{fmt} T=512 B=2 S=4096 D={d}")
            entry.update(prefill_case=pre["case"], prefill_ms=pre["ms"],
                         prefill_plain_ms=pre["plain_ms"], prefill_bound_ms=pre["bound_ms"],
                         prefill_bound_by=pre["bound_by"], prefill_library_ms=pre["library_ms"],
                         phi=[{k: r[k] for k in ("case", "regime", "nmse", "ms", "bound_ms",
                                                 "bound_by", "plain_ms", "library_ms")}
                              for r in rows if " phi" in r["case"]],
                         launches_decode=launches[f"flash_{fmt}.d{d}.decode"],
                         launches_prefill=launches[f"flash_{fmt}.d{d}.prefill"],
                         registers=ptxas.get(
                             f"flash_decode_kernel<{d},{d},{FLASH_FORMATS.index(fmt)}>"),
                         prefill_registers=ptxas.get(
                             f"flash_prefill_kernel<{d},{d},{FLASH_FORMATS.index(fmt)}>"))
            expect(entry["launches_decode"] > 0 and entry["launches_prefill"] > 0,
                   f"{key} launched in both regimes on the main path")
        elif key in FLASH_DKDV_KEYS:
            # the decode regime at T = 1 (representative), the prefill regime
            # at T = 512 beside it; launches from the mla models phase's
            # decompressed runs
            fmt, dims = key.split("_")[1], key.split("_")[2]
            d, dv = (int(x) for x in dims[1:].split("v"))
            pre = next(r for r in rows if r["case"] == f"{fmt} T=512 B=2 S=4096 D={d}/{dv}")
            entry.update(prefill_case=pre["case"], prefill_ms=pre["ms"],
                         prefill_plain_ms=pre["plain_ms"], prefill_bound_ms=pre["bound_ms"],
                         prefill_bound_by=pre["bound_by"], prefill_library_ms=pre["library_ms"],
                         launches_decode=launches[f"flash_{fmt}.{dims}.decode"],
                         launches_prefill=launches[f"flash_{fmt}.{dims}.prefill"],
                         registers=ptxas.get(
                             f"flash_decode_kernel<{d},{dv},{FLASH_FORMATS.index(fmt)}>"),
                         prefill_registers=ptxas.get(
                             f"flash_prefill_kernel<{d},{dv},{FLASH_FORMATS.index(fmt)}>"))
            expect(entry["launches_decode"] > 0 and entry["launches_prefill"] > 0,
                   f"{key} launched in both regimes on the main path")
        elif key in (FLASH_MLA_KEY, FLASH_MLA288_KEY):
            # the decode regime at B = 2 (representative) and B = 1 kv 20, the
            # prefill regime beside it, the decode regime's row groups (V2-Lite
            # at T = 2, 4; MiniCPM3's R = 40) with the prefill kernel at that
            # call; launches from the deepseek2 and mla models phases
            dims = key.split("_")[-1]
            d, dv = (int(x) for x in dims[1:].split("v"))
            kv20 = next(r for r in rows if "T=1 B=1 kv=20" in r["case"])
            pre = next(r for r in rows if "T=512 B=2" in r["case"])
            entry.update(kv20_ms=kv20["ms"], kv20_bound_ms=kv20["bound_ms"],
                         kv20_library_ms=kv20["library_ms"], prefill_case=pre["case"],
                         prefill_ms=pre["ms"], prefill_plain_ms=pre["plain_ms"],
                         prefill_bound_ms=pre["bound_ms"], prefill_bound_by=pre["bound_by"],
                         prefill_library_ms=pre["library_ms"],
                         prefill_kernel_at_decode_ms=rep.get("prefill_kernel_ms"),
                         row_groups=[{k: r[k] for k in ("case", "rows", "regime", "nmse", "ms",
                                                        "bound_ms", "library_ms",
                                                        "prefill_kernel_ms") if k in r}
                                     for r in rows if r["rows"] > 16],
                         launches_decode=launches[f"flash_bf16.{dims}.decode"],
                         launches_prefill=launches[f"flash_bf16.{dims}.prefill"],
                         registers=ptxas.get(f"flash_mla_kernel<{d},{dv},1>"),
                         prefill_registers=ptxas.get(f"flash_mla_kernel<{d},{dv},0>"))
            expect(entry["launches_decode"] > 0 and entry["launches_prefill"] > 0,
                   f"{key} launched in both regimes on the main path")
        elif key in FLASH_ROWS_KEYS:
            # Falcon-7B's decode token (R = 71: five row groups) at B = 2
            # (representative) and B = 1 at kv 1024, each beside the prefill
            # kernel at the same call; launches from the falcon phase
            fmt = key.split("_")[1]
            one = next(r for r in rows if " B=1 " in r["case"])
            entry.update(row_groups=5, prefill_kernel_at_decode_ms=rep["prefill_kernel_ms"],
                         kv1024_case=one["case"], kv1024_ms=one["ms"],
                         kv1024_bound_ms=one["bound_ms"], kv1024_library_ms=one["library_ms"],
                         kv1024_prefill_kernel_ms=one["prefill_kernel_ms"],
                         launches_decode=launches[f"flash_{fmt}.d64.decode"],
                         launches_prefill=launches[f"flash_{fmt}.d64.prefill"],
                         registers=ptxas.get(
                             f"flash_decode_kernel<64,64,{FLASH_FORMATS.index(fmt)}>"))
            expect(entry["launches_decode"] > 0, f"{key}: the decode regime on the main path")
        elif key.startswith("flash"):
            # the representative is the decode regime (T = 1); the decode
            # regime at short contexts and the prefill regime beside it
            for r in rows:
                if " B=1 kv=" in r["case"]:
                    kv = r["case"].split("kv=")[1].split()[0]
                    entry.update({f"kv{kv}_ms": r["ms"], f"kv{kv}_bound_ms": r["bound_ms"],
                                  f"kv{kv}_library_ms": r["library_ms"]})
            pre = next(r for r in rows if r["case"].endswith("T=512 S=4096"))
            entry.update(prefill_case=pre["case"], prefill_ms=pre["ms"],
                         prefill_plain_ms=pre["plain_ms"], prefill_bound_ms=pre["bound_ms"],
                         prefill_bound_by=pre["bound_by"], prefill_library_ms=pre["library_ms"],
                         prefill_p_terms1_nmse=pre["p_terms1_nmse"],
                         prefill_p_terms2_nmse=pre["p_terms2_nmse"],
                         launches_decode=launches[key + ".decode"],
                         launches_prefill=launches[key] - launches[key + ".decode"])
            expect(entry["launches_decode"] > 0 and entry["launches_prefill"] > 0,
                   f"{key} launched in both regimes on the main path")
        if key == "qmm_mxfp4":
            # MXFP4 is an expert format only: its main-path launches go through
            # the stack and gather entries of the same device body
            entry["launches_2d"] = launches[key]
            entry["launched_through"] = ["qmm_stack", "qmm_gather"]
            entry["launches"] = (launches.get("qmm_stack.MXFP4", 0)
                                 + launches.get("qmm_gather.MXFP4", 0))
        for name, rows_by_key in (("batched", batched), ("verify", verify), ("qwen", qwen),
                                  ("phi", phi), ("unfused", unfused), ("gemma", gemma_k),
                                  ("options", opt_k), ("alibi", alibi_k),
                                  ("bloom_gpt2", bloom_gpt2_k), ("moe_families", fam_k)):
            # the shapes of continuous batching, of speculative verification,
            # of the Qwen models, of the Phi models and Qwen (v1), of the
            # 8B's projections apart (a LoRA engine's), of Gemma-3-4B, of
            # the option models, of the ALiBi family's attention, of the
            # bloom and gpt2 families' linears and of the three MoE families
            if key in rows_by_key:
                entry[name] = [{k: r[k] for k in ("case", "nmse", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")}
                               for r in rows_by_key[key]]
        expect(entry["launches"] > 0, f"{key} launched on the main path")
        kernels.append(entry)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"conformance": conformance}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
