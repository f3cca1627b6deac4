#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line and any failure exits non-zero:

1. ``device``  — the card (torch and nvidia-smi), the TF32 switches.
2. ``build``   — seconds to build the CUDA kernels from ``csrc/`` with nvcc
   (one process per source, in parallel), nvcc's version, and ptxas's
   register report; the updater and paged decode must keep no stack frame
   and spill nothing.
3. ``kernels`` — each kernel at its path's shapes, held against its plain
   PyTorch version on the same inputs (max abs error and tolerance):
   attention in float32 and bfloat16 at the serving shapes (and float32 at
   D 192, which the float32 tensor-core forward refuses: the CUDA-core one
   stays checked and timed), and float32 at the speculative draft step's
   shape (96 rows, one query each over 1,024 keys under a key mask, also
   timed through the op with its layout copies); paged decode (split-KV, one launch a call)
   at 8 slots of 1…1024 tokens and at 8 slots all at 1024, its faulted
   split-KV transcriptions (a split dropped, the combine without its
   rescale) beyond the tolerance; the fused
   updater (Nesterovs) in float32 and bfloat16 at the largest ResNet-50
   leaf and a 3×3×256×256 conv leaf (one leaf a launch), and over the
   whole ResNet-50 tree (Nesterovs, 161 leaves) and BERT-base tree (Adam,
   206 leaves) in one multi-tensor launch each, bit-exact leaf by leaf,
   beside ``torch._fused_sgd_`` / ``torch._fused_adam_`` over the same
   lists; the BN/matmul/BN-stats kernel in
   bfloat16 at the stage-1 c1 and c3 and the stage-3 c1 1×1 convs of
   batch 128, in both designs (``convbn_design``: the tensor-core "sm90"
   on the aligned operands the main path gives it, the WMMA one on an x
   off 16-byte alignment), z, mean and var to ``kernel_tolerance`` and
   each 128-row block's partial sums to ``partials_tolerance``, the sm90
   design's faulted plain variants (prologue skipped, last K slab
   dropped, a row block counted twice) beyond that check; the flash
   forward with dropout 0.1 and the dq and dk/dv backward kernels in
   float32 and bfloat16 at BERT's two attention shapes (A: BH 384, T 128,
   ragged key mask; B: BH 96, T 512), the float32 dq and dk/dv also causal
   at BH 12 × T 512 and at D 192 (the CUDA-core ones: the float32
   tensor-core dq and dk/dv take D <= 64), and the forward without
   dropout at shape A (``onnx_bert``'s attention); the fused matmul + bias +
   activation epilogue in float32 and bfloat16 at the three imported
   BERT-base shapes (M 4096; K×N 768×768, 768×3072 with gelu_exact,
   3072×768), every activation at 768×768, a ragged M of 4000, a K of 770
   (TMA cannot read it: the WMMA design in bfloat16, the CUDA-core SGEMM in
   float32), ragged M 4095 × K 776 × N 1000 and the 768×9 classifier
   (bfloat16 runs the tensor-core "sm90" design where TMA can read the
   operands; each tensor-core entry's faulted plain variants — the last K
   slab dropped, a slab added twice — must exceed the tolerance); the
   fused LayerNorm + activation at 4096 × 768 (the fine-tune head's rows)
   with gelu, gelu_exact and none in float32 and bfloat16; the int8
   serving matmul — the row quantization and the s8 tensor-core GEMM with
   its de-scale, in both designs (``int8_design``: the wgmma "sm90" on
   its K-major weight copy, whose one-off cost is timed apart, and the
   WMMA one on a q off 16-byte alignment) — in float32 and bfloat16 at the int8 BERT-base shapes
   (M 4096; K×N 768×768, 768×3072, 3072×768, 768×2), each equal to its
   plain version bit for bit, the sm90 design's faulted plain variants
   (a K slab dropped, the scales on the wrong axis) not. Attention in
   bfloat16 at D 64 runs the
   tensor-core ("sm90") forward, dq and dk/dv, which round P and dS to
   bfloat16 as the TPU kernels do: their bound adds that rounding
   (``testing/flash_check.py``), each faulted plain variant (keep mask
   shifted a column, last tile dropped, a rescale skipped) must exceed
   it, two runs must give the same bits, and the dropout forward's
   dropped entries must be keep_mask's. The float32 flash forward at
   D <= 128, the float32 dq and dk/dv at D <= 64 and the float32 fused
   matmul where TMA reads x run the "sm90_f32" designs — every product
   three TF32 passes on the tensor cores (``testing/split_f32.py``) —
   held to the float32 checks unchanged; their faulted plain variants add
   one TF32 pass (and the matmul's slabs are 32 deep, the backward's tiles
   32 wide), and two runs must give the same bits; their entries carry the
   one-off K-major split copy of the weight and the bound at the split's
   rate (three TF32 passes). With
   kernel / plain / library times (device time: the calls replayed from a
   CUDA graph between CUDA events, so no host work sits between launches)
   and the least time the card could take (``bound_ms``); the updater's
   beside ``torch._fused_sgd_`` (Nesterov) and ``torch._fused_adam_``.
3a. ``tuning`` — measured dispatch (``ops/tuning.py``): ``autotune(
   smoke=True)`` on the card into a temporary cache directory (every op's
   entries written, the table loaded back and live), then the standing
   tables restored; prints the device kind, the checked-in tables that
   stand (``default.json`` and the card kind's own, written by a full
   ``autotune()`` on such a card) and their crossovers. The later phases
   dispatch by them.
4. ``serve``   — GPT at GPT-2-small width (GptConfig.base(), float32,
   random weights from a numpy seed) served by the port's
   GenerativeEngine through start()/submit()/stop(): once with
   helper_mode="generic" (plain PyTorch attention) as the reference, then
   — with every launch count set to 0 just before — through the kernels,
   its prefill, write-prompt and decode steps replayed as CUDA-graph
   captures (``ops/capture.py``), then by the same engine under
   ``disable_capture()`` (op by op). Checks finish reasons, launch counts
   through the replays (every prefill on the float32 tensor-core forward,
   12 paged decodes a decode step), the serving ledger (one
   ``first_compile`` each for prefill, write_prompt and decode, no
   ``new_shape``), greedy tokens against the reference run and 12 of 12
   equal between the captured and the eager run; then with 8 slots
   decoding, the decode step's wall p50 captured and eager, and one
   decode step on fixed inputs captured and eager, logits bit-equal.
4b. ``serve_supervised`` — a new engine of the same configuration,
   supervised (the default), threaded, with ``decode_step_error`` and
   ``worker_death`` armed once each (``SERVE_CRASH_AT``) and
   ``max_retries=2``: every request's greedy tokens equal to the ``serve``
   run's, 2 restarts, the retries equal to the requests active at the two
   crashes, one capture and one ``first_compile`` a step unit (none after
   a restart), the KV pool the same buffer; then one ``page_oom`` shot
   ends its request as ``oom``. Reports each crash's recovery seconds and
   a ``faults`` line.
4c. ``serve_prefix`` — the radix prefix cache at the same width:
   ``PREFIX_REQUESTS`` requests (four 96-token system prompts, 8–32-token
   tails, 16 greedy tokens each) closed loop with the cache off (the
   reference), then — launch counts set to 0 just before — the four
   system prompts pre-warmed and pinned and the same requests through
   an engine with ``prefix_pages`` 64 and ``suffix_bucket`` 32 (prompt
   bucket 128, page 16). Checks the tokens against the cache-off run
   (ties explained by the top-2 gap), 16 hits, exactly 48 flash
   prefills, 12 paged decodes a decode step and 12 generic attentions a
   suffix prefill (the flash gate refuses its dense mask, as the JAX
   gate does), one ``first_compile`` a unit, no ``new_shape``, the
   allocator and tree invariants. Reports TTFT p50 on and off, the
   suffix-prefill and full-prefill units' device time and the generic
   attention's share of the suffix prefill.
4d. ``serve_spec`` — the ``serve`` phase's engine and requests with
   ``spec_k`` 4, once with ``perturbed_draft(scale=1e-2)`` and once with
   scale 3e-3 (accepts and rejections both). Checks each run's committed
   streams against the ``serve`` phase's (ties explained), the flash
   launches (12 per target and draft prefill and 12 × 5 a propose: every
   draft step runs flash at one query a slot), the generic attention of
   each verify (12), no paged decode unless a slot falls back to plain
   decode, one ``first_compile`` a unit and no ``new_shape``, the
   draft/target length invariant. The draft path is checked against
   its references: propose call ``SPEC_CHECK_CALL``'s proposals against
   the same draft steps under ``helper_mode="generic"`` from the draft
   cache it started from (near ties explained), the flash forward at
   that call's shape (96 rows, ``t_q`` 1, 1,024 keys, the call's key
   lengths, on the cache's first layer) against its plain version with
   the faulted variants, and every request's accepted count against the
   count its committed stream predicts (one generic draft prefill over
   the stream gives every proposal). Reports proposed and accepted
   tokens, tokens/s beside the ``serve`` phase's, the propose and verify
   units' device time, and one layer's attention inside each, as the
   path calls it (layout copies, gather and concatenation included) and
   alone, each with its share.
4e. ``serve_cluster`` — a ``ClusterRouter`` over two serve_prefix
   engines behind ``SLOFrontend`` (interactive and standard pin a system
   prompt each; batch's token bucket holds 2). Engine 0's loop runs alone
   until ``engine_death`` fires in it; then engine 1 starts. Every
   retryable request must complete on engine 1 with the serve_prefix
   reference tokens, exactly 2 of the 4 batch arrivals shed by the
   bucket, no ``new_shape``, the survivor's invariants, and, from the
   run's own counts, 12 flash launches a prefix miss, 12 generic
   attentions a hit and 12 paged launches a decode step.
5. ``train``   — ResNet-50 at full width (224×224×3, 1000 classes), the
   usual configuration (float32, composed blocks, Nesterovs lr 0.1),
   batch 32, trained through ``ResNet50().init()`` → ``fit``: 3 steps
   with helper_mode="generic", then — launch counts set to 0 just before —
   3 steps through the kernels from the same initial state on the same
   batches. Checks the updater counts (161 leaves × 3 steps updated, one
   multi-tensor launch a step) and the losses and parameters against the
   generic run.
6. ``train_fused`` — the same for ``ResNet50(fused_blocks=True,
   dtype="mixed")`` at batch 128, where every 1×1 conv of the fused
   blocks takes the BN/matmul/BN-stats kernel's sm90 design (36 × 3
   launches, their (M, K, N, prologue) census reported). The
   step-1 losses (same parameters) must agree to one bfloat16 unit; the
   generic run is repeated with its input moved by one bfloat16 unit,
   and the kernel run's parameters after 3 steps must sit within 3× that
   run's distance.
7. ``bert_train`` — BERT-base at full width (``BertConfig.base()``,
   110.1M parameters in 206 leaves, random weights from the port's seed),
   float32, ``fit_classifier`` on batch 32 × seq 128 with ragged rows,
   Adam lr 2e-5, attention and FFN dropout 0.1: 3 steps through the
   kernels (launch counts set to 0 just before; 12 flash forwards, 12 dq
   and 12 dk/dv — all on the float32 tensor-core designs — and the
   updater over 206 leaves in one launch a step), then the same steps
   with
   the plain flash versions installed as the ``cuda`` helper (same
   seeds, same dropped entries), and at dropout 0 against
   ``helper_mode="generic"``; losses step by step and parameters after
   3 steps against a yardstick run from parameters moved by one unit in
   the last place; ``predict`` launches 12 forwards.
8. ``bert_mlm`` — the same for ``BertModel(..., dtype=bfloat16)``,
   ``fit_mlm`` on batch 8 × seq 512 with 15% of positions masked; its
   forward, dq and dk/dv launches (12 each a step) are the sm90 kernels',
   and every float32 phase launches none of them (nor the 16-bit sm90
   fused matmul): their flash forwards, dq, dk/dv and fused matmuls are
   all the float32 tensor-core ("sm90_f32") designs', none the CUDA-core
   ones.
9. ``onnx_bert`` — the imported-graph path: the ONNX bytes of a
   BERT-base-width encoder (12 layers, d 768, 12 heads, ff 3072, vocab
   30522, ~108.5M float32 weights from a numpy seed) built by the port's
   builder, ``import_onnx`` onto the card, and ``sd.output`` on batch 32
   × seq 128 with ragged rows (16…128 keys): the optimized plan must hold
   12 attention and 72 epilogue fusions, and one forward — launch counts
   and the dispatch counter set to 0 just before — must dispatch 72
   ``fused_matmul_bias_act`` and 12 ``dot_product_attention`` calls to
   the ``cuda`` kernels — a replay of the plan's CUDA-graph capture, its
   launches counted through the replay. Its output is held against
   ``helper_mode="generic"`` and against the unoptimized graph
   (``optimize=False``), and the captured output against the same
   forward under ``disable_capture()``, bit for bit, with one
   ``first_compile`` for ``exec`` in the ledger. Reports the p50 forward
   time (captured and eager) and tokens/s over 5 forwards after 2 warm
   ones, parse and plan seconds, node counts, peak memory and the graph
   pool's memory.
9a. ``onnx_vit`` — an imported ViT-B/16 (``google/vit-base-patch16-224``
   widths: 224², patch 16, 197 tokens, 768, 12 layers, 12 heads, 3072,
   exact GELU, 1000 classes; ``testing/onnx_builder.vit_onnx_model``, as
   ``torch.onnx.export`` writes HF's ``ViTForImageClassification``, ~86.6M
   float32 weights from a seed) served at batch 32: build, parse and
   import seconds and the weight count; the plan's fusions (12 attention,
   73 epilogue: the transB=1 Gemm head fused but refused by the kernel's
   gate); one counted forward (counts set to 0 just before, read just
   after) must launch exactly 12 ``sm90_f32`` flash forwards and 72
   ``sm90_f32`` fused matmuls and nothing else of the table, every
   attention dispatched to the kernel and the head the only generic
   fused matmul; logits against ``helper_mode="generic"`` and against
   ``optimize=False`` within 3× a generic forward from weights moved by
   one ulp; captured = eager bit for bit; forward p50 captured and eager,
   images/s, the busy share of 2 profiled forwards, peak memory.
9b. ``onnx_resnet50`` — an imported ResNet-50 (torchvision v1.5,
   BatchNormalization kept; ``resnet50_onnx_model``, ~25.6M weights) at
   batch 32 × 3 × 224 × 224: the same import figures; its counted forward
   launches none of the table's kernels (conv, BN and pooling are library
   calls, as the JAX package runs them in plain XLA); logits against
   ``optimize=False`` within the same yardstick; captured = eager bit for
   bit; forward p50, images/s, busy share, peak memory.
10. ``sd_bert_finetune`` — SameDiff training of that imported encoder: the
   same ONNX bytes through ``import_onnx``, a token-classification head
   added in SameDiff (dense 768×768 → ``sd.nn.layer_norm`` →
   ``sd.nn.gelu`` → classifier over the 9 BIO tags of CoNLL-2003 NER,
   ``sd.loss.softmax_cross_entropy`` against one-hot token labels; 201
   trainable leaves), ``TrainingConfig(Adam lr 5e-5)`` and ``sd.fit`` for
   3 steps on one repeated batch 32 × 128 (ragged rows), then
   ``sd.output`` of the logits. The loss plan must hold exactly 12
   attention, 74 epilogue and 1 LayerNorm fusions, and each step — launch
   counts set to 0 just before the 3 steps and read just after — must
   launch 1 fused LayerNorm, 12 flash forwards, 12 dq, 12 dk/dv (the three
   on their sm90_f32 designs), 74 fused
   matmuls (forwards and matmuls on the sm90_f32 designs, with one K-major
   split copy of each matmul's weight a step: the updater's weights are
   new tensors) and one updater launch over 201 leaves. Losses are held
   against a
   ``helper_mode="generic"`` run from the same weights (step 1 to 1e-5
   relative; later steps and the parameters to 3× a generic run from
   weights moved by one unit in the last place), and the last loss must
   be below the first. ``sd.output`` of the logits, captured before the
   3 steps and replayed after them on the updated weights (reloaded into
   its static buffers, their K-major split copies remade in place), must
   equal the same call under ``disable_capture()`` bit for bit.
10a. ``tf_bert`` — TF import without TensorFlow: ``testing/tf_builder.py``
   writes a frozen BERT-base GraphDef in google-research/bert's
   ``modeling.py`` layout (float32 Const weights, ~440 MB; pooler and a
   2-way classifier; batch 32 × 128, ragged key mask, segment ids);
   ``import_frozen_graph`` puts it on the card (build, parse and import
   seconds printed). The plan must hold 12 attention and 74 epilogue
   fusions (no LayerNorm: TF's is decomposed); one counted forward
   launches 12 flash forwards and 74 fused matmuls; a softmax cross
   entropy added in SameDiff and 3 ``sd.fit`` Adam (5e-5) steps, counted,
   launch 12 + 12 + 12 flash (sm90_f32), 74 fused matmuls and one updater
   launch over 201 leaves a step. The captured steps equal the same steps
   under ``disable_capture()`` bit for bit (one ``first_compile``); the
   forward is held to 1e-4 of ``helper_mode="generic"``, the losses and
   parameters as sd_bert_finetune holds its own; ``GraphRunner`` on the
   same bytes gives the forward again. A SameDiff ``while_loop`` whose
   trip count depends on its input must equal its CPU run and be routed
   to eager once (one ledger event, ``dl4j_tpu_capture_skipped_total``
   1, no capture). Step p50 (captured and eager), tokens/s, the busy
   share of 2 more profiled steps and peak memory.
10b. ``sd_namespaces`` — a SameDiff graph recorded through the public
   namespaces alone (``testing/namespace_encoder.py``): a float32
   placeholder [8, 128, 768] through 12 layers of
   ``sd.nn.multi_head_dot_product_attention`` (12 heads) → residual add →
   ``sd.nn.layer_norm`` → ``sd.nn.linear`` 768→3072 → ``sd.nn.gelu`` →
   ``sd.nn.linear`` 3072→768 → residual add → ``sd.nn.layer_norm``, the
   mean over T, ``sd.nn.linear`` 768→2 and
   ``sd.loss.softmax_cross_entropy`` (85.0M parameters from numpy
   RandomState(0) × 0.02): ``sd.output``, then 3 ``sd.fit`` steps (Adam
   5e-5), then the logits again. Counts set to 0 just before the forward
   and the steps: 12 flash forwards a forward, 12 + 12 + 12 flash and one
   updater launch over 146 leaves a step. The step-1 loss and the first
   logits within 1e-5 relative of ``helper_mode="generic"``, later
   losses, parameters and logits within 3× a generic run from weights
   moved by one unit in the last place; step p50, tokens/s and the busy
   share of 2 more profiled steps.
10c. ``op_catalog`` — every spec of the port's ``ops/validation.py`` (287
   ops, 885 spec × dtype cases) through the registry on the card and on
   the CPU (``testing/consistency.run_catalog``): structure, shapes and
   dtypes equal, values within the spec's tolerance, random draws held
   by their semantic checks and repeated from the same seed. Prints the
   counts of ops, cases and failures; any failure fails the run.
11. ``int8_bert`` — int8 serving: the same BERT-base encoder with every
   dense MatMul a ``matmul_int8`` (ONNX Runtime's dynamic quantization
   layout: weights int8 per column, quantized once at build; activations
   per row at call time; embeddings, biases, LayerNorms and attention in
   float32), recorded through ``SameDiff`` by
   ``testing/int8_bert.bert_int8_encoder`` from onnx_bert's own weights
   and feeds, and run by ``sd.output``. One forward — launch counts and
   the dispatch counter set to 0 just before — must launch the int8 GEMM
   (all 73 on its sm90 design, their 73 K-major weight copies all made
   before it) and the row quantization 73 times each and the flash
   forward 12 times,
   and no ``matmul_int8`` or ``dot_product_attention`` call may take the
   generic. Its output is held against ``helper_mode="generic"`` within
   3× the distance of a generic run whose float32 embedding table is
   moved by one unit in the last place, and against onnx_bert's float32
   forward (same weights and feeds) within a gross-fault bound on the
   last hidden state's relative error, which a wrong-scale-axis graph
   must exceed. The captured forward equals the same forward under
   ``disable_capture()`` bit for bit, with one ``first_compile`` for
   ``exec``. Reports the p50 forward time (captured and eager) and
   tokens/s over 5 forwards after 2 warm ones, peak memory, the graph
   pool's memory and node counts beside onnx_bert's.
11b. ``export_bindings`` — the BN/matmul/BN-stats, LayerNorm and int8
   kernels as ``torch.library`` operators through ``torch.export`` on the
   card: a one-op module each of ``bn_matmul_stats`` (ResNet-50's stage-3
   c1 at batch 32) and ``fused_layer_norm`` (4096 × 768, gelu) exported,
   stored in an ``ExportCache``, loaded and run; int8_bert's graph
   exported by ``export_exec`` and warm-booted back from the cache — each
   restored program equal to the direct call bit for bit, with the same
   launches (73 int8 GEMMs, 73 row quantizations and 12 flash forwards an
   int8 forward); ``torch.library.opcheck`` of the four operators on CUDA
   tensors.
11a. ``onnx_bert_autocast`` — onnx_bert's bytes through the optimizer's
   autocast pass (``passes=PASS_ORDER + ("autocast",)``: every dense
   MatMul's x and w cast to bfloat16, its result back to float32),
   ``sd.save`` to a zip, ``SameDiff.load`` on the card, ``sd.output``.
   One counted forward must launch the 16-bit sm90 fused matmul 72 times
   and the float32 flash forward 12 times and nothing else, as many as
   the gates sent to the kernels (the dispatch tally of that forward);
   the loaded graph's output equals the in-memory graph's; the last
   hidden state is held against ``helper_mode="generic"`` (relative
   error 2^-5) and against onnx_bert's float32 forward (the int8 gross
   bound); captured equals eager bit for bit with one ``first_compile``.
   Reports tokens/s (forward p50 over 5) beside onnx_bert's float32
   figure, the busy share of 2 profiled forwards and peak memory.
12. ``lenet`` — the sequential network: ``LeNet().init()`` at its zoo
   defaults (28×28×1, 10 classes, Adam 1e-3, seed 123; 431,080
   parameters) → ``fit`` on batches of 64 synthetic digits, 3 steps
   ``helper_mode="generic"``, then 3 counted steps (launch counts and the
   dispatch tally set to 0 just before): one updater launch over the 8
   leaves a step; losses and parameters held to the generic run as
   ``train`` holds them. Reports images/s.
12b. ``lenet_bf16`` — the same under ``dtype("bfloat16")``: bfloat16
   parameters and updater state, float32 input promoting each op to
   float32 as jnp does; 3 steps through the fused updater on bfloat16
   leaves bit-equal to ``helper_mode="generic"``.
13. ``bilstm_tagger`` — BASELINE config 3 at a realistic width:
   ``Bidirectional(LSTM(256, tanh), concat)`` over 300-wide word vectors
   → ``RnnOutputLayer`` over CoNLL-2003's 9 tags, Adam 5e-3, built with
   ``builder()…list()…build()``; batch 32 × T 128 with ragged lengths
   8…128 (features and labels masks right padded). 3 counted ``fit``
   steps must dispatch ``lstm_layer`` to cuDNN twice a forward (one a
   direction) and never to the generic, and launch the updater once a
   step; losses and parameter moves against ``helper_mode="generic"``
   (float32, TF32 off) within max(1e-5 relative / 1e-3 relative L2, 3×
   a generic run from parameters one ulp away); then ``output`` at every
   position, padded ones included, cuDNN against the generic within 1e-5.
   Reports real tokens/s and ``lstm_layer``'s forward + backward time at
   the shape on cuDNN and on the generic.
14. ``char_lstm`` — the layers of ``TextGenerationLSTM(vocab_size=77)``
   (2 × LSTM 256, RmsProp 1e-2) built with ``tbptt(50, 50)``, one ``fit``
   batch of 32 × 1000 one-hot characters: 20 segments, 20 updater
   launches, 40 cuDNN dispatches. Each segment is held, from the generic
   run's own state at its start, cuDNN against the generic (score 1e-5
   relative, parameter move 1e-3 relative L2, carried h and c 1e-5 +
   1e-5 relative); the free-running trajectories are reported beside
   their one-ulp yardstick. ``rnn_time_step`` fed 50 steps one at a time
   must equal ``output`` over the same 50 within 1e-4. Reports tokens/s.
15. ``zoo_cnn`` — the zoo's vision families at their zoo defaults (the
   reference's constructor defaults: full width, the zoo's input size;
   ``testing/zoo_cnn.py``): SimpleCNN 48² b64, AlexNet 224² b128, VGG16
   and VGG19 224² b32, Darknet19 224² b64, SqueezeNet 227² b64, UNet
   128²×1 b16, Xception 299² b32 (8 middle blocks), InceptionResNetV1
   160² b64 (blocks 5, 10, 5), each through ``Zoo().init()`` → ``fit``:
   3 steps ``helper_mode="generic"``, then 3 counted steps from the same
   start on the same batches (launch counts set to 0 just before), with
   a ``CollectScoresIterationListener`` and a ``PerformanceListener``
   attached. Checks: one updater launch a step for each table of at most
   256 leaves (InceptionResNetV1's 366 leaves take 2); losses and
   parameters held to the generic run as ``train`` holds ResNet-50, and
   for the four models with overlapping 3×3/2 max pools within
   max(1e-5, 3× a generic run from parameters one ulp away); ``output``
   on 2 images on the card against the port's CPU ``output`` of the same
   parameters (1e-3 relative + 1e-5 of the output's largest magnitude,
   TF32 off); ``evaluate`` on
   a held batch against numpy's argmax agreement (UNet: a
   ``RegressionEvaluation`` against numpy's mean squared error); the
   listener's 3 scores equal to the run's losses. UNet has no loss
   layer in the reference: its score is 0 and no parameter moves. Then
   TinyYOLO and YOLO2 at 416×416×3, batch 8: ``output`` through the
   kernels against the generic and against the CPU, and ``yolo_loss``
   with its gradient w.r.t. the prediction finite and equal to the
   generic's. Reports each model's step p50, images/s, parameters, peak
   memory, FLOPs a step (from the convolution and dense shapes) and
   their share of 67 TFLOP/s (float32 without tensor cores), and the
   phase's seconds.
16. ``supervised_train`` — ``AlexNet()`` at the zoo defaults (224², 1000
   classes, batch 128, Nesterovs, dropout 0.5) on 2 epochs × 4 batches of
   uint8 textures through ``ListDataSetIterator(shuffle=True)`` with
   ``ImagePreProcessingScaler`` attached: the uninterrupted oracle; a
   ``TrainingSupervisor(save_every=2)`` run killed by the ``preemption``
   fault after 5 steps; a graceful ``request_preemption()`` at iteration
   3 continued by a fresh network of another seed; the newest save torn
   and a hard kill (the restore falls back). Per-iteration losses, final
   parameters, updater and generator state bit-equal to the oracle's;
   restarts, resumes, fallbacks and steps run as expected; one updater
   launch a step run, replays included. Reports checkpoint bytes, sync
   save and restore seconds, the training thread's seconds per async save
   beside the writer's, and the unarmed poll's cost a step.
17. ``graph_tbptt`` — TextGenerationLSTM's layers through
   ``graph_builder()`` (tBPTT 50) on two 32 × 1000 character batches under
   ``TrainingSupervisor(save_every=1)``, killed mid second batch: the
   resumed run's losses and parameters equal to the oracle's, checkpoints
   only at the batch boundaries; the graph's 20 segment losses equal to
   the ``MultiLayerNetwork``'s from the same parameters, and 200
   characters through ``rnn_time_step`` equal to the network's. Where a
   run is not bit-reproducible the first differing segment is named and
   held to ``char_lstm``'s 1e-5 relative.
18. ``fit_scanned`` — the scanned entry points against as many ``fit``
   steps from the same start, bit for bit in losses and in the whole
   state, each chunk run twice (the first captures the unit, the second
   replays it with one host synchronization, counted by
   ``torch.cuda.set_sync_debug_mode``): LeNet's ``fit_scanned`` in both
   modes, ResNet-50 A's through ``ComputationGraph.fit_scanned`` (3
   per-step batches of 32 at 224²) and ``fit_mlm_scanned`` at bert_mlm's
   shape.
19. ``updater_coefficients`` — every schedule's learning rate and every
   updater kind's coefficient buffer computed on the card from an int32
   step tensor against the CPU's: the largest ulp gap, reported.
20. ``keras_bert`` — Keras import without h5py, Keras or TensorFlow:
   ``testing/keras_builder.py`` writes the legacy ``.h5`` of a BERT-base
   width functional Keras encoder (~440 MB), the port's HDF5 reader
   parses it and ``import_keras_model_and_weights`` builds the
   ComputationGraph on the card (build, parse, import seconds); every
   leaf bit-equal to the builder's arrays; ``output`` at batch 32 × 128
   launches exactly 12 float32 tensor-core flash forwards and nothing
   else, within 3× the one-ulp yardstick of ``helper_mode="generic"``
   (probabilities and last hidden state); eager forward p50, tokens/s,
   busy share, peak memory; and a Sequential Conv1D classifier from the
   same builder against its generic run and its CPU import.
20a. ``keras_bert_transfer`` — keras_bert's ``.h5`` bytes imported again
   with ``validate=True`` (the checker's seconds), made a 9-way classifier
   by ``graph_transfer_builder`` (``testing/layer_nets.
   transfer_keras_encoder``: the classifier removed, an OutputLayer on
   ``pooler``, the embeddings and blocks 0–7 frozen, Adam by a
   ``FineTuneConfiguration``) and fine-tuned by ``EarlyStoppingTrainer``
   (4 batches of 32 × 128 an epoch, 2 held out, at most 3 epochs,
   ``InMemoryModelSaver``), captured; then op by op under
   ``helper_mode="generic"`` and from one-ulp-nudged parameters. Frozen
   leaves bit-identical, the best model restored with its held-out score
   equal to ``best_score``, losses and trained leaves within 3× the
   yardstick, the flash forward / dq / dk/dv and updater launches the
   steps and held-out scores make; step p50, tokens/s, peak memory.
20b. ``nn_layer_types`` — the last fourteen layer types through the
   networks of ``testing/layer_nets`` at card size (CapsNet at Sabour et
   al. widths, a 784-input VAE by its ELBO, an attention sequence
   classifier with a CenterLossOutputLayer at batch 32 × T 256, a
   recurrent-attention tagger at T 64, and one network each of MaskLayer,
   ElementWiseMultiplicationLayer, FrozenLayerWithBackprop, CnnLossLayer,
   Yolo2OutputLayer at TinyYOLO's head and a SameDiffLayer): 3 steps
   each, captured = eager, held to ``helper_mode="generic"`` and to the
   port's CPU run of the same parameters by the one-ulp yardstick; the
   learned-query attention launches the flash forward, dq and dk/dv.
21. ``aot_warm_boot`` — the export cache (``autodiff/export.py``,
   ``serving/aot.py``; the kernels as ``torch.library`` operators), each
   leg a fresh process (``chip_smoke.py --aot-leg``) with
   ``DL4J_TPU_COMPILE_CACHE`` set or not: GPT-2-small width (4 layers)
   served by ``run_randomized_replay`` (16 requests, prefix cache and
   speculation armed, every 4th request sampled: the plain decode step;
   the prefix cache hit in every leg) cold,
   populating and warm — tokens bit for bit across the three, no serving
   ``first_compile`` in the warm leg, no ``new_shape`` in any, the flash
   and paged decode launches of each leg equal; onnx_bert (batch 32 ×
   128) through ``export_exec`` in one process, its output equal to the
   same process's plain forward, and ``warm_boot_samediff`` in another,
   equal to it, 72 ``sm90_f32`` fused matmuls and 12 ``sm90_f32`` flash
   forwards a restored forward, only ``cache_hit`` in the ledger; LeNet
   under ``TrainingSupervisor`` (synchronous saves), its train step
   exported, killed by SIGKILL after 3 of 6 steps and resumed in a fresh
   process (checkpoint and warm boot): every score and the final
   parameters equal to an uninterrupted run of the exported step, 3 + 3
   updater launches, the exported step against the plain step. Each
   leg's process-start-to-first-output seconds, each entry's bytes, the
   export and load seconds.

Every training phase (5–8, 10, 12–17) runs its steps as CUDA-graph
training units (``nn/compiled.py``): the warm-up captures each step key,
the counted run replays, and the same steps under ``disable_capture()``
from the same start must equal the captured ones bit for bit in losses,
parameters, updater and batch-norm state, with one ``first_compile`` a
step key and no ``new_shape`` in the ledger (``capture_fields``: both
step p50s, the ledger, each unit's captures and pool). Between runs the
state is copied into the trainer's own tensors (``_load``), and the
reference runs (generic, plain flash, the one-ulp yardsticks) run op by
op. ``bilstm_tagger`` feeds masks to an LSTM: its steps are routed to
eager by rule, and the phase prints their count.

Every phase's line carries ``observe.dispatch_summary()``: the
registry's kernel-or-generic decisions since the phase's last
``observe.reset()``, with their reasons (``crossover`` where a measured
crossover sent a call to the generic).

Then the kernel summary line, the card's name and power limit as
nvidia-smi prints them, and the result line. Without a GPU (or without the
package beside this script) it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,      # CUDA cores, no tensor cores
              "bfloat16": 989e12,    # dense tensor cores
              "int8": 1979e12,       # dense int8 tensor cores (TOP/s)
              # float32 products as three TF32 passes (the sm90_f32 designs)
              "tf32_split": 494.7e12 / 3}
# kernel vs plain version, elementwise |kernel - plain| <= ATOL + RTOL*|plain|:
#  float32  — same math, another summation order: 1e-4 absolute (errors of
#             ~1e-6 are seen)
#  bfloat16 — both sides compute in float32 and round the output once to
#             bfloat16, so they differ by at most one rounding step: one
#             unit in the last place, at most 2^-7 of |plain|
ATOL = {"float32": 1e-4, "bfloat16": 1e-5}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
# The sm90 design (ca.flash_design: bfloat16 with D <= 128) rounds P and dS
# to bfloat16 before the products that take them, as the TPU kernels' `_mm`
# does; its bound adds that rounding per element (testing/flash_check.py):
# out + 2^-7·(|P̃|·|V|), dv + 2^-7·(|P̃ᵀ|·|dO|), dk + 2^-7·scale·(|dSᵀ|·|Q|),
# dq + 2^-7·scale·(|dS|·|K|) (dS unscaled, as the TPU dq rounds it), the
# products of the plain version's absolute values in float32.
TOL_LSE = 1e-4          # float32 in both dtypes; logsumexp of <= 512 terms
# the float32 forward with D <= 128 (ca.flash_design: "sm90_f32") forms
# every product from TF32 parts (testing/split_f32.py) and is held to the
# float32 bounds above unchanged; its faulted plain variants — one TF32
# pass, the last key tile dropped, a rescale skipped, the keep mask shifted
# a column — must exceed them
FLASH_FWD_KERNEL = {"simt": "flash_attn_fwd", "sm90": "flash_attn_fwd_sm90",
                    "sm90_f32": "flash_attn_fwd_f32_sm90"}
FLASH_F32_FAULTS = ("single_pass_tf32", "keep_shifted", "last_tile_dropped",
                    "rescale_skipped")
FLASH_DQ_KERNEL = {"simt": "flash_attn_dq", "sm90": "flash_attn_dq_sm90",
                   "sm90_f32": "flash_attn_dq_f32_sm90"}
FLASH_DKV_KERNEL = {"simt": "flash_attn_dkv", "sm90": "flash_attn_dkv_sm90",
                    "sm90_f32": "flash_attn_dkv_f32_sm90"}
# the float32 dq and dk/dv with D <= 64 ("sm90_f32") are held to the
# float32 backward bound (BWD_ATOL, BWD_RTOL) unchanged; their faulted plain
# variants — one TF32 pass (testing/split_f32.py), the keep mask shifted a
# column, the last 32-wide tile dropped — must exceed it
FLASH_BWD_F32_FAULTS = ("single_pass_tf32", "keep_shifted",
                        "last_tile_dropped")
LOGIT_TOL = 1e-3        # kernel vs generic GPT logits (float32, 12 layers)
DECODE_TIMED = 20       # serve: decode steps timed captured, then eager

FLASH_SHAPE = dict(bh=12, t=512, d=64)
# a float32 head dim the tensor-core forward refuses: the CUDA-core one
# stays checked and timed there
FLASH_SIMT_D = 192
# the speculative draft step's flash forward (serve_spec): 8 slots x 12
# heads, one query each against the 1,024-position dense draft cache;
# visible keys a slot at one key, tile edges and the whole context
DRAFT_FLASH = dict(slots=8, heads=12, t=1024, d=64,
                   lens=(1, 9, 63, 64, 65, 300, 544, 1024))
PAGED_SHAPE = dict(slots=8, heads=12, d=64, page=16, max_pages=64)
# fused updater: the fc weight (the largest leaf) and a stage-3 3×3 conv,
# one leaf a call; and the whole ResNet-50 and BERT-base trees, one
# multi-tensor launch a call (updater_tree_case)
UPDATER_SHAPES = {"fc.W": (2048, 1000), "conv3x3": (3, 3, 256, 256)}
# libraries whose every kernel must keep no stack frame and spill nothing
NO_STACK_KERNELS = ("fused_updater", "paged_decode")
# bn_matmul_stats at batch 128: stage-1 c3 (M = 128·56·56, prologue+relu),
# stage-3 c1 (M = 128·14·14, no prologue) and stage-1 c1 (N 64, the
# narrowest tile), as FusedBottleneck calls it
CONVBN_SHAPES = {"stage1_c3": (401408, 64, 256, True),
                 "stage3_c1": (25088, 1024, 256, False),
                 "stage1_c1": (401408, 64, 64, False)}
# train_fused: convbn launches a step (16 bottlenecks × c1, c3 + 4
# projection shortcuts), every one on the sm90 design
CONVBN_PER_STEP = 36
# BERT-base attention at the two BERT phases' shapes (BH = batch·12):
# A — fine-tune, batch 32 × seq 128, ragged rows (key mask); B — MLM,
# batch 8 × seq 512, full rows. Dropout 0.1 (BertConfig's default).
BERT_ATTN_SHAPES = {"A": dict(batch=32, heads=12, t=128, d=64, min_len=16),
                    "B": dict(batch=8, heads=12, t=512, d=64, min_len=None)}
# the backward also at a causal shape (the causal branch of the float32
# tensor-core dq and dk/dv: GPT-2-small's 12 heads over 512 tokens)
BWD_CAUSAL_SHAPE = dict(batch=1, heads=12, t=512, d=64, min_len=None)
ATTN_DROPOUT = 0.1
# the backward: sums of up to T products in float32 in another order:
# 1e-4 absolute plus 1e-5 relative; bfloat16 one unit in the last place
BWD_ATOL = 1e-4
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
BERT_STEPS = 3
# BERT phases: the kernel run against a reference run on the same data,
# seeds and starting state. Each step's loss may differ by LOSS_RTOL of
# its value or by 3× the reference run's own change when its starting
# parameters move by one unit in the last place (the yardstick), and the
# parameters after 3 steps by 3× the yardstick's distance (at least one
# unit in the last place of the largest parameter). Adam's first step
# moves an element by ~±lr whatever its gradient's size, so tiny
# gradients of opposite sign move parameters by ~2·lr in either run pair.
BERT_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
BERT_YARDSTICK = 3.0
# fused matmul epilogue at the imported BERT-base shapes (M = batch 32 ·
# seq 128): (K, N, activation) per layer — q/k/v/o projections ×4, FF1
# with the exact gelu, FF2 — plus every activation at one shape, a ragged
# M, a K that is no multiple of 4 (TMA cannot read it: bfloat16 runs the
# "wmma" design there and float32 the CUDA-core "simt" one), ragged M, K
# and N with K and N multiples of 8 but not of the sm90 tile (M 4095, K
# 776 = 12 slabs + 8, N 1000 = 5 tiles of 192 + 40) and the fine-tune
# head's 768×9 classifier. Tolerance: cuda_matmul.kernel_tolerance — the
# float32 summation bound of K terms (2·K·2^-24·max|x|·max|w|) plus, in
# bfloat16, one unit in the last place of the plain output, unchanged for
# the float32 "sm90_f32" design, whose products are three TF32 passes; each
# tensor-core entry's faulted plain variants (testing/matmul_check.py; for
# sm90_f32 also one TF32 pass) must exceed it.
FUSED_MM_SHAPES = [(4096, 768, 768, "none"), (4096, 768, 3072, "gelu_exact"),
                   (4096, 3072, 768, "none")]
FUSED_MM_EXTRA = [(4096, 768, 768, "relu"), (4096, 768, 768, "tanh"),
                  (4096, 768, 768, "gelu"), (4000, 768, 768, "gelu_exact"),
                  (4096, 770, 768, "none"), (4095, 776, 1000, "gelu"),
                  (4096, 768, 9, "none")]
# onnx_bert: the kernel run, the generic run and the unoptimized graph
# compute the same float32 function through 12 layers, summed in other
# orders (CUDA-core kernels vs cuBLAS): the output probabilities (y, in
# [0, 1]) may differ by 1e-4 absolute
ONNX_BERT_TOL = 1e-4
ONNX_BERT_TIMED = 5
# onnx_vit / onnx_resnet50: imported ViT-B/16 and ResNet-50 at 224×224,
# batch 32, float32; logits held to 3× a generic forward from weights moved
# by one unit in the last place (at least one ulp of the largest logit)
ONNX_VISION_BATCH = 32
ONNX_VISION_YARDSTICK = 3.0
ONNX_VISION_TIMED = 5
# tf_bert: the kernel forward against the generic one (float32 logits), and
# the routed while graph (a vector doubled plus one until its sum reaches
# the limit: integers, exact in float32 on both devices)
TF_BERT_TOL = ONNX_BERT_TOL
TF_WHILE_N = 4096
TF_WHILE_LIMIT = 1e7
# fused LayerNorm + activation at the fine-tune head's rows (batch 32 ·
# seq 128) × hidden 768; tolerance cuda_layernorm.kernel_tolerance
LN_SHAPE = (4096, 768)
LN_ACTS = ("gelu", "gelu_exact", "none")
# the int8 serving matmul at the int8 BERT-base shapes (M = batch 32 · seq
# 128): q/k/v/o 768×768, FF up 768×3072, FF down 3072×768 and the 768×2
# classifier. The kernels compute the plain versions' integers and float32
# products: equal bit for bit
INT8_MM_SHAPES = [(4096, 768, 768), (4096, 768, 3072), (4096, 3072, 768),
                  (4096, 768, 2)]
# int8_bert: the kernel run against helper_mode="generic" within this many
# times the distance of a generic run with the embedding table moved by one
# unit in the last place (a moved float input flips single quantized
# values, so no fixed tolerance holds); and the last hidden state's relative
# error against the float32 encoder, ||h_int8 - h_f32|| / ||h_f32||, below
# a gross-fault bound: the true graph sits far below it, a wrong scale axis
# or transposed projections far above (tests/test_torch_int8_bert.py, and
# the run's own wrong-axis graph)
INT8_BERT_YARDSTICK = 3.0
INT8_GROSS_REL_ERR = 0.1
INT8_BERT_TIMED = 5
# onnx_bert_autocast: onnx_bert's graph with the optimizer's autocast pass
# (every dense MatMul's x and w cast to bfloat16, its result back to
# float32), saved to a zip and loaded back. The sm90 kernel rounds
# act(acc + b) to bfloat16 once, the generic rounds acc to bfloat16 and
# adds the float32 bias after: a node's result differs by at most one
# bfloat16 unit (2^-7 of its magnitude, the kernel check's
# cuda_matmul.kernel_tolerance); over 12 layers the last hidden state
# differs from helper_mode="generic"'s by a relative error (norm-wise)
# below 2^-5, and from onnx_bert's float32 forward by less than the int8
# gross-fault bound
AUTOCAST_GENERIC_REL_ERR = 2.0 ** -5
AUTOCAST_GROSS_REL_ERR = INT8_GROSS_REL_ERR
AUTOCAST_TIMED = 5
# keras_bert: the imported Keras encoder's forward at the tf_bert shape,
# against helper_mode="generic" within this many times the generic
# forward's own change when every weight moves by one unit in the last
# place (at least one unit in the last place of the largest value); the
# Sequential Conv1D classifier (no kernel on its path) against
# its generic run and the port's CPU import
KERAS_BERT_BATCH = 32
KERAS_BERT_SEQ = 128
KERAS_BERT_YARDSTICK = 3.0
KERAS_BERT_TIMED = 5
KERAS_SEQ_CFG = dict(vocab=1000, seq=128, width=32, filters=16, kernel=5,
                     pool=2, classes=4)
KERAS_SEQ_TOL = 1e-5
# keras_bert_transfer: the fine-tune of the imported encoder
KT_CLASSES = 9
KT_FREEZE = "layer_7_output_norm"   # the embeddings and blocks 0-7 frozen
KT_TRAIN = 4                        # training batches an epoch
KT_HELD_OUT = 2                     # held-out batches
KT_EPOCHS = 3
LAYERS_STEPS = 3                    # nn_layer_types: fit steps a network
# sd_bert_finetune: Adam lr and steps (BERT fine-tune practice: 2e-5…5e-5)
FINETUNE_LR = 5e-5
FINETUNE_STEPS = 3
IMAGE = (224, 224, 3)
CLASSES = 1000
TRAIN_STEPS = 3
# train phase A: the updater kernel is bit-exact and cuDNN is run
# deterministic, so the kernel run should equal the generic run; the
# bound leaves room for summation-order noise only
TRAIN_A_LOSS_RTOL = 1e-5
TRAIN_A_PARAM_SHARE = 1e-5   # of the largest parameter move in 3 steps
# train phase B (mixed): the kernel's z differs from the plain version's
# by bf16 roundings, which 50 layers of batch statistics amplify. Step 1
# runs both at the same parameters: its loss may move by one bf16 unit.
# After that the parameters differ, and the lr-0.1 run diverges (its loss
# rises), so the later losses are not bounded by a single yardstick run;
# the parameters after 3 steps (a max over 25.6M values) are held to 3×
# the generic run's own distance when its input moves by one bf16 unit.
TRAIN_B_LOSS1_RTOL = 2.0 ** -8
TRAIN_B_YARDSTICK = 3.0


# parallel_moe: google/switch-base-8's sparse FFN widths (Fedus et al.,
# Switch Transformers: d_model 768, d_ff 3072, 8 experts, top-1,
# capacity factor 1.25) in a Dense -> MoE -> softmax network, 8 sequences
# of 512 tokens a step (4096 rows), trained through ParallelWrapper at
# world 1; ring and Ulysses attention at BERT-base heads, T 2048
MOE_WIDTH = dict(d_model=768, d_ff=3072, experts=8, top_k=1,
                 capacity_factor=1.25)
MOE_TOKENS = (8, 512)
MOE_CLASSES = 10
MOE_STEPS = 8
SP_ATTN_SHAPE = dict(batch=2, heads=12, t=2048, d=64)
SP_ATTN_TOL = 1e-4      # float32 online softmax against the plain one
# parallel_inference: the zoo ResNet-50 served by ParallelInference, 4
# client threads sending 64 requests of 1-8 images
PI_MAX_BATCH = 32
PI_WINDOW_MS = 3.0
PI_CLIENTS = 4
PI_REQUESTS = 64
PI_IMAGES = (1, 8)
PI_YARDSTICK = 3.0
PI_CALIBRATION = 64     # train-mode forwards setting the BN statistics


# the sequential phases' widths and data: testing/sequential.py
LENET_PARAMS = 431080   # 520 + 25,050 + 400,500 + 5,010
# cuDNN's LSTM against the generic recurrence (float32, TF32 off): each
# loss 1e-5 relative or 3x a generic run from parameters one ulp away,
# the parameter moves 1e-3 relative L2 or 3x that run's (a few elements
# in Adam's / RmsProp's epsilon region move by a share of lr on a
# rounding of their gradient)
RNN_LOSS_RTOL = 1e-5
RNN_MOVE_RTOL = 1e-3
RNN_YARDSTICK = 3.0
LSTM_OUT_TOL = 1e-5     # probabilities, every position
STATE_TOL = 1e-5        # carried h and c, absolute + relative: c is
                        # unbounded (tens of units in a loss spike)
STREAM_TOL = 1e-4       # rnn_time_step vs output, BASELINE.md's gate
# zoo_cnn: each model against the generic run as train phase A holds
# ResNet-50 (TRAIN_A_*); the card's output against the port's CPU output
# of the same parameters (float32 both, TF32 off; cuDNN and the CPU's
# library sum in other orders)
ZOO_CPU_RTOL = 1e-3
ZOO_CPU_ATOL = 1e-5
ZOO_STEPS = 3
ZOO_CPU_IMAGES = 2
ZOO_CPU_TOL_TEXT = (f"{ZOO_CPU_ATOL:g} x max(1, max |cpu|) + {ZOO_CPU_RTOL:g}"
                    f" x |cpu|, elementwise, {ZOO_CPU_IMAGES} images")
# supervised_train: AlexNet at its zoo_cnn batch, 2 epochs of 4 batches
SUP_BATCH = 128
SUP_BATCHES = 4
SUP_EPOCHS = 2
SUP_DATA_SEED = 600
SUP_SHUFFLE_SEED = 17
SUP_OTHER_SEED = 321    # the relaunch's network: the restore overwrites it
# graph_tbptt: characters streamed through rnn_time_step
GRAPH_STREAM_CHARS = 200
# serve_supervised: after_n of decode_step_error (decode steps) and
# worker_death (serving-loop iterations with work)
SERVE_CRASH_AT = (5, 30)
# serve_prefix: four 96-token system prompts pre-warmed and pinned, then
# 16 requests (four a prompt) with 8-32-token tails, closed loop, each
# 16 greedy tokens; the engine's prompt bucket 128, 64 tree pages, the
# suffix bucket 32
PREFIX_KW = dict(max_slots=8, page_size=16, max_pages_per_seq=16,
                 max_prompt=128, seed=0)
PREFIX_CACHE_KW = dict(prefix_pages=64, suffix_bucket=32)
PREFIX_SYSTEM = (4, 96)       # system prompts, tokens each
PREFIX_REQUESTS = 16
PREFIX_TAILS = (8, 32)        # tail tokens, inclusive
PREFIX_NEW_TOKENS = 16
# serve_spec: the serve phase's engine and requests with spec_k 4, once
# with each perturbed_draft of the target: noise of 1e-2 (the random
# GPT-2-small's weights are N(0, 0.072): its greedy argmax then agrees
# with the target's at none of the 372 positions the serve streams feed
# it) and of 3e-3 (at 124: every position of four requests, none of the
# other eight), so that accepts and rejections both run on the card
SPEC_K = 4
SPEC_DRAFT_SCALES = (1e-2, 3e-3)
SPEC_CHECK_CALL = 8           # the propose call held against generic
# serve_cluster: engine_death after this many loop iterations of engine
# 0; the batch class's token bucket admits this many of its arrivals
CLUSTER_DEATH_AT = 3
CLUSTER_BATCH = (4, 2)        # batch arrivals, bucket size


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the registry's dispatch
    decisions since the last ``observe.reset()``
    (``observe.dispatch_summary()``)."""
    if "phase" in obj and "dispatch_summary" not in obj:
        from deeplearning4j_tpu_torch import observe

        obj = dict(obj, dispatch_summary=observe.dispatch_summary())
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, the graph replayed ``replays`` times between two CUDA
    events, the mean per call. A replay issues the captured launches with
    no Python, argument checks or allocation between them, so the time is
    the kernels' own (and the gaps between them inside the graph), not the
    host's rate of issuing calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def compare(out, ref, dtype: str):
    """(max abs error, worst error as a share of its tolerance) of a
    kernel's output against its plain version's."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    lim = ATOL[dtype] + RTOL[dtype] * ref.abs()
    return err.max().item(), (err / lim).max().item()


def tol_text(dtype: str, design: str = "simt", term: str = "|P~|.|V|",
             atol: float = None, rtol: float = None) -> str:
    atol = ATOL[dtype] if atol is None else atol
    rtol = RTOL[dtype] if rtol is None else rtol
    text = f"{atol:g}" if rtol == 0.0 else f"{atol:g} + {rtol:g}*|plain|"
    if design == "sm90":
        text += f" + 2^-7*({term})"  # the rounding of P or dS to bfloat16
    return text


def flash_check_forward(out, ref, args, kw, dtype, design):
    """(max abs error, share of the bound, {fault: share}) of a flash
    forward against its plain version. The sm90 design rounds P̃ to the
    input dtype before P̃·V, as the TPU kernel does, so its bound adds
    2^-7·(|P̃|·|V|) (``testing/flash_check.py``); the sm90_f32 design is
    held to the float32 bound itself. Each faulted plain variant (rounded
    as the kernel rounds; for sm90_f32 also one TF32 pass,
    ``testing/split_f32.py``) must exceed that bound, which shows the bound
    still catches such faults. Faults that cannot show (the keep mask at
    dropout 0, the last key tile dropped where the mask hides every key
    of it) are left out."""
    from deeplearning4j_tpu_torch.testing import flash_check as fc
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    name = str(dtype).replace("torch.", "")
    unit = fc.rounding_unit(dtype, design)
    slack = fc.forward_slack(*args, unit=unit, **kw)
    err, share = fc.excess(out, ref, slack, ATOL[name], RTOL[name])
    faults = {}
    if design in ("sm90", "sm90_f32"):
        for fault in (fc.FAULTS if design == "sm90" else FLASH_F32_FAULTS):
            if fault == "keep_shifted" and not kw["dropout_rate"]:
                continue
            mask = args[3]
            if (fault == "last_tile_dropped" and mask is not None
                    and not bool((mask[:, -fc.FORWARD_TILE:] > 0.5).any())):
                continue
            if fault == "single_pass_tf32":
                bad, _ = sf.flash_forward_split(*args, passes="single", **kw)
            else:
                bad, _ = fc.forward_variant(
                    *args, round_to=dtype if design == "sm90" else None,
                    fault=fault, **kw)
            faults[fault] = fc.excess(bad, ref, slack, ATOL[name],
                                      RTOL[name])[1]
    return err, share, faults


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def design_bound(nbytes: float, flops: float, name: str, design: str):
    """``bound`` of a flash or matmul entry: the sm90_f32 designs' at the
    split's rate (three TF32 passes), the others' at their dtype's."""
    return bound(nbytes, flops, "tf32_split" if design == "sm90_f32"
                 else name)


def flash_case(dtype, dev, d=FLASH_SHAPE["d"]):
    """Flash prefill at the slice's shape: causal, end-padded key mask."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import cuda_attention as ca

    bh, t = FLASH_SHAPE["bh"], FLASH_SHAPE["t"]
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, d),
                                                    dtype=np.float32))
               .to(dev, dtype) for _ in range(3))
    lens = np.array([512, 300, 1, 17, 64, 65, 128, 200, 511, 256, 400, 33])
    mask_np = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    mask = torch.from_numpy(mask_np).to(dev)
    out, lse = ca.flash_attention(q, k, v, mask, causal=True)
    again, _ = ca.flash_attention(q, k, v, mask, causal=True)
    ref_out, ref_lse = ca.flash_attention_reference(q, k, v, mask,
                                                    causal=True)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    design = ca.flash_design(dtype, d, "fwd")
    fwd_kw = dict(scale=1.0 / math.sqrt(d), causal=True, dropout_rate=0.0)
    err, share, faults = flash_check_forward(
        out, ref_out, (q, k, v, mask, None), fwd_kw, dtype, design)
    err_lse = (lse - ref_lse).abs().max().item()
    same_bits = torch.equal(out, again)
    ok = (share <= 1.0 and err_lse <= TOL_LSE and same_bits
          and bool(torch.isfinite(out.float()).all())
          and all(f > 1.0 for f in faults.values()))
    # SDPA yardstick with the same (causal & key) mask, timed only
    allowed = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    sdpa_mask = (allowed[None] & (mask[:, None, :] > 0.5))[None]
    q4, k4, v4 = q[None], k[None], v[None]
    ms = time_ms(lambda: ca.flash_attention(q, k, v, mask, causal=True))
    plain_ms = time_ms(lambda: ca.flash_attention_reference(
        q, k, v, mask, causal=True))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=sdpa_mask))
    es = q.element_size()
    nbytes = 4 * bh * t * d * es + bh * t * 4 + bh * t * 4
    # (query, key) pairs this data needs: key j is visible to rows j..t-1
    pairs = float((mask_np * (t - np.arange(t))[None, :]).sum())
    bms, by = design_bound(nbytes, 4.0 * d * pairs, name, design)
    return ok, {"kernel": FLASH_FWD_KERNEL[design], "design": design,
                "dtype": name, "shape": [bh, t, d], "max_abs_err": err,
                "tol": tol_text(name, design), "err_over_tol": share,
                "faulted_plain_over_tol": faults, "same_bits_twice": same_bits,
                "lse_max_abs_err": err_lse, "lse_tol": TOL_LSE, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "bound_by": by}


def flash_draft_case(dev, kv=None, lens=None, seed=4):
    """Flash forward at the speculative draft step's shape: one query a
    slot against the whole dense draft cache, ``(S, 1, 1, T)`` key mask
    (S·H = 96 rows, t_q 1, t_k ``DRAFT_FLASH["t"]``), float32. ``kv`` is a
    layer of the draft cache, ``(2, S, T + 1, H, Dh)`` (the trash position
    last), and ``lens`` each slot's visible keys; by default random K/V in
    that layout and ``DRAFT_FLASH["lens"]``. The kernel is held against
    its plain version with the faulted variants, as in ``flash_case``, on
    the folded inputs ``flash_dpa`` hands it; ``path_ms`` times the
    registry's ``dot_product_attention`` on the cache's views as the draft
    step calls it (``flash_dpa``'s layout copies of K and V included),
    ``ms`` the kernel alone on the folded inputs."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import exec_op

    s_n, h, t, d = (DRAFT_FLASH[k] for k in ("slots", "heads", "t", "d"))
    rng = np.random.default_rng(seed)
    if kv is None:
        kv = torch.from_numpy(rng.standard_normal(
            (2, s_n, t + 1, h, d), dtype=np.float32)).to(dev)
        lens = DRAFT_FLASH["lens"]
    lens_np = np.asarray(lens, np.int64)
    q4 = torch.from_numpy(rng.standard_normal(
        (s_n, h, 1, d), dtype=np.float32)).to(dev)
    k4 = kv[0, :, :t].permute(0, 2, 1, 3)        # (S, H, T, Dh) views
    v4 = kv[1, :, :t].permute(0, 2, 1, 3)
    mask4 = (torch.arange(t, device=dev)[None, :] < torch.from_numpy(
        lens_np).to(dev)[:, None])[:, None, None, :]
    bh = s_n * h
    q, k, v = (x.reshape(bh, x.shape[2], d).contiguous()
               for x in (q4, k4, v4))
    mask = mask4.reshape(s_n, t).to(torch.float32).repeat_interleave(h, 0)
    out, lse = ca.flash_attention(q, k, v, mask)
    again, _ = ca.flash_attention(q, k, v, mask)
    ref_out, ref_lse = ca.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    design = ca.flash_design(torch.float32, d, "fwd")
    fwd_kw = dict(scale=1.0 / math.sqrt(d), causal=False, dropout_rate=0.0)
    err, share, faults = flash_check_forward(
        out, ref_out, (q, k, v, mask, None), fwd_kw, torch.float32, design)
    err_lse = (lse - ref_lse).abs().max().item()
    same_bits = torch.equal(out, again)
    ok = (share <= 1.0 and err_lse <= TOL_LSE and same_bits
          and bool(torch.isfinite(out).all())
          and all(f > 1.0 for f in faults.values()))
    ms = time_ms(lambda: ca.flash_attention(q, k, v, mask))
    path_ms = time_ms(lambda: exec_op("dot_product_attention", q4, k4, v4,
                                      mask4, scaled=True))
    plain_ms = time_ms(lambda: ca.flash_attention_reference(q, k, v, mask))
    kc, vc = k.view(s_n, h, t, d), v.view(s_n, h, t, d)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask4))
    # the keys this data makes visible, each read once (K and V), each
    # query and output row once, the folded mask and lse
    pairs = float(h * lens_np.sum())
    nbytes = 4 * (2 * bh * d + 2 * pairs * d + bh * t + bh)
    bms, by = design_bound(nbytes, 4.0 * d * pairs, "float32", design)
    return ok, {"kernel": FLASH_FWD_KERNEL[design], "design": design,
                "dtype": "float32", "shape": [bh, 1, t, d],
                "context": "draft decode step, (S,1,1,T) key mask",
                "key_lens": lens_np.tolist(), "max_abs_err": err,
                "tol": tol_text("float32", design), "err_over_tol": share,
                "faulted_plain_over_tol": faults, "same_bits_twice": same_bits,
                "lse_max_abs_err": err_lse, "lse_tol": TOL_LSE, "ms": ms,
                "path_ms": path_ms, "layout_copies_ms": path_ms - ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "bound_by": by}


def paged_case(dtype, dev):
    """Paged decode at the slice's shape, shuffled page table: seq_lens of
    1, page boundaries and full context in one batch ("mixed", the serve
    phase's kind of batch), and every slot at full context ("full": the
    bandwidth the short slots hide). The split-KV transcription's faulted
    variants (a split dropped, the combine without its rescale,
    ``testing/paged_check.py``) must exceed the tolerance."""
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.testing import paged_check as pc

    s_n, h, d = PAGED_SHAPE["slots"], PAGED_SHAPE["heads"], PAGED_SHAPE["d"]
    page, max_pages = PAGED_SHAPE["page"], PAGED_SHAPE["max_pages"]
    n_pages = s_n * max_pages
    name = str(dtype).replace("torch.", "")
    entries, ok = [], True
    for context, lens in (("mixed", [1, 16, 17, 32, 100, 513, 1000, 1024]),
                          ("full", [max_pages * page] * s_n)):
        rng = np.random.default_rng(2)
        q = torch.from_numpy(rng.standard_normal(
            (s_n, h, d), dtype=np.float32)).to(dev, dtype)
        # one (2, P+1, page, H, D) buffer, k/v as its views — as in the cache
        kv = torch.from_numpy(rng.standard_normal(
            (2, n_pages + 1, page, h, d), dtype=np.float32)).to(dev, dtype)
        pt = torch.from_numpy(rng.permutation(n_pages).reshape(
            s_n, max_pages).astype(np.int32)).to(dev)
        lens_np = np.array(lens, np.int32)
        sl = torch.from_numpy(lens_np).to(dev)
        before = ca.paged_decode_attention.launches
        out = ca.paged_decode_attention(q, kv[0], kv[1], pt, sl)
        launches = ca.paged_decode_attention.launches - before
        again = ca.paged_decode_attention(q, kv[0], kv[1], pt, sl)
        ref = ca.paged_decode_attention_reference(q, kv[0], kv[1], pt, sl)
        torch.cuda.synchronize()
        err, share = compare(out, ref, name)
        plan = ca.paged_plan(s_n, h, d, page, max_pages, q.element_size(),
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)
        faults = {f: compare(pc.paged_decode_split(
            q, kv[0], kv[1], pt, sl, plan=plan, fault=f), ref, name)[1]
            for f in pc.FAULTS}
        same = torch.equal(out, again)
        ok = (ok and share <= 1.0 and same and launches == 1
              and bool(torch.isfinite(out.float()).all())
              and all(v > 1.0 for v in faults.values()))
        ms = time_ms(lambda: ca.paged_decode_attention(q, kv[0], kv[1], pt,
                                                       sl))
        plain_ms = time_ms(lambda: ca.paged_decode_attention_reference(
            q, kv[0], kv[1], pt, sl))
        es = q.element_size()
        tokens = float(lens_np.sum())
        nbytes = (tokens * 2 * h * d * es + 2 * s_n * h * d * es
                  + s_n * max_pages * 4 + s_n * 4)
        bms, by = bound(nbytes, 4.0 * h * d * tokens, name)
        entries.append({
            "kernel": "paged_decode", "dtype": name, "context": context,
            "seq_lens": lens, "shape": [s_n, h, d, page, max_pages],
            "plan": dataclasses.asdict(plan), "launches_per_call": launches,
            "max_abs_err": err, "tol": tol_text(name), "err_over_tol": share,
            "faulted_plain_over_tol": faults, "same_bits_twice": same,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "library_note": "none: no single PyTorch call gathers pages "
                            "through a page table and attends",
            "bound_ms": bms, "bound_by": by})
    return ok, entries


def _attn_inputs(shape, dtype, dev, seed):
    """q, k, v, dO (BH, T, D) and the key mask of a BERT attention shape
    (ragged rows of min_len…T for A, None for B's full rows)."""
    import torch

    bh, t, d = shape["batch"] * shape["heads"], shape["t"], shape["d"]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (bh, t, d), dtype=np.float32)).to(dev, dtype) for _ in range(4))
    mask_np = None
    if shape["min_len"] is not None:
        lens = rng.integers(shape["min_len"], t + 1, shape["batch"])
        rows = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        mask_np = np.repeat(rows, shape["heads"], axis=0)  # batch-major
    mask = None if mask_np is None else torch.from_numpy(mask_np).to(dev)
    pairs = float(bh * t * t if mask_np is None else t * mask_np.sum())
    return q, k, v, do, mask, mask_np, pairs


def _sdpa_args(q, k, v, mask, heads):
    """(B, H, T, D) views and the broadcast boolean key mask for SDPA."""
    bh, t, d = q.shape
    four = [x.reshape(bh // heads, heads, t, d) for x in (q, k, v)]
    m4 = None if mask is None else (mask.reshape(bh // heads, heads, t)[
        :, :1, None, :] > 0.5)
    return four, m4


def flash_bert_case(dtype, dev, label, rate):
    """Flash forward at a BERT shape, not causal, with in-kernel dropout
    ``rate`` (0.1 for training; 0 for the imported forward of
    ``onnx_bert``, which builds the kernel without dropout), against its
    plain version with the same seed (same keep mask)."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import cuda_attention as ca

    shape = BERT_ATTN_SHAPES[label]
    q, k, v, _, mask, _, pairs = _attn_inputs(shape, dtype, dev, 11)
    seed = (torch.tensor([20260917], dtype=torch.int32, device=dev)
            if rate else None)
    kw = dict(dropout_rate=rate)
    out, lse = ca.flash_attention(q, k, v, mask, seed, **kw)
    again, _ = ca.flash_attention(q, k, v, mask, seed, **kw)
    ref_out, ref_lse = ca.flash_attention_reference(q, k, v, mask, seed,
                                                    **kw)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    bh, t, d = q.shape
    design = ca.flash_design(dtype, d, "fwd")
    err, share, faults = flash_check_forward(
        out, ref_out, (q, k, v, mask, seed),
        dict(scale=1.0 / math.sqrt(d), causal=False, **kw), dtype, design)
    err_lse = (lse - ref_lse).abs().max().item()
    same_bits = torch.equal(out, again)
    keep_equal = None
    if rate:
        # the dropped entries read out: with V the identity on its first
        # D columns, out[i, j] != 0 exactly where key j < D is kept
        eye = torch.eye(t, d, device=dev, dtype=dtype).expand(
            bh, t, d).contiguous()
        o_eye, _ = ca.flash_attention(q, k, eye, mask, seed, **kw)
        visible = torch.ones((bh, t, d), dtype=torch.bool, device=dev)
        if mask is not None:
            visible = visible & (mask[:, None, :d] > 0.5)
        keep = ca._tile_keep(seed, bh, t, d, rate, dev)
        keep_equal = torch.equal(o_eye != 0, keep & visible)
    ok = (share <= 1.0 and err_lse <= TOL_LSE and same_bits
          and keep_equal is not False
          and bool(torch.isfinite(out.float()).all())
          and all(f > 1.0 for f in faults.values()))
    (q4, k4, v4), m4 = _sdpa_args(q, k, v, mask, shape["heads"])
    ms = time_ms(lambda: ca.flash_attention(q, k, v, mask, seed, **kw))
    plain_ms = time_ms(lambda: ca.flash_attention_reference(
        q, k, v, mask, seed, **kw))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4, dropout_p=rate))
    es = q.element_size()
    nbytes = 4 * bh * t * d * es + bh * t * 4 + (0 if mask is None
                                                 else bh * t * 4)
    bms, by = design_bound(nbytes, 4.0 * d * pairs, name, design)
    return ok, {"kernel": FLASH_FWD_KERNEL[design], "design": design,
                "dtype": name, "bert": label,
                "shape": [bh, t, d], "masked": mask is not None,
                "dropout": rate, "max_abs_err": err,
                "tol": tol_text(name, design), "err_over_tol": share,
                "faulted_plain_over_tol": faults, "same_bits_twice": same_bits,
                "keep_mask_equal": keep_equal,
                "lse_max_abs_err": err_lse, "lse_tol": TOL_LSE, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_note": f"SDPA forward with dropout_p {rate:g}"
                                + (" (its own RNG)" if rate else "")
                                + ", timed only",
                "bound_ms": bms, "bound_by": by}


def sdpa_backward_ms(q4, k4, v4, m4, do4, causal: bool = False) -> float:
    """SDPA's backward alone, no dropout: the device time of forward plus
    backward minus that of the forward, each captured in a CUDA graph by
    :func:`time_ms` (autograd's backward runs on the capture stream, as
    in whole-network capture)."""
    import torch
    import torch.nn.functional as F

    xs = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]

    def fwd():
        return F.scaled_dot_product_attention(*xs, attn_mask=m4,
                                              is_causal=causal)

    def fwd_bwd():
        torch.autograd.grad(fwd(), xs, do4)

    return time_ms(fwd_bwd) - time_ms(fwd)


def _bwd_faults(args, kw, dtype, design, dq_name, dkv_name):
    """The faulted plain variants of a tensor-core backward design: for
    sm90 ``testing/flash_check.py``'s, rounded as the kernels round; for
    sm90_f32 one TF32 pass (``testing/split_f32.py``) and the tile faults
    at its 32-wide tiles. {kernel: {fault: (dq,) or (dk, dv)}}."""
    from deeplearning4j_tpu_torch.testing import flash_check as fc
    from deeplearning4j_tpu_torch.testing import split_f32 as sf

    out = {dq_name: {}, dkv_name: {}}
    if design == "sm90":
        for fault in fc.DQ_FAULTS:
            out[dq_name][fault] = (fc.dq_variant(*args, round_to=dtype,
                                                 fault=fault, **kw),)
        for fault in fc.DKV_FAULTS:
            out[dkv_name][fault] = fc.dkv_variant(*args, round_to=dtype,
                                                  fault=fault, **kw)
    elif design == "sm90_f32":
        for fault in FLASH_BWD_F32_FAULTS:
            if fault == "single_pass_tf32":
                out[dq_name][fault] = (sf.flash_dq_split(
                    *args, passes="single", **kw),)
                out[dkv_name][fault] = sf.flash_dkv_split(
                    *args, passes="single", **kw)
                continue
            tile = dict(fault=fault, tile=sf.FLASH_BWD_TILE)
            out[dq_name][fault] = (fc.dq_variant(*args, **tile, **kw),)
            out[dkv_name][fault] = fc.dkv_variant(*args, **tile, **kw)
    return out


def flash_backward_case(dtype, dev, label, d=None):
    """dq and dk/dv kernels at a BERT shape (``label`` "A" or "B") or the
    causal shape (``"causal"``: :data:`BWD_CAUSAL_SHAPE`) with dropout 0.1,
    against their plain versions (same seed, lse and Δ); ``d`` overrides
    the head dim. Returns two entries."""
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.testing import flash_check as fc

    causal = label == "causal"
    shape = dict(BWD_CAUSAL_SHAPE if causal else BERT_ATTN_SHAPES[label])
    if d is not None:
        shape["d"] = d
    q, k, v, do, mask, _, pairs = _attn_inputs(shape, dtype, dev, 12)
    seed = torch.tensor([-5], dtype=torch.int32, device=dev)
    bh, t, d = q.shape
    if causal:  # (query, key) pairs on or below the diagonal
        pairs = float(bh * t * (t + 1) // 2)
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal,
              dropout_rate=ATTN_DROPOUT)
    out, lse = ca.flash_attention_reference(q, k, v, mask, seed, **kw)
    delta = ca.attention_delta(do, out)
    args = (q, k, v, mask, seed, do, lse, delta)
    name = str(dtype).replace("torch.", "")
    design = ca.flash_design(dtype, d, "dq")
    dq_name, dkv_name = FLASH_DQ_KERNEL[design], FLASH_DKV_KERNEL[design]
    got = {dq_name: (ca.flash_attention_dq(*args, **kw),),
           dkv_name: ca.flash_attention_dkv(*args, **kw)}
    again = {dq_name: (ca.flash_attention_dq(*args, **kw),),
             dkv_name: ca.flash_attention_dkv(*args, **kw)}
    ref = {dq_name: (ca.flash_attention_dq_reference(*args, **kw),),
           dkv_name: ca.flash_attention_dkv_reference(*args, **kw)}
    torch.cuda.synchronize()
    same_bits = {n: all(torch.equal(a, b) for a, b in zip(got[n], again[n]))
                 for n in got}
    # the sm90 kernels round dS and P̃ to bfloat16 (as the TPU kernels do):
    # the bound adds 2^-7·scale·(|dS|·|K|) to dq (dS unscaled), and
    # 2^-7·scale·(|dSᵀ|·|Q|) to dk and 2^-7·(|P̃ᵀ|·|dO|) to dv; the sm90_f32
    # kernels are held to the float32 bound itself. Each faulted plain
    # variant must exceed the bound.
    unit = fc.rounding_unit(dtype, design)
    slack = {dq_name: (fc.dq_slack(*args, unit=unit, **kw),),
             dkv_name: fc.dkv_slack(*args, unit=unit, **kw)}
    faults = {n: {f: max(fc.excess(b, r, sl, BWD_ATOL, BWD_RTOL[name])[1]
                         for b, r, sl in zip(bad, ref[n], slack[n]))
                  for f, bad in fs.items()}
              for n, fs in _bwd_faults(args, kw, dtype, design, dq_name,
                                       dkv_name).items()}
    (q4, k4, v4), m4 = _sdpa_args(q, k, v, mask, shape["heads"])
    lib_ms = sdpa_backward_ms(q4, k4, v4, m4, do.reshape(q4.shape), causal)
    es = q.element_size()
    side = 2 * bh * t * 4 + (0 if mask is None else bh * t * 4)
    timed = {dq_name: (ca.flash_attention_dq,
                       ca.flash_attention_dq_reference, 5, 6.0,
                       "dq: scale*|dS|.|K|"),
             dkv_name: (ca.flash_attention_dkv,
                        ca.flash_attention_dkv_reference, 6, 8.0,
                        "dk: scale*|dS^T|.|Q|, dv: |P~^T|.|dO|")}
    ok = all(f > 1.0 for fs in faults.values() for f in fs.values())
    entries = []
    for kernel, (fn, plain, tensors, ops_per_pair, term) in timed.items():
        errs, shares = [], []
        for g, r, sl in zip(got[kernel], ref[kernel], slack[kernel]):
            e, share = fc.excess(g, r, sl, BWD_ATOL, BWD_RTOL[name])
            errs.append(e)
            shares.append(share)
            ok = ok and bool(torch.isfinite(g.float()).all())
        ok = ok and max(shares) <= 1.0
        nbytes = tensors * bh * t * d * es + side
        bms, by = design_bound(nbytes, ops_per_pair * d * pairs, name, design)
        tensor_cores = design in ("sm90", "sm90_f32")
        ok = ok and same_bits[kernel]
        entries.append({
            "kernel": kernel, "design": design,
            "dtype": name, "bert": label,
            "shape": [bh, t, d], "masked": mask is not None,
            "causal": causal, "dropout": ATTN_DROPOUT,
            "max_abs_err": max(errs),
            "tol": tol_text(name, design, term, BWD_ATOL, BWD_RTOL[name]),
            "err_over_tol": max(shares),
            **({"faulted_plain_over_tol": faults[kernel],
                "same_bits_twice": same_bits[kernel]} if tensor_cores
               else {}),
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: plain(*args, **kw)),
            "library_ms": lib_ms,
            "library_note": "SDPA backward (dq, dk and dv together), no "
                            "dropout: its RNG differs",
            "bound_ms": bms, "bound_by": by})
    return ok, entries


def updater_case(dtype, dev):
    """Nesterovs (ResNet-50's updater) on the largest leaf and a conv leaf;
    the kernel must equal the plain version bit for bit. The learning rate
    and step live on the card, as a trainer's do; the kernel reads the
    coefficient buffer ``Updater.coefficients`` made from them (made once
    here, outside the timed calls)."""
    import torch

    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    upd = Nesterovs(learning_rate=0.1, momentum=0.9)
    name = str(dtype).replace("torch.", "")
    it = torch.zeros((), dtype=torch.int32, device=dev)
    lr = upd.lr(it)
    coef = upd.coefficients(lr, it)
    out = {}
    for leaf, shape in UPDATER_SHAPES.items():
        rng = np.random.default_rng(4)
        p, g, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype) for _ in range(3))
        hyper = upd.fused_hyper()
        got = cu.fused_updater(p, g, lr, it, v, kind="Nesterovs", coef=coef,
                               **hyper)
        ref = cu.fused_updater_step.fn(p, g, lr, it, v, kind="Nesterovs",
                                       **hyper)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = time_ms(lambda: cu.fused_updater(p, g, lr, it, v,
                                              kind="Nesterovs", coef=coef,
                                              **hyper))
        plain_ms = time_ms(lambda: cu.fused_updater_step.fn(
            p, g, lr, it, v, kind="Nesterovs", **hyper))
        n = p.numel()
        # p, g, v read once; p, v written once
        bms, by = bound(5.0 * n * p.element_size(), 10.0 * n, "float32")
        out[leaf] = {"kernel": "fused_updater", "dtype": name,
                     "leaf": leaf, "shape": list(shape), "max_abs_err": err,
                     "tol": "0 (bit-exact)", "exact": exact, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bms, "bound_by": by}
        out[leaf].update(fused_sgd_ms(p, g, v, float(lr)))
        if leaf == "fc.W":
            out[leaf].update(adam_ms(p, g))
    ok = all(e["exact"] for e in out.values())
    return ok, list(out.values())


def updater_count_problems(launches, leaves, n_leaves, steps):
    """The updater counts of a training run: every leaf updated once a
    step (``fused_updater.leaves``), in one multi-tensor launch a step for
    each table of at most ``TABLE_LEAVES`` leaves (one updater, one dtype:
    one group)."""
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    problems = []
    if leaves != n_leaves * steps:
        problems.append(f"fused_updater leaves {leaves} != {n_leaves} "
                        f"leaves x {steps} steps")
    groups = -(-n_leaves // cu.TABLE_LEAVES)
    if launches != groups * steps:
        problems.append(f"fused_updater launches {launches} != {groups} "
                        f"launch(es) x {steps} steps")
    return problems


def _model_leaf_shapes(model: str, dev):
    """The parameter leaves' shapes of ResNet-50 (161) or BERT-base (206),
    from the models' own init (random weights; none downloaded)."""
    import torch

    if model == "resnet50":
        from deeplearning4j_tpu_torch.models import ResNet50

        net = ResNet50(num_classes=CLASSES, input_shape=IMAGE,
                       device=dev).init()
        shapes = [tuple(net.params[n][k].shape) for n in net.params
                  for k in sorted(net.params[n])]
    else:
        from deeplearning4j_tpu_torch.models._tree import leaf_paths
        from deeplearning4j_tpu_torch.models.bert import (BertConfig,
                                                          BertModel)

        net = BertModel(BertConfig.base(), device=dev)
        shapes = [tuple(t.shape) for _, t in leaf_paths(net.params)]
    del net
    torch.cuda.empty_cache()
    return shapes


def updater_tree_case(dtype, dev):
    """The fused updater over a whole model's leaves in one multi-tensor
    launch: ResNet-50's 161 leaves with Nesterovs (train A and B's
    updater) and BERT-base's 206 with Adam (bert_train's), against
    PyTorch's multi-tensor ``torch._fused_sgd_`` (Nesterov) and
    ``torch._fused_adam_`` over the same lists (timed only). Every leaf
    must equal the plain version bit for bit."""
    import torch

    from deeplearning4j_tpu_torch.nn.updater import Adam, Nesterovs
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    name = str(dtype).replace("torch.", "")
    entries, ok = [], True
    for model, upd in (("resnet50", Nesterovs(learning_rate=0.1,
                                              momentum=0.9)),
                       ("bert_base", Adam(learning_rate=2e-5))):
        shapes = _model_leaf_shapes(model, dev)
        gen = torch.Generator(device=dev).manual_seed(4)

        def draw(shape, scale=1.0, positive=False):
            t = torch.randn(shape, generator=gen, device=dev) * scale
            return (t.abs() if positive else t).to(dtype)

        kind = type(upd).__name__
        ns = len(upd.init_state(torch.zeros(1)))
        ps = [draw(s) for s in shapes]
        gs = [draw(s, 0.1) for s in shapes]
        ss = [tuple(draw(s, 0.1, True) for _ in range(ns)) for s in shapes]
        # the trainer's step and learning rate on the card
        step = torch.ones((), dtype=torch.int32, device=dev)
        lr, hyper = upd.lr(step), upd.fused_hyper()
        coef = upd.coefficients(lr, step)
        lr_f = float(lr)  # the library calls take a host float
        before = cu.fused_updater.launches
        outs = cu.fused_updater_multi(ps, gs, ss, lr, step, kind=kind,
                                      coef=coef, **hyper)
        torch.cuda.synchronize()
        launches = cu.fused_updater.launches - before
        exact, err = True, 0.0
        for p, g, s, out in zip(ps, gs, ss, outs):
            ref = cu.fused_updater_step.fn(p, g, lr, step, *s, kind=kind,
                                           **hyper)
            exact = exact and all(torch.equal(a, b) for a, b in zip(out,
                                                                    ref))
            err = max(err, max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(out, ref)))
        del outs
        ms = time_ms(lambda: cu.fused_updater_multi(
            ps, gs, ss, lr, step, kind=kind, coef=coef, **hyper), iters=5,
            replays=3)
        plain_ms = time_ms(lambda: [cu.fused_updater_step.fn(
            p, g, lr, step, *s, kind=kind, **hyper)
            for p, g, s in zip(ps, gs, ss)], iters=2, replays=2)
        if kind == "Nesterovs":
            vl = [s[0].clone() for s in ss]
            lib_ms = time_ms(lambda: torch._fused_sgd_(
                ps, gs, vl, weight_decay=0.0, momentum=0.9, lr=lr_f,
                dampening=0.0, nesterov=True, maximize=False,
                is_first_step=False), iters=5, replays=3)
            lib = "torch._fused_sgd_ (Nesterov momentum) over the same lists"
        else:
            ml = [s[0].clone() for s in ss]
            vl = [s[1].clone() for s in ss]
            steps = [torch.ones((), device=dev) for _ in ss]
            lib_ms = time_ms(lambda: torch._fused_adam_(
                ps, gs, ml, vl, [], steps, lr=lr_f, beta1=upd.beta1,
                beta2=upd.beta2, weight_decay=0.0, eps=upd.epsilon,
                amsgrad=False, maximize=False), iters=5, replays=3)
            lib = "torch._fused_adam_ over the same lists"
        n = sum(p.numel() for p in ps)
        # param, grad, state read once; param, state written once
        bms, by = bound((3 + 2 * ns) * n * ps[0].element_size(),
                        10.0 * n, "float32")
        ok = ok and exact and launches == 1
        entries.append({
            "kernel": "fused_updater", "dtype": name,
            "leaf": f"{model} tree, {kind}", "shape": [len(shapes), n],
            "leaves": len(shapes), "launches_per_call": launches,
            "max_abs_err": err, "tol": "0 (bit-exact)", "exact": exact,
            "ms": ms, "plain_ms": plain_ms, "plain_note": "the plain "
            "version leaf by leaf", "library_ms": lib_ms,
            "library_note": lib + ", timed only", "bound_ms": bms,
            "bound_by": by})
        del ps, gs, ss
        torch.cuda.empty_cache()
    return ok, entries


def fused_sgd_ms(p, g, v, lr):
    """PyTorch's own fused optimizer step on the same leaf, timed only (the
    port never calls it): ``torch._fused_sgd_`` with Nesterov momentum
    beside the Nesterovs kernel (PyTorch's Nesterov form; the same reads
    and writes)."""
    import torch

    pl, gl, vl = (t.clone() for t in (p, g, v))
    return {"library_ms": time_ms(lambda: torch._fused_sgd_(
                [pl], [gl], [vl], weight_decay=0.0, momentum=0.9, lr=lr,
                dampening=0.0, nesterov=True, maximize=False,
                is_first_step=False)),
            "library_note": "torch._fused_sgd_ (Nesterov momentum), timed "
                            "only"}


def adam_ms(p, g):
    """The kernel's Adam step (the JAX updater's bias-corrected form) and
    ``torch._fused_adam_`` on the same leaf, the latter timed only."""
    import torch

    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    adam = Adam(learning_rate=1e-3)
    m, sq = torch.zeros_like(p), torch.zeros_like(p)
    it = torch.ones((), dtype=torch.int32, device=p.device)
    lr = adam.lr(it)
    coef = adam.coefficients(lr, it)
    kernel_ms = time_ms(lambda: cu.fused_updater(
        p, g, lr, it, m, sq, kind="Adam", coef=coef, **adam.fused_hyper()))
    pa, ga, ma, va = (t.clone() for t in (p, g, m, sq))
    step = torch.ones((), dtype=torch.float32, device=p.device)
    lib_ms = time_ms(lambda: torch._fused_adam_(
        [pa], [ga], [ma], [va], [], [step], lr=1e-3, beta1=adam.beta1,
        beta2=adam.beta2, weight_decay=0.0, eps=adam.epsilon, amsgrad=False,
        maximize=False))
    return {"adam_ms": kernel_ms, "adam_library_ms": lib_ms,
            "adam_library_note": "torch._fused_adam_ on the same leaf, "
                                 "timed only"}


def convbn_case(dev):
    """bn_matmul_stats (bfloat16) at three batch-128 ResNet-50 1×1 convs,
    in both designs: "sm90" on the aligned operands the main path gives
    it, "wmma" on an x one element into its buffer (the only operands
    ``convbn_design`` routes to it). Each is held to ``kernel_tolerance``
    (one bf16 unit on z; the derived bound for statistics taken from the
    float32 accumulator) and each 128-row block's partial sums to
    ``partials_tolerance`` (``matmul_check.convbn_share``). The sm90
    design's faulted plain variants (prologue skipped, last K slab
    dropped, a row block's statistics counted twice) must exceed that
    check, and two of its runs must give the same bits."""
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
    from deeplearning4j_tpu_torch.ops.cuda_matmul import sm_count
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    entries, ok = [], True
    for label, (m, k, n, prologue) in CONVBN_SHAPES.items():
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                             ).to(dev, torch.bfloat16)
        sc = torch.from_numpy((rng.random(k) + 0.5).astype(np.float32)
                              ).to(dev)
        sh = torch.from_numpy((0.1 * rng.standard_normal(k)).astype(
            np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5
                              ).astype(np.float32)).to(dev, torch.bfloat16)
        ss = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
            np.float32)).to(dev)
        x_off = torch.empty(m * k + 1, dtype=x.dtype, device=dev)[1:].view(
            m, k)
        x_off.copy_(x)
        kw = dict(relu=prologue, fuse_prologue=prologue)
        args = (x, sc, sh, w, ss)
        zr, mr, vr = cc.reference_bn_matmul_stats(*args, **kw)
        plain = (zr, cc.reference_partials(zr, ss), mr, vr)
        y = x.float() * sc + sh if prologue else x.float()
        y = (torch.clamp_min(y, 0.0) if prologue else y).to(torch.bfloat16)
        plain_ms = time_ms(lambda: cc.reference_bn_matmul_stats(*args, **kw))
        lib_ms = time_ms(lambda: torch.matmul(y, w))

        def chain():
            yc = x.float() * sc + sh if prologue else x
            if prologue:
                yc = torch.clamp_min(yc, 0.0).to(torch.bfloat16)
            return torch.var_mean(torch.matmul(yc, w), dim=0)

        chain_ms = time_ms(chain)
        nbytes = (2.0 * m * k + 2.0 * k * n + 8.0 * k + 4.0 * n
                  + 2.0 * m * n + 8.0 * n)
        bms, by = bound(nbytes, 2.0 * m * k * n, "bfloat16")
        for design, a in (("sm90", args), ("wmma", (x_off,) + args[1:])):
            before = cc.bn_matmul_stats.sm90_launches
            z, parts = cc.bn_matmul_stats_partials(*a, **kw)
            got = (z, parts) + cc.reduce_partials(parts, ss)
            torch.cuda.synchronize()
            sm90 = cc.bn_matmul_stats.sm90_launches - before == 1
            share = mc.convbn_share(got, plain, args, **kw)
            ok = (ok and share <= 1.0 and bool(torch.isfinite(z.float()).all())
                  and sm90 == (design == "sm90")
                  and cc.convbn_design(a[0], a[3]) == design)
            extra = {}
            if design == "sm90":
                faults = {f: mc.convbn_share(mc.bn_matmul_stats_variant(
                    *args, **kw, fault=f), plain, args, **kw)
                    for f in mc.convbn_faults(prologue)}
                z2, parts2 = cc.bn_matmul_stats_partials(*a, **kw)
                same = torch.equal(z, z2) and torch.equal(parts, parts2)
                ok = ok and same and all(v > 1.0 for v in faults.values())
                extra = {"faulted_plain_over_tol": faults,
                         "same_bits_twice": same,
                         "kernel_only_ms": time_ms(
                             lambda: cc.bn_matmul_stats_partials(*a, **kw)),
                         "tile_n": cc.convbn_tile_n(m, n, sm_count(0))}
            ms = time_ms(lambda: cc.bn_matmul_stats(*a, **kw))
            entries.append({
                "kernel": "bn_matmul_stats" + ("_sm90" if design == "sm90"
                                               else ""),
                "design": design, "dtype": "bfloat16", "conv": label,
                "shape": [m, k, n], "prologue_relu": prologue,
                "max_abs_err": (z.float() - zr.float()).abs().max().item(),
                "mean_max_abs_err": (got[2] - mr).abs().max().item(),
                "var_max_abs_err": (got[3] - vr).abs().max().item(),
                "tol": "cuda_convbn.kernel_tolerance + partials_tolerance",
                "err_over_tol": share, **extra,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_note": "cuBLAS bf16 torch.matmul of the prologued "
                                "operand: the product alone, no prologue or "
                                "statistics",
                "library_chain_ms": chain_ms,
                "library_chain_note": "the composed chain: elementwise "
                                      "affine + relu, torch.matmul, "
                                      "torch.var_mean of z",
                "bound_ms": bms, "bound_by": by})
    return ok, entries


def _clone_tree(tree):
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _max_diff(a, b):
    if isinstance(a, (dict, list, tuple)):
        keys = a.keys() if isinstance(a, dict) else range(len(a))
        return max([_max_diff(a[k], b[k]) for k in keys], default=0.0)
    if a.numel() == 0:
        return 0.0
    return (a.float() - b.float()).abs().max().item()


def _load(live, start):
    """``start``'s values copied into the tensors of ``live``
    (``nn.compiled.commit``): the trainer keeps the buffers its captured
    steps read and write, so its next step replays rather than captures
    anew."""
    from deeplearning4j_tpu_torch.nn.compiled import commit

    return commit(live, start)


def _eager_if(flag):
    """``disable_capture()`` when ``flag``, else nothing: the reference
    runs (generic, plain, nudged) and the eager comparison run op by op."""
    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    return disable_capture() if flag else contextlib.nullcontext()


def _ledger_by_key(events, keys) -> dict:
    """The recompile ledger's causes by unit key, for ``keys``."""
    out = {}
    for ev in events:
        if ev.key in keys:
            out.setdefault(ev.key, []).append(ev.cause)
    return out


def capture_fields(units, captured, eager, events, keys) -> tuple:
    """A training phase's captured steps against the same steps under
    ``disable_capture()`` from the same starting state: ``captured`` and
    ``eager`` are (losses, host seconds a step, ..., state tree). Both
    bit-equal in losses and in every tensor of the state (parameters,
    updater state, batch-norm state); one ``first_compile`` per step key
    and no other ledger event (no ``new_shape``: every later step
    replays; no ``state_moved``), and each key's unit captured once at
    most (none when its steps are routed to eager) with no capture that
    only moved addresses called for. ``units``: the trainer's ``{key:
    CapturedUnit}``. Returns (problems, line fields)."""
    ledger = _ledger_by_key(events, keys)
    losses_equal = list(captured[0]) == list(eager[0])
    state_equal = _equal_trees(captured[-1], eager[-1])
    problems = []
    if not losses_equal:
        problems.append(f"captured losses {captured[0]} != eager "
                        f"{eager[0]}")
    if not state_equal:
        problems.append(f"captured state differs from eager by "
                        f"{_max_diff(captured[-1], eager[-1])}")
    for k in keys:
        if ledger.get(k) != ["first_compile"]:
            problems.append(f"ledger {k}: {ledger.get(k)} (one "
                            f"first_compile, no new_shape)")
        unit = units.get(k)
        if unit is not None and (unit.captures > 1 or unit.moved):
            problems.append(f"unit {k}: {unit.captures} captures, "
                            f"{unit.moved} for moved addresses (one "
                            f"capture, replayed)")
    return problems, {
        "captured_step_p50_ms": float(np.percentile(captured[1], 50)) * 1e3,
        "eager_step_p50_ms": float(np.percentile(eager[1], 50)) * 1e3,
        "captured_bit_equal_eager": losses_equal and state_equal,
        "losses_eager": list(eager[0]), "ledger": ledger,
        "graph_units": {k: unit_memory(u) for k, u in units.items()}}


def train_phase(phase, dev, smi, *, fused, dtype, batch):
    """ResNet-50 at full width through ``ResNet50(...).init()`` → ``fit``:
    generic run(s) as the reference, then the kernel run with every launch
    count set to 0 just before. Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.datasets import synthetic_image_batch
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    env = environment()
    net = ResNet50(num_classes=CLASSES, input_shape=IMAGE,
                   fused_blocks=fused, dtype=dtype, device=dev).init()
    n_leaves = sum(len(p) for p in net.params.values())
    start = (_clone_tree(net.params), _clone_tree(net.opt_state),
             _clone_tree(net.net_state))
    data = []
    for i in range(TRAIN_STEPS):
        x, lab = synthetic_image_batch(batch, *IMAGE, CLASSES, seed=100 + i)
        data.append((x, np.eye(CLASSES, dtype=np.float32)[lab]))

    def run(mode, scale=None, eager=False):
        """3 steps from ``start`` (copied into the network's tensors):
        captured under ``"auto"``, op by op for the references and with
        ``eager``."""
        env.helper_mode = mode
        net.params = _load(net.params, start[0])
        net.opt_state = _load(net.opt_state, start[1])
        net.net_state = _load(net.net_state, start[2])
        net.iteration_count = 0
        losses, times = [], []
        with _eager_if(eager or mode != "auto"):
            for x, y in data:
                if scale is not None:
                    x = (x * scale).astype(np.float32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(x, y, batch_size=batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(net.score())
        return (losses, times, _clone_tree(net.params),
                _clone_tree([net.params, net.opt_state, net.net_state]))

    observe.reset()
    run("auto")       # warm-up: cuDNN/cuBLAS set-up, the kernel build and
    run("generic")    # the step's capture
    generic, g_times, g_params, _ = run("generic")
    pert = None
    if dtype == "mixed":
        sign = np.sign(np.random.default_rng(6).standard_normal(
            (batch,) + IMAGE)).astype(np.float32)
        pert = run("generic", 1.0 + 2.0 ** -8 * sign)
    cu.fused_updater.launches = cu.fused_updater.leaves = 0
    cc.reset_launch_counts()                 # the main path's run starts
    kernel_run = run("auto")
    kernel, k_times, k_params, _ = kernel_run
    launches = {"fused_updater": cu.fused_updater.launches,
                "bn_matmul_stats": cc.bn_matmul_stats.launches,
                "bn_matmul_stats_sm90": cc.bn_matmul_stats.sm90_launches}
    updater_leaves = cu.fused_updater.leaves  # ... ends
    census = {f"{m}x{k}x{n}{' prologue' if p else ''} {d}": c / TRAIN_STEPS
              for (m, k, n, p, d), c in sorted(
                  cc.bn_matmul_stats.census.items())}  # ... ends
    env.helper_mode = "auto"
    cap_problems, cap_fields = capture_fields(
        net._steps.units, kernel_run, run("auto", eager=True),
        observe.ledger().events(), ("train",))
    param_diff = _max_diff(g_params, k_params)
    moved = _max_diff(start[0], g_params)
    loss_diff = max(abs(a - b) for a, b in zip(kernel, generic))
    problems = []
    if not all(math.isfinite(v) for v in kernel + generic):
        problems.append("non-finite loss")
    problems += updater_count_problems(launches["fused_updater"],
                                       updater_leaves, n_leaves, TRAIN_STEPS)
    problems += cap_problems
    line = {"phase": phase, "card": smi,
            "model": f"ResNet50(fused_blocks={fused}, dtype={dtype!r})",
            "image": list(IMAGE), "classes": CLASSES, "batch": batch,
            "steps": TRAIN_STEPS, "leaves": n_leaves,
            "params": net.num_params(), "launches": launches,
            "fused_updater_leaves": updater_leaves,
            "convbn_census_per_step": census,
            "losses_generic": generic, "losses_kernel": kernel,
            "loss_max_abs_diff": loss_diff,
            "param_max_abs_diff": param_diff,
            "param_max_move_generic": moved}
    if dtype == "mixed":
        yard_loss = max(abs(a - b) for a, b in zip(pert[0], generic))
        yard_param = _max_diff(g_params, pert[2])
        line.update({"losses_generic_input_moved_1_bf16_unit": pert[0],
                     "yardstick_loss_diff": yard_loss,
                     "yardstick_param_diff": yard_param,
                     "loss_diff_over_yardstick": [
                         abs(a - b) / max(abs(c - b), 1e-12)
                         for a, b, c in zip(kernel, generic, pert[0])],
                     "tol": f"step-1 loss {TRAIN_B_LOSS1_RTOL:g} relative; "
                            f"params {TRAIN_B_YARDSTICK:g} x yardstick"})
        want = CONVBN_PER_STEP * TRAIN_STEPS
        if (launches["bn_matmul_stats"] != want
                or launches["bn_matmul_stats_sm90"] != want):
            problems.append(f"convbn launches {launches['bn_matmul_stats']}"
                            f" (sm90 {launches['bn_matmul_stats_sm90']}) != "
                            f"{CONVBN_PER_STEP} x {TRAIN_STEPS}, all sm90")
        if abs(kernel[0] - generic[0]) > TRAIN_B_LOSS1_RTOL * abs(generic[0]):
            problems.append(f"step-1 loss {kernel[0]} vs generic "
                            f"{generic[0]}")
        if param_diff > TRAIN_B_YARDSTICK * yard_param:
            problems.append(f"param diff {param_diff} > {TRAIN_B_YARDSTICK}"
                            f" x {yard_param}")
    else:
        line["tol"] = (f"loss {TRAIN_A_LOSS_RTOL:g} relative; params "
                       f"{TRAIN_A_PARAM_SHARE:g} x the largest 3-step move")
        if any(abs(a - b) > TRAIN_A_LOSS_RTOL * abs(b)
               for a, b in zip(kernel, generic)):
            problems.append(f"losses {kernel} vs generic {generic}")
        if param_diff > TRAIN_A_PARAM_SHARE * moved:
            problems.append(f"param diff {param_diff} > "
                            f"{TRAIN_A_PARAM_SHARE} x {moved}")
    p50 = float(np.percentile(k_times, 50))
    line.update({"smoke_reading": f"{TRAIN_STEPS} steps, no spread",
                 "step_p50_ms": p50 * 1e3, "images_per_s": batch / p50,
                 "generic_step_p50_ms": float(np.percentile(g_times, 50))
                 * 1e3, **cap_fields,
                 "problems": problems})
    del net
    torch.cuda.empty_cache()
    return problems, line, launches


def _nudged(tree, rng):
    """``tree`` with every parameter moved by one unit in the last place
    of its dtype, the sign drawn from ``rng`` (numpy)."""
    import torch

    def move(t):
        f = t.float()
        ulp = torch.finfo(t.dtype).eps * torch.exp2(torch.floor(torch.log2(
            f.abs().clamp_min(torch.finfo(t.dtype).tiny))))
        sign = torch.from_numpy(np.sign(rng.standard_normal(
            tuple(t.shape))).astype(np.float32)).to(t.device)
        return (f + sign * ulp).to(t.dtype)

    if isinstance(tree, dict):
        return {k: _nudged(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nudged(v, rng) for v in tree]
    return move(tree)


def bert_phase(phase, dev, smi, *, dtype, batch, seq, task, min_len):
    """BERT-base at full width through ``BertModel(...)`` → ``fit_*`` →
    ``predict``, 3 steps per run from one starting state on the same
    batches:

    * the kernel run at dropout 0.1 — the main path, every launch count
      set to 0 just before and read just after;
    * the reference at dropout 0.1: the same model with attention run by
      the plain flash versions on the card (a ``cuda`` helper installed
      through the registry), drawing the same seeds, so both drop the
      same attention probabilities and the same FFN activations; and
      that reference again from parameters moved by one unit in the last
      place (its yardstick);
    * at dropout 0: the kernels against ``helper_mode="generic"``, with
      the generic run's own yardstick.

    Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.datasets import synthetic_bert_batch
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models.bert import BertConfig, BertModel
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.ops.registry import registry

    env = environment()
    torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig.base()
    model = BertModel(cfg, seed=0, dtype=getattr(torch, dtype), device=dev)
    n_leaves = len(list(leaf_paths(model.params)))
    start = (_clone_tree(model.params), _clone_tree(model.opt_state),
             [g.get_state() for g in model.rng])
    iterator_task = ("seq_classification" if task == "classifier"
                     else "unsupervised")
    data = [synthetic_bert_batch(batch, seq, cfg.vocab_size,
                                 task=iterator_task, seed=300 + i,
                                 min_len=min_len)
            for i in range(BERT_STEPS)]
    fit = model.fit_classifier if task == "classifier" else model.fit_mlm
    desc = registry().get("dot_product_attention")
    kernel_helper = desc.platform_impls["cuda"]

    def run(mode, dropout, *, plain=False, nudge=False, steps=BERT_STEPS,
            eager=False):
        """``steps`` steps from ``start`` (copied into the model's tensors,
        the generators reset): captured under ``"auto"``, op by op for the
        references and with ``eager``."""
        model.cfg = dataclasses.replace(cfg, dropout=dropout)
        model.params = _load(model.params, _nudged(
            start[0], np.random.default_rng(8)) if nudge else start[0])
        model.opt_state = _load(model.opt_state, start[1])
        for g, st in zip(model.rng, start[2]):
            g.set_state(st)
        model.step = 0
        env.helper_mode = mode
        if plain:
            desc.platform_impls["cuda"] = functools.partial(ca.flash_dpa,
                                                            plain=True)
        losses, times = [], []
        try:
            with _eager_if(eager or plain or mode != "auto"):
                for b in data[:steps]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses += fit([b])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
        finally:
            desc.platform_impls["cuda"] = kernel_helper
            env.helper_mode = "auto"
        return (losses, times, _clone_tree(model.params),
                _clone_tree([model.params, model.opt_state]))

    observe.reset()
    run("auto", ATTN_DROPOUT, steps=1)   # warm-up: cuBLAS, the capture
    run("generic", 0.0, steps=1)
    disp0 = dispatch_tally()
    ca.reset_launch_counts()
    cu.fused_updater.launches = cu.fused_updater.leaves = 0  # starts here
    kernel_run = run("auto", ATTN_DROPOUT)
    kernel, k_times, k_params, _ = kernel_run
    launches = dict(ca.launch_counts(),
                    fused_updater=cu.fused_updater.launches)  # ... ends here
    step_dispatch = dispatch_since(disp0)
    updater_leaves = cu.fused_updater.leaves
    cap_problems, cap_fields = capture_fields(
        model._steps.units, kernel_run, run("auto", ATTN_DROPOUT, eager=True),
        observe.ledger().events(), ("cls" if task == "classifier" else "mlm",))
    ref, r_times, r_params, _ = run("auto", ATTN_DROPOUT, plain=True)
    yard, _, y_params, _ = run("auto", ATTN_DROPOUT, plain=True, nudge=True)
    kernel0, k0_times, k0_params, _ = run("auto", 0.0)
    generic0, g0_times, g0_params, _ = run("generic", 0.0)
    yard0, _, y0_params, _ = run("generic", 0.0, nudge=True)

    # predict: no dropout, forward kernels only
    model.params = _load(model.params, k_params)
    pb = data[0]
    disp0 = dispatch_tally()
    ca.reset_launch_counts()
    logits = model.predict(pb["ids"], pb["segments"], pb["mask"])
    predict_launches = ca.launch_counts()
    predict_dispatch = dispatch_since(disp0)
    model.cfg = cfg

    problems = list(cap_problems)
    # bfloat16 at head dim 64 takes the tensor-core (sm90) forward, dq and
    # dk/dv; float32 the tensor-core sm90_f32 ones (ca.flash_design)
    head_dim = cfg.hidden // cfg.heads
    sm90 = ca.flash_design(getattr(torch, dtype), head_dim, "dq") == "sm90"
    f32 = ca.flash_design(getattr(torch, dtype), head_dim,
                          "fwd") == "sm90_f32"
    f32_bwd = ca.flash_design(getattr(torch, dtype), head_dim,
                              "dq") == "sm90_f32"
    # the attentions the gates send to the flash kernels under the
    # standing tuning table, from the steps' and predict's dispatch
    # tallies; BERT's stay there
    n_step, more = gated(step_dispatch, "dot_product_attention",
                         cfg.layers * BERT_STEPS,
                         floor=cfg.layers * BERT_STEPS)
    n_pred, more2 = gated(predict_dispatch, "dot_product_attention",
                          cfg.layers, floor=cfg.layers)
    problems += more + more2
    want = {"flash_attn_fwd": n_step,
            "flash_attn_fwd_sm90": n_step * sm90,
            "flash_attn_fwd_f32_sm90": n_step * f32,
            "flash_attn_dq": n_step,
            "flash_attn_dq_sm90": n_step * sm90,
            "flash_attn_dq_f32_sm90": n_step * f32_bwd,
            "flash_attn_dkv": n_step,
            "flash_attn_dkv_sm90": n_step * sm90,
            "flash_attn_dkv_f32_sm90": n_step * f32_bwd}
    for name, n in want.items():
        if launches[name] != n:
            problems.append(f"{name} launches {launches[name]} != {n}")
    problems += updater_count_problems(launches["fused_updater"],
                                       updater_leaves, n_leaves, BERT_STEPS)
    if (predict_launches["flash_attn_fwd"] != n_pred
            or predict_launches["flash_attn_fwd_sm90"] != n_pred * sm90
            or predict_launches["flash_attn_fwd_f32_sm90"] != n_pred * f32
            or predict_launches["flash_attn_dq"]
            or predict_launches["flash_attn_dkv"]):
        problems.append(f"predict launches {predict_launches}")
    if logits.shape != (batch, cfg.num_labels) or not np.all(
            np.isfinite(logits)):
        problems.append(f"predict logits {logits.shape} not finite")
    all_losses = kernel + ref + yard + kernel0 + generic0 + yard0
    if not all(math.isfinite(v) for v in all_losses):
        problems.append("non-finite loss")
    big = max(t.float().abs().max().item() for _, t in leaf_paths(start[0]))
    p_floor = torch.finfo(getattr(torch, dtype)).eps * big
    checks = {}
    for label, got, want_l, yard_l, gp, wp, yp in (
            ("dropout_0.1_kernel_vs_plain_flash", kernel, ref, yard,
             k_params, r_params, y_params),
            ("dropout_0_kernel_vs_generic", kernel0, generic0, yard0,
             k0_params, g0_params, y0_params)):
        loss_lim = [max(BERT_LOSS_RTOL[dtype] * abs(w),
                        BERT_YARDSTICK * abs(y - w))
                    for w, y in zip(want_l, yard_l)]
        loss_diff = [abs(a - b) for a, b in zip(got, want_l)]
        p_diff = _max_diff(gp, wp)
        p_lim = max(BERT_YARDSTICK * _max_diff(yp, wp), p_floor)
        checks[label] = {"losses": got, "reference_losses": want_l,
                         "yardstick_losses": yard_l,
                         "loss_abs_diff": loss_diff, "loss_limit": loss_lim,
                         "param_max_abs_diff": p_diff, "param_limit": p_lim}
        if any(d > lim for d, lim in zip(loss_diff, loss_lim)):
            problems.append(f"{label}: losses {got} vs {want_l} "
                            f"(limits {loss_lim})")
        if p_diff > p_lim:
            problems.append(f"{label}: params {p_diff} > {p_lim}")
    tokens = batch * seq
    real = int(sum(b["mask"].sum() for b in data)) / len(data)
    p50 = float(np.percentile(k_times, 50))
    line = {"phase": phase, "card": smi,
            "model": f"BertModel(BertConfig.base(), dtype={dtype})",
            "task": task, "batch": batch, "seq": seq,
            "min_len": min_len, "real_tokens_per_batch": real,
            "steps": BERT_STEPS, "leaves": n_leaves,
            "params": model.num_params(), "dropout": ATTN_DROPOUT,
            "launches": launches, "fused_updater_leaves": updater_leaves,
            "predict_launches": predict_launches,
            "checks": checks, "tol": (
                f"loss max({BERT_LOSS_RTOL[dtype]:g} relative, "
                f"{BERT_YARDSTICK:g} x yardstick); params "
                f"{BERT_YARDSTICK:g} x yardstick"),
            "smoke_reading": f"{BERT_STEPS} steps, no spread",
            "step_p50_ms": p50 * 1e3, "tokens_per_s": tokens / p50,
            "real_tokens_per_s": real / p50,
            "plain_flash_step_p50_ms": float(np.percentile(r_times, 50))
            * 1e3,
            "dropout0_step_p50_ms": float(np.percentile(k0_times, 50)) * 1e3,
            "generic_dropout0_step_p50_ms": float(np.percentile(g0_times,
                                                                50)) * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            **cap_fields, "problems": problems}
    del model
    torch.cuda.empty_cache()
    return problems, line, launches


def fused_matmul_case(dev):
    """act(x @ w + b) at the imported BERT-base shapes (float32 and
    bfloat16) and the extra activations and ragged shapes (float32 and
    bfloat16), held to ``cuda_matmul.kernel_tolerance``. Each entry names
    the design ``cm.matmul_design`` chose: the BERT shapes must run "sm90"
    (bfloat16) and "sm90_f32" (float32), and at least one extra "wmma" and
    one "simt"; each design's launch counter moves for its entries alone;
    each tensor-core entry's faulted plain variants must exceed the
    tolerance and two of its runs must give the same bits."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops.cuda_matmul import sm_count
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    lib_act = {"none": lambda y: y, "relu": torch.relu, "tanh": torch.tanh,
               "gelu": lambda y: F.gelu(y, approximate="tanh"),
               "gelu_exact": F.gelu}
    want_design = {torch.float32: "sm90_f32", torch.bfloat16: "sm90"}
    entries, ok = [], True
    cases = ([(s, d) for d in (torch.float32, torch.bfloat16)
              for s in FUSED_MM_SHAPES]
             + [(s, d) for s in FUSED_MM_EXTRA
                for d in (torch.float32, torch.bfloat16)])
    for (m, k, n, act), dtype in cases:
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                             ).to(dev, dtype)
        w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
            np.float32)).to(dev, dtype)
        b = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
            np.float32)).to(dev)
        before = (cm.fused_matmul.sm90_launches,
                  cm.fused_matmul.sm90_f32_launches)
        out = cm.fused_matmul(x, w, b, activation=act)
        again = cm.fused_matmul(x, w, b, activation=act)
        ref = cm.fused_matmul_bias_act_reference(x, w, b, activation=act)
        torch.cuda.synchronize()
        design = cm.matmul_design(x, w, out)
        tensor_cores = design in ("sm90", "sm90_f32")
        atol, rtol = cm.kernel_tolerance(x, w, ref)

        def share_of(y):
            err = (y.float() - ref.float()).abs()
            return err, (err / (atol + rtol * ref.float().abs())).max().item()

        err, share = share_of(out)
        faults = {}
        if design == "sm90":
            faults = {f: share_of(mc.fused_matmul_variant(
                x, w, b, activation=act, fault=f))[1] for f in mc.FAULTS}
        elif design == "sm90_f32":
            faults = {f: share_of(mc.fused_matmul_variant(
                x, w, b, activation=act, fault=f, slab=mc.F32_SLAB))[1]
                for f in mc.F32_FAULTS}
        same_bits = torch.equal(out, again)
        ok = (ok and share <= 1.0 and bool(torch.isfinite(out.float()).all())
              and cm.fused_matmul.sm90_launches - before[0]
              == 2 * int(design == "sm90")
              and cm.fused_matmul.sm90_f32_launches - before[1]
              == 2 * int(design == "sm90_f32")
              and all(f > 1.0 for f in faults.values())
              and (same_bits or not tensor_cores))
        if (m, k, n, act) in FUSED_MM_SHAPES:
            ok = ok and design == want_design[dtype]
        bl = b.to(dtype)
        ms = time_ms(lambda: cm.fused_matmul(x, w, b, activation=act))
        plain_ms = time_ms(lambda: cm.fused_matmul_bias_act_reference(
            x, w, b, activation=act))
        lib_ms = time_ms(lambda: lib_act[act](torch.addmm(bl, x, w)))
        name = str(dtype).replace("torch.", "")
        es = x.element_size()
        nbytes = es * (m * k + k * n + m * n) + 4.0 * n
        bms, by = design_bound(nbytes, 2.0 * m * k * n, name, design)
        extra = {}
        if design == "sm90_f32":
            extra = dict(
                tile_n=cm.fullest_tile_n(m, n, cm.TILE_N, sm_count(0)),
                kmajor_copy_ms=time_ms(lambda: cm.kmajor_split(w)),
                kmajor_copy_note="the one-off K-major split copy (w_hi, "
                                 "w_lo) of the weight, made once a weight, "
                                 "not in ms")
        kernel = {"sm90": "fused_matmul_bias_act_sm90",
                  "sm90_f32": "fused_matmul_bias_act_f32_sm90"}.get(
                      design, "fused_matmul_bias_act")
        entries.append({
            "kernel": kernel, "design": design, "dtype": name,
            "shape": [m, k, n], "activation": act, "max_abs_err":
            err.max().item(), "tol": f"{atol:.3g} + {rtol:g}*|plain|",
            "err_over_tol": share,
            **({"faulted_plain_over_tol": faults,
                "same_bits_twice": same_bits} if tensor_cores else {}),
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms,
            "library_note": "torch.addmm (cuBLAS, TF32 off) plus the "
                            "activation, bias in the operands' dtype",
            "bound_ms": bms, "bound_by": by, **extra,
            "achieved_tflops": 2.0 * m * k * n / ms / 1e9})
    ok = (ok and any(e["design"] == "wmma" for e in entries)
          and any(e["design"] == "simt" for e in entries))
    return ok, entries


def fused_layer_norm_case(dev):
    """act(LayerNorm(x)·g + b) at 4096 × 768 for gelu, gelu_exact and
    none, float32 and bfloat16, held to ``cuda_layernorm.kernel_tolerance``
    of its plain version; ``F.layer_norm`` (then ``F.gelu``) timed as the
    library yardstick."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops.nn_ops import apply_fused_activation

    rows, d = LN_SHAPE
    entries, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        for act in LN_ACTS:
            rng = np.random.default_rng(7)
            x = torch.from_numpy(rng.standard_normal(
                (rows, d), dtype=np.float32)).to(dev, dtype)
            g = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(
                np.float32)).to(dev)
            b = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(
                np.float32)).to(dev)
            out = cl.fused_layer_norm_kernel(x, g, b, activation=act)
            ref = cl.fused_layer_norm_reference(x, g, b, activation=act)
            torch.cuda.synchronize()
            atol, rtol = cl.kernel_tolerance(dtype)
            err = (out.float() - ref.float()).abs()
            share = (err / (atol + rtol * ref.float().abs())).max().item()
            ok = (ok and share <= 1.0 and out.dtype == dtype
                  and bool(torch.isfinite(out.float()).all()))
            gl, bl = g.to(dtype), b.to(dtype)
            ms = time_ms(lambda: cl.fused_layer_norm_kernel(
                x, g, b, activation=act))
            plain_ms = time_ms(lambda: cl.fused_layer_norm_reference(
                x, g, b, activation=act))
            lib_ms = time_ms(lambda: apply_fused_activation(F.layer_norm(
                x, (d,), gl, bl, 1e-5), act))
            name = str(dtype).replace("torch.", "")
            # x read and y written once, g and b (float32) once; ~10
            # float32 operations an element besides the activation
            bms, by = bound(2.0 * rows * d * x.element_size() + 8.0 * d,
                            10.0 * rows * d, "float32")
            entries.append({
                "kernel": "fused_layer_norm", "dtype": name,
                "shape": [rows, d], "activation": act,
                "max_abs_err": err.max().item(),
                "tol": f"{atol:g} + {rtol:g}*|plain|", "err_over_tol": share,
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library_note": "F.layer_norm" + (
                    "" if act == "none" else " then F.gelu") +
                    ", gain and bias in x's dtype",
                "bound_ms": bms, "bound_by": by,
                "achieved_gb_per_s": (2.0 * rows * d * x.element_size()
                                      + 8.0 * d) / ms / 1e6})
    return ok, entries


def matmul_int8_case(dev):
    """The int8 serving matmul at the int8 BERT-base shapes, float32 and
    bfloat16 x: ``row_quantize`` against ``quantized._row_quantize`` and
    the GEMM in both designs — "sm90" on the aligned q the main path gives
    it, "wmma" on a q one byte into its buffer (the operands
    ``int8_design`` routes to it besides an odd K) — against its plain
    version on the same quantized inputs, all bit for bit. The sm90 design's faulted
    plain variants (a K slab dropped, the scales on the wrong axis) must
    differ from it, two of its runs must give the same bits, and the
    one-off K-major copy of the weight it reads is timed apart from the
    GEMM. ``torch._int_mm`` (cuBLASLt) plus the de-scale is timed as the
    library yardstick where it takes the shape."""
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import quantized as Q
    from deeplearning4j_tpu_torch.ops.cuda_matmul import sm_count
    from deeplearning4j_tpu_torch.testing import matmul_check as mc

    entries, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        quantized_rows = set()
        for m, k, n in INT8_MM_SHAPES:
            rng = np.random.default_rng(8)
            x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)
                                 ).to(dev, dtype)
            w = torch.from_numpy((0.02 * rng.standard_normal((k, n))).astype(
                np.float32)).to(dev)
            wq, ws = Q.quantize_int8.fn(w, axis=0)
            xq, xs = cq.row_quantize(x)
            rq, rs = Q._row_quantize(x)
            yr = cq.int8_matmul_reference(xq, xs, wq, ws, dtype)
            whole = cq.matmul_int8(x, wq, ws)
            torch.cuda.synchronize()
            q_exact = torch.equal(xq, rq) and torch.equal(xs, rs)
            ok = (ok and q_exact and cq.int8_design(xq) == "sm90"
                  and torch.equal(whole, cq.matmul_int8_reference(x, wq, ws)))
            es = x.element_size()
            if k not in quantized_rows:  # one row_quantize entry per K
                quantized_rows.add(k)
                bms, by = bound(m * k * es + m * k + 4.0 * m, 3.0 * m * k,
                                "float32")
                entries.append({
                    "kernel": "matmul_int8_row_quantize", "dtype": name,
                    "shape": [m, k],
                    "max_abs_err": float((xq.int() - rq.int()).abs().max()),
                    "scale_max_abs_err": (xs - rs).abs().max().item(),
                    "tol": "0 (bit-exact)", "exact": q_exact,
                    "ms": time_ms(lambda: cq.row_quantize(x)),
                    "plain_ms": time_ms(lambda: Q._row_quantize(x)),
                    "library_ms": None,
                    "library_note": "no single PyTorch call quantizes rows",
                    "bound_ms": bms, "bound_by": by})
            lib_ms, lib_note = None, ("torch._int_mm takes M > 16 and K, N "
                                      "multiples of 8 only")
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                wt = wq.t().contiguous().t()  # the column-major mat2 it wants
                lib_ms = time_ms(lambda: (torch._int_mm(xq, wt).float() * xs
                                          * ws).to(dtype))
                lib_note = ("torch._int_mm (cuBLASLt s8 GEMM, int32 out) then "
                            "the float32 de-scale: two kernels and an "
                            "(M, N) int32 round trip")
            bms, by = bound(m * k + 4.0 * m + k * n + 4.0 * n + m * n * es,
                            2.0 * m * k * n, "int8")
            plain_ms = time_ms(lambda: cq.int8_matmul_reference(
                xq, xs, wq, ws, dtype))
            xq_off = torch.empty(m * k + 1, dtype=torch.int8,
                                 device=dev)[1:].view(m, k)
            xq_off.copy_(xq)
            for design, q in (("sm90", xq), ("wmma", xq_off)):
                before = cq.int8_matmul.sm90_launches
                y = cq.int8_matmul(q, xs, wq, ws, dtype)
                torch.cuda.synchronize()
                y_exact = torch.equal(y, yr)
                ok = (ok and y_exact and bool(torch.isfinite(y.float()).all())
                      and cq.int8_design(q) == design
                      and cq.int8_matmul.sm90_launches - before
                      == int(design == "sm90"))
                extra = {}
                if design == "sm90":
                    faults = {f: not torch.equal(mc.int8_matmul_variant(
                        xq, xs, wq, ws, dtype, fault=f), y)
                        for f in mc.INT8_FAULTS}
                    same = torch.equal(y, cq.int8_matmul(xq, xs, wq, ws,
                                                         dtype))
                    ok = ok and same and all(faults.values())
                    extra = {"faulted_plain_differs": faults,
                             "same_bits_twice": same,
                             "tile_n": cq.int8_tile_n(m, n, sm_count(0)),
                             "kmajor_copy_ms": time_ms(
                                 lambda: wq.t().contiguous()),
                             "kmajor_copy_note": "the one-off (N, K) copy "
                                                 "of the weight, made once a "
                                                 "weight, not in ms"}
                ms = time_ms(lambda: cq.int8_matmul(q, xs, wq, ws, dtype))
                entries.append({
                    "kernel": "matmul_int8" + ("_sm90" if design == "sm90"
                                               else ""),
                    "design": design, "dtype": name, "shape": [m, k, n],
                    "max_abs_err": (y.float() - yr.float()).abs().max().item(),
                    "tol": "0 (bit-exact)", "exact": y_exact, **extra,
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_note": lib_note,
                    "bound_ms": bms, "bound_by": by,
                    "achieved_tops": 2.0 * m * k * n / ms / 1e9})
    return ok, entries


@functools.lru_cache(maxsize=1)
def _bert_base_onnx():
    """(ONNX bytes of the BERT-base-width encoder, seconds to build them):
    built once, read by onnx_bert and sd_bert_finetune."""
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        BERT_BASE_ONNX, bert_onnx_model)

    t0 = time.perf_counter()
    model = bert_onnx_model(**BERT_BASE_ONNX)
    return model, time.perf_counter() - t0


def samediff_ledger(observe) -> list:
    """The (key, cause) of every SameDiff compile in the ledger."""
    return [[ev.key, ev.cause] for ev in observe.ledger().events()
            if ev.graph == "samediff"]


def exec_unit(sd, outputs):
    """The captured unit behind ``sd.output(feeds, outputs)``."""
    from deeplearning4j_tpu_torch.autodiff.optimize import CompiledGraph

    (fn,) = [f for k, f in sd._jit_cache.items()
             if isinstance(f, CompiledGraph) and k[1] == tuple(outputs)]
    return fn.unit


def captured_vs_eager(sd, feeds, outputs, captured, timed):
    """``captured`` (a replayed ``sd.output``'s first output) against the
    same call under ``disable_capture()``, bit for bit; the eager wall p50
    over ``timed`` forwards; the unit's captures and memory."""
    import torch

    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    times = []
    with disable_capture():
        eager = sd.output(feeds, outputs)[outputs[0]]
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sd.output(feeds, outputs)
            times.append(time.perf_counter() - t0)
    return {"bits_equal_eager": bool(np.array_equal(captured, eager)),
            "max_abs_diff_eager": float(np.abs(captured - eager).max()),
            "eager_p50_ms": float(np.percentile(times, 50)) * 1e3,
            "eager_times_ms": [t * 1e3 for t in times],
            "graph_unit": unit_memory(exec_unit(sd, outputs))}


def captured_problems(info) -> list:
    """A phase's captured-vs-eager checks: the same bits, one capture, one
    first_compile for exec and nothing else."""
    problems = []
    if not info["bits_equal_eager"]:
        problems.append(f"captured output differs from eager by "
                        f"{info['max_abs_diff_eager']}")
    if info["graph_unit"]["captures"] != 1:
        problems.append(f"captures {info['graph_unit']}")
    if info["ledger"] != [["exec", "first_compile"]]:
        problems.append(f"ledger {info['ledger']}")
    return problems


def onnx_bert_phase(dev, smi):
    """The imported-graph path at BERT-base width: ONNX bytes →
    ``import_onnx`` → SameDiff → optimizer → ``sd.output``, with the
    kernels, with ``helper_mode="generic"`` and with ``optimize=False``.
    Returns (problems, line, launches of the main path's forward)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        BERT_BASE_ONNX, bert_onnx_feeds)

    cfg = BERT_BASE_ONNX
    env = environment()
    model, build_s = _bert_base_onnx()
    feeds = bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    last = f"l{cfg['layers'] - 1}_out"
    float32_out = {}  # the kernel run's y and last hidden state (int8_bert)

    def run(mode, optimize, *, counted=False):
        """Import, 2 warm forwards, [the counted forward], 5 timed."""
        env.helper_mode = mode
        try:
            if counted:
                observe.reset()  # the ledger from here holds this graph's
            copies0 = cm.kmajor_weight.copies
            t0 = time.perf_counter()
            sd = import_onnx(model, optimize=optimize, device=dev)
            torch.cuda.synchronize()
            parse_s = time.perf_counter() - t0
            check_s = sd.last_check_report.seconds  # inside parse_s
            t0 = time.perf_counter()
            sd.output(feeds, ["y"])  # the first forward builds the plan
            first_s = time.perf_counter() - t0
            sd.output(feeds, ["y"])
            launches = None
            if counted:
                ledger = samediff_ledger(observe)
                observe.reset()
                ca.reset_launch_counts()
                cm.fused_matmul.launches = 0
                cm.fused_matmul.sm90_launches = 0
                cm.fused_matmul.sm90_f32_launches = 0
                copies1 = cm.kmajor_weight.copies  # the main path starts here
                y = sd.output(feeds, ["y"])["y"]
                launches = dict(fused_matmul_bias_act=cm.fused_matmul.launches,
                                fused_matmul_bias_act_sm90=cm.fused_matmul
                                .sm90_launches,
                                fused_matmul_bias_act_f32_sm90=cm.fused_matmul
                                .sm90_f32_launches,
                                flash_attn_fwd=ca.flash_attention.launches,
                                flash_attn_fwd_sm90=ca.flash_attention
                                .sm90_launches,
                                flash_attn_fwd_f32_sm90=ca.flash_attention
                                .sm90_f32_launches)  # ... ends here
                # the sm90_f32 matmul's K-major split weight copies: all
                # made by the forwards before this one
                launches["kmajor_copies"] = {
                    "import_to_counted": copies1 - copies0,
                    "counted_forward": cm.kmajor_weight.copies - copies1}
                launches["dispatch"] = dispatch_tally()  # reset above
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(ONNX_BERT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = sd.output(feeds, ["y"])["y"]
                times.append(time.perf_counter() - t0)
            st = sd.last_compile_stats
            info = {"parse_s": parse_s, "check_s": check_s,
                    "first_forward_s": first_s,
                    "p50_ms": float(np.percentile(times, 50)) * 1e3,
                    "times_ms": [t * 1e3 for t in times],
                    "peak_memory_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                    "nodes": len(sd._nodes)}
            if optimize:
                info.update(plan_s=st.optimize_seconds,
                            nodes_before=st.nodes_before,
                            nodes_after=st.nodes_after, fusions=st.fusions,
                            invariant_checks=st.invariant_checks)
            info.update(trace_s=st.trace_seconds,
                        capture_s=st.compile_seconds)
            if counted:
                info.update(captured_vs_eager(sd, feeds, ["y"], y,
                                              ONNX_BERT_TIMED),
                            ledger=ledger)
            if counted:  # after the timing: a second plan, for int8_bert
                out = sd.output(feeds, ["y", last])
                float32_out.update(y=out["y"], hidden=out[last])
            del sd
            gc.collect()  # a captured graph's cycle back to sd, and its pool
            torch.cuda.empty_cache()
            return y, info, launches
        finally:
            env.helper_mode = "auto"

    y_k, k_info, launches = run("auto", True, counted=True)
    y_g, g_info, _ = run("generic", True)
    y_u, u_info, _ = run("auto", False)
    problems = []
    if k_info["fusions"] != {"attention": cfg["layers"],
                             "epilogue": 6 * cfg["layers"]}:
        problems.append(f"fusions {k_info['fusions']}")
    # the gates' decisions under the standing tuning table (the counted
    # forward's dispatch tally; the encoder's stay on the kernels), every
    # float32 fused matmul and flash forward they send there on the
    # tensor-core sm90_f32 designs, none on the CUDA-core ones
    layers = cfg["layers"]
    n_mm, more = gated(launches["dispatch"], "fused_matmul_bias_act",
                       6 * layers, floor=6 * layers)
    n_fa, more2 = gated(launches["dispatch"], "dot_product_attention",
                        layers, floor=layers)
    problems += more + more2
    want = {"fused_matmul_bias_act": n_mm,
            "fused_matmul_bias_act_sm90": 0,
            "fused_matmul_bias_act_f32_sm90": n_mm,
            "flash_attn_fwd": n_fa, "flash_attn_fwd_sm90": 0,
            "flash_attn_fwd_f32_sm90": n_fa}
    for name, n in want.items():
        if launches[name] != n:
            problems.append(f"{name} launches {launches[name]} != {n}")
    # one split copy a kernel matmul's weight, all made before the
    # counted forward
    if launches["kmajor_copies"] != {"import_to_counted": n_mm,
                                     "counted_forward": 0}:
        problems.append(f"K-major weight copies {launches['kmajor_copies']} "
                        f"!= {n_mm} before the counted forward, 0 in it")
    problems += captured_problems(k_info)
    shape = (cfg["batch"], cfg["seq"], 2)
    diffs = {}
    for label, y in (("kernel", y_k), ("generic", y_g),
                     ("unoptimized", y_u)):
        if y.shape != shape or not np.all(np.isfinite(y)):
            problems.append(f"{label} output {y.shape} not finite")
    diffs["kernel_vs_generic"] = float(np.abs(y_k - y_g).max())
    diffs["kernel_vs_unoptimized"] = float(np.abs(y_k - y_u).max())
    diffs["generic_vs_unoptimized"] = float(np.abs(y_g - y_u).max())
    for label, d in diffs.items():
        if d > ONNX_BERT_TOL:
            problems.append(f"{label} max abs diff {d} > {ONNX_BERT_TOL}")
    tokens = cfg["batch"] * cfg["seq"]
    real = float(feeds["mask"].sum())
    line = {"phase": "onnx_bert", "card": smi, "config": cfg,
            "weights": "float32, numpy RandomState(0) * 0.02",
            "build_bytes_s": build_s, "model_bytes": len(model),
            "launches": launches, "kernel": k_info, "generic": g_info,
            "unoptimized": u_info, "max_abs_diff": diffs,
            "tol": ONNX_BERT_TOL,
            "smoke_reading": f"{ONNX_BERT_TIMED} forwards, no spread",
            "forward_p50_ms": k_info["p50_ms"],
            "eager_forward_p50_ms": k_info["eager_p50_ms"],
            "tokens_per_s": tokens / (k_info["p50_ms"] / 1e3),
            "real_tokens_per_s": real / (k_info["p50_ms"] / 1e3),
            "eager_tokens_per_s": tokens / (k_info["eager_p50_ms"] / 1e3),
            "generic_tokens_per_s": tokens / (g_info["p50_ms"] / 1e3),
            "unoptimized_tokens_per_s": tokens / (u_info["p50_ms"] / 1e3),
            "problems": problems}
    return problems, line, {k: launches[k] for k in want}, float32_out


def _nudge_variables(sd, seed):
    """Move every float VARIABLE of ``sd`` by one unit in the last place
    in place (the sign from numpy ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    for name, t in sd._arrays.items():
        if sd._vars[name].vtype == "VARIABLE" and t.is_floating_point():
            t.copy_(_nudged(t, rng))


def onnx_vision_phase(phase, dev, smi):
    """An imported vision model served on the card (``onnx_vit``: ViT-B/16,
    ``onnx_resnet50``: ResNet-50): ONNX bytes → ``import_onnx`` → SameDiff
    → ``sd.output`` at batch 32 × 3 × 224 × 224. Returns (problems, line,
    launches of the counted forward)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import import_onnx, parse_model
    from deeplearning4j_tpu_torch.ops.capture import disable_capture
    from deeplearning4j_tpu_torch.profile_serve import _profile
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob

    vit = phase == "onnx_vit"
    cfg = dict(ob.VIT_B16 if vit else ob.RESNET50)
    batch = ONNX_VISION_BATCH
    image = cfg["image"]
    env = environment()
    problems = []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = (ob.vit_onnx_model(batch=batch, **cfg) if vit
             else ob.resnet50_onnx_model(batch=batch, **cfg))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ir = parse_model(model)
    parse_s = time.perf_counter() - t0
    weights = int(sum(a.size for a in ir.initializers.values()
                      if a.dtype == np.float32))
    del ir
    feed = "pixel_values" if vit else "x"
    feeds = ob.image_feeds(feed, batch, image)
    out = ["logits"]

    def load(optimize=True):
        t0 = time.perf_counter()
        sd = import_onnx(model, optimize=optimize, device=dev)
        torch.cuda.synchronize()
        return sd, time.perf_counter() - t0

    def forward(sd, mode="auto"):
        env.helper_mode = mode
        try:
            return sd.output(feeds, out)["logits"]
        finally:
            env.helper_mode = "auto"

    sd, import_s = load()
    check_s = sd.last_check_report.seconds  # inside import_s
    t0 = time.perf_counter()
    forward(sd)  # the first forward builds the plan and warms up
    first_s = time.perf_counter() - t0
    forward(sd)  # the capture
    observe.reset()
    _zero_counters()  # the main path's forward starts here
    y = forward(sd)
    launches = _read_counters()  # ... and ends here
    gate_disp = dispatch_tally()
    dispatch = {f"{op}.{impl}": sum(v for k, v in gate_disp.items()
                                    if k.startswith(f"{op} {impl} "))
                for op in ("fused_matmul_bias_act", "dot_product_attention")
                for impl in ("cuda", "generic")}
    st = sd.last_compile_stats
    info = captured_vs_eager(sd, feeds, out, y, ONNX_VISION_TIMED)
    if not info["bits_equal_eager"]:
        problems.append(f"captured output differs from eager by "
                        f"{info['max_abs_diff_eager']}")
    times = []
    for _ in range(ONNX_VISION_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(sd)
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    prof = _profile(lambda: forward(sd), 2, top=6,
                    named=("flash", "fused_matmul", "conv", "gemm"))
    with disable_capture():
        prof_eager = _profile(lambda: forward(sd), 2, top=6,
                              named=("flash", "fused_matmul", "conv",
                                     "gemm"))
    y_g = forward(sd, "generic")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del sd
    gc.collect()
    torch.cuda.empty_cache()

    # the yardstick: generic from weights moved by one ulp; then the
    # unoptimized graph
    sd, _ = load()
    _nudge_variables(sd, 11)
    y_n = forward(sd, "generic")
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    sd, import_u_s = load(optimize=False)
    y_u = forward(sd)
    del sd
    gc.collect()
    torch.cuda.empty_cache()

    yard = float(np.abs(y_n - y_g).max())
    lim = max(ONNX_VISION_YARDSTICK * yard,
              float(np.finfo(np.float32).eps * np.abs(y_g).max()))
    diffs = {"kernel_vs_unoptimized": float(np.abs(y - y_u).max()),
             "generic_vs_unoptimized": float(np.abs(y_g - y_u).max())}
    if vit:
        diffs["kernel_vs_generic"] = float(np.abs(y - y_g).max())
    for label, d in diffs.items():
        if not d <= lim:
            problems.append(f"{label} max abs diff {d} > {lim} "
                            f"({ONNX_VISION_YARDSTICK:g} x yardstick {yard})")
    for label, v in (("kernel", y), ("generic", y_g), ("unoptimized", y_u)):
        if v.shape != (batch, cfg["classes"]) or not np.all(np.isfinite(v)):
            problems.append(f"{label} logits {v.shape} not finite")

    layers = cfg.get("layers", 0)
    want = {k: 0 for k in launches}
    if vit:
        # the encoder's matmuls and attentions the gates send to the
        # kernels under the standing tuning table (the counted forward's
        # dispatch tally; they stay there); the classifier, which reads
        # the class token's offset row, is refused by shape
        n_mm, more = gated(gate_disp, "fused_matmul_bias_act", 6 * layers,
                           floor=6 * layers)
        n_fa, more2 = gated(gate_disp, "dot_product_attention", layers,
                            floor=layers)
        problems += more + more2
        want.update(flash_attn_fwd=n_fa, flash_attn_fwd_f32_sm90=n_fa,
                    fused_matmul_bias_act=n_mm,
                    fused_matmul_bias_act_f32_sm90=n_mm)
        fusions = {"attention": layers, "epilogue": 6 * layers + 1}
        want_disp = {"fused_matmul_bias_act.cuda": n_mm,
                     "fused_matmul_bias_act.generic": 6 * layers + 1 - n_mm,
                     "dot_product_attention.cuda": n_fa,
                     "dot_product_attention.generic": layers - n_fa}
    else:
        fusions = {"epilogue": 1}
        want_disp = {"fused_matmul_bias_act.cuda": 0,
                     "fused_matmul_bias_act.generic": 1,
                     "dot_product_attention.cuda": 0,
                     "dot_product_attention.generic": 0}
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if dispatch != want_disp:
        problems.append(f"dispatches {dispatch} != {want_disp}")
    if st.fusions != fusions:
        problems.append(f"fusions {st.fusions} != {fusions}")
    line = {"phase": phase, "card": smi, "config": cfg, "batch": batch,
            "graph": ("HF ViTForImageClassification as torch.onnx.export "
                      "writes it" if vit else
                      "torchvision resnet50 (v1.5) as torch.onnx.export "
                      "writes it, BatchNormalization kept"),
            "weights": weights, "weights_gb": 4 * weights / 1e9,
            "model_bytes": len(model), "build_bytes_s": build_s,
            "parse_s": parse_s, "import_s": import_s,
            "check_s": check_s,
            "import_unoptimized_s": import_u_s,
            "first_forward_s": first_s,
            "nodes_before": st.nodes_before, "nodes_after": st.nodes_after,
            "fusions": st.fusions, "forward_launches": launches,
            "table_kernels_launched": sum(launches.values()),
            "dispatch": dispatch, "max_abs_diff": diffs,
            "yardstick_1_ulp": yard, "limit": lim,
            "max_abs_logit": float(np.abs(y_g).max()),
            "forward_p50_ms": p50 * 1e3,
            "forward_times_ms": [t * 1e3 for t in times],
            "eager_forward_p50_ms": info["eager_p50_ms"],
            "images_per_s": batch / p50,
            "eager_images_per_s": batch / (info["eager_p50_ms"] / 1e3),
            "captured_vs_eager": {k: info[k] for k in (
                "bits_equal_eager", "max_abs_diff_eager", "graph_unit")},
            "device_busy_share": prof["device_busy_share"], "profile": prof,
            "eager_device_busy_share": prof_eager["device_busy_share"],
            "eager_profile": prof_eager,
            "peak_memory_gib": peak, "peak_memory_own_gib": peak - resident,
            "smoke_reading": f"{ONNX_VISION_TIMED} forwards, no spread",
            "problems": problems}
    return problems, line, launches


def sd_bert_finetune_phase(dev, smi):
    """SameDiff training of the imported BERT-base: ONNX bytes →
    ``import_onnx`` → a token-classification head added in SameDiff →
    ``TrainingConfig`` → ``sd.fit`` (3 steps) → ``sd.output``, through the
    kernels; then the same steps with ``helper_mode="generic"`` from the
    same weights, and from weights moved by one unit in the last place
    (the yardstick). Returns (problems, line, launches of the 3 steps)."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob

    cfg = ob.BERT_BASE_ONNX
    env = environment()
    model, _ = _bert_base_onnx()
    feeds = ob.bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    batch = ob.TokenBatch(feeds, ob.token_labels(cfg["batch"], cfg["seq"]))
    head = ob.token_head_arrays(cfg["d"])

    def build(nudge=False):
        sd = import_onnx(model, device=dev)
        logits, loss = ob.add_token_head(sd, f"l{cfg['layers'] - 1}_out",
                                         head, cfg["batch"], cfg["seq"])
        sd.set_training_config(TrainingConfig(
            updater=Adam(learning_rate=FINETUNE_LR),
            data_set_feature_mapping=["ids", "mask"],
            data_set_label_mapping=["labels"], loss_variables=[loss]))
        if nudge:
            moved = _nudged(sd.training_state()["params"],
                            np.random.default_rng(9))
            for n, t in moved.items():
                sd.set_arr(n, t)
        return sd, logits

    def run(mode, *, nudge=False, counted=False, refit=False, eager=False):
        """Build, 3 fit steps, then ``sd.output`` of the logits. With
        ``refit`` that output is captured before the steps (and replayed
        once) and replayed after them, then held against eager. The steps
        are captured under ``"auto"``, op by op for the references and
        with ``eager``."""
        from deeplearning4j_tpu_torch import observe
        from deeplearning4j_tpu_torch.nn.compiled import TrainUnits

        env.helper_mode = mode
        if counted:
            observe.reset()
        try:
            resident = torch.cuda.memory_allocated() / 2 ** 30
            sd, logits = build(nudge)
            if refit:
                before = sd.output(feeds, [logits])[logits]
                sd.output(feeds, [logits])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches = None
            if counted:
                ca.reset_launch_counts()
                cl.fused_layer_norm_kernel.launches = 0
                cm.fused_matmul.launches = 0
                cm.fused_matmul.sm90_launches = 0
                cm.fused_matmul.sm90_f32_launches = 0
                copies0 = cm.kmajor_weight.copies
                disp0 = dispatch_tally()
                cu.fused_updater.launches = 0  # the main path starts here
                cu.fused_updater.leaves = 0
            losses, times = [], []
            with _eager_if(eager or mode != "auto"):
                for _ in range(FINETUNE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses += sd.fit([batch])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            events = list(observe.ledger().events())
            # the unit's records (not the unit: its pool goes with sd)
            units = {k[0]: types.SimpleNamespace(
                captures=u.units["train"].captures,
                moved=u.units["train"].moved,
                pool_bytes=u.units["train"].pool_bytes,
                static_bytes=u.units["train"].static_bytes)
                for k, u in sd._jit_cache.items()
                if isinstance(u, TrainUnits) and "train" in u.units}
            if counted:
                launches = dict(
                    {k: v for k, v in ca.launch_counts().items()
                     if k != "paged_decode"},
                    fused_layer_norm=cl.fused_layer_norm_kernel.launches,
                    fused_matmul_bias_act=cm.fused_matmul.launches,
                    fused_matmul_bias_act_sm90=cm.fused_matmul.sm90_launches,
                    fused_matmul_bias_act_f32_sm90=cm.fused_matmul
                    .sm90_f32_launches,
                    fused_updater=cu.fused_updater.launches)  # ... ends here
                step_dispatch = dispatch_since(disp0)
                # the updater makes new weights each step: the sm90_f32
                # matmul makes their K-major split copies anew
                copies = cm.kmajor_weight.copies - copies0
                updater_leaves = cu.fused_updater.leaves
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            st = sd.last_compile_stats
            info = {"losses": losses, "times_ms": [t * 1e3 for t in times],
                    "step_p50_ms": float(np.percentile(times, 50)) * 1e3,
                    "peak_memory_gib": peak,
                    "resident_before_gib": resident,  # earlier phases'
                    "fusions": st.fusions,
                    "plan_nodes": st.nodes_after}
            if counted:
                info["kmajor_copies"] = copies
                info["fused_updater_leaves"] = updater_leaves
                info["step_dispatch"] = step_dispatch
            params = {n: t.clone() for n, t in
                      sd.training_state()["params"].items()}
            info["state"] = _clone_tree([params, sd.training_state()[
                "opt_state"]])
            info["events"], info["units"] = events, units
            n_params = sum(t.numel() for t in params.values())
            disp0 = dispatch_tally()
            cl.fused_layer_norm_kernel.launches = 0
            cm.fused_matmul.launches = 0
            out = sd.output(feeds, [logits])[logits]
            info["output_launches"] = {
                "fused_layer_norm": cl.fused_layer_norm_kernel.launches,
                "fused_matmul_bias_act": cm.fused_matmul.launches}
            info["output_dispatch"] = dispatch_since(disp0)
            if refit:
                info.update(captured_vs_eager(sd, feeds, [logits], out, 1),
                            changed_by_fit=bool(not np.array_equal(before,
                                                                   out)))
            del sd
            gc.collect()  # a captured graph's cycle back to sd, and its pool
            torch.cuda.empty_cache()
            return info, launches, params, n_params, out
        finally:
            env.helper_mode = "auto"

    # warm-up (cuBLAS, the allocator, the plan's first build), with the
    # logits' sd.output captured before the steps and replayed after them
    r_info = run("auto", refit=True)[0]
    k_info, launches, k_params, n_params, k_out = run("auto", counted=True)
    e_info = run("auto", eager=True)[0]
    g_info, _, g_params, _, g_out = run("generic")
    y_info, _, y_params, _, _ = run("generic", nudge=True)

    problems, cap_fields = capture_fields(
        k_info.pop("units"),
        (k_info["losses"], [t / 1e3 for t in k_info["times_ms"]],
         k_info.pop("state")),
        (e_info["losses"], [t / 1e3 for t in e_info["times_ms"]],
         e_info.pop("state")),
        k_info.pop("events"), ("train",))
    for info in (r_info, e_info, g_info, y_info):
        for k in ("units", "state", "events"):
            info.pop(k, None)
    layers = cfg["layers"]
    want_fusions = {"attention": layers, "epilogue": 6 * layers + 2,
                    "layernorm": 1}
    if k_info["fusions"] != want_fusions:
        problems.append(f"fusions {k_info['fusions']} != {want_fusions}")
    n_leaves = len(k_params)
    # the launches the gates chose under the standing tuning table, from
    # the steps' and the output's dispatch tallies (the encoder's 6 a
    # layer, the head's dense and classifier at M 4096, its LayerNorm)
    n_fused = 6 * layers + 2
    gates = {}
    for window, disp, per in (("steps", k_info["step_dispatch"],
                               FINETUNE_STEPS),
                              ("output", k_info["output_dispatch"], 1)):
        got = {}
        for op, calls, floor in (("fused_matmul_bias_act", n_fused,
                                  6 * layers),
                                 ("dot_product_attention", layers, layers),
                                 ("fused_layer_norm", 1, 1)):
            n, more = gated(disp, op, calls * per, floor * per)
            problems += [f"{window}: {p}" for p in more]
            got[op] = n // per
        gates[window] = got
    mm, fa, ln = (gates["steps"][op] for op in (
        "fused_matmul_bias_act", "dot_product_attention", "fused_layer_norm"))
    per_step = {"fused_layer_norm": ln, "flash_attn_fwd": fa,
                "flash_attn_dq": fa, "flash_attn_dkv": fa,
                "flash_attn_fwd_sm90": 0, "flash_attn_dq_sm90": 0,
                "flash_attn_dkv_sm90": 0, "flash_attn_fwd_f32_sm90": fa,
                "flash_attn_dq_f32_sm90": fa,
                "flash_attn_dkv_f32_sm90": fa,
                "fused_matmul_bias_act": mm,
                "fused_matmul_bias_act_sm90": 0,
                "fused_matmul_bias_act_f32_sm90": mm}
    for name, n in per_step.items():
        if launches[name] != n * FINETUNE_STEPS:
            problems.append(f"{name} launches {launches[name]} != {n} x "
                            f"{FINETUNE_STEPS} steps")
    problems += updater_count_problems(launches["fused_updater"],
                                       k_info["fused_updater_leaves"],
                                       n_leaves, FINETUNE_STEPS)
    # one K-major split copy of each kernel matmul's weight a step: the
    # updater's new weights are new tensors
    if k_info["kmajor_copies"] != mm * FINETUNE_STEPS:
        problems.append(f"K-major weight copies {k_info['kmajor_copies']} != "
                        f"{mm} x {FINETUNE_STEPS} steps")
    want_out = {"fused_layer_norm": gates["output"]["fused_layer_norm"],
                "fused_matmul_bias_act": gates["output"][
                    "fused_matmul_bias_act"]}
    if k_info["output_launches"] != want_out:
        problems.append(f"output launches {k_info['output_launches']} != "
                        f"{want_out}")
    refit = {k: r_info[k] for k in ("bits_equal_eager", "max_abs_diff_eager",
                                    "changed_by_fit", "graph_unit")}
    if not (refit["bits_equal_eager"] and refit["changed_by_fit"]
            and refit["graph_unit"]["captures"] == 1):
        problems.append(f"sd.output captured before the steps, replayed "
                        f"after them: {refit}")
    kernel, generic, yard = (i["losses"] for i in (k_info, g_info, y_info))
    if not all(math.isfinite(v) for v in kernel + generic + yard):
        problems.append("non-finite loss")
    loss_lim = [max(BERT_LOSS_RTOL["float32"] * abs(g), 0.0 if i == 0 else
                    BERT_YARDSTICK * abs(y - g))
                for i, (g, y) in enumerate(zip(generic, yard))]
    loss_diff = [abs(a - b) for a, b in zip(kernel, generic)]
    if any(d > lim for d, lim in zip(loss_diff, loss_lim)):
        problems.append(f"losses {kernel} vs generic {generic} "
                        f"(limits {loss_lim})")
    if not kernel[-1] < kernel[0]:
        problems.append(f"loss did not fall: {kernel}")
    big = max(t.abs().max().item() for t in g_params.values())
    p_diff = _max_diff(k_params, g_params)
    p_lim = max(BERT_YARDSTICK * _max_diff(y_params, g_params),
                torch.finfo(torch.float32).eps * big)
    if p_diff > p_lim:
        problems.append(f"params {p_diff} > {p_lim}")
    shape = (cfg["batch"], cfg["seq"], ob.NER_TAGS)
    if k_out.shape != shape or not np.all(np.isfinite(k_out)):
        problems.append(f"output {k_out.shape} not finite")
    out_diff = float(np.abs(k_out - g_out).max())
    tokens = cfg["batch"] * cfg["seq"]
    real = float(feeds["mask"].sum())
    p50 = k_info["step_p50_ms"] / 1e3
    line = {"phase": "sd_bert_finetune", "card": smi, "config": cfg,
            "head": "dense 768x768 -> layer_norm -> gelu -> 768x9 "
                    "(CoNLL-2003 BIO tags), softmax cross entropy",
            "weights": "float32, numpy RandomState(0) * 0.02; head "
                       "RandomState(2)",
            "updater": f"Adam lr {FINETUNE_LR:g}", "steps": FINETUNE_STEPS,
            "leaves": n_leaves, "params": n_params,
            "param_bytes": 4 * n_params, "adam_state_bytes": 8 * n_params,
            "launches": launches, "gated": gates,
            "launches_per_step": {k: v / FINETUNE_STEPS
                                  for k, v in launches.items()},
            "kernel": k_info, "generic": g_info,
            "generic_weights_moved_1_ulp": y_info,
            "loss_abs_diff": loss_diff, "loss_limit": loss_lim,
            "param_max_abs_diff": p_diff, "param_limit": p_lim,
            "output_max_abs_diff_vs_generic": out_diff,
            "output_captured_before_fit_replayed_after": refit,
            "tol": (f"step-1 loss {BERT_LOSS_RTOL['float32']:g} relative; "
                    f"later losses and params {BERT_YARDSTICK:g} x "
                    f"yardstick"),
            "smoke_reading": f"{FINETUNE_STEPS} steps, no spread",
            "step_p50_ms": k_info["step_p50_ms"], "tokens_per_s": tokens / p50,
            "real_tokens_per_s": real / p50,
            "generic_step_p50_ms": g_info["step_p50_ms"],
            "peak_memory_gib": k_info["peak_memory_gib"],
            "peak_memory_own_gib": k_info["peak_memory_gib"]
            - k_info["resident_before_gib"], **cap_fields,
            "problems": problems}
    return problems, line, launches


def tf_bert_phase(dev, smi):
    """TF import at BERT-base width, without TensorFlow: the port's builder
    writes a frozen google-research/bert GraphDef (``testing/tf_builder``,
    ~440 MB of float32 ``Const`` weights), ``import_frozen_graph`` puts it
    on the card (parse and import seconds printed), ``sd.output`` runs the
    logits, a softmax cross entropy is added in SameDiff and ``sd.fit``
    takes 3 Adam steps through the kernels (counts set to 0 just before
    the forward and just before the steps, read just after each); then
    the same steps op by op (captured against eager, bit for bit), under
    ``helper_mode="generic"`` from the same weights and from weights moved
    by one unit in the last place (the yardstick); the forward once more
    through ``GraphRunner``; and a SameDiff graph with a data-dependent
    ``while_loop``, routed to eager, against its CPU run. Returns
    (problems, line, launches of the counted forward and steps)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import (
        GraphRunner, TensorflowImporter, import_frozen_graph, tf_proto)
    from deeplearning4j_tpu_torch.nn.compiled import CONTROL_FLOW, TrainUnits
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.profile_serve import _profile
    from deeplearning4j_tpu_torch.testing import tf_builder as tb

    cfg = tb.BERT_BASE_TF
    layers = cfg["layers"]
    n_fused = 6 * layers + 2  # six dense layers a layer, pooler, classifier
    env = environment()
    t0 = time.perf_counter()
    data = tb.bert_tf_graph(**cfg)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gd = tf_proto.parse_graph_def(data)  # the references' imports reuse it
    parse_s = time.perf_counter() - t0
    feeds = tb.tf_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    names = ["input_ids", "input_mask", "segment_ids"]
    labels = tb.class_labels(cfg["batch"])
    batch = types.SimpleNamespace(features=[feeds[n] for n in names],
                                  labels=labels,
                                  num_examples=lambda: cfg["batch"])

    def build(source, nudge=False):
        if isinstance(source, bytes):
            sd = import_frozen_graph(source, device=dev)
        else:
            sd = TensorflowImporter(device=dev).run_import(source)
        lab = sd.placeholder("labels", (cfg["batch"], 2))
        sd.loss.softmax_cross_entropy(sd.get_variable("logits"),
                                      lab).rename("loss")
        sd.set_training_config(TrainingConfig(
            updater=Adam(learning_rate=FINETUNE_LR),
            data_set_feature_mapping=names, data_set_label_mapping=["labels"],
            loss_variables=["loss"]))
        if nudge:
            moved = _nudged(sd.training_state()["params"],
                            np.random.default_rng(9))
            for n, t in moved.items():
                sd.set_arr(n, t)
        return sd

    def run(mode, *, source=gd, nudge=False, counted=False, eager=False):
        """Import, the logits' forward twice (the second counted), 3 fit
        steps (counted), the logits after them."""
        env.helper_mode = mode
        if counted:
            observe.reset()
        try:
            resident = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sd = build(source, nudge)
            torch.cuda.synchronize()
            info = {"import_s": time.perf_counter() - t0,
                    "check_s": sd.last_check_report.seconds}
            n_params = sum(a.numel() for n, a in sd._arrays.items()
                           if sd._vars[n].vtype == "VARIABLE")
            with _eager_if(eager or mode != "auto"):
                t0 = time.perf_counter()
                sd.output(feeds, ["logits"])  # builds the plan, captures
                info["first_forward_s"] = time.perf_counter() - t0
                if counted:
                    disp0 = dispatch_tally()
                    _zero_counters()  # the main path's forward starts here
                out = sd.output(feeds, ["logits"])["logits"]
                if counted:
                    info["forward_launches"] = _read_counters()  # ... ends
                    info["forward_dispatch"] = dispatch_since(disp0)
                st = sd.last_compile_stats
                info.update(fusions=st.fusions, plan_nodes=st.nodes_after,
                            nodes=len(sd._nodes))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if counted:
                    copies0 = cm.kmajor_weight.copies
                    _zero_counters()  # the main path's steps start here
                losses, times = [], []
                for _ in range(FINETUNE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses += sd.fit([batch])
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                if counted:
                    info["step_launches"] = _read_counters()  # ... end here
                    # the updater's new weights: new K-major split copies
                    info["kmajor_copies"] = cm.kmajor_weight.copies - copies0
            info["events"] = list(observe.ledger().events())
            info["units"] = {k[0]: types.SimpleNamespace(
                captures=u.units["train"].captures,
                moved=u.units["train"].moved,
                pool_bytes=u.units["train"].pool_bytes,
                static_bytes=u.units["train"].static_bytes)
                for k, u in sd._jit_cache.items()
                if isinstance(u, TrainUnits) and "train" in u.units}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            params = {n: t.clone() for n, t in
                      sd.training_state()["params"].items()}
            info.update(
                losses=losses, times_ms=[t * 1e3 for t in times],
                step_p50_ms=float(np.percentile(times, 50)) * 1e3,
                peak_memory_gib=peak, resident_before_gib=resident,
                params=n_params, leaves=len(params),
                state=_clone_tree([params,
                                   sd.training_state()["opt_state"]]))
            with _eager_if(eager or mode != "auto"):
                after = sd.output(feeds, ["logits"])["logits"]
            if counted:
                # where the step's time goes (device busy share), over two
                # more replayed steps, after the counted ones
                info["profile"] = _profile(lambda: sd.fit([batch, batch]), 1,
                                           steps_per_call=2, top=8)
            del sd
            gc.collect()  # a captured graph's cycle back to sd, and its pool
            torch.cuda.empty_cache()
            return info, out, params, after
        finally:
            env.helper_mode = "auto"

    k_info, k_out, k_params, k_after = run("auto", source=data, counted=True)
    e_info = run("auto", eager=True)[0]
    g_info, g_out, g_params, g_after = run("generic")
    y_info, _, y_params, _ = run("generic", nudge=True)

    problems, cap_fields = capture_fields(
        k_info.pop("units"),
        (k_info["losses"], [t / 1e3 for t in k_info["times_ms"]],
         k_info.pop("state")),
        (e_info["losses"], [t / 1e3 for t in e_info["times_ms"]],
         e_info.pop("state")),
        k_info.pop("events"), ("train",))
    for info in (e_info, g_info, y_info):
        for k in ("units", "state", "events"):
            info.pop(k, None)
    want_fusions = {"attention": layers, "epilogue": n_fused}
    for label, info in (("kernel", k_info), ("generic", g_info)):
        if info["fusions"] != want_fusions:
            problems.append(f"{label} fusions {info['fusions']} != "
                            f"{want_fusions}")
    fwd, step = k_info["forward_launches"], k_info["step_launches"]
    # the fused matmuls and attentions the gates send to the kernels under
    # the standing tuning table (the pooler's and the classifier's M of 32
    # lies below a measured crossover where the card's table has one):
    # the counted forward's dispatch tally; the encoder's stay on them
    disp = k_info["forward_dispatch"]
    n_kernel, gate_problems = gated(disp, "fused_matmul_bias_act", n_fused,
                                    floor=6 * layers)
    n_flash, more = gated(disp, "dot_product_attention", layers,
                          floor=layers)
    problems += gate_problems + more
    per_forward = {"flash_attn_fwd": n_flash,
                   "flash_attn_fwd_f32_sm90": n_flash,
                   "flash_attn_dq": 0, "flash_attn_dkv": 0,
                   "fused_matmul_bias_act": n_kernel,
                   "fused_matmul_bias_act_f32_sm90": n_kernel,
                   "fused_layer_norm": 0, "fused_updater": 0}
    per_step = {"flash_attn_fwd": n_flash, "flash_attn_dq": n_flash,
                "flash_attn_dkv": n_flash, "flash_attn_fwd_sm90": 0,
                "flash_attn_dq_sm90": 0, "flash_attn_dkv_sm90": 0,
                "flash_attn_fwd_f32_sm90": n_flash,
                "flash_attn_dq_f32_sm90": n_flash,
                "flash_attn_dkv_f32_sm90": n_flash,
                "fused_matmul_bias_act": n_kernel,
                "fused_matmul_bias_act_sm90": 0,
                "fused_matmul_bias_act_f32_sm90": n_kernel,
                "fused_layer_norm": 0}
    for name, n in per_forward.items():
        if fwd[name] != n:
            problems.append(f"forward: {name} launches {fwd[name]} != {n}")
    for name, n in per_step.items():
        if step[name] != n * FINETUNE_STEPS:
            problems.append(f"steps: {name} launches {step[name]} != {n} x "
                            f"{FINETUNE_STEPS} steps")
    problems += updater_count_problems(step["fused_updater"],
                                       step["fused_updater_leaves"],
                                       k_info["leaves"], FINETUNE_STEPS)
    if k_info["kmajor_copies"] != n_kernel * FINETUNE_STEPS:
        problems.append(f"K-major weight copies {k_info['kmajor_copies']} != "
                        f"{n_kernel} x {FINETUNE_STEPS} steps")
    kernel, generic, yard = (i["losses"] for i in (k_info, g_info, y_info))
    if not all(math.isfinite(v) for v in kernel + generic + yard):
        problems.append("non-finite loss")
    loss_lim = [max(BERT_LOSS_RTOL["float32"] * abs(g), 0.0 if i == 0 else
                    BERT_YARDSTICK * abs(y - g))
                for i, (g, y) in enumerate(zip(generic, yard))]
    loss_diff = [abs(a - b) for a, b in zip(kernel, generic)]
    if any(d > lim for d, lim in zip(loss_diff, loss_lim)):
        problems.append(f"losses {kernel} vs generic {generic} "
                        f"(limits {loss_lim})")
    if not kernel[-1] < kernel[0]:
        problems.append(f"loss did not fall: {kernel}")
    big = max(t.abs().max().item() for t in g_params.values())
    p_diff = _max_diff(k_params, g_params)
    p_lim = max(BERT_YARDSTICK * _max_diff(y_params, g_params),
                torch.finfo(torch.float32).eps * big)
    if p_diff > p_lim:
        problems.append(f"params {p_diff} > {p_lim}")
    shape = (cfg["batch"], 2)
    for label, y in (("kernel", k_out), ("generic", g_out),
                     ("kernel after fit", k_after)):
        if y.shape != shape or not np.all(np.isfinite(y)):
            problems.append(f"{label} logits {y.shape} not finite")
    fwd_diff = float(np.abs(k_out - g_out).max())
    if fwd_diff > TF_BERT_TOL:
        problems.append(f"forward vs generic max abs diff {fwd_diff} > "
                        f"{TF_BERT_TOL}")

    # the same forward through GraphRunner (its own import, captured)
    runner = GraphRunner(data, device=dev)
    r_out = runner.run(feeds, ["logits"])["logits"]
    r_out = runner.run(feeds, ["logits"])["logits"]
    runner_diff = float(np.abs(r_out - k_out).max())
    runner_info = {"framework": runner.framework,
                   "fusions": runner.compile_stats.fusions,
                   "max_abs_diff_vs_forward": runner_diff,
                   "bits_equal_forward": bool(np.array_equal(r_out, k_out))}
    if runner.framework != "tensorflow" or runner_diff > TF_BERT_TOL:
        problems.append(f"GraphRunner {runner_info}")
    del runner
    gc.collect()
    torch.cuda.empty_cache()

    # a data-dependent while loop built through the SameDiff API: its
    # predicate is read on the host, so sd.output routes it to eager, once
    def while_graph(device):
        sd = SameDiff(device=device)
        x = sd.placeholder("x", (TF_WHILE_N,))
        sd.while_loop(lambda v: v.sum() < TF_WHILE_LIMIT,
                      lambda v: v * 2.0 + 1.0, x).rename("y")
        return sd

    xw = np.random.RandomState(5).randint(0, 8, TF_WHILE_N).astype(
        np.float32)
    w_cpu = while_graph("cpu").output({"x": xw}, "y")["y"]
    observe.reset()
    sdw = while_graph(dev)
    w_gpu = sdw.output({"x": xw}, "y")["y"]
    routed = [[e.key, e.reason] for e in observe.ledger().routed_events()
              if e.graph == "samediff"]
    skipped = observe.metrics().counter("dl4j_tpu_capture_skipped_total",
                                        unit="exec",
                                        reason=CONTROL_FLOW).value
    w_info = {"n": TF_WHILE_N, "limit": TF_WHILE_LIMIT,
              "equal_cpu": bool(np.array_equal(w_gpu, w_cpu)),
              "trips": int(round(math.log2((float(w_gpu[0]) + 1.0)
                                           / (float(xw[0]) + 1.0)))),
              "routed": routed, "capture_skipped_total": skipped,
              "captures": exec_unit(sdw, ["y"]).captures}
    if not (w_info["equal_cpu"] and routed == [["exec", CONTROL_FLOW]]
            and skipped == 1 and w_info["captures"] == 0):
        problems.append(f"while graph {w_info}")

    tokens = cfg["batch"] * cfg["seq"]
    real = float(feeds["input_mask"].sum())
    p50 = k_info["step_p50_ms"] / 1e3
    prof = k_info.pop("profile")
    weight_bytes = 4 * k_info["params"]
    line = {"phase": "tf_bert", "card": smi, "config": cfg,
            "graph": "google-research/bert modeling.py layout, frozen "
                     "(Const weights), pooler + 2-way classifier; key mask",
            "weights": "float32, numpy RandomState(0) * 0.02",
            "graph_bytes": len(data), "build_bytes_s": build_s,
            "parse_s": parse_s, "import_s": k_info["import_s"],
            "import_weight_gb_per_s": weight_bytes / k_info["import_s"] / 1e9,
            "updater": f"Adam lr {FINETUNE_LR:g}", "steps": FINETUNE_STEPS,
            "loss": "softmax cross entropy on the logits, added in SameDiff",
            "leaves": k_info["leaves"], "params": k_info["params"],
            "forward_launches": fwd, "step_launches": step,
            "launches_per_step": {k: v / FINETUNE_STEPS
                                  for k, v in step.items()},
            "kernel": k_info, "eager": e_info, "generic": g_info,
            "generic_weights_moved_1_ulp": y_info,
            "forward_max_abs_diff_vs_generic": fwd_diff, "tol": TF_BERT_TOL,
            "loss_abs_diff": loss_diff, "loss_limit": loss_lim,
            "param_max_abs_diff": p_diff, "param_limit": p_lim,
            "loss_tol": (f"step-1 loss {BERT_LOSS_RTOL['float32']:g} "
                         f"relative; later losses and params "
                         f"{BERT_YARDSTICK:g} x yardstick"),
            "graph_runner": runner_info, "while_loop": w_info,
            "smoke_reading": f"{FINETUNE_STEPS} steps, no spread",
            "step_p50_ms": k_info["step_p50_ms"],
            "eager_step_p50_ms": e_info["step_p50_ms"],
            "generic_step_p50_ms": g_info["step_p50_ms"],
            "tokens_per_s": tokens / p50, "real_tokens_per_s": real / p50,
            "device_busy_share": prof["device_busy_share"], "profile": prof,
            "peak_memory_gib": k_info["peak_memory_gib"],
            "peak_memory_own_gib": k_info["peak_memory_gib"]
            - k_info["resident_before_gib"], **cap_fields,
            "problems": problems}
    launches = {k: fwd.get(k, 0) + v for k, v in step.items()}
    return problems, line, launches


def _zero_counters():
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    for _, w, a in _kernel_counters():
        setattr(w, a, 0)
    cu.fused_updater.leaves = 0


def _read_counters() -> dict:
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    out = {name: getattr(w, a) for name, w, a in _kernel_counters()}
    out["fused_updater_leaves"] = cu.fused_updater.leaves
    return out


def sd_namespaces_phase(dev, smi):
    """A SameDiff graph built through the public namespaces alone at
    BERT-base width (``testing/namespace_encoder.py``): ``sd.output`` of
    the logits and loss, then ``sd.fit`` for 3 Adam steps, then the
    logits again, through the kernels (counts set to 0 just before the
    forward and just before the steps, read just after each); then the
    same under ``helper_mode="generic"`` from the same weights and from
    weights moved by one unit in the last place (the yardstick). Returns
    (problems, line, launches of the 3 steps)."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.profile_serve import _profile
    from deeplearning4j_tpu_torch.testing import namespace_encoder as ne

    cfg = ne.BERT_BASE
    env = environment()
    weights = ne.encoder_weights(cfg)
    x, labels = ne.encoder_batch(cfg)
    feeds = {"x": x, "labels": labels}
    batch = ne.Batch(x, labels)
    layers = cfg["layers"]

    def run(mode, *, nudge=False, counted=False):
        env.helper_mode = mode
        try:
            sd = SameDiff(device=dev)
            logits, loss = ne.build_encoder(sd, cfg, weights)
            sd.set_training_config(TrainingConfig(
                updater=Adam(learning_rate=FINETUNE_LR),
                data_set_feature_mapping=["x"],
                data_set_label_mapping=["labels"], loss_variables=[loss]))
            if nudge:
                moved = _nudged(sd.training_state()["params"],
                                np.random.default_rng(9))
                for n, t in moved.items():
                    sd.set_arr(n, t)
            info = {}
            torch.cuda.synchronize()
            disp0 = dispatch_tally()
            _zero_counters()  # the forward's main path starts here
            out = sd.output(feeds, [logits, loss])
            torch.cuda.synchronize()
            info["forward_launches"] = _read_counters()  # ... ends here
            info["forward_dispatch"] = dispatch_since(disp0)
            losses, times = [], []
            disp0 = dispatch_tally()
            _zero_counters()  # the steps' main path starts here
            for _ in range(FINETUNE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses += sd.fit([batch])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            info["step_launches"] = _read_counters()  # ... ends here
            info["step_dispatch"] = dispatch_since(disp0)
            params = {n: t.clone() for n, t in
                      sd.training_state()["params"].items()}
            after = sd.output(feeds, [logits])[logits]
            info.update(losses=losses, times_ms=[t * 1e3 for t in times],
                        step_p50_ms=float(np.percentile(times, 50)) * 1e3,
                        fusions=sd.last_compile_stats.fusions,
                        plan_nodes=sd.last_compile_stats.nodes_after)
            if counted:
                # where the step's time goes (device busy share), over two
                # more replayed steps, after the counted ones
                info["profile"] = _profile(lambda: sd.fit([batch, batch]), 1,
                                           steps_per_call=2, top=8)
            del sd
            gc.collect()
            torch.cuda.empty_cache()
            return info, out[logits], float(out[loss]), after, params
        finally:
            env.helper_mode = "auto"

    k_info, k_out, k_loss0, k_after, k_params = run("auto", counted=True)
    g_info, g_out, g_loss0, g_after, g_params = run("generic")
    y_info, y_out, _, y_after, y_params = run("generic", nudge=True)

    problems = []
    fwd, step = k_info["forward_launches"], k_info["step_launches"]
    # the attentions the gates send to the flash kernels under the
    # standing tuning table, from each window's dispatch tally
    n_fwd, more = gated(k_info["forward_dispatch"], "dot_product_attention",
                        layers, floor=layers)
    n_step, more2 = gated(k_info["step_dispatch"], "dot_product_attention",
                          layers * FINETUNE_STEPS,
                          floor=layers * FINETUNE_STEPS)
    problems += more + more2
    want_fwd = {"flash_attn_fwd": n_fwd, "flash_attn_dq": 0,
                "flash_attn_dkv": 0, "fused_updater": 0}
    want_step = {"flash_attn_fwd": n_step, "flash_attn_dq": n_step,
                 "flash_attn_dkv": n_step}
    for name, n in want_fwd.items():
        if fwd[name] != n:
            problems.append(f"forward: {name} launches {fwd[name]} != {n}")
    for name, n in want_step.items():
        if step[name] != n:
            problems.append(f"steps: {name} launches {step[name]} != {n}")
    n_leaves = len(k_params)
    problems += updater_count_problems(step["fused_updater"],
                                       step["fused_updater_leaves"],
                                       n_leaves, FINETUNE_STEPS)
    # the generic runs launch no flash kernel
    for info in (g_info, y_info):
        for name, n in dict(info["forward_launches"],
                            **info["step_launches"]).items():
            if n and name.startswith("flash"):
                problems.append(f"generic run launched {name} {n} times")
    kernel, generic, yard = (i["losses"] for i in (k_info, g_info, y_info))
    if not all(math.isfinite(v) for v in kernel + generic + yard):
        problems.append("non-finite loss")
    loss_lim = [max(BERT_LOSS_RTOL["float32"] * abs(g), 0.0 if i == 0 else
                    BERT_YARDSTICK * abs(y - g))
                for i, (g, y) in enumerate(zip(generic, yard))]
    loss_diff = [abs(a - b) for a, b in zip(kernel, generic)]
    if any(d > lim for d, lim in zip(loss_diff, loss_lim)):
        problems.append(f"losses {kernel} vs generic {generic} "
                        f"(limits {loss_lim})")
    big = max(t.abs().max().item() for t in g_params.values())
    p_diff = _max_diff(k_params, g_params)
    p_lim = max(BERT_YARDSTICK * _max_diff(y_params, g_params),
                torch.finfo(torch.float32).eps * big)
    if p_diff > p_lim:
        problems.append(f"params {p_diff} > {p_lim}")
    # the forward before the steps: the same weights, 1e-5 of the largest
    # logit or 3x the yardstick's distance; the logits after them as the
    # parameters are held
    out_diff = float(np.abs(k_out - g_out).max())
    out_lim = max(BERT_LOSS_RTOL["float32"] * float(np.abs(g_out).max()),
                  BERT_YARDSTICK * float(np.abs(y_out - g_out).max()))
    after_diff = float(np.abs(k_after - g_after).max())
    after_lim = max(BERT_LOSS_RTOL["float32"] * float(np.abs(g_after).max()),
                    BERT_YARDSTICK * float(np.abs(y_after - g_after).max()))
    if out_diff > out_lim or after_diff > after_lim:
        problems.append(f"logits {out_diff} (limit {out_lim}), after the "
                        f"steps {after_diff} (limit {after_lim})")
    if abs(k_loss0 - g_loss0) > BERT_LOSS_RTOL["float32"] * abs(g_loss0):
        problems.append(f"forward loss {k_loss0} vs generic {g_loss0}")
    shape = (cfg["batch"], cfg["classes"])
    if k_out.shape != shape or not np.all(np.isfinite(k_after)):
        problems.append(f"logits {k_out.shape} != {shape} or not finite")
    n_params = sum(t.numel() for t in k_params.values())
    step_launches = {k: v for k, v in step.items()
                     if k != "fused_updater_leaves"}
    # the main path's launches: the counted forward and the 3 steps
    path_launches = {k: v + fwd[k] for k, v in step_launches.items()}
    line = {"phase": "sd_namespaces", "card": smi, "config": cfg,
            "graph": "per layer: sd.nn.multi_head_dot_product_attention, "
                     "add, sd.nn.layer_norm, sd.nn.linear 768x3072, "
                     "sd.nn.gelu, sd.nn.linear 3072x768, add, "
                     "sd.nn.layer_norm; mean over T, sd.nn.linear 768x2, "
                     "sd.loss.softmax_cross_entropy",
            "weights": "float32, numpy RandomState(0) * 0.02",
            "updater": f"Adam lr {FINETUNE_LR:g}", "steps": FINETUNE_STEPS,
            "leaves": n_leaves, "params": n_params,
            "fusions": k_info["fusions"], "plan_nodes": k_info["plan_nodes"],
            "forward_launches": {k: v for k, v in fwd.items() if v},
            "launches_per_step": {k: v / FINETUNE_STEPS
                                  for k, v in step_launches.items() if v},
            "losses": kernel, "generic_losses": generic,
            "yardstick_losses": yard, "loss_abs_diff": loss_diff,
            "loss_limit": loss_lim, "param_max_abs_diff": p_diff,
            "param_limit": p_lim, "logits_max_abs_diff": out_diff,
            "logits_limit": out_lim,
            "logits_after_steps_max_abs_diff": after_diff,
            "logits_after_steps_limit": after_lim,
            "loss_fell": kernel[-1] < kernel[0],
            "tol": (f"step-1 loss and the first forward "
                    f"{BERT_LOSS_RTOL['float32']:g} relative; later losses, "
                    f"params and logits {BERT_YARDSTICK:g} x yardstick"),
            "step_ms": k_info["times_ms"],
            "step_p50_ms": k_info["step_p50_ms"],
            "generic_step_p50_ms": g_info["step_p50_ms"],
            "tokens_per_s": cfg["batch"] * cfg["seq"]
            / (k_info["step_p50_ms"] / 1e3),
            "profile_2_steps": k_info["profile"], "problems": problems}
    return problems, line, path_launches


def op_catalog_phase(dev, smi):
    """Every spec of the port's validation table in every dtype it takes,
    through the registry on the card and on the CPU
    (``testing/consistency.run_catalog``). Returns (problems, line)."""
    from deeplearning4j_tpu_torch.testing.consistency import run_catalog

    out = run_catalog(dev)
    problems = list(out["failed"])
    if out["uncovered"]:
        problems.append(f"ops with no spec: {out['uncovered']}")
    line = {"phase": "op_catalog", "card": smi, "ops": out["ops"],
            "cases": out["cases"], "failures": out["failures"],
            "seconds": out["seconds"], "failed": out["failed"],
            "problems": problems}
    return problems, line


def _rel_err(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def int8_bert_phase(dev, smi, onnx_line, float32_out, keep=None):
    """int8 serving: the BERT-base encoder with every dense MatMul a
    ``matmul_int8``, recorded through ``SameDiff`` from onnx_bert's weights
    and run by ``sd.output`` — through the kernels, with
    ``helper_mode="generic"``, generic from an embedding table moved by one
    unit in the last place (the yardstick), and generic with each column
    de-scaled by its neighbour's scale (the gross fault the float32 bound
    must catch). ``keep`` (a dict), when given, receives the counted
    run's graph, feeds and ``y`` (``export_bindings`` exports it).
    Returns (problems, line, launches of the main path's forward)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.testing import int8_bert as ib
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob

    cfg = ob.BERT_BASE_ONNX
    env = environment()
    t0 = time.perf_counter()
    arrays = ob.bert_onnx_weights(**{k: cfg[k] for k in (
        "layers", "seq", "d", "ff", "vocab")})
    draw_s = time.perf_counter() - t0
    feeds = ob.bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    nudged = dict(arrays, emb=_nudged(torch.from_numpy(arrays["emb"]),
                                      np.random.default_rng(10)).numpy())
    dense = [k for k, a in arrays.items() if a.ndim == 2
             and k not in ("emb", "pos")]
    int8_bytes = sum(arrays[k].size + 4 * arrays[k].shape[1] for k in dense)

    def run(mode, weights, *, counted=False, timed=True):
        """Build, [2 warm, the counted, 5 timed forwards of y], then y and
        the last hidden state."""
        env.helper_mode = mode
        try:
            gc.collect()  # an earlier graph's reference cycles, freed now
            resident = torch.cuda.memory_allocated()
            if counted:
                observe.reset()  # the ledger from here holds this graph's
            copies0 = cq.kmajor_weight.copies
            t0 = time.perf_counter()
            sd = SameDiff(device=dev)
            ib.bert_int8_encoder(sd, weights, batch=cfg["batch"],
                                 seq=cfg["seq"], heads=cfg["heads"])
            torch.cuda.synchronize()
            info = {"build_s": time.perf_counter() - t0}
            launches = None
            if timed:
                t0 = time.perf_counter()
                sd.output(feeds, ["y"])  # the first forward builds the plan
                info["first_forward_s"] = time.perf_counter() - t0
                sd.output(feeds, ["y"])
            if counted:
                ledger = samediff_ledger(observe)
                observe.reset()
                ca.reset_launch_counts()
                cq.reset_launch_counts()
                cm.fused_matmul.launches = 0  # the main path starts here
                copies1 = cq.kmajor_weight.copies
                sd.output(feeds, ["y"])
                info["kmajor_copies"] = {  # the sm90 GEMM's weight copies
                    "build_to_counted": cq.kmajor_weight.copies - copies0,
                    "counted_forward": cq.kmajor_weight.copies - copies1}
                launches = dict(
                    matmul_int8=cq.int8_matmul.launches,
                    matmul_int8_sm90=cq.int8_matmul.sm90_launches,
                    matmul_int8_row_quantize=cq.row_quantize.launches,
                    flash_attn_fwd=ca.flash_attention.launches,
                    flash_attn_fwd_sm90=ca.flash_attention.sm90_launches,
                    flash_attn_fwd_f32_sm90=ca.flash_attention
                    .sm90_f32_launches,
                    fused_matmul_bias_act=cm.fused_matmul.launches)  # ... ends
                launches["dispatch"] = dispatch_tally()  # reset above
            if timed:
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(INT8_BERT_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = sd.output(feeds, ["y"])["y"]
                    times.append(time.perf_counter() - t0)
                st = sd.last_compile_stats
                info.update(
                    p50_ms=float(np.percentile(times, 50)) * 1e3,
                    times_ms=[t * 1e3 for t in times],
                    peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    peak_memory_own_gib=(torch.cuda.max_memory_allocated()
                                         - resident) / 2 ** 30,
                    nodes_before=st.nodes_before, nodes_after=st.nodes_after,
                    fusions=st.fusions, trace_s=st.trace_seconds,
                    capture_s=st.compile_seconds)
            if counted:
                info.update(captured_vs_eager(sd, feeds, ["y"], y,
                                              INT8_BERT_TIMED),
                            ledger=ledger)
            out = sd.output(feeds, ["y", "hidden"])
            if counted and keep is not None:
                keep.update(sd=sd, feeds=feeds, y=out["y"])
            del sd
            torch.cuda.empty_cache()
            return out, info, launches
        finally:
            env.helper_mode = "auto"

    k_out, k_info, launches = run("auto", arrays, counted=True)
    g_out, g_info, _ = run("generic", arrays)
    n_out, _, _ = run("generic", nudged, timed=False)
    real_quantize = ib.quantize_weight
    try:  # the gross fault: each column de-scaled by its neighbour's scale
        ib.quantize_weight = lambda w: (lambda q, s: (q, np.roll(s, 1, 1)))(
            *real_quantize(w))
        bad_out, _, _ = run("generic", arrays, timed=False)
    finally:
        ib.quantize_weight = real_quantize

    problems = []
    layers = cfg["layers"]
    n_dense = 6 * layers + 1
    # the gates' decisions under the standing tuning table, from the
    # counted forward's dispatch tally: every dense layer and attention
    # at M 4096 / T 128 stays on the kernels
    n_q, more = gated(launches["dispatch"], "matmul_int8", n_dense,
                      floor=n_dense)
    n_fa, more2 = gated(launches["dispatch"], "dot_product_attention",
                        layers, floor=layers)
    problems += more + more2
    want = {"matmul_int8": n_q, "matmul_int8_sm90": n_q,
            "matmul_int8_row_quantize": n_q,
            "flash_attn_fwd": n_fa, "flash_attn_fwd_sm90": 0,
            "flash_attn_fwd_f32_sm90": n_fa, "fused_matmul_bias_act": 0}
    for name, n in want.items():
        if launches[name] != n:
            problems.append(f"{name} launches {launches[name]} != {n}")
    # one K-major copy a kernel GEMM's weight, made before the counted
    # forward
    if k_info["kmajor_copies"] != {"build_to_counted": n_q,
                                   "counted_forward": 0}:
        problems.append(f"K-major weight copies {k_info['kmajor_copies']} != "
                        f"{n_q} before the counted forward, 0 in it")
    problems += captured_problems(k_info)
    shapes = {"y": (cfg["batch"], cfg["seq"], 2),
              "hidden": (cfg["batch"], cfg["seq"], cfg["d"])}
    checks = {}
    for name, shape in shapes.items():
        for label, out in (("kernel", k_out), ("generic", g_out),
                           ("generic_nudged", n_out)):
            if out[name].shape != shape or not np.all(np.isfinite(out[name])):
                problems.append(f"{label} {name} {out[name].shape} not finite")
        diff = float(np.abs(k_out[name] - g_out[name]).max())
        yard = float(np.abs(n_out[name] - g_out[name]).max())
        checks[name] = {"kernel_vs_generic_max_abs": diff,
                        "yardstick_max_abs": yard,
                        "limit": INT8_BERT_YARDSTICK * yard}
        if not diff <= INT8_BERT_YARDSTICK * yard:
            problems.append(f"{name}: kernel vs generic {diff} > "
                            f"{INT8_BERT_YARDSTICK} x yardstick {yard}")
    h, hf = k_out["hidden"], float32_out["hidden"]
    cos = (h * hf).sum(-1) / (np.linalg.norm(h, axis=-1)
                              * np.linalg.norm(hf, axis=-1))
    vs_f32 = {"hidden_rel_err": _rel_err(h, hf),
              "hidden_cosine": float(h.ravel() @ hf.ravel()
                                     / (np.linalg.norm(h) * np.linalg.norm(hf))),
              "hidden_min_token_cosine": float(cos.min()),
              "hidden_max_abs_err": float(np.abs(h - hf).max()),
              "y_max_abs_err": float(np.abs(k_out["y"]
                                            - float32_out["y"]).max()),
              "wrong_scale_axis_hidden_rel_err": _rel_err(bad_out["hidden"],
                                                          hf),
              "gross_bound": INT8_GROSS_REL_ERR}
    if not vs_f32["hidden_rel_err"] <= INT8_GROSS_REL_ERR:
        problems.append(f"hidden vs float32: relative error "
                        f"{vs_f32['hidden_rel_err']} > {INT8_GROSS_REL_ERR}")
    if not vs_f32["wrong_scale_axis_hidden_rel_err"] > INT8_GROSS_REL_ERR:
        problems.append("the gross bound does not catch a wrong scale axis")
    tokens = cfg["batch"] * cfg["seq"]
    real = float(feeds["mask"].sum())
    p50 = k_info["p50_ms"] / 1e3
    line = {"phase": "int8_bert", "card": smi, "config": cfg,
            "layout": "every dense MatMul matmul_int8 (weights int8 per "
                      "column, offline; activations per row); embeddings, "
                      "biases, LayerNorm, attention float32",
            "weights": "onnx_bert's: float32 numpy RandomState(0) * 0.02",
            "draw_weights_s": draw_s, "int8_dense_bytes": int8_bytes,
            "float32_embedding_bytes": 4 * (arrays["emb"].size
                                            + arrays["pos"].size),
            "launches": launches, "kernel": k_info, "generic": g_info,
            "checks_vs_generic": checks,
            "tol": f"{INT8_BERT_YARDSTICK:g} x the generic run's distance "
                   f"with the embedding table moved by one unit in the last "
                   f"place; hidden vs float32 relative error <= "
                   f"{INT8_GROSS_REL_ERR:g}",
            "vs_float32_onnx_bert": vs_f32,
            "smoke_reading": f"{INT8_BERT_TIMED} forwards, no spread",
            "forward_p50_ms": k_info["p50_ms"], "tokens_per_s": tokens / p50,
            "real_tokens_per_s": real / p50,
            "eager_forward_p50_ms": k_info["eager_p50_ms"],
            "eager_tokens_per_s": tokens / (k_info["eager_p50_ms"] / 1e3),
            "generic_forward_p50_ms": g_info["p50_ms"],
            "generic_tokens_per_s": tokens / (g_info["p50_ms"] / 1e3),
            "float32_onnx_bert": {
                k: (onnx_line["kernel"][k] if k in onnx_line["kernel"]
                    else onnx_line[k])
                for k in ("forward_p50_ms", "tokens_per_s",
                          "real_tokens_per_s", "peak_memory_gib",
                          "nodes_before", "nodes_after")},
            "problems": problems}
    return problems, line, {k: launches[k] for k in want}


def tuning_phase(dev, smi):
    """Measured dispatch: ``autotune(smoke=True)`` on the card into a
    temporary cache directory (every op must write its entries, the table
    must load back and be live), then the standing table restored — the
    checked-in tables the rest of the run dispatches by: its device kind,
    its sources and crossovers. Returns (problems, line)."""
    import tempfile

    from deeplearning4j_tpu_torch.ops import tuning

    problems = []
    keys = {"dot_product_attention": "flash_min_t",
            "fused_matmul_bias_act": "pallas_min_m",
            "fused_layer_norm": "min_rows",
            "fused_updater_step": "min_size",
            "matmul_int8": "pallas_min_m",
            "paged_decode_attention": "min_pages",
            "fused_bn_matmul_stats": "blocks"}
    old = os.environ.get(tuning.ENV_DIR)
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as tmp:
        os.environ[tuning.ENV_DIR] = tmp
        tuning.reset_tables()
        try:
            table, report = tuning.autotune(smoke=True, device=dev)
            back = tuning.TuningTable.load(report.table_path)
            live = {op: tuning.tuned(op, key) for op, key in keys.items()
                    if key != "blocks"}
        finally:
            if old is None:
                os.environ.pop(tuning.ENV_DIR, None)
            else:
                os.environ[tuning.ENV_DIR] = old
            tuning.reset_tables()
    for op, key in keys.items():
        if key not in table.entries.get(op, {}):
            problems.append(f"autotune wrote no {op}.{key}")
    if back.entries != table.entries:
        problems.append("the saved table does not load back as written")
    if live != {op: table.get(op, key) for op, key in keys.items()
                if key != "blocks"}:
        problems.append(f"the measured table is not live: {live}")
    standing = tuning.active_table()
    line = {"phase": "tuning", "card": smi,
            "device_kind": tuning.current_device_kind(),
            "standing_tables": tuning.default_table_paths(
                tuning.current_device_kind()),
            "standing_crossovers": {op: standing.get(op, key)
                                    for op, key in keys.items()
                                    if key != "blocks"},
            "standing_blocks": standing.entries.get(
                "fused_bn_matmul_stats", {}).get("blocks", {}),
            "standing_measured_on": standing.measured_on,
            "smoke_table": table.entries, "smoke_seconds": report.seconds,
            "smoke_measurements": report.measurements,
            "smoke_timings": report.timings,
            "smoke_note": "tiny ladders: a check of the code path, not the "
                          "card's crossovers",
            "problems": problems}
    return problems, line


def _build_dir():
    from deeplearning4j_tpu_torch.ops import _build

    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    return _build.BUILD_DIR.parent


def onnx_bert_autocast_phase(dev, smi, onnx_line, float32_out):
    """onnx_bert's bytes through the optimizer's autocast pass: ONNX bytes
    → ``import_onnx`` → ``optimize_graph(passes=… + ("autocast",))`` →
    ``sd.save(zip)`` → ``SameDiff.load(zip)`` → ``sd.output``, every dense
    MatMul on the 16-bit sm90 fused matmul (bfloat16 x and w, float32
    bias) and the attention on the float32 flash forward (Q, K and V come
    out of the cast-back as float32). The loaded graph's output must
    equal the in-memory graph's; the expected launches are the gates' own
    decisions under the standing table (the registry's dispatch tally of
    the counted forward), which must be 72 and 12. Held against
    ``helper_mode="generic"`` and onnx_bert's float32 forward. Returns
    (problems, line, launches of the counted forward)."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.autodiff.optimize import PASS_ORDER
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.profile_serve import _profile
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        BERT_BASE_ONNX, bert_onnx_feeds)

    cfg = BERT_BASE_ONNX
    layers = cfg["layers"]
    passes = PASS_ORDER + ("autocast",)
    env = environment()
    problems = []
    last = f"l{layers - 1}_out"
    model, build_s = _bert_base_onnx()
    feeds = bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()

    def forward(sd, outs=("y",), mode="auto"):
        env.helper_mode = mode
        try:
            return sd.output(feeds, list(outs))
        finally:
            env.helper_mode = "auto"

    t0 = time.perf_counter()
    sd = import_onnx(model, device=dev)
    sd.optimize_passes = passes
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    y_mem = forward(sd)["y"]
    st_mem = sd.last_compile_stats
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as tmp:
        path = os.path.join(tmp, "bert_autocast.zip")
        t0 = time.perf_counter()
        sd.save(path)
        save_s = time.perf_counter() - t0
        zip_bytes = os.path.getsize(path)
        del sd
        gc.collect()
        torch.cuda.empty_cache()
        observe.reset()  # the ledger from here holds the loaded graph's
        t0 = time.perf_counter()
        sd = SameDiff.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    sd.optimize_passes = passes
    t0 = time.perf_counter()
    forward(sd)  # the first forward builds the plan and warms up
    first_s = time.perf_counter() - t0
    forward(sd)  # the capture
    ledger = samediff_ledger(observe)
    observe.reset()
    _zero_counters()  # the main path's forward starts here
    y = forward(sd)["y"]
    launches = _read_counters()  # ... and ends here
    disp = dispatch_tally()  # reset above
    st = sd.last_compile_stats
    info = captured_vs_eager(sd, feeds, ["y"], y, AUTOCAST_TIMED)
    info["ledger"] = ledger
    problems += captured_problems(info)
    times = []
    for _ in range(AUTOCAST_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(sd)
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    prof = _profile(lambda: forward(sd), 2, top=6,
                    named=("flash", "fused_matmul", "gemm", "cast",
                           "copy"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out_k = forward(sd, ("y", last))
    out_g = forward(sd, ("y", last), "generic")
    del sd
    gc.collect()
    torch.cuda.empty_cache()

    # the gates' decisions in the counted forward, and what they launched:
    # every matmul and attention of the path on the kernels (the 16-bit
    # sm90 fused matmul has no other path)
    usable_mm, more = gated(disp, "fused_matmul_bias_act", 6 * layers,
                            floor=6 * layers)
    usable_fa, more2 = gated(disp, "dot_product_attention", layers,
                             floor=layers)
    problems += more + more2
    want = {k: 0 for k in launches}
    want.update(fused_matmul_bias_act=usable_mm,
                fused_matmul_bias_act_sm90=usable_mm,
                flash_attn_fwd=usable_fa, flash_attn_fwd_f32_sm90=usable_fa)
    if launches != want:
        problems.append(f"launches {launches} != the gates' decisions "
                        f"{want}")
    want_fusions = {"attention": layers, "epilogue": 6 * layers,
                    "autocast_casts": 2 * (6 * layers) + 2}
    if st.fusions != want_fusions or st_mem.fusions != want_fusions:
        problems.append(f"fusions {st.fusions} / in memory "
                        f"{st_mem.fusions} != {want_fusions}")
    if not np.array_equal(y, y_mem):
        problems.append(f"the loaded graph's y differs from the in-memory "
                        f"graph's by {float(np.abs(y - y_mem).max())}")
    shape = (cfg["batch"], cfg["seq"], 2)
    for label, v in (("kernel", out_k["y"]), ("generic", out_g["y"])):
        if v.shape != shape or v.dtype != np.float32 or \
                not np.all(np.isfinite(v)):
            problems.append(f"{label} y {v.shape} {v.dtype} not finite")
    h, hg, hf = out_k[last], out_g[last], float32_out["hidden"]
    checks = {"hidden_rel_err_vs_generic": _rel_err(h, hg),
              "y_max_abs_vs_generic": float(np.abs(out_k["y"]
                                                   - out_g["y"]).max()),
              "hidden_rel_err_vs_float32": _rel_err(h, hf),
              "generic_hidden_rel_err_vs_float32": _rel_err(hg, hf),
              "y_max_abs_vs_float32": float(np.abs(out_k["y"]
                                                   - float32_out["y"]).max()),
              "generic_bound": AUTOCAST_GENERIC_REL_ERR,
              "gross_bound": AUTOCAST_GROSS_REL_ERR}
    if not checks["hidden_rel_err_vs_generic"] <= AUTOCAST_GENERIC_REL_ERR:
        problems.append(f"hidden vs generic: relative error "
                        f"{checks['hidden_rel_err_vs_generic']} > "
                        f"{AUTOCAST_GENERIC_REL_ERR}")
    if not checks["hidden_rel_err_vs_float32"] <= AUTOCAST_GROSS_REL_ERR:
        problems.append(f"hidden vs float32: relative error "
                        f"{checks['hidden_rel_err_vs_float32']} > "
                        f"{AUTOCAST_GROSS_REL_ERR}")
    if not checks["hidden_rel_err_vs_float32"] > 0.0:
        problems.append("the autocast forward equals the float32 one: no "
                        "bfloat16 arithmetic ran")
    tokens = cfg["batch"] * cfg["seq"]
    real = float(feeds["mask"].sum())
    f32_p50 = onnx_line["kernel"]["p50_ms"] / 1e3
    line = {"phase": "onnx_bert_autocast", "card": smi, "config": cfg,
            "passes": list(passes),
            "weights": "onnx_bert's: float32, numpy RandomState(0) * 0.02",
            "build_bytes_s": build_s, "import_s": import_s,
            "save_s": save_s, "zip_bytes": zip_bytes, "load_s": load_s,
            "first_forward_s": first_s, "nodes_before": st.nodes_before,
            "nodes_after": st.nodes_after, "fusions": st.fusions,
            "launches": launches, "dispatch": disp,
            "loaded_equals_in_memory": bool(np.array_equal(y, y_mem)),
            "checks": checks,
            "tol": f"hidden vs generic relative error <= "
                   f"{AUTOCAST_GENERIC_REL_ERR:g} (one bfloat16 unit a node "
                   f"over 12 layers); vs float32 <= "
                   f"{AUTOCAST_GROSS_REL_ERR:g} (gross faults)",
            "captured_vs_eager": {k: info[k] for k in (
                "bits_equal_eager", "max_abs_diff_eager", "graph_unit",
                "ledger")},
            "forward_p50_ms": p50 * 1e3,
            "forward_times_ms": [t * 1e3 for t in times],
            "eager_forward_p50_ms": info["eager_p50_ms"],
            "tokens_per_s": tokens / p50, "real_tokens_per_s": real / p50,
            "eager_tokens_per_s": tokens / (info["eager_p50_ms"] / 1e3),
            "float32_onnx_bert": {"forward_p50_ms": f32_p50 * 1e3,
                                  "tokens_per_s": tokens / f32_p50},
            "speedup_vs_float32": f32_p50 / p50,
            "device_busy_share": prof["device_busy_share"], "profile": prof,
            "peak_memory_gib": peak, "peak_memory_own_gib": peak - resident,
            "smoke_reading": f"{AUTOCAST_TIMED} forwards, no spread",
            "problems": problems}
    return problems, line, {k: launches[k] for k in (
        "fused_matmul_bias_act", "fused_matmul_bias_act_sm90",
        "fused_matmul_bias_act_f32_sm90", "flash_attn_fwd",
        "flash_attn_fwd_sm90", "flash_attn_fwd_f32_sm90")}


def serve(eng, prompts):
    """Serve ``prompts`` through ``eng``'s start()/submit()/stop(); returns
    the results and the wall seconds from first submit to last result."""
    eng.start()
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=32) for p in prompts]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    return results, wall


def decode_step_case(eng, prompts):
    """A new engine, every slot decoding inline: the step's wall p50
    (``eng.step()``, host
    clock; it ends reading the tokens back) captured and under
    ``disable_capture()``, then one decode step on fixed inputs — the
    staged buffers the last step left — captured and eager. Returns
    (logits bit-equal, their max abs difference, {"captured": p50 ms,
    "eager": p50 ms}) and drains the engine."""
    import torch

    from deeplearning4j_tpu_torch.ops.capture import disable_capture

    for p in prompts[:eng.cache.max_slots]:
        eng.submit(p, max_new_tokens=2 * DECODE_TIMED + 4, eos_token=-1)
    eng.step()  # admits every slot, then decodes
    p50 = {}
    for label, ctx in (("captured", contextlib.nullcontext),
                       ("eager", disable_capture)):
        times = []
        with ctx():
            for _ in range(DECODE_TIMED):
                t0 = time.perf_counter()
                eng.step()
                times.append(time.perf_counter() - t0)
        p50[label] = float(np.percentile(times, 50)) * 1e3
    captured = eng._decode_fn()[1].clone()
    with disable_capture():
        eager = eng._decode_fn()[1]
    equal = bool(torch.equal(captured, eager))
    diff = float((captured - eager).abs().max())
    while eng.scheduler.has_work():
        eng.step()
    return equal, diff, p50


def unit_memory(unit) -> dict:
    """A captured unit's graphs and memory: the pool's reserved bytes and
    the static input buffers, MiB."""
    return {"captures": unit.captures, "moved": unit.moved,
            "pool_mib": unit.pool_bytes / 2 ** 20,
            "static_mib": unit.static_bytes / 2 ** 20}


def explain_divergence(model, prompt, toks_a, toks_b):
    """Greedy tokens of two runs first differ at index j: accept only a
    near-tie — the prefix's next-token logits agree between the generic
    and kernel paths within LOGIT_TOL and the top-2 gap is below
    2*LOGIT_TOL. Returns (ok, details)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models.gpt import gpt_prefill

    j = 0
    while j < min(len(toks_a), len(toks_b)) and toks_a[j] == toks_b[j]:
        j += 1
    ids = np.concatenate([prompt, toks_a[:j]]).astype(np.int64)[None]
    ids_t = torch.from_numpy(ids).to(model.device)
    env = environment()
    logits = {}
    with torch.no_grad():
        for mode in ("generic", "auto"):
            env.helper_mode = mode
            logits[mode] = gpt_prefill(model.params, ids_t, model.cfg)[0][
                0, -1].float()
    env.helper_mode = "auto"
    diff = (logits["generic"] - logits["auto"]).abs().max().item()
    top2 = torch.topk(logits["generic"], 2).values
    gap = (top2[0] - top2[1]).item()
    ok = diff <= LOGIT_TOL and gap <= 2 * LOGIT_TOL
    return ok, {"index": j, "logit_max_abs_diff": diff, "top2_gap": gap}


# ------------------------------------------------ the sequential network


def dispatch_tally(op=None) -> dict:
    """The registry's dispatch counter, ``"op impl reason": count``."""
    from deeplearning4j_tpu_torch import observe

    out = {}
    for c in observe.metrics().instruments():
        if c.name != "dl4j_tpu_helper_dispatch_total" or not c.value:
            continue
        lab = dict(c.labels)
        if op is None or lab["op"] == op:
            out[f"{lab['op']} {lab['impl']} {lab['reason']}"] = int(c.value)
    return out


def dispatch_since(before: dict) -> dict:
    """The dispatch decisions taken since ``before`` (an earlier
    :func:`dispatch_tally`), in its keys."""
    now = dispatch_tally()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def gated(disp: dict, op: str, calls: int, floor: int = 1) -> tuple:
    """The gates' own decisions for the ``calls`` dispatches of ``op``
    that its kernel takes at their shapes, from a dispatch tally (the
    keys of :func:`dispatch_tally`): (the kernel's share, problems). Each
    such call goes to the kernel (``cuda usable``) or, below a crossover
    of the tuning table standing on this card (``ops/tuning.py``), to the
    generic (``generic crossover``); the launches a phase expects are the
    kernel's share. ``floor`` of them must stay on the kernel: the path
    the phase exists to drive."""
    n = disp.get(f"{op} cuda usable", 0)
    cross = disp.get(f"{op} generic crossover", 0)
    problems = []
    if n + cross != calls:
        problems.append(f"{op}: {n} calls to the kernel + {cross} by "
                        f"crossover != {calls}")
    if n < floor:
        problems.append(f"{op}: {n} calls to the kernel < {floor}: the "
                        f"path left the kernel")
    return n, problems


def _move_distance(a, b, start) -> float:
    """‖a − b‖ / ‖b − start‖ over every parameter leaf: how far two runs'
    parameter moves differ, relative to the move."""
    from deeplearning4j_tpu_torch.models._tree import leaf_paths

    num = den = 0.0
    for (_, x), (_, y), (_, s) in zip(leaf_paths(a), leaf_paths(b),
                                      leaf_paths(start)):
        num += float(((x.float() - y.float()) ** 2).sum())
        den += float(((y.float() - s.float()) ** 2).sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def _mln_run(net, start, mode, batches, *, nudge=False, eager=False,
             fit=None):
    """``net.fit`` (or ``fit(ds)``) over ``batches`` (one call each) from
    the ``start`` state (copied into the network's own tensors) under
    ``helper_mode=mode``, captured (``"auto"``) or, for the references
    and with ``eager``, op by op: (scores — one a step, or one a tBPTT
    segment —, host seconds a batch, parameters, the whole state)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment

    env = environment()
    env.helper_mode = mode
    net.params = _load(net.params, _nudged(start[0], np.random.default_rng(
        8)) if nudge else start[0])
    net.opt_state = _load(net.opt_state, start[1])
    net.net_state = _load(net.net_state, start[2])
    net.iteration_count = 0
    net._gen.manual_seed(net.conf.seed)
    tbptt = net.conf.backprop_type == "tbptt"
    scores, times = [], []
    try:
        with _eager_if(eager or mode != "auto"):
            for ds in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if fit is None:
                    net.fit(ds, batch_size=ds.num_examples())
                else:
                    fit(ds)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                scores += net.tbptt_scores() if tbptt else [net.score()]
    finally:
        env.helper_mode = "auto"
    return (scores, times, _clone_tree(net.params),
            _clone_tree([net.params, net.opt_state, net.net_state]))


def _mln_main_path(net, batches, keys=("train",), counters=None):
    """Warm-up (the step keys' captures), the generic run (the reference,
    op by op), then the counted run — replays — with every launch count
    and the dispatch tally set to 0 just before and read just after, then
    the same steps under ``disable_capture()``. Returns (start, generic
    run, kernel run, launches, updater leaves, tally, (capture problems,
    capture fields)); ``counters`` (a dict), when given, receives every
    kernel's count of the counted run (``_read_counters``)."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    observe.reset()
    start = (_clone_tree(net.params), _clone_tree(net.opt_state),
             _clone_tree(net.net_state))
    _mln_run(net, start, "auto", batches[:1])   # warm-up: the captures
    generic = _mln_run(net, start, "generic", batches)
    events = list(observe.ledger().events())
    cu.fused_updater.launches = cu.fused_updater.leaves = 0
    if counters is not None:
        _zero_counters()
    observe.reset()                                 # the main path's run
    kernel = _mln_run(net, start, "auto", batches)
    if counters is not None:
        counters.update(_read_counters())
    launches = {"fused_updater": cu.fused_updater.launches}
    leaves, tally = cu.fused_updater.leaves, dispatch_tally()  # ... ends
    events += observe.ledger().events()
    eager = _mln_run(net, start, "auto", batches, eager=True)
    capture = capture_fields(net._steps.units, kernel, eager, events, keys)
    return start, generic, kernel, launches, leaves, tally, capture


def _rnn_agreement(start, generic, kernel, yard) -> tuple:
    """Losses and parameters of the cuDNN run against the generic run:
    each loss within max(RNN_LOSS_RTOL relative, RNN_YARDSTICK × the
    one-ulp-nudged generic run's distance), the parameter moves within
    max(RNN_MOVE_RTOL, RNN_YARDSTICK × the yardstick's) in relative L2
    norm. Returns (problems, line fields)."""
    loss_lim = [max(RNN_LOSS_RTOL * abs(g), RNN_YARDSTICK * abs(y - g))
                for g, y in zip(generic[0], yard[0])]
    loss_diff = [abs(k - g) for k, g in zip(kernel[0], generic[0])]
    move = _move_distance(kernel[2], generic[2], start[0])
    yard_move = _move_distance(yard[2], generic[2], start[0])
    move_lim = max(RNN_MOVE_RTOL, RNN_YARDSTICK * yard_move)
    problems = []
    if not all(math.isfinite(v) for v in kernel[0] + generic[0] + yard[0]):
        problems.append("non-finite loss")
    if any(d > lim for d, lim in zip(loss_diff, loss_lim)):
        problems.append(f"losses {kernel[0]} vs generic {generic[0]} "
                        f"(limits {loss_lim})")
    if move > move_lim:
        problems.append(f"parameter moves differ by {move} > {move_lim}")
    return problems, {
        "losses_kernel": kernel[0], "losses_generic": generic[0],
        "losses_generic_nudged_1_ulp": yard[0],
        "loss_abs_diff": loss_diff, "loss_limit": loss_lim,
        "param_move_rel_diff": move, "param_move_rel_diff_yardstick":
            yard_move, "param_move_limit": move_lim,
        "param_max_abs_diff": _max_diff(kernel[2], generic[2]),
        "param_max_move_generic": _max_diff(start[0], generic[2]),
        "tol": (f"loss max({RNN_LOSS_RTOL:g} relative, {RNN_YARDSTICK:g} x "
                f"yardstick); parameter moves max({RNN_MOVE_RTOL:g}, "
                f"{RNN_YARDSTICK:g} x yardstick) relative L2")}


def _train_a_agreement(start, generic, kernel) -> tuple:
    """The kernel run against the generic run as train phase A holds
    ResNet-50: finite losses, each within TRAIN_A_LOSS_RTOL relative, the
    parameters within TRAIN_A_PARAM_SHARE × the generic run's largest
    move. Returns (problems, line fields)."""
    param_diff = _max_diff(kernel[2], generic[2])
    moved = _max_diff(start[0], generic[2])
    problems = []
    if not all(math.isfinite(v) for v in kernel[0] + generic[0]):
        problems.append("non-finite loss")
    if any(abs(a - b) > TRAIN_A_LOSS_RTOL * abs(b)
           for a, b in zip(kernel[0], generic[0])):
        problems.append(f"losses {kernel[0]} vs generic {generic[0]}")
    if param_diff > TRAIN_A_PARAM_SHARE * moved:
        problems.append(f"param diff {param_diff} > {TRAIN_A_PARAM_SHARE} "
                        f"x {moved}")
    return problems, {
        "param_max_abs_diff": param_diff, "param_max_move_generic": moved,
        "bit_equal": param_diff == 0.0,
        "tol": f"loss {TRAIN_A_LOSS_RTOL:g} relative; params "
               f"{TRAIN_A_PARAM_SHARE:g} x the largest 3-step move"}


def lenet_phase(dev, smi):
    """``LeNet().init()`` → ``fit`` at the zoo defaults, batch 64 of
    synthetic digits: 3 steps generic, then 3 counted steps through the
    kernels. Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.testing import sequential as S

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    net = LeNet(device=dev).init()
    n_leaves = sum(len(p) for p in net.params)
    batch, steps = S.LENET["batch"], S.LENET["steps"]
    batches = S.lenet_batches(batch, steps)
    start, generic, kernel, launches, leaves, tally, capture = (
        _mln_main_path(net, batches))
    out = net.output(batches[0].features)
    problems = updater_count_problems(launches["fused_updater"], leaves,
                                      n_leaves, steps) + capture[0]
    if net.num_params() != LENET_PARAMS:
        problems.append(f"{net.num_params()} parameters != {LENET_PARAMS}")
    agree, against = _train_a_agreement(start, generic, kernel)
    problems += agree
    if out.shape != (batch, 10) or not np.allclose(out.sum(-1), 1.0,
                                                   atol=1e-5):
        problems.append(f"output {out.shape} is not a softmax")
    p50 = float(np.percentile(kernel[1], 50))
    line = {"phase": "lenet", "card": smi, "model": "LeNet()",
            "input": [28, 28, 1], "classes": 10, "batch": batch,
            "steps": steps, "leaves": n_leaves,
            "params": net.num_params(), "launches": launches,
            "fused_updater_leaves": leaves, "dispatch": tally,
            "losses_generic": generic[0], "losses_kernel": kernel[0],
            **against, "smoke_reading": f"{steps} steps, no spread",
            "step_p50_ms": p50 * 1e3, "images_per_s": batch / p50,
            "generic_step_p50_ms": float(np.percentile(generic[1], 50))
            * 1e3, **capture[1], "problems": problems}
    del net
    torch.cuda.empty_cache()
    return problems, line, launches


def lstm_layer_ms(params, x, mask) -> dict:
    """Forward + backward of one ``lstm_layer`` call (the tagger's forward
    direction) on the cuDNN helper and on the generic: CUDA events around
    5 calls after 2 warm ones, the host's gaps between launches included;
    each call gets a fresh copy of the mask, as each ``fit`` step does
    (the helper reads its lengths once a mask)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.ops import exec_op

    env = environment()
    leaves = [params[k].detach().clone().requires_grad_(True)
              for k in ("W", "RW", "b")]
    xs = x.detach().clone().requires_grad_(True)
    out = {}
    for impl, mode in (("cudnn", "kernel"), ("generic", "generic")):
        env.helper_mode = mode

        def once():
            hs, _, _ = exec_op("lstm_layer", xs, *leaves, None, None,
                               mask.clone(), gate_activation="sigmoid",
                               activation="tanh")
            hs.sum().backward()

        try:
            for _ in range(2):
                once()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            torch.cuda.synchronize()
            t0.record()
            for _ in range(5):
                once()
            t1.record()
            torch.cuda.synchronize()
        finally:
            env.helper_mode = "auto"
        out[impl] = t0.elapsed_time(t1) / 5
    return out


def bilstm_tagger_phase(dev, smi):
    """BASELINE config 3: Bidirectional(LSTM 256, concat) over 300-wide
    word vectors → RnnOutputLayer over CoNLL-2003's 9 tags, Adam 5e-3,
    batch 32 × T 128 with ragged lengths 8…128 (features and labels masks
    right padded). 3 ``fit`` steps generic, 3 counted through cuDNN and
    the updater kernel, 3 generic from parameters moved one ulp (the
    yardstick); then ``output`` at every position, cuDNN against the
    generic. Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.testing import sequential as S

    cfg = S.TAGGER
    b, t, tags, steps = cfg["batch"], cfg["seq"], cfg["tags"], cfg["steps"]
    net = tnn.MultiLayerNetwork(S.tagger_conf(
        cfg["features"], cfg["hidden"], tags), device=dev).init()
    n_leaves = len(list(leaf_paths(net.params)))
    batches, real = S.tagger_batches(b, t, cfg["min_len"], cfg["features"],
                                     tags, steps)
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.nn.compiled import MASKED_LSTM

    start, generic, kernel, launches, leaves, tally, capture = (
        _mln_main_path(net, batches))
    # the steps of the counted run and of its eager twin, each routed to
    # eager by the masked-LSTM rule (the metrics were reset before them)
    routed = int(observe.metrics().counter(
        "dl4j_tpu_capture_skipped_total", unit="train",
        reason=MASKED_LSTM).value)
    yard = _mln_run(net, start, "generic", batches, nudge=True)
    problems, fields = _rnn_agreement(start, generic, kernel, yard)
    problems += updater_count_problems(launches["fused_updater"], leaves,
                                       n_leaves, steps) + capture[0]
    if routed != 2 * steps or capture[1]["graph_units"]["train"][
            "captures"]:
        problems.append(f"masked steps routed to eager {routed} != 2 x "
                        f"{steps}, captures {capture[1]['graph_units']}")
    want = {"lstm_layer cudnn usable": 2 * steps}
    if {k: v for k, v in tally.items() if k.startswith("lstm_layer")} != want:
        problems.append(f"lstm_layer dispatch {tally} != {want}")
    # output at every position, padded ones included: cuDNN vs generic on
    # the counted run's parameters
    net.params = _load(net.params, kernel[2])
    ds = batches[0]
    observe.reset()
    out = net.output(ds.features, ds.features_mask)
    out_tally = dispatch_tally("lstm_layer")
    env = environment()
    env.helper_mode = "generic"
    try:
        out_generic = net.output(ds.features, ds.features_mask)
    finally:
        env.helper_mode = "auto"
    out_diff = float(np.abs(out - out_generic).max())
    if out_tally != {"lstm_layer cudnn usable": 2}:
        problems.append(f"output's lstm_layer dispatch {out_tally}")
    if out_diff > LSTM_OUT_TOL or out.shape != (b, t, tags):
        problems.append(f"output {out.shape}: cuDNN vs generic {out_diff} "
                        f"> {LSTM_OUT_TOL}")
    timing = lstm_layer_ms(net.params[0]["fwd"],
                           torch.from_numpy(ds.features).to(dev),
                           torch.from_numpy(ds.features_mask).to(dev))
    p50 = float(np.percentile(kernel[1], 50))
    line = {"phase": "bilstm_tagger", "card": smi,
            "model": f"Bidirectional(LSTM({cfg['hidden']}), concat) -> "
                     f"RnnOutputLayer({tags})",
            "batch": b, "seq": t, "features": cfg["features"],
            "lengths": f"{cfg['min_len']}..{t}",
            "real_tokens_per_batch": float(np.mean(real)),
            "steps": steps, "leaves": n_leaves,
            "params": net.num_params(), "launches": launches,
            "fused_updater_leaves": leaves, "dispatch": tally, **fields,
            "output_max_abs_diff_cudnn_vs_generic": out_diff,
            "output_tol": LSTM_OUT_TOL, "output_dispatch": out_tally,
            "lstm_layer_fwd_bwd_ms": timing,
            "lstm_layer_timed": f"CUDA events around 5 calls (N {b}, T {t}, "
                                f"I {cfg['features']}, H {cfg['hidden']}, "
                                f"right padded), host gaps included",
            "smoke_reading": f"{steps} steps, no spread",
            "step_p50_ms": p50 * 1e3, "tokens_per_s": b * t / p50,
            "real_tokens_per_s": float(np.mean(real)) / p50,
            "generic_step_p50_ms": float(np.percentile(generic[1], 50))
            * 1e3, **capture[1], "routed_eager_steps": routed,
            "routed": [e.to_dict() for e in
                       observe.ledger().routed_events()],
            "problems": problems}
    del net
    torch.cuda.empty_cache()
    return problems, line, launches


def char_lstm_phase(dev, smi):
    """The layers of ``TextGenerationLSTM(vocab_size=77)`` (2 × LSTM 256,
    RmsProp 1e-2, seed 123) built with ``tbptt(50, 50)``: one ``fit``
    batch of 32 × 1000 one-hot characters is 20 segments, one update
    each. Generic, then counted through cuDNN and the updater kernel, then
    the one-ulp yardstick; then ``rnn_time_step`` over 50 single steps
    against ``output`` over the same 50. Returns (problems, line,
    launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.testing import sequential as S

    b, t, v, seg = (S.CHAR["batch"], S.CHAR["seq"], S.CHAR["vocab"],
                    S.CHAR["tbptt"])
    net = tnn.MultiLayerNetwork(S.char_conf(v, S.CHAR["hidden"], seg),
                                device=dev).init()
    n_leaves = len(list(leaf_paths(net.params)))
    batches = [S.char_batch(b, t, v)]
    segments = -(-t // seg)
    start, generic, kernel, launches, leaves, tally, capture = (
        _mln_main_path(net, batches, keys=("train_tbptt",)))
    yard = _mln_run(net, start, "generic", batches, nudge=True)
    # 20 RmsProp steps through a loss spike: the free-running trajectories
    # are reported beside their one-ulp yardstick; the gate is each
    # segment from a shared state
    free_problems, free = _rnn_agreement(start, generic, kernel, yard)
    problems, segment_fields = _tbptt_segment_checks(net, start, batches[0])
    problems += updater_count_problems(launches["fused_updater"], leaves,
                                       n_leaves, segments) + capture[0]
    want = {"lstm_layer cudnn usable": 2 * segments}
    if {k: v for k, v in tally.items() if k.startswith("lstm_layer")} != want:
        problems.append(f"lstm_layer dispatch {tally} != {want}")
    if len(kernel[0]) != segments:
        problems.append(f"{len(kernel[0])} segment scores != {segments}")
    # streaming: 50 single steps against one output over the same 50
    net.params = _load(net.params, kernel[2])
    xs = batches[0].features[:, :seg]
    observe.reset()
    net.rnn_clear_previous_state()
    streamed = np.stack([net.rnn_time_step(xs[:, i]) for i in range(seg)],
                        axis=1)
    stream_tally = dispatch_tally("lstm_layer")
    whole = net.output(xs)
    stream_diff = float(np.abs(streamed - whole).max())
    if stream_diff > STREAM_TOL:
        problems.append(f"rnn_time_step vs output {stream_diff} > "
                        f"{STREAM_TOL}")
    if stream_tally != {"lstm_layer cudnn usable": 2 * seg}:
        problems.append(f"rnn_time_step dispatch {stream_tally}")
    wall = kernel[1][0]
    line = {"phase": "char_lstm", "card": smi,
            "model": f"TextGenerationLSTM(vocab_size={v}) layers, "
                     f"tbptt({seg}, {seg})",
            "batch": b, "seq": t, "segments": segments, "leaves": n_leaves,
            "params": net.num_params(), "launches": launches,
            "fused_updater_leaves": leaves, "dispatch": tally,
            "free_running": dict(free, within_yardstick=not free_problems,
                                 gated=False),
            "segment_by_segment": segment_fields,
            "rnn_time_step_vs_output_max_abs_diff": stream_diff,
            "stream_tol": STREAM_TOL, "stream_dispatch": stream_tally,
            "smoke_reading": "one batch of 20 segments, no spread",
            "batch_s": wall, "tokens_per_s": b * t / wall,
            "generic_batch_s": generic[1][0], **capture[1],
            "captured_step_p50_note": "one fit call of 20 segments",
            "problems": problems}
    del net
    torch.cuda.empty_cache()
    return problems, line, launches


def _clone_states(states):
    """A copy of carried RNN states (tuples, tensors or None)."""
    return [None if st is None else tuple(t.clone() for t in st)
            if isinstance(st, tuple) else st.clone() for st in states]


def _tbptt_segment_checks(net, start, ds):
    """Each tBPTT segment of ``ds`` trained from the generic run's own
    state at its start (parameters, updater state, carried h and c,
    iteration), once through cuDNN and once generic: the segment's score
    within RNN_LOSS_RTOL relative, its parameter move within
    RNN_MOVE_RTOL relative L2 and the carried state it hands on within
    STATE_TOL absolute + STATE_TOL relative. Returns (problems, line
    fields)."""
    from deeplearning4j_tpu_torch.environment import environment

    env = environment()
    net.params = _load(net.params, start[0])
    net.opt_state = _load(net.opt_state, start[1])
    net.net_state = _load(net.net_state, start[2])
    net.iteration_count = 0
    x, y = net._feed(ds.features), net._feed(ds.labels)
    seg = net.conf.tbptt_fwd_length
    rnn = net._zero_rnn_states(x.shape[0])
    loss_rel, moves, state_diff = [], [], []
    for t0 in range(0, x.shape[1], seg):
        sl = slice(t0, t0 + seg)
        before = (_clone_tree(net.params), _clone_tree(net.opt_state))
        outs = {}
        for mode in ("auto", "generic"):
            env.helper_mode = mode
            net.params = _load(net.params, before[0])
            net.opt_state = _load(net.opt_state, before[1])
            try:
                # kernels against the generic, a segment at a time: op by op
                with _eager_if(True):
                    score, new_rnn = net._train_step(
                        x[:, sl], y[:, sl], None, None, _clone_states(rnn))
            finally:
                env.helper_mode = "auto"
            outs[mode] = (float(score), _clone_tree(net.params), new_rnn)
        (k_score, k_params, k_rnn), (g_score, _, rnn) = (outs["auto"],
                                                         outs["generic"])
        net.iteration_count += 1
        loss_rel.append(abs(k_score - g_score) / abs(g_score))
        moves.append(_move_distance(k_params, net.params, before[0]))
        state_diff.append(max(
            ((a.float() - b.float()).abs()
             / (STATE_TOL + STATE_TOL * b.float().abs())).max().item()
            for ka, ga in zip(k_rnn, rnn) if ka is not None
            for a, b in zip(ka, ga)))
    problems = []
    if max(loss_rel) > RNN_LOSS_RTOL:
        problems.append(f"segment scores differ by {max(loss_rel)} "
                        f"relative > {RNN_LOSS_RTOL}")
    if max(moves) > RNN_MOVE_RTOL:
        problems.append(f"segment parameter moves differ by {max(moves)} "
                        f"> {RNN_MOVE_RTOL}")
    if max(state_diff) > 1.0:
        problems.append(f"carried state differs by {max(state_diff)} x "
                        f"its tolerance")
    return problems, {
        "score_rel_diff": loss_rel, "param_move_rel_diff": moves,
        "carried_state_diff_over_tol": state_diff,
        "tol": f"score {RNN_LOSS_RTOL:g} relative, parameter move "
               f"{RNN_MOVE_RTOL:g} relative L2, carried h and c "
               f"{STATE_TOL:g} + {STATE_TOL:g} x |generic|, each segment "
               f"from the generic run's state"}


# ---------------------------------------------------------------------------
# checkpointed, supervised training and serving
# ---------------------------------------------------------------------------


def _ckpt_dir(name: str) -> str:
    """A fresh checkpoint directory inside this checkout (``build/`` is
    ignored by git); the phase deletes it when done."""
    import os
    import pathlib
    import shutil

    d = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    d = d / name
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return str(d)


def _drop_ckpt_dirs() -> None:
    import pathlib
    import shutil

    shutil.rmtree(pathlib.Path(__file__).resolve().parent / "build"
                  / "chip_smoke_ckpt", ignore_errors=True)


class _StepLog:
    """A listener: every ``iteration_done`` call's (iteration, score);
    with ``kill_at`` one hard kill when that iteration is reported
    (``InjectedFault("preemption")`` raised from inside the batch), with
    ``preempt_at`` one graceful ``request_preemption()``."""

    def __init__(self, kill_at=None, preempt_at=None):
        self.calls = []
        self.kill_at, self.preempt_at = kill_at, preempt_at

    def iteration_done(self, model, iteration, epoch, score):
        from deeplearning4j_tpu_torch import faults

        self.calls.append((iteration, float(score)))
        if iteration == self.kill_at:
            self.kill_at = None
            raise faults.InjectedFault("preemption")
        if iteration == self.preempt_at:
            self.preempt_at = None
            faults.request_preemption()

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _equal_trees(a, b) -> bool:
    """Same leaves, dtypes and bits."""
    import torch

    from deeplearning4j_tpu_torch.models._tree import leaf_paths

    la, lb = list(leaf_paths(a)), list(leaf_paths(b))
    return len(la) == len(lb) and all(
        pa == pb and x.dtype == y.dtype and torch.equal(x, y)
        for (pa, x), (pb, y) in zip(la, lb))


def _final_state(net) -> dict:
    return {"params": _clone_tree(net.params),
            "opt_state": _clone_tree(net.opt_state),
            "gen": net._gen.get_state().clone()}


def _state_problems(run, got, want) -> list:
    """Bit-equality of a run's final parameters, updater state and
    generator state against the oracle's."""
    out = []
    for part in ("params", "opt_state"):
        if not _equal_trees(got[part], want[part]):
            out.append(f"{run}: {part} differ from the oracle's by "
                       f"{_max_diff(got[part], want[part])}")
    if not _equal_trees(got["gen"], want["gen"]):
        out.append(f"{run}: generator state differs from the oracle's")
    return out


def _faults_line(phase: str, runs: list) -> dict:
    """The phase's faults summary: per run the points armed, the fires
    and the supervisor's restarts."""
    return {"faults": phase, "runs": runs,
            "fires": {k: sum(r["fires"].get(k, 0) for r in runs)
                      for k in sorted({k for r in runs for k in r["fires"]})},
            "restarts": sum(r["restarts"] for r in runs)}


def _poll_ns(n: int = 200000) -> float:
    """Host nanoseconds of one unarmed preemption poll of a fit loop
    (``maybe_fail`` + ``preemption_requested``)."""
    from deeplearning4j_tpu_torch import faults

    t0 = time.perf_counter()
    for _ in range(n):
        faults.maybe_fail("preemption")
        faults.preemption_requested()
    return (time.perf_counter() - t0) / n * 1e9


def supervised_train_phase(dev, smi, *, input_shape=None, classes=None,
                           batch=SUP_BATCH, batches=SUP_BATCHES,
                           epochs=SUP_EPOCHS):
    """``AlexNet()`` at the zoo defaults (224×224×3, 1000 classes,
    Nesterovs, dropout 0.5 in both dense layers) fed ``epochs`` ×
    ``batches`` batches of ``batch`` synthetic uint8 textures through a
    reshuffling ``ListDataSetIterator`` with ``ImagePreProcessingScaler``
    attached by ``set_pre_processor``, cuDNN deterministic. Four runs:
    the uninterrupted oracle; ``TrainingSupervisor(save_every=2)``
    (asynchronous saves) killed by the ``preemption`` fault after 5
    steps; a graceful ``request_preemption()`` at iteration 3, then a
    fresh ``AlexNet(seed=...)`` and a fresh checkpointer on the same
    directory to the end; the newest save torn
    (``checkpoint_torn_write``) and a hard kill after 5 steps, the restore
    falling back. Each run's per-iteration losses, final parameters,
    updater state and generator state must equal the oracle's bit for
    bit; restarts, resumes and fallbacks are counted; fused-updater
    launches equal the steps run, replays included. Returns (problems,
    line, launches, faults line)."""
    import torch

    from deeplearning4j_tpu_torch import faults, observe
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ImagePreProcessingScaler, ListDataSetIterator,
        synthetic_image_batch)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.parallel import (
        TrainingCheckpointer, TrainingSupervisor)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    kw = dict(device=dev)
    if input_shape is not None:
        kw.update(input_shape=input_shape, num_classes=classes)

    def model(seed=123):
        return zoo.AlexNet(seed=seed, **kw)

    h, w, c = model().input_shape
    n_cls = model().num_classes
    n = batch * batches
    x, lab = synthetic_image_batch(n, h, w, c, n_cls, seed=SUP_DATA_SEED)
    x_u8 = np.clip(x / 1.05 * 255.0, 0, 255).astype(np.uint8)
    y = np.eye(n_cls, dtype=np.float32)[lab]
    del x

    def data():
        it = ListDataSetIterator(DataSet(x_u8, y), batch_size=batch,
                                 shuffle=True, seed=SUP_SHUFFLE_SEED)
        it.set_pre_processor(ImagePreProcessingScaler())
        return it

    steps = batches * epochs
    observe.reset()
    m = observe.metrics()

    def counters():
        return {k: m.counter(f"dl4j_tpu_{k}").value for k in (
            "ckpt_resumes_total", "checkpoint_fallback_total",
            "checkpoint_corrupt_total", "checkpoint_saves_total")}

    def run(body):
        """One run from a clean fault table: (scores by iteration,
        final state, steps run, updater launches, counters moved,
        fires, restarts, seconds)."""
        faults.reset()
        before = counters()
        cu.fused_updater.launches = 0
        t0 = time.perf_counter()
        logs, restarts, net = body()
        _sync(dev)
        secs = time.perf_counter() - t0
        scores = {}
        for lg in logs:
            scores.update(dict(lg.calls))
        out = dict(scores=scores, state=_final_state(net),
                   captures={k: u.captures
                             for k, u in net._steps.units.items()},
                   steps=sum(len(lg.calls) for lg in logs),
                   launches=cu.fused_updater.launches,
                   moved={k: v - before[k] for k, v in counters().items()},
                   fires=faults.fire_counts(), restarts=restarts,
                   seconds=secs)
        faults.reset()
        return out

    # 1. the oracle
    def oracle_body():
        net = model().init()
        lg = _StepLog()
        net.set_listeners(lg)
        net.fit(data(), epochs=epochs)
        return [lg], 0, net

    oracle = run(oracle_body)
    # the oracle's steps op by op, from the same starting state
    with _eager_if(True):
        eager = run(oracle_body)

    save_block = []   # the training thread's seconds a save_async

    class TimedCheckpointer(TrainingCheckpointer):
        def save_async(self, step, net):
            t0 = time.perf_counter()
            super().save_async(step, net)
            save_block.append(time.perf_counter() - t0)

    # 2. asynchronous saves every 2 steps, killed after 5 steps
    def killed_body():
        net = model().init()
        lg = _StepLog()
        net.set_listeners(lg)
        sup = TrainingSupervisor(net, TimedCheckpointer(
            _ckpt_dir("killed"), keep_last=2), save_every=2,
            restart_backoff_s=0.0)
        faults.arm("preemption", after_n=5, max_fires=1)
        status = sup.fit(data(), epochs=epochs)
        if status != "completed":
            raise RuntimeError(f"supervised fit returned {status}")
        sup.ckpt.close()
        return [lg], sup.restarts, net

    write_h0 = m.histogram("dl4j_tpu_ckpt_write_seconds")
    w_count0, w_sum0 = write_h0.count, write_h0.sum
    killed = run(killed_body)
    writes = write_h0.count - w_count0
    writer_s = (write_h0.sum - w_sum0) / max(writes, 1)

    # 3. graceful preemption at iteration 3, a fresh net of another seed
    def graceful_body():
        d = _ckpt_dir("graceful")
        net = model().init()
        lg1 = _StepLog(preempt_at=3)
        net.set_listeners(lg1)
        sup = TrainingSupervisor(net, TrainingCheckpointer(d, keep_last=2),
                                 save_every=2, restart_backoff_s=0.0)
        status = sup.fit(data(), epochs=epochs)
        faults.clear_preemption()
        sup.ckpt.close()
        if status != "preempted":
            raise RuntimeError(f"graceful run returned {status}")
        del net
        net2 = model(seed=SUP_OTHER_SEED).init()
        lg2 = _StepLog()
        net2.set_listeners(lg2)
        sup2 = TrainingSupervisor(net2, TrainingCheckpointer(d, keep_last=2),
                                  save_every=2, restart_backoff_s=0.0)
        status = sup2.fit(data(), epochs=epochs)
        sup2.ckpt.close()
        if status != "completed":
            raise RuntimeError(f"resumed run returned {status}")
        return [lg1, lg2], sup.restarts + sup2.restarts, net2

    graceful = run(graceful_body)

    # 4. the newest save torn, then a hard kill: the restore falls back
    def torn_body():
        net = model().init()
        lg = _StepLog()
        net.set_listeners(lg)
        sup = TrainingSupervisor(net, TrainingCheckpointer(
            _ckpt_dir("torn"), keep_last=2), save_every=2,
            restart_backoff_s=0.0)
        faults.arm("checkpoint_torn_write", after_n=1, max_fires=1)
        faults.arm("preemption", after_n=5, max_fires=1)
        status = sup.fit(data(), epochs=epochs)
        if status != "completed":
            raise RuntimeError(f"supervised fit returned {status}")
        sup.ckpt.close()
        return [lg], sup.restarts, net

    torn = run(torn_body)

    # the checkpoint's size, one synchronous save and one restore of the
    # oracle's state
    net = model().init()
    d = _ckpt_dir("timed")
    ck = TrainingCheckpointer(d, keep_last=None)
    net.params, net.opt_state = (oracle["state"]["params"],
                                 oracle["state"]["opt_state"])
    t0 = time.perf_counter()
    path = ck.save(steps, net)
    sync_save_s = time.perf_counter() - t0
    ckpt_bytes = __import__("os").path.getsize(path)
    fresh = model(seed=SUP_OTHER_SEED).init()
    _sync(dev)
    t0 = time.perf_counter()
    ck.restore(fresh)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    restored_equal = (_equal_trees(fresh.params, oracle["state"]["params"])
                      and _equal_trees(fresh.opt_state,
                                       oracle["state"]["opt_state"]))
    del net, fresh
    _drop_ckpt_dirs()

    problems = []
    if not restored_equal:
        problems.append("save + restore of the oracle's state not exact")
    # captured against eager; one capture a network (a restore copies into
    # the network's buffers, so a resumed fit replays); one first_compile
    # a network and no new_shape
    if eager["scores"] != oracle["scores"]:
        problems.append(f"captured losses {oracle['scores']} != eager "
                        f"{eager['scores']}")
    problems += _state_problems("captured vs eager", oracle["state"],
                                eager["state"])
    ledger = [ev.cause for ev in observe.ledger().events()
              if ev.key == "train"]
    if ledger != ["first_compile"] * 6:
        problems.append(f"ledger {ledger}: one first_compile for each of "
                        f"the 6 networks trained")
    for name, r in dict(oracle=oracle, killed=killed, graceful=graceful,
                        torn=torn).items():
        if dev.type == "cuda" and r["captures"] != {"train": 1}:
            problems.append(f"{name}: captures {r['captures']}")
    if len(oracle["scores"]) != steps or not all(
            math.isfinite(v) for v in oracle["scores"].values()):
        problems.append(f"oracle scores {oracle['scores']}")
    # expected: restarts, resumes, fallbacks, steps run (replays included)
    want = {"killed": (1, 1, 0, steps + 1),      # saved at 4, killed at 5
            "graceful": (0, 1, 0, steps),        # saved at 3 (SIGTERM path)
            "torn": (1, 1, 1, steps + 3)}        # 4 torn: back to 2
    runs = {"killed": killed, "graceful": graceful, "torn": torn}
    for name, r in runs.items():
        restarts, resumes, fallbacks, ran = want[name]
        got = (r["restarts"], r["moved"]["ckpt_resumes_total"],
               r["moved"]["checkpoint_fallback_total"], r["steps"])
        if got != want[name]:
            problems.append(f"{name}: (restarts, resumes, fallbacks, steps) "
                            f"{got} != {want[name]}")
        if r["scores"] != oracle["scores"]:
            diff = {k: (v, oracle["scores"].get(k))
                    for k, v in r["scores"].items()
                    if v != oracle["scores"].get(k)}
            problems.append(f"{name}: per-iteration losses differ from the "
                            f"oracle's: {diff}")
        problems += _state_problems(name, r["state"], oracle["state"])
    for name, r in dict(oracle=oracle, **runs).items():
        if dev.type == "cuda" and r["launches"] != r["steps"]:
            problems.append(f"{name}: {r['launches']} updater launches != "
                            f"{r['steps']} steps run")
    if killed["fires"] != {"preemption": 1} or torn["fires"] != {
            "preemption": 1, "checkpoint_torn_write": 1}:
        problems.append(f"fires {killed['fires']}, {torn['fires']}")
    step_s = oracle["seconds"] / steps
    poll = _poll_ns()
    line = {"phase": "supervised_train", "card": smi,
            "model": "AlexNet()", "input": list(model().input_shape),
            "classes": n_cls, "batch": batch, "batches_per_epoch": batches,
            "epochs": epochs, "updater": "Nesterovs", "dropout": 0.5,
            "data": "uint8 textures, ListDataSetIterator(shuffle=True) + "
                    "ImagePreProcessingScaler",
            "runs": {name: {"steps_run": r["steps"],
                            "restarts": r["restarts"],
                            "counters": r["moved"], "fires": r["fires"],
                            "updater_launches": r["launches"],
                            "seconds": r["seconds"]}
                     for name, r in dict(oracle=oracle, **runs).items()},
            "losses": [oracle["scores"][k] for k in sorted(oracle["scores"])],
            "bit_equal_to_oracle": not problems,
            "checkpoint_bytes": ckpt_bytes, "sync_save_s": sync_save_s,
            "async_save_training_thread_s": save_block,
            "async_write_s_mean": writer_s, "async_writes": writes,
            "restore_s": restore_s, "oracle_step_s": step_s,
            "captured_step_s_mean": step_s,
            "eager_step_s_mean": eager["seconds"] / steps,
            "captured_bit_equal_eager": eager["scores"] == oracle["scores"]
            and not _state_problems("", oracle["state"], eager["state"]),
            "captures": {name: r["captures"] for name, r in dict(
                oracle=oracle, killed=killed, graceful=graceful,
                torn=torn).items()},
            "ledger_train": ledger,
            "unarmed_poll_ns": poll,
            "unarmed_poll_share_of_step": poll * 1e-9 / step_s,
            "smoke_reading": "one run each, no spread", "problems": problems}
    launches = {"fused_updater": killed["launches"]}
    fl = _faults_line("supervised_train", [
        {"run": name, "armed": armed, "fires": runs[name]["fires"],
         "restarts": runs[name]["restarts"]}
        for name, armed in (
            ("killed", ["preemption:after_n=5"]),
            ("graceful", ["request_preemption() at iteration 3"]),
            ("torn", ["checkpoint_torn_write:after_n=1",
                      "preemption:after_n=5"]))])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return problems, line, launches, fl


def graph_tbptt_phase(dev, smi, *, batch=None, seq=None, vocab=None,
                      hidden=None, seg=None, stream=GRAPH_STREAM_CHARS):
    """TextGenerationLSTM's three layers (2 × LSTM 256, RmsProp 1e-2) built
    with ``graph_builder()``, tBPTT 50, on ``char_lstm``'s data: two
    batches of 32 × 1000 (20 segments each). ``ComputationGraph.fit``
    through the tBPTT dispatch under ``TrainingSupervisor(save_every=1)``,
    killed mid second batch (a listener raises ``InjectedFault`` at
    iteration 25): the resumed run must equal the uninterrupted oracle's
    parameters and losses, and checkpoints land only at batch boundaries.
    The graph's per-segment losses must equal the
    ``MultiLayerNetwork``'s from the same parameters, and ``stream``
    characters through ``rnn_time_step`` one at a time must equal the
    network's. Returns (problems, line, launches, faults line)."""
    import torch

    from deeplearning4j_tpu_torch import faults, observe
    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.parallel import (
        TrainingCheckpointer, TrainingSupervisor)
    from deeplearning4j_tpu_torch.testing import sequential as S

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    b = batch or S.CHAR["batch"]
    t = seq or S.CHAR["seq"]
    v = vocab or S.CHAR["vocab"]
    hd = hidden or S.CHAR["hidden"]
    sg = seg or S.CHAR["tbptt"]
    segments = -(-t // sg)
    ds = [S.char_batch(b, t, v), S.char_batch(b, t, v, seed=78)]
    conf = S.char_graph_conf(v, hd, sg)

    def graph():
        return ComputationGraph(conf, device=dev).init()

    start = _clone_tree(graph().params)
    observe.reset()
    # the oracle
    cu.fused_updater.launches = 0
    oracle = graph()
    o_log = _StepLog()
    oracle.set_listeners(o_log)
    t0 = time.perf_counter()
    oracle.fit(ListDataSetIterator(ds))
    _sync(dev)
    oracle_s = time.perf_counter() - t0
    oracle_launches = cu.fused_updater.launches
    # the oracle's segments op by op, from the same starting state
    e_oracle = graph()
    e_log = _StepLog()
    e_oracle.set_listeners(e_log)
    t0 = time.perf_counter()
    with _eager_if(True):
        e_oracle.fit(ListDataSetIterator(ds))
    _sync(dev)
    eager_s = time.perf_counter() - t0
    # supervised, killed mid second batch
    kill_at = segments + segments // 4
    faults.reset()
    m = observe.metrics()
    saves0 = m.counter("dl4j_tpu_checkpoint_saves_total").value
    resumes0 = m.counter("dl4j_tpu_ckpt_resumes_total").value
    cu.fused_updater.launches = 0
    net = graph()
    log = _StepLog(kill_at=kill_at)
    net.set_listeners(log)
    ck = TrainingCheckpointer(_ckpt_dir("graph_tbptt"), keep_last=None)
    sup = TrainingSupervisor(net, ck, save_every=1, restart_backoff_s=0.0)
    status = sup.fit(ListDataSetIterator(ds), epochs=1)
    ck.close()
    launches = {"fused_updater": cu.fused_updater.launches}
    saved = sorted(s for s, _, _ in ck._saved)
    saves = m.counter("dl4j_tpu_checkpoint_saves_total").value - saves0
    resumes = m.counter("dl4j_tpu_ckpt_resumes_total").value - resumes0
    _drop_ckpt_dirs()
    problems = []
    if status != "completed" or sup.restarts != 1 or resumes != 1:
        problems.append(f"status {status}, restarts {sup.restarts}, "
                        f"resumes {resumes}")
    if saved != [segments, 2 * segments] or saves != 2:
        problems.append(f"checkpoints at {saved} ({saves} saves), not only "
                        f"at the batch boundaries {segments}, "
                        f"{2 * segments}")
    ran = len(log.calls)
    if ran != 2 * segments + (kill_at - segments):
        problems.append(f"{ran} segments run")
    if dev.type == "cuda" and (launches["fused_updater"] != ran
                               or oracle_launches != 2 * segments):
        problems.append(f"updater launches {launches} / {oracle_launches} "
                        f"!= segments run {ran} / {2 * segments}")

    def first_diff(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)

    # the resumed run against the oracle: losses a segment, parameters
    o_scores = [s for _, s in o_log.calls]
    eager_equal = ([s for _, s in e_log.calls] == o_scores
                   and _equal_trees(e_oracle.params, oracle.params)
                   and _equal_trees(e_oracle.opt_state, oracle.opt_state))
    if not eager_equal:
        problems.append("the captured oracle differs from its eager twin: "
                        f"params by {_max_diff(e_oracle.params, oracle.params)}")
    captures = {"oracle": oracle._steps.units["train_tbptt"].captures,
                "supervised": net._steps.units["train_tbptt"].captures}
    if dev.type == "cuda" and captures != {"oracle": 1, "supervised": 1}:
        problems.append(f"captures {captures}: one a network, the resumed "
                        f"segments replayed")
    r_scores = [s for _, s in log.calls[:segments]] + [
        s for _, s in log.calls[-segments:]]
    resumed_equal = _equal_trees(net.params, oracle.params)
    resumed_first = first_diff(r_scores, o_scores)
    # the graph against the MultiLayerNetwork of the same layers
    mln = tnn.MultiLayerNetwork(S.char_conf(v, hd, sg), device=dev).init(
        params=[start["l0"], start["l1"], start["out"]])
    g2 = graph()
    g2.params = _clone_tree(start)
    mln.fit(ds[0], batch_size=b)
    g2.fit(ds[0], batch_size=b)
    g_scores, m_scores = g2.tbptt_scores(), mln.tbptt_scores()
    mln_first = first_diff(g_scores, m_scores)
    # the yardstick where a run is not bit-reproducible: char_lstm's
    # segment tolerance (RNN_LOSS_RTOL), named by its first segment
    for label, got, want, first in (
            ("resumed vs oracle", r_scores, o_scores, resumed_first),
            ("graph vs network", g_scores, m_scores, mln_first)):
        if first is None:
            continue
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if rel > RNN_LOSS_RTOL:
            problems.append(f"{label}: segment {first} first differs; "
                            f"{rel} relative > {RNN_LOSS_RTOL}")
    if resumed_first is None and not resumed_equal:
        problems.append(f"resumed parameters differ from the oracle's by "
                        f"{_max_diff(net.params, oracle.params)}")
    # streaming through both networks from the oracle's parameters
    mln.params = [oracle.params["l0"], oracle.params["l1"],
                  oracle.params["out"]]
    g2.params = oracle.params
    chars = np.random.default_rng(79).integers(0, v, (b, stream))
    eye = np.eye(v, dtype=np.float32)
    g2.rnn_clear_previous_state()
    mln.rnn_clear_previous_state()
    t0 = time.perf_counter()
    sg_out = [g2.rnn_time_step(eye[chars[:, i]]) for i in range(stream)]
    stream_s = time.perf_counter() - t0
    sm_out = [mln.rnn_time_step(eye[chars[:, i]]) for i in range(stream)]
    stream_diff = float(np.abs(np.stack(sg_out) - np.stack(sm_out)).max())
    if stream_diff != 0.0:
        problems.append(f"graph rnn_time_step differs from the network's "
                        f"by {stream_diff}")
    # every network's train_tbptt unit compiled once, no new_shape: the
    # graph oracle and its eager twin, the supervised graph, g2 and mln
    ledger = [(ev.graph, ev.cause) for ev in observe.ledger().events()
              if ev.key == "train_tbptt"]
    if sorted(ledger) != sorted([("graph", "first_compile")] * 4
                                + [("mln", "first_compile")]):
        problems.append(f"ledger {ledger}")
    line = {"phase": "graph_tbptt", "card": smi,
            "model": f"TextGenerationLSTM(vocab_size={v}) layers as "
                     f"graph_builder(), tbptt({sg}, {sg})",
            "batch": b, "seq": t, "batches": 2, "segments": 2 * segments,
            "kill_at_iteration": kill_at, "status": status,
            "restarts": sup.restarts, "checkpoints_at": saved,
            "segments_run": ran, "launches": launches,
            "oracle_launches": oracle_launches,
            "resumed_params_bit_equal": resumed_equal,
            "resumed_first_differing_segment": resumed_first,
            "graph_vs_network_first_differing_segment": mln_first,
            "graph_segment_losses": g_scores,
            "rnn_time_step_chars": stream,
            "rnn_time_step_max_abs_diff": stream_diff,
            "rnn_time_step_ms_a_char": stream_s / stream * 1e3,
            "oracle_s": oracle_s, "tokens_per_s": 2 * b * t / oracle_s,
            "captured_segment_s_mean": oracle_s / (2 * segments),
            "eager_segment_s_mean": eager_s / (2 * segments),
            "captured_bit_equal_eager": eager_equal, "captures": captures,
            "ledger_train_tbptt": ledger,
            "smoke_reading": "one run, no spread", "problems": problems}
    fl = _faults_line("graph_tbptt", [{
        "run": "supervised", "armed": [f"InjectedFault('preemption') "
                                       f"raised at iteration {kill_at}"],
        "fires": {"preemption": int(log.kill_at is None)},
        "restarts": sup.restarts}])
    faults.reset()
    del net, oracle, e_oracle, mln, g2
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return problems, line, launches, fl


@contextlib.contextmanager
def _host_syncs():
    """The synchronizing CUDA calls made inside the block (a host read, a
    device-to-host copy, a stream or device synchronization), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: yields the
    list of their warnings."""
    import warnings

    import torch

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        found = []
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            # one warning a synchronizing call; the mode's own notice
            # that it is a prototype is not one
            found += [str(w.message) for w in caught
                      if "called a synchronizing" in str(w.message)]


def _kernel_counters():
    """(name in the kernels line, wrapper, attribute) of every kernel
    wrapper's launch count. The flash, fused-matmul, bn_matmul_stats and
    int8 base names count every design, as in the kernels line."""
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    cells = [(name, w, a) for name, (w, a) in ca.KERNELS.items()]
    cells += [(f"fused_matmul_bias_act{suffix}", cm.fused_matmul, a)
              for suffix, a in (("", "launches"), ("_sm90", "sm90_launches"),
                                ("_f32_sm90", "sm90_f32_launches"))]
    cells += [("fused_layer_norm", cl.fused_layer_norm_kernel, "launches"),
              ("bn_matmul_stats", cc.bn_matmul_stats, "launches"),
              ("bn_matmul_stats_sm90", cc.bn_matmul_stats, "sm90_launches"),
              ("matmul_int8", cq.int8_matmul, "launches"),
              ("matmul_int8_sm90", cq.int8_matmul, "sm90_launches"),
              ("matmul_int8_row_quantize", cq.row_quantize, "launches"),
              ("fused_updater", cu.fused_updater, "launches")]
    return cells


def _scan_case(label, trainer, load, stepped, scanned, units_key, state,
               steps=3):
    """One scanned entry point against as many steps of ``fit``: ``load()``
    sets the trainer to its starting state; ``stepped()`` runs the
    ``steps`` steps one ``fit`` call each and returns their losses;
    ``scanned()`` runs them as one chunk and returns its losses. The chunk
    runs twice from the start — the first captures its unit, the second
    replays it with its host synchronizations counted (one: the losses
    read back) — and each must equal the stepped run bit for bit in losses
    and in the ``state()`` tree. The kernels' launch counts are set to 0
    just before the replayed chunk and read just after: that run alone is
    the scanned path's, and it must launch the updater once a step at
    least. Returns (problems, line fields)."""
    import torch

    cells = _kernel_counters()
    load()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [float(v) for v in stepped()]
    torch.cuda.synchronize()
    stepped_s = time.perf_counter() - t0
    want_state = _clone_tree(state())
    load()
    first = [float(v) for v in scanned()]
    first_state = _clone_tree(state())
    load()
    torch.cuda.synchronize()
    for _, w, a in cells:
        setattr(w, a, 0)                # the scanned path's run starts
    t0 = time.perf_counter()
    with _host_syncs() as syncs:
        got = [float(v) for v in scanned()]
    chunk_s = time.perf_counter() - t0
    launches = {name: getattr(w, a) for name, w, a in cells
                if getattr(w, a)}       # ... and ends
    got_state = _clone_tree(state())
    problems = []
    for run, losses, st in (("first chunk", first, first_state),
                            ("replayed chunk", got, got_state)):
        if losses != want:
            problems.append(f"{label} {run}: losses {losses} != fit's "
                            f"{want}")
        if not _equal_trees(st, want_state):
            problems.append(f"{label} {run}: state differs from fit's by "
                            f"{_max_diff(st, want_state)}")
    equal = not problems
    if len(syncs) != 1:
        problems.append(f"{label}: {len(syncs)} host synchronizations in a "
                        f"replayed chunk, not 1: {syncs}")
    if launches.get("fused_updater", 0) < steps:
        problems.append(f"{label}: the replayed chunk launched the fused "
                        f"updater {launches.get('fused_updater', 0)} times "
                        f"for {steps} steps")
    unit = trainer._steps.units[units_key]
    return problems, {"losses": got, "bit_equal_fit": equal,
                      "host_syncs_a_chunk": len(syncs),
                      "launches": launches,
                      "chunk_s": chunk_s, "fit_s": stepped_s,
                      "graph_unit": unit_memory(unit)}


def fit_scanned_phase(dev, smi):
    """The scanned entry points, each against as many ``fit`` steps from
    the same starting state, bit for bit, with one host read a chunk:
    LeNet's ``fit_scanned`` in both modes (``steps`` None: a [3, 64, 784]
    stack staged on the card once; ``steps=3`` on one batch), ResNet-50
    A's (``ComputationGraph.fit_scanned``, float32, batch 32 at 224²,
    three per-step batches) and BERT-base's ``fit_mlm_scanned`` at
    bert_mlm's shape (bfloat16, 8 × 512, dropout 0.1, 3 steps on one
    batch against three ``fit_mlm`` calls). The launches are those of the
    four replayed chunks, each counted alone (``_scan_case``), summed.
    Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch.datasets import (
        synthetic_bert_batch, synthetic_image_batch)
    from deeplearning4j_tpu_torch.models import LeNet, ResNet50
    from deeplearning4j_tpu_torch.models.bert import BertConfig, BertModel
    from deeplearning4j_tpu_torch.testing import sequential as S

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    problems, cases = [], {}

    def network_loader(net):
        start = _clone_tree([net.params, net.opt_state, net.net_state])

        def load():
            net.params = _load(net.params, start[0])
            net.opt_state = _load(net.opt_state, start[1])
            net.net_state = _load(net.net_state, start[2])
            net.iteration_count = 0
            net._gen.manual_seed(net.conf.seed)
        return load, lambda: [net.params, net.opt_state, net.net_state]

    def stepped_fit(net, xs, ys, rows):
        """``fit`` a batch at a time, on the host arrays."""
        xs, ys = xs.cpu().numpy(), ys.cpu().numpy()

        def run():
            out = []
            for k in range(len(xs) if rows else 3):
                x, y = (xs[k], ys[k]) if rows else (xs, ys)
                net.fit(x, y, batch_size=x.shape[0])
                out.append(net.score())
            return out
        return run

    # LeNet, both modes
    net = LeNet(device=dev).init()
    load, state = network_loader(net)
    lb = S.lenet_batches(S.LENET["batch"], 3)
    xs = torch.from_numpy(np.stack([d.features for d in lb])).to(dev)
    ys = torch.from_numpy(np.stack([d.labels for d in lb])).to(dev)
    for label, rows in (("lenet_rows", True), ("lenet_steps", False)):
        x, y = (xs, ys) if rows else (xs[0], ys[0])
        found, cases[label] = _scan_case(
            label, net, load, stepped_fit(net, x, y, rows),
            lambda x=x, y=y, rows=rows: net.fit_scanned(
                x, y, steps=None if rows else 3), "fit_scanned", state)
        problems += found
    del net
    # ResNet-50 A through ComputationGraph.fit_scanned
    net = ResNet50(num_classes=CLASSES, input_shape=IMAGE,
                   device=dev).init()
    load, state = network_loader(net)
    data = [synthetic_image_batch(32, *IMAGE, CLASSES, seed=100 + i)
            for i in range(3)]
    xs = torch.from_numpy(np.stack([x for x, _ in data])).to(dev)
    ys = torch.from_numpy(np.stack([np.eye(CLASSES, dtype=np.float32)[lab]
                                    for _, lab in data])).to(dev)
    found, cases["resnet50_a_rows"] = _scan_case(
        "resnet50_a_rows", net, load, stepped_fit(net, xs, ys, True),
        lambda: net.fit_scanned(xs, ys), "fit_scanned", state)
    problems += found
    del net, xs, ys
    torch.cuda.empty_cache()
    # BERT-base fit_mlm_scanned at bert_mlm's shape
    cfg = BertConfig.base()
    model = BertModel(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    start = (_clone_tree([model.params, model.opt_state]),
             [g.get_state() for g in model.rng])
    b = synthetic_bert_batch(8, 512, cfg.vocab_size, task="unsupervised",
                             seed=300)
    b_dev = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in b.items()}

    def load_bert():
        model.params = _load(model.params, start[0][0])
        model.opt_state = _load(model.opt_state, start[0][1])
        for g, st in zip(model.rng, start[1]):
            g.set_state(st)
        model.step = 0

    found, cases["bert_mlm_scanned"] = _scan_case(
        "bert_mlm_scanned", model, load_bert,
        lambda: [model.fit_mlm([b])[0] for _ in range(3)],
        lambda: model.fit_mlm_scanned(b_dev, 3), "mlm",
        lambda: [model.params, model.opt_state])
    problems += found
    if model.step != 3:
        problems.append(f"BERT step {model.step} != 3 after the chunk")
    launches = {}
    for case in cases.values():
        for name, n in case["launches"].items():
            launches[name] = launches.get(name, 0) + n
    del model
    torch.cuda.empty_cache()
    line = {"phase": "fit_scanned", "card": smi,
            "cells": {"lenet": "LeNet(), batch 64, 3 steps",
                      "resnet50_a": "ResNet50(), float32, batch 32, 224x224",
                      "bert_mlm": "BertModel(BertConfig.base(), bfloat16), "
                                  "8 x 512, dropout 0.1"},
            "cases": cases, "launches": launches,
            "launches_note": "the replayed chunk of each case alone, its "
                             "counts set to 0 just before it and read just "
                             "after; summed over the cases",
            "problems": problems}
    return problems, line, launches


def _ulp_gap(a, b) -> int:
    """The float32 values' distance in units in the last place (their
    bit patterns on one ordered integer line)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def updater_coefficients_phase(dev, smi):
    """Each schedule's learning rate and each updater kind's coefficient
    buffer (``Updater.coefficients``: what the fused updater kernel reads)
    computed on the card from an int32 step tensor against the same on
    the CPU, at steps 0, 1, 7, 1000 and 100000: the largest gap in float32
    units in the last place, by schedule and by kind. Reported: the
    card's ``pow`` and ``exp`` may differ from the CPU's by an ulp; a
    non-finite value on one side only fails. Returns (problems, line)."""
    import torch

    from deeplearning4j_tpu_torch.nn import updater as U

    schedules = {
        "constant": 3e-3,
        "StepSchedule": U.StepSchedule(value=0.1, decay_rate=0.5, step=3.0),
        "ExponentialSchedule": U.ExponentialSchedule(value=0.05,
                                                     gamma=0.97),
        "InverseSchedule": U.InverseSchedule(value=0.1, gamma=0.2,
                                             power=1.5),
        "PolySchedule": U.PolySchedule(value=0.1, power=2.0, max_iter=500),
        "SigmoidSchedule": U.SigmoidSchedule(value=0.1, gamma=0.05,
                                             step_size=5),
        "CycleSchedule": U.CycleSchedule(initial_lr=1e-3, max_lr=1e-1,
                                         cycle_length=20,
                                         annealing_length=4),
        "MapSchedule": U.MapSchedule(value=0.1, values=((1, 0.05),
                                                        (7, 0.01)))}
    steps = (0, 1, 7, 1000, 100000)
    by_schedule, by_kind, problems = {}, {}, []
    for sname, sched in schedules.items():
        for kind, cls in U.UPDATERS.items():
            u = cls() if kind == "AdaDelta" else cls(learning_rate=sched)
            for step in steps:
                vals = []
                for where in ("cpu", dev):
                    it = torch.tensor(step, dtype=torch.int32, device=where)
                    lr = u.lr(it)
                    vals.append((lr.cpu().numpy(),
                                 u.coefficients(lr, it).cpu().numpy()))
                (lr_c, co_c), (lr_d, co_d) = vals
                if not (np.array_equal(np.isfinite(co_c), np.isfinite(co_d))
                        and np.isfinite(lr_c) == np.isfinite(lr_d)):
                    problems.append(f"{kind} {sname} step {step}: "
                                    f"{co_c} vs {co_d}")
                    continue
                fin = np.isfinite(co_c)
                by_schedule[sname] = max(by_schedule.get(sname, 0),
                                         _ulp_gap(lr_c, lr_d))
                by_kind[kind] = max(by_kind.get(kind, 0),
                                    _ulp_gap(co_c[fin], co_d[fin])
                                    if fin.any() else 0)
    line = {"phase": "updater_coefficients", "card": smi, "steps": steps,
            "max_ulp_gap_lr_by_schedule": by_schedule,
            "max_ulp_gap_coefficients_by_kind": by_kind,
            "max_ulp_gap": max(list(by_schedule.values())
                               + list(by_kind.values())),
            "note": "card (int32 step tensor on the GPU) against the CPU; "
                    "reported, not gated", "problems": problems}
    return problems, line


def _keras_expected_leaves(arrays):
    """The leaves ``import_keras_model_and_weights`` must put in the
    network for the builder's arrays (by layer, in ``weight_names``
    order), written out here independently of the importer's mappers:
    Embedding W; LayerNormalization gain and b; Dense W and b;
    MultiHeadAttention's (d, H, hd) / (H, hd, d) kernels flattened to 2-D
    Wq, Wk, Wv, Wo and their biases to 1-D."""
    want = {}
    for name, arrs in arrays.items():
        if not arrs:
            continue
        if name.endswith("_embedding"):
            want[name] = {"W": arrs[0]}
        elif name.endswith("_norm"):
            want[name] = {"gain": arrs[0], "b": arrs[1]}
        elif name.endswith("_attention"):
            d = arrs[0].shape[0]
            leaves = {}
            for i, part in enumerate("qkv"):
                leaves[f"W{part}"] = arrs[2 * i].reshape(d, -1)
                leaves[f"b{part}"] = arrs[2 * i + 1].reshape(-1)
            leaves["Wo"] = arrs[6].reshape(-1, arrs[6].shape[-1])
            leaves["bo"] = arrs[7].reshape(-1)
            want[name] = leaves
        else:
            want[name] = {"W": arrs[0], "b": arrs[1]}
    return want


def keras_bert_phase(dev, smi, keep=None):
    """Keras import without h5py, Keras or TensorFlow, served on the card:
    ``testing/keras_builder`` writes the legacy ``.h5`` of a BERT-base
    width functional Keras encoder (12 layers, 768, 12 heads, 3072, vocab
    30522, 512 positions; ~440 MB of float32 weights), the port's HDF5
    reader parses it and ``import_keras_model_and_weights`` puts the
    ``ComputationGraph`` on the card (build, parse and import seconds
    printed); every imported leaf must equal the builder's array bit for
    bit; ``output`` on token ids and positions of batch 32 × 128 (counts
    set to 0 just before, read just after) must launch the float32
    tensor-core flash forward exactly 12 times and nothing else of the
    table, and agree with the same forward under ``helper_mode="generic"``
    within 3× that forward's own change when every weight moves by one
    unit in the last place (the probabilities and the last hidden state);
    then the eager forward's p50, tokens/s, busy share and the phase's
    peak memory. A Sequential Conv1D text classifier written by the same
    builder is imported on the card too and held to its generic run and to
    the port's CPU import. ``keep`` (a dict), when given, receives the
    ``.h5`` bytes. Returns (problems, line, launches of the counted
    forward)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import keras_import as ki
    from deeplearning4j_tpu_torch.nn import dtype as DT
    from deeplearning4j_tpu_torch.profile_serve import _profile
    from deeplearning4j_tpu_torch.testing import keras_builder as kb

    cfg = dict(kb.BERT_BASE_KERAS, seq=KERAS_BERT_SEQ)
    layers, batch, seq = cfg["layers"], KERAS_BERT_BATCH, KERAS_BERT_SEQ
    env = environment()
    problems = []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data, arrays = kb.bert_keras_h5(None, **cfg)
    build_s = time.perf_counter() - t0
    if keep is not None:  # keras_bert_transfer imports the same bytes
        keep["h5"] = data
    h5_bytes = len(data)
    t0 = time.perf_counter()
    config, weights = ki.read_keras_h5(data)
    parse_s = time.perf_counter() - t0
    del config, weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net = ki.import_keras_model_and_weights(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    check_s = net.last_check_report.seconds  # inside import_s
    n_params = sum(t.numel() for p in net.params.values()
                   for t in p.values())

    # every leaf against the builder's arrays, bit for bit
    want = _keras_expected_leaves(arrays)
    leaf_problems = []
    got_names = {n for n, p in net.params.items() if p}
    if got_names != set(want):
        leaf_problems.append(f"layers with leaves differ: "
                             f"{sorted(got_names ^ set(want))}")
    n_leaves = 0
    for name, leaves in want.items():
        got = net.params.get(name, {})
        if set(got) != set(leaves):
            leaf_problems.append(f"{name}: leaves {sorted(got)} != "
                                 f"{sorted(leaves)}")
            continue
        for k, arr in leaves.items():
            n_leaves += 1
            t = got[k]
            if (t.device.type != torch.device(dev).type
                    or t.dtype != torch.float32
                    or not torch.equal(t.cpu(), torch.from_numpy(arr))):
                leaf_problems.append(f"{name}.{k} not bit-equal on the card")
    problems += leaf_problems[:8]
    del data, arrays, want

    ids, pos = kb.bert_inputs(batch, seq, cfg["vocab"], seed=1)
    feeds = (ids.astype(np.float32), pos.astype(np.float32))
    last_norm = f"layer_{layers - 1}_output_norm"

    def forward(mode, params=None):
        """(probabilities, last hidden state) under ``mode``."""
        env.helper_mode = mode
        try:
            feed = net._feed(dict(zip(net.conf.network_inputs, feeds)))
            with torch.no_grad(), DT.precision_scope(net.conf.dtype):
                acts, _ = net._forward(params or net.params, net.net_state,
                                       feed, None, train=False)
            return (acts[net.conf.network_outputs[0]].cpu().numpy(),
                    acts[last_norm].cpu().numpy())
        finally:
            env.helper_mode = "auto"

    net.output(*feeds)  # warm-up: the first cuBLAS and kernel calls
    torch.cuda.synchronize()
    disp0 = dispatch_tally()
    _zero_counters()  # the main path's forward starts here
    probs = net.output(*feeds)[0]
    launches = _read_counters()  # ... and ends here
    n_fa, more = gated(dispatch_since(disp0), "dot_product_attention",
                       layers, floor=layers)
    problems += more
    k_probs, k_hidden = forward("auto")
    g_probs, g_hidden = forward("generic")
    y_probs, y_hidden = forward("generic", _nudged(net.params,
                                                   np.random.default_rng(11)))
    want_launches = {k: 0 for k in launches}
    want_launches.update(flash_attn_fwd=n_fa,
                         flash_attn_fwd_f32_sm90=n_fa)
    if launches != want_launches:
        problems.append(f"launches {launches} != {want_launches}")
    if probs.shape != (batch, 2) or not np.all(np.isfinite(probs)):
        problems.append(f"output {probs.shape} not finite")
    if not np.array_equal(probs, k_probs):
        problems.append("output() and the phase's own forward differ")
    checks = {}
    for label, k, g, y in (("probabilities", k_probs, g_probs, y_probs),
                           ("hidden", k_hidden, g_hidden, y_hidden)):
        diff = float(np.abs(k - g).max())
        yard = float(np.abs(y - g).max())
        # at least one unit in the last place of the largest value
        lim = max(KERAS_BERT_YARDSTICK * yard,
                  float(np.finfo(np.float32).eps * np.abs(g).max()))
        checks[label] = {"max_abs_diff_vs_generic": diff,
                         "yardstick_1_ulp": yard, "limit": lim}
        if not diff <= lim:
            problems.append(f"{label}: kernel vs generic {diff} > {lim} "
                            f"({KERAS_BERT_YARDSTICK:g} x yardstick {yard})")

    # the eager forward's time, busy share and the phase's peak memory
    times = []
    for _ in range(KERAS_BERT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(*feeds)
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    prof = _profile(lambda: net.output(*feeds), 2, top=6,
                    named=("flash",))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del net
    gc.collect()
    torch.cuda.empty_cache()

    # the Sequential Conv1D text classifier, on the card and on the CPU
    seq_data, _ = kb.conv1d_keras_h5(None, **KERAS_SEQ_CFG)
    snet = ki.import_keras_sequential_model_and_weights(seq_data, device=dev)
    cnet = ki.import_keras_model_and_weights(seq_data, device="cpu")
    x = np.random.RandomState(2).randint(
        0, KERAS_SEQ_CFG["vocab"], (batch, KERAS_SEQ_CFG["seq"])).astype(
            np.float32)
    s_out = snet.output(x)
    env.helper_mode = "generic"
    try:
        s_gen = snet.output(x)
    finally:
        env.helper_mode = "auto"
    s_cpu = cnet.output(x)
    seq_info = {"config": KERAS_SEQ_CFG, "network": type(snet).__name__,
                "layers": [type(l.lc).__name__ for l in snet.layers],
                "max_abs_diff_vs_generic": float(np.abs(s_out - s_gen).max()),
                "max_abs_diff_vs_cpu": float(np.abs(s_out - s_cpu).max()),
                "tol": KERAS_SEQ_TOL}
    if (s_out.shape != (batch, KERAS_SEQ_CFG["classes"])
            or not np.all(np.isfinite(s_out))
            or seq_info["max_abs_diff_vs_generic"] > KERAS_SEQ_TOL
            or seq_info["max_abs_diff_vs_cpu"] > KERAS_SEQ_TOL):
        problems.append(f"sequential conv1d {seq_info}")
    del snet, cnet
    gc.collect()
    torch.cuda.empty_cache()

    line = {"phase": "keras_bert", "card": smi, "config": cfg,
            "graph": "functional Keras encoder, legacy .h5 as Keras 3.13 "
                     "writes it: Embedding x2 + Add + LayerNormalization, "
                     "per layer MultiHeadAttention + Dense(gelu) + Dense, "
                     "GlobalAveragePooling1D + Dense(tanh) + Dense(2, "
                     "softmax)",
            "weights": "float32, numpy RandomState(0) * 0.02",
            "batch": batch, "seq": seq, "params": n_params,
            "leaves_checked": n_leaves,
            "leaves_bit_equal": not leaf_problems,
            "h5_bytes": h5_bytes, "build_s": build_s,
            "parse_s": parse_s, "import_s": import_s,
            "check_s": check_s,
            "import_weight_gb_per_s": 4 * n_params / import_s / 1e9,
            "forward_launches": launches, "checks": checks,
            "forward_p50_ms": p50 * 1e3,
            "forward_times_ms": [t * 1e3 for t in times],
            "tokens_per_s": batch * seq / p50,
            "device_busy_share": prof["device_busy_share"], "profile": prof,
            "peak_memory_gib": peak,
            "peak_memory_own_gib": peak - resident,
            "sequential_conv1d": seq_info,
            "smoke_reading": f"{KERAS_BERT_TIMED} eager forwards, no spread",
            "problems": problems}
    return problems, line, launches


def serve_supervised_phase(dev, smi, model, engine_kw, prompts, want):
    """The ``serve`` phase's engine (GPT-2-small width, threaded through
    ``start()``), supervised, with ``decode_step_error`` once and
    ``worker_death`` once armed: every request's greedy tokens must equal
    the unfaulted ``serve`` run's (``want``), two restarts, the retries
    equal to the requests active at the two crashes, no capture and no
    ``new_shape`` after a restart, the KV pool the same buffer; then one
    ``page_oom`` shot ends its request as ``oom``. Returns (problems,
    line, launches, faults line)."""
    from deeplearning4j_tpu_torch import faults, observe
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.serving import GenerativeEngine

    faults.reset()
    observe.reset()
    eng = GenerativeEngine(model, **engine_kw)
    crashes = []
    real_recover = eng._recover

    def recover(exc):
        t0 = time.perf_counter()
        active = len(eng.scheduler.active_slots())
        ok = real_recover(exc)
        crashes.append({"error": repr(exc), "active": active,
                        "recovered": ok,
                        "seconds": time.perf_counter() - t0})
        return ok

    eng._recover = recover
    ptr = eng.cache.kv.data_ptr()
    faults.arm("decode_step_error", after_n=SERVE_CRASH_AT[0], max_fires=1)
    faults.arm("worker_death", after_n=SERVE_CRASH_AT[1], max_fires=1)
    disp0 = dispatch_tally()
    ca.reset_launch_counts()              # the main path's run starts here
    eng.start()
    t0 = time.perf_counter()
    try:
        futs = [eng.submit(p, max_new_tokens=32, max_retries=2)
                for p in prompts]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = ca.launch_counts()     # ... and ends here
        serve_disp = dispatch_since(disp0)
        fires = faults.fire_counts()
        faults.reset()
        faults.arm("page_oom", max_fires=1)
        oom = eng.submit(prompts[0], max_new_tokens=4).result(timeout=600)
        oom_fires = faults.fire_counts()
    finally:
        faults.reset()
        eng.stop()
    m = observe.metrics()
    retries = int(m.counter("dl4j_tpu_serving_retries_total").value)
    restarts = int(m.counter("dl4j_tpu_serving_engine_restarts_total").value)
    ledger = _serving_ledger(observe)
    units = {name: unit_memory(u) for name, u in (
        ("prefill", eng._prefill_fn), ("write_prompt", eng._write_fn),
        ("decode", eng._decode_fn))}
    problems = []
    equal = sum(list(a.tokens) == list(b.tokens)
                for a, b in zip(results, want))
    if equal != len(prompts):
        problems.append(f"greedy tokens equal to the unfaulted run: "
                        f"{equal} of {len(prompts)}")
    if any(r.finish_reason not in ("length", "eos") for r in results):
        problems.append(f"finish reasons "
                        f"{[r.finish_reason for r in results]}")
    if fires != {"decode_step_error": 1, "worker_death": 1}:
        problems.append(f"fires {fires}")
    if eng.restarts != 2 or restarts != 2 or len(crashes) != 2:
        problems.append(f"restarts {eng.restarts} (counter {restarts}, "
                        f"{len(crashes)} crashes)")
    if retries != sum(c["active"] for c in crashes):
        problems.append(f"retries {retries} != active at the crashes "
                        f"{[c['active'] for c in crashes]}")
    if ledger != {k: ["first_compile"] for k in (
            "prefill", "write_prompt", "decode")}:
        problems.append(f"serving ledger {ledger}")
    if dev.type == "cuda" and any(u["captures"] != 1
                                  for u in units.values()):
        problems.append(f"captures after the restarts {units}")
    if eng.cache.kv.data_ptr() != ptr:
        problems.append("the KV pool was reallocated")
    if oom.finish_reason != "oom" or oom_fires != {"page_oom": 1}:
        problems.append(f"page_oom shot: {oom.finish_reason}, {oom_fires}")
    # the launches are the gates' decisions under the standing tuning
    # table (the faults fire before a step dispatches anything)
    want = {name: serve_disp.get(f"{op} cuda usable", 0) for op, name in (
        ("dot_product_attention", "flash_attn_fwd"),
        ("paged_decode_attention", "paged_decode"))}
    if dev.type == "cuda" and (
            any(launches[k] != n or not n for k, n in want.items())
            or sum(serve_disp.get(f"dot_product_attention {r}", 0)
                   for r in ("cuda usable", "generic crossover"))
            < len(prompts)):
        problems.append(f"launches {launches}, dispatches {serve_disp}")
    line = {"phase": "serve_supervised", "card": smi,
            "model": "GptConfig.base()", "dtype": "float32",
            "requests": len(prompts), "max_retries": 2,
            "armed": {"decode_step_error": SERVE_CRASH_AT[0],
                      "worker_death": SERVE_CRASH_AT[1]},
            "crashes": crashes, "restarts": eng.restarts,
            "retries": retries, "tokens_equal_unfaulted": equal,
            "launches": launches, "serving_ledger": ledger,
            "graph_units": units, "page_oom_result": oom.finish_reason,
            "wall_s": wall, "tokens_per_s": sum(
                int(r.tokens.size) for r in results) / wall,
            "smoke_reading": "one run, no spread", "problems": problems}
    fl = _faults_line("serve_supervised", [
        {"run": "threaded", "armed": [
            f"decode_step_error:after_n={SERVE_CRASH_AT[0]}",
            f"worker_death:after_n={SERVE_CRASH_AT[1]}"],
         "fires": fires, "restarts": eng.restarts},
        {"run": "page_oom shot", "armed": ["page_oom:max_fires=1"],
         "fires": oom_fires, "restarts": 0}])
    return problems, line, launches, fl


def cuda_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` (a captured unit, which cannot be
    captured again inside ``time_ms``'s graph): ``iters`` calls between
    two CUDA events after two warm calls, the mean per call."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _serving_ledger(observe) -> dict:
    out = {}
    for ev in observe.ledger().events():
        if ev.graph == "serving":
            out.setdefault(ev.key, []).append(ev.cause)
    return out


def attention_ms(dev, b, h, t_q, t_k, d, mask) -> float:
    """Device time of the registry's ``dot_product_attention`` as the
    serving path calls it (its gate picks flash or the generic version by
    shape) on random inputs of that shape, ``mask`` (b, 1, t_q|1, t_k)."""
    import torch

    from deeplearning4j_tpu_torch.ops import exec_op

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=dev)
               for t in (t_q, t_k, t_k))
    return time_ms(lambda: exec_op("dot_product_attention", q, k, v, mask,
                                   scaled=True))


def prefix_requests(cfg):
    """The serve_prefix traffic: ``PREFIX_SYSTEM`` system prompts and
    ``PREFIX_REQUESTS`` prompts (four a system prompt, in turn) each with
    a ``PREFIX_TAILS`` tail, from a numpy seed."""
    rng = np.random.default_rng(5)
    n_sys, sys_len = PREFIX_SYSTEM
    systems = [rng.integers(1, cfg.vocab_size, sys_len).astype(np.int32)
               for _ in range(n_sys)]
    prompts = [np.concatenate([systems[i % n_sys], rng.integers(
        1, cfg.vocab_size, int(rng.integers(PREFIX_TAILS[0],
                                            PREFIX_TAILS[1] + 1)))
        .astype(np.int32)]) for i in range(PREFIX_REQUESTS)]
    return systems, prompts


def _divergences(model, prompts, want, got, problems, what):
    """Explain every greedy stream of ``got`` that differs from ``want``
    (``explain_divergence``: a near tie, else a problem)."""
    out = []
    for p, a, b in zip(prompts, want, got):
        if list(a) != list(b):
            ok, det = explain_divergence(model, p, list(a), list(b))
            out.append(det)
            if not ok:
                problems.append(f"{what}: greedy tokens diverge without a "
                                f"near-tie: {det}")
    return out


def serve_prefix_phase(dev, smi, model):
    """The radix prefix cache at GPT-2-small width: ``PREFIX_REQUESTS``
    shared-prefix requests closed loop through an engine with the cache
    off (the reference), then — launch counts set to 0 just before —
    ``prewarm_prefix`` of the ``PREFIX_SYSTEM`` system prompts (pinned)
    and the same requests through an engine with ``prefix_pages``. Checks
    the tokens against the cache-off run (ties explained), one hit a
    request, the exact flash, paged and generic-attention counts, one
    ``first_compile`` a unit and no ``new_shape``, and the allocator and
    tree invariants. Times TTFT on and off, the suffix-prefill and
    full-prefill units, and the generic attention inside the suffix
    prefill. Returns (problems, line, launches, traffic)."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.serving import GenerativeEngine

    import torch

    cfg, layers = model.cfg, model.cfg.layers
    systems, prompts = prefix_requests(cfg)
    kw = dict(PREFIX_KW, device=dev)

    def closed_loop(eng):
        return [eng.generate([p], max_new_tokens=PREFIX_NEW_TOKENS,
                             eos_token=-1)[0] for p in prompts]

    off = closed_loop(GenerativeEngine(model, **kw))
    observe.reset()
    eng = GenerativeEngine(model, **kw, **PREFIX_CACHE_KW)
    ca.reset_launch_counts()              # the main path's run starts here
    t0 = time.perf_counter()
    for sp in systems:
        eng.prewarm_prefix(sp)
    on = closed_loop(eng)
    wall = time.perf_counter() - t0
    launches = ca.launch_counts()         # ... and ends here
    dispatch = dispatch_tally()
    m = observe.metrics()
    decode_steps = m.histogram("dl4j_tpu_serving_decode_step_seconds").count
    hits = int(m.counter("dl4j_tpu_prefix_hits_total").value)
    cows = int(m.counter("dl4j_tpu_prefix_cow_copies_total").value)
    ledger = _serving_ledger(observe)
    units = {name: unit_memory(u) for name, u in (
        ("prefill", eng._prefill_fn), ("write_prompt", eng._write_fn),
        ("suffix_prefill", eng._suffix_fn), ("decode", eng._decode_fn))}
    problems = []
    try:
        eng.check_invariants()
    except AssertionError as e:
        problems.append(f"invariants: {e}")
    n_sys, sys_len = PREFIX_SYSTEM
    want_steps = PREFIX_REQUESTS * (PREFIX_NEW_TOKENS - 1)
    if any(r.finish_reason != "length" for r in on + off):
        problems.append(f"finish reasons {[r.finish_reason for r in on]}")
    if hits != PREFIX_REQUESTS or any(r.prefix_hit_tokens != sys_len
                                      for r in on):
        problems.append(f"hits {hits}, hit tokens "
                        f"{[r.prefix_hit_tokens for r in on]}")
    if eng.prefix.pinned_pages != n_sys * sys_len // PREFIX_KW["page_size"]:
        problems.append(f"pinned pages {eng.prefix.pinned_pages}")
    # the system prompts' prefills and the decode steps go to the kernels
    # as the gates decide under the standing tuning table; the suffix
    # prefills (a query offset into the cached keys) are refused by shape
    n_fa, more = gated(dispatch, "dot_product_attention", layers * n_sys)
    n_pd, more2 = gated(dispatch, "paged_decode_attention",
                        layers * want_steps)
    problems += more + more2
    want_disp = {"dot_product_attention generic not_usable":
                 layers * PREFIX_REQUESTS}
    got_disp = {k: dispatch.get(k, 0) for k in want_disp}
    if decode_steps != want_steps or got_disp != want_disp:
        problems.append(f"decode steps {decode_steps} (want {want_steps}), "
                        f"dispatches {got_disp} (want {want_disp})")
    if (launches["flash_attn_fwd"] != n_fa
            or launches["flash_attn_fwd_f32_sm90"] != n_fa
            or launches["paged_decode"] != n_pd):
        problems.append(f"launches {launches}, want flash {n_fa}, paged "
                        f"{n_pd}")
    if ledger != {k: ["first_compile"] for k in (
            "prefill", "write_prompt", "suffix_prefill", "decode")}:
        problems.append(f"serving ledger {ledger}")
    if dev.type == "cuda" and any(u["captures"] != 1
                                  for u in units.values()):
        problems.append(f"captures {units}")
    divergences = _divergences(model, prompts, [r.tokens for r in off],
                               [r.tokens for r in on], problems,
                               "prefix on vs off")
    timing = {}
    if dev.type == "cuda":
        # after every check: a replay rewrites the last request's suffix
        # K/V with the same values, and the full prefill's unit its scratch
        suffix_ms = cuda_ms(eng._suffix_fn)
        prefill_ms = cuda_ms(eng._prefill_fn)
        b, t_pre = PREFIX_CACHE_KW["suffix_bucket"], PREFIX_KW["max_prompt"]
        ar = torch.arange(b, device=dev)
        m_suf = (ar[None, :] <= ar[:, None]) & (ar[None, :] < 16)
        m_pre = (torch.arange(t_pre, device=dev) < sys_len)[None].expand(
            b, t_pre)
        mask = torch.cat([m_pre, m_suf], dim=1)[None, None]
        attn = attention_ms(dev, 1, cfg.heads, b, t_pre + b,
                            cfg.hidden // cfg.heads, mask)
        timing = {"suffix_prefill_unit_ms": suffix_ms,
                  "prefill_unit_ms": prefill_ms,
                  "generic_attention_ms": attn,
                  "generic_attention_ms_per_unit": attn * layers,
                  "generic_attention_share": attn * layers / suffix_ms,
                  "attention_shape": f"q 1x{cfg.heads}x{b}x64, k/v "
                                     f"1x{cfg.heads}x{t_pre + b}x64, "
                                     f"dense (1,1,{b},{t_pre + b}) mask",
                  "timed": "CUDA events over 20 replays (units); 20 calls "
                           "in a CUDA graph x 5 replays (attention)"}
    ttft_on = float(np.percentile([r.ttft_s for r in on], 50)) * 1e3
    ttft_off = float(np.percentile([r.ttft_s for r in off], 50)) * 1e3
    line = {"phase": "serve_prefix", "card": smi,
            "model": "GptConfig.base()", "dtype": "float32",
            "engine": dict(PREFIX_KW, **PREFIX_CACHE_KW),
            "system_prompts": list(PREFIX_SYSTEM),
            "requests": PREFIX_REQUESTS, "tails": list(PREFIX_TAILS),
            "new_tokens": PREFIX_NEW_TOKENS, "hits": hits,
            "cow_copies": cows, "tree_pages": eng.prefix.tree_pages,
            "pinned_pages": eng.prefix.pinned_pages,
            "decode_steps": decode_steps, "launches": launches,
            "dispatch": dispatch, "serving_ledger": ledger,
            "graph_units": units,
            "ttft_p50_ms": {"prefix_on": ttft_on, "prefix_off": ttft_off},
            "ttft_reading": "closed loop, one request at a time; the p50 "
                            "over the 16 requests, the first of which "
                            "captures its units; one run, no spread",
            "wall_s": wall,
            "tokens_equal_prefix_off": sum(
                list(a.tokens) == list(b.tokens) for a, b in zip(off, on)),
            "divergences": divergences, **timing, "problems": problems}
    traffic = (systems, prompts, [r.tokens for r in off])
    return problems, line, launches, traffic


def _draft_agreement(draft, k, prompts, results):
    """The acceptance the committed streams predict. The draft is fed the
    committed stream, so proposal ``i`` of a verify is the draft's argmax
    after that stream's prefix: one draft prefill over each prompt and its
    stream (``helper_mode="generic"``: no kernel) gives every such argmax
    at once. Walking each request's verifies as the engine does (the
    leading agreeing proposals land, then the target's token, never past
    the budget) gives its accepted count. Returns (per-request predicted
    accepted, per-request smallest draft top-2 gap at the positions the
    walk read, positions where the draft agrees, positions)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models.gpt import gpt_prefill

    env = environment()
    env.helper_mode = "generic"
    predicted, gaps, agree_n, n_pos = [], [], 0, 0
    try:
        for p, r in zip(prompts, results):
            toks = np.asarray(r.tokens, np.int64)
            n, p_len = int(toks.size), int(p.size)
            ids = torch.from_numpy(np.concatenate(
                [p.astype(np.int64), toks[:-1]])[None]).to(draft.device)
            with torch.no_grad():
                rows = gpt_prefill(draft.params, ids, draft.cfg)[0][
                    0, p_len - 1:p_len - 1 + n].float()
            top2 = torch.topk(rows, 2, dim=-1)
            agree = (top2.indices[:, 0].cpu().numpy() == toks)
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            agree_n += int(agree[1:].sum())
            n_pos += n - 1
            c, acc, read = 1, 0, []
            while c < n:
                rem, j = n - c, 0
                while j < min(k, rem) and agree[c + j]:
                    j += 1
                read += list(range(c, min(c + j + 1, n)))
                m = min(j + 1, rem)
                acc += min(j, m)
                c += m
            predicted.append(acc)
            gaps.append(float(gap[read].min()))
    finally:
        env.helper_mode = "auto"
    return predicted, gaps, agree_n, n_pos


def _propose_check(spec, snap):
    """One captured ``propose`` against the same draft steps run with
    ``helper_mode="generic"`` from the draft cache it started from
    (``snap``: the cache, the staged tokens, lengths and active flags, and
    the proposals the captured unit returned). Each generic step is fed
    the captured proposal before it, so every step compares one argmax; a
    proposal that differs passes only as a near tie (the generic top-2 gap
    within 2·LOGIT_TOL). Returns (problems, summary)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.serving.speculative import (
        _draft_decode_step)

    env = environment()
    env.helper_mode = "generic"
    cfg, params = spec.draft.cfg, spec.draft.params
    kv = snap["kv"].clone()
    toks, pos, active = snap["tokens"], snap["lens"], snap["active"]
    step = (active > 0).to(torch.int32)
    props = torch.from_numpy(snap["props"]).to(kv.device)
    on = snap["active"].cpu().numpy() > 0
    mismatches, n_eq = [], 0
    try:
        with torch.no_grad():
            for j in range(spec.k):
                _, logits = _draft_decode_step(params, kv, toks, pos,
                                               active, cfg)
                top2 = torch.topk(logits.float(), 2, dim=-1)
                am = top2.indices[:, 0].cpu().numpy()
                gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
                for s in np.flatnonzero(on):
                    if am[s] == snap["props"][s, j]:
                        n_eq += 1
                    else:
                        mismatches.append({"slot": int(s), "step": j,
                                           "top2_gap": float(gap[s])})
                toks, pos = props[:, j], pos + step
    finally:
        env.helper_mode = "auto"
    problems = [f"captured propose vs generic: {m}" for m in mismatches
                if m["top2_gap"] > 2 * LOGIT_TOL]
    return problems, {"propose_call": snap["call"],
                      "active_slots": int(on.sum()),
                      "lens": snap["lens"].cpu().numpy().tolist(),
                      "proposals": int(on.sum()) * spec.k,
                      "equal_generic": n_eq, "mismatches": mismatches}


def verify_attention_ms(dev, eng, cfg) -> dict:
    """Device time of one layer's attention inside ``gpt_verify`` at the
    run's shape: as the path calls it (the gather of every slot's pages
    from the engine's cache through its last page table, the
    concatenation with the fed tokens' K/V, the registry's generic
    ``dot_product_attention`` under the dense mask) and the attention
    alone on contiguous inputs; their difference is the layout work."""
    import torch

    from deeplearning4j_tpu_torch.ops import exec_op

    v = eng._ver
    kvp, page = eng.cache.kv, eng.cache.page_size
    table, seq_lens = v["page_table"], v["seq_lens"]
    s_n, w = v["tokens"].shape
    h, d = cfg.heads, cfg.hidden // cfg.heads
    t_v = table.shape[1] * page
    tpos = torch.arange(t_v, device=dev)
    ar = torch.arange(w, device=dev)
    gpage, goff = table.long()[:, tpos // page], tpos % page
    m_ctx = (tpos[None, None, :] < seq_lens[:, None, None]).expand(
        s_n, w, t_v)
    m_fed = (ar[None, :] <= ar[:, None])[None].expand(s_n, w, w)
    m4 = torch.cat([m_ctx, m_fed], dim=2)[:, None]
    g = torch.Generator(device=dev).manual_seed(0)
    q, kf, vf = (torch.randn((s_n, h, w, d), generator=g, device=dev)
                 for _ in range(3))

    def path():
        kc = kvp[0, 0][gpage, goff].permute(0, 2, 1, 3)
        vc = kvp[0, 1][gpage, goff].permute(0, 2, 1, 3)
        return exec_op("dot_product_attention", q, torch.cat([kc, kf], 2),
                       torch.cat([vc, vf], 2), m4, scaled=True)

    path_ms = time_ms(path)
    alone = attention_ms(dev, s_n, h, w, t_v + w, d, m4)
    return {"path_ms": path_ms, "attention_ms": alone,
            "layout_ms": path_ms - alone,
            "shape": f"q {s_n}x{h}x{w}x{d}, k/v {s_n}x{h}x{t_v + w}x{d}, "
                     f"dense ({s_n},1,{w},{t_v + w}) mask"}


def _spec_run(dev, model, engine_kw, prompts, want, scale, timed):
    """One serve_spec run: the serve phase's engine configuration and
    requests with ``spec_k`` ``SPEC_K`` and ``perturbed_draft(scale)``,
    threaded, launch counts set to 0 just before and read just after.
    Propose call ``SPEC_CHECK_CALL`` keeps the draft cache it started from
    and its proposals; after the run they are held against the generic
    draft steps (``_propose_check``), and that cache's first layer, at the
    key lengths the call's step 0 sees, feeds ``flash_draft_case``. The
    accepted count must equal what the committed streams predict
    (``_draft_agreement``) request by request, or differ only where the
    draft has a near tie. Returns (problems, line, launches)."""
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.serving import (
        GenerativeEngine, perturbed_draft)

    import torch

    cfg, layers = model.cfg, model.cfg.layers
    draft = perturbed_draft(model, scale=scale, seed=1)
    observe.reset()
    eng = GenerativeEngine(model, **engine_kw, spec_k=SPEC_K,
                           draft_model=draft)
    calls = {"propose": 0, "plain_decode": 0}
    snap = {}
    real_propose = eng.spec.propose

    def propose(tokens, active):
        calls["propose"] += 1
        if calls["propose"] != SPEC_CHECK_CALL:
            return real_propose(tokens, active)
        torch.cuda.synchronize()
        snap["kv"] = eng.spec.kv.clone()
        props = real_propose(tokens, active)
        p = eng.spec._prop
        snap.update(call=SPEC_CHECK_CALL, props=props,
                    tokens=p["tokens"].clone(), lens=p["lens"].clone(),
                    active=p["active"].clone())
        torch.cuda.synchronize()
        return props

    def plain_decode(*a, **k):
        calls["plain_decode"] += 1
        return real_decode(*a, **k)

    real_decode = eng._step_decode
    eng.spec.propose = propose
    eng._step_decode = plain_decode
    disp0 = dispatch_tally()
    ca.reset_launch_counts()              # the main path's run starts here
    results, wall = serve(eng, prompts)
    launches = ca.launch_counts()         # ... and ends here
    dispatch = dispatch_since(disp0)
    ledger = _serving_ledger(observe)
    units = {name: unit_memory(u) for name, u in (
        ("prefill", eng._prefill_fn), ("write_prompt", eng._write_fn),
        ("verify", eng._verify_fn),
        ("draft_prefill", eng.spec._prefill_fn),
        ("draft_decode", eng.spec._propose_fn))}
    problems = []
    try:
        eng.check_invariants()
    except AssertionError as e:
        problems.append(f"invariants: {e}")
    n_req = len(prompts)
    proposes = calls["propose"]
    # the target's and the draft's prefills and the verify windows go to
    # the flash kernel, the plain steps to paged decode, as the gates
    # decide under the standing tuning table
    want_flash, more = gated(dispatch, "dot_product_attention",
                             layers * (2 * n_req + (SPEC_K + 1) * proposes))
    want_paged, more2 = gated(dispatch, "paged_decode_attention",
                              layers * calls["plain_decode"], floor=0)
    problems += more + more2
    if (launches["flash_attn_fwd"] != want_flash
            or launches["flash_attn_fwd_f32_sm90"] != want_flash
            or launches["paged_decode"] != want_paged):
        problems.append(f"launches {launches}, want flash {want_flash}, "
                        f"paged {want_paged}")
    want_disp = {"dot_product_attention generic not_usable":
                 layers * proposes}
    got_disp = {k: dispatch.get(k, 0) for k in want_disp}
    if not proposes or got_disp != want_disp:
        problems.append(f"{proposes} proposes, dispatches {got_disp}")
    want_ledger = {k: ["first_compile"] for k in (
        "prefill", "write_prompt", "draft_prefill", "draft_decode",
        "verify")}
    if calls["plain_decode"]:
        want_ledger["decode"] = ["first_compile"]
    if ledger != want_ledger:
        problems.append(f"serving ledger {ledger}")
    if dev.type == "cuda" and any(u["captures"] != 1
                                  for u in units.values()):
        problems.append(f"captures {units}")
    if any(r.finish_reason not in ("length", "eos") for r in results):
        problems.append(f"finish reasons "
                        f"{[r.finish_reason for r in results]}")
    divergences = _divergences(model, prompts, [r.tokens for r in want],
                               [r.tokens for r in results], problems,
                               f"spec (draft scale {scale}) vs serve")
    proposed = sum(r.spec_proposed_tokens for r in results)
    accepted = sum(r.spec_accepted_tokens for r in results)
    generated = sum(int(r.tokens.size) for r in results)
    # the draft path against its references, after the counted run
    if not snap:
        problems.append(f"propose call {SPEC_CHECK_CALL} never came")
        propose_check, draft_flash = None, None
    else:
        probs, propose_check = _propose_check(eng.spec, snap)
        problems += probs
        # step 0 of the call attends to keys j <= lens in every slot
        ok, draft_flash = flash_draft_case(
            dev, snap["kv"][0], snap["lens"].cpu().numpy() + 1)
        if not ok:
            problems.append(f"flash at the draft step: {draft_flash}")
        del snap["kv"]
    predicted, gaps, agree_n, n_pos = _draft_agreement(
        draft, SPEC_K, prompts, results)
    acc_by_req = [r.spec_accepted_tokens for r in results]
    unexplained = [i for i, (a, b, g) in enumerate(
        zip(acc_by_req, predicted, gaps)) if a != b and g > 2 * LOGIT_TOL]
    if unexplained:
        problems.append(f"accepted {acc_by_req} vs predicted {predicted}: "
                        f"requests {unexplained} without a draft near tie")
    timing = {}
    if timed and dev.type == "cuda":
        # after every check: replays rewrite K/V past the committed lengths
        propose_ms = cuda_ms(eng.spec._propose_fn)
        verify_ms = cuda_ms(eng._verify_fn)
        ver = verify_attention_ms(dev, eng, cfg)
        per_propose = layers * (SPEC_K + 1)
        timing = {
            "draft_decode_unit_ms": propose_ms, "verify_unit_ms": verify_ms,
            "flash_tq1_path_ms": draft_flash["path_ms"],
            "flash_tq1_kernel_ms": draft_flash["ms"],
            "flash_tq1_layout_copies_ms": draft_flash["layout_copies_ms"],
            "flash_tq1_path_ms_per_propose":
                draft_flash["path_ms"] * per_propose,
            "flash_tq1_path_share_of_propose":
                draft_flash["path_ms"] * per_propose / propose_ms,
            "flash_tq1_kernel_share_of_propose":
                draft_flash["ms"] * per_propose / propose_ms,
            "verify_attention_path_ms": ver["path_ms"],
            "verify_generic_attention_ms": ver["attention_ms"],
            "verify_layout_ms": ver["layout_ms"],
            "verify_attention_path_share":
                ver["path_ms"] * layers / verify_ms,
            "verify_generic_attention_share":
                ver["attention_ms"] * layers / verify_ms,
            "verify_attention_shape": ver["shape"],
            "timed": "CUDA events over 20 replays (units); 20 calls in a "
                     "CUDA graph x 5 replays (attention, one layer, on the "
                     "run's caches)"}
    line = {"draft": f"perturbed_draft(scale={scale}, seed=1)",
            "calls": calls, "proposed_tokens": proposed,
            "accepted_tokens": accepted,
            "accept_ratio": accepted / proposed if proposed else None,
            "accepted_by_request": acc_by_req,
            "predicted_accepted_by_request": predicted,
            "draft_agrees_at": [agree_n, n_pos],
            "draft_min_top2_gap_by_request": gaps,
            "propose_check": propose_check, "draft_flash": draft_flash,
            "generated_tokens": generated, "wall_s": wall,
            "tokens_per_s": generated / wall, "launches": launches,
            "dispatch": dispatch, "serving_ledger": ledger,
            "graph_units": units,
            "tokens_equal_serve": sum(list(a.tokens) == list(b.tokens)
                                      for a, b in zip(want, results)),
            "divergences": divergences, **timing, "problems": problems}
    return problems, line, launches


def serve_spec_phase(dev, smi, model, engine_kw, prompts, want, serve_line):
    """Speculative decoding at GPT-2-small width: the serve phase's
    engine configuration and requests with ``spec_k`` ``SPEC_K``, once a
    draft scale of ``SPEC_DRAFT_SCALES`` (``_spec_run``). Checks in each
    run the committed streams against the serve phase's greedy streams
    ``want`` (ties explained), the flash launches (``layers`` x (target
    and draft prefills + (K+1) x proposes): every draft step runs flash at
    one query a slot), the paged launches (plain decode steps only), the
    generic attention of each verify, one ``first_compile`` a unit and no
    ``new_shape``, and the invariants; each run also holds one captured
    propose against the generic draft steps, the flash forward against its
    plain version on that propose's draft cache, and the accepted counts
    against the committed streams' prediction (``_spec_run``). The second
    draft must have some of its proposals accepted and some rejected. The
    first run times the propose and verify units, and one layer's
    attention inside each as the path calls it (layout copies included)
    and alone. Returns (problems, line, launches of both runs)."""
    problems, runs, total = [], [], {}
    for i, scale in enumerate(SPEC_DRAFT_SCALES):
        probs, run, launches = _spec_run(dev, model, engine_kw, prompts,
                                         want, scale, timed=i == 0)
        problems += probs
        runs.append(run)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    mixed = runs[-1]
    if not 0 < mixed["accepted_tokens"] < mixed["proposed_tokens"]:
        problems.append(f"draft {mixed['draft']}: {mixed['accepted_tokens']}"
                        f" of {mixed['proposed_tokens']} accepted")
    line = {"phase": "serve_spec", "card": smi, "model": "GptConfig.base()",
            "dtype": "float32", "spec_k": SPEC_K, "requests": len(prompts),
            "max_new_tokens": 32, "runs": runs,
            "tokens_per_s_spec_off": serve_line["tokens_per_s"],
            "tokens_per_s_reading": "spec off is the serve phase's captured "
                                    "run in this call; each run includes "
                                    "its units' captures; one run each, no "
                                    "spread",
            "problems": problems}
    return problems, line, total


def serve_cluster_phase(dev, smi, model, traffic):
    """``ClusterRouter`` over two engines of the serve_prefix
    configuration behind ``SLOFrontend`` (interactive and standard pin a
    system prompt each on both engines; batch's token bucket holds
    ``CLUSTER_BATCH[1]``). Engine 0's loop runs alone until
    ``engine_death`` fires in it (after ``CLUSTER_DEATH_AT`` iterations);
    then engine 1 starts. Every retryable request must complete on engine
    1 with the serve_prefix reference tokens (ties explained), the batch
    arrivals past the bucket shed by count, and the survivor record no
    ``new_shape``. Returns (problems, line, launches)."""
    from deeplearning4j_tpu_torch import faults, observe
    from deeplearning4j_tpu_torch.faults import InjectedFault
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.serving import (
        ClusterRouter, GenerativeEngine, LadderThresholds, SLOFrontend,
        default_classes)

    systems, prompts, want = traffic
    faults.reset()
    observe.reset()
    engines = [GenerativeEngine(model, **PREFIX_KW, **PREFIX_CACHE_KW,
                                device=dev, engine_id=i) for i in range(2)]
    for e in engines:  # capture every unit before the frontend reads
        e.generate([prompts[0]], max_new_tokens=2, eos_token=-1)
    router = ClusterRouter(engines)
    e0, e1 = engines
    classes = default_classes()
    classes["interactive"].shared_prefix = systems[0]
    classes["standard"].shared_prefix = systems[1]
    classes["batch"].rate = 1e-3            # no refill inside the run
    classes["batch"].burst = CLUSTER_BATCH[1]
    # a ladder that stays "ok": the phase checks migration and the token
    # bucket, and a degraded answer would not be the reference's
    fe = SLOFrontend(router, classes=classes, thresholds=LadderThresholds(
        degraded_queue=1000, shedding_queue=2000, degraded_p99_s=60.0,
        shedding_p99_s=120.0))
    plan = [("interactive" if i % 4 == 0 else "standard", i)
            for i in range(len(prompts))]
    plan += [("batch", i) for i in range(CLUSTER_BATCH[0])]
    new_shape0 = sum(c == "new_shape" for cs in _serving_ledger(
        observe).values() for c in cs)
    faults.arm("engine_death", prob=1.0, after_n=CLUSTER_DEATH_AT,
               max_fires=1)
    counts0 = _cluster_counts(observe)
    ca.reset_launch_counts()              # the main path's run starts here
    t0 = time.perf_counter()
    e0.start()
    try:
        futs = [fe.submit(prompts[i], slo_class=cls,
                          max_new_tokens=PREFIX_NEW_TOKENS, eos_token=-1,
                          max_retries=2) for cls, i in plan]
        limit = time.perf_counter() + 300
        while e0._error is None and time.perf_counter() < limit:
            time.sleep(1e-3)
        death_s = time.perf_counter() - t0
        e1.start()
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = ca.launch_counts()     # ... and ends here
        counts = {k: n - counts0[k]
                  for k, n in _cluster_counts(observe).items()}
        live = router.live_engines()
    finally:
        faults.reset()
        router.stop()
    m = observe.metrics()
    routed = {}
    for inst in m.instruments():
        if inst.name == "dl4j_tpu_cluster_routed_total" and inst.value:
            lab = dict(inst.labels)
            routed[f"{lab['engine']} {lab['reason']}"] = int(inst.value)
    sheds = {}
    for inst in m.instruments():
        if inst.name == "dl4j_tpu_slo_shed_total" and inst.value:
            lab = dict(inst.labels)
            sheds[f"{lab['class']} {lab['reason']}"] = int(inst.value)
    ledger = _serving_ledger(observe)
    new_shape = sum(c == "new_shape" for cs in ledger.values()
                    for c in cs) - new_shape0
    problems = []
    try:
        router.check_invariants()
    except AssertionError as e:
        problems.append(f"invariants: {e}")
    if not isinstance(e0._error, InjectedFault) or live != [e1]:
        problems.append(f"engine 0 error {e0._error!r}, live "
                        f"{[e.engine_id for e in live]}")
    to_e0 = sum(n for k, n in routed.items() if k.startswith("0 "))
    if router.deaths != 1 or not to_e0 or router.migrations != to_e0:
        problems.append(f"deaths {router.deaths}, migrations "
                        f"{router.migrations}, routed {routed}")
    n_shed = CLUSTER_BATCH[0] - CLUSTER_BATCH[1]
    if sheds != {"batch rate_limit": n_shed}:
        problems.append(f"sheds {sheds}, want batch rate_limit {n_shed}")
    served = [(i, r) for (cls, i), r in zip(plan, results)
              if r.finish_reason != "shed"]
    if (len(served) != len(plan) - n_shed
            or any(r.finish_reason != "length" for _, r in served)):
        problems.append(f"finish reasons "
                        f"{[r.finish_reason for r in results]}")
    divergences = _divergences(
        model, [prompts[i] for i, _ in served], [want[i] for i, _ in served],
        [r.tokens for _, r in served], problems, "cluster vs reference")
    if new_shape:
        problems.append(f"{new_shape} new_shape events: {ledger}")
    # in the run's own counts: every admission without a hit is a full
    # (flash) prefill, every hit a suffix prefill (generic attention),
    # every decode step a paged launch a layer
    layers = model.cfg.layers
    full = counts["lookups"] - counts["hits"]
    # the full prefills and decode steps the gates send to the kernels
    # under the standing tuning table
    n_fa, more = gated(counts, "dot_product_attention", layers * full)
    n_pd, more2 = gated(counts, "paged_decode_attention",
                        layers * counts["decode_steps"])
    problems += more + more2
    want_counts = {"flash_attn_fwd": n_fa, "flash_attn_fwd_f32_sm90": n_fa,
                   "paged_decode": n_pd,
                   "generic not_usable": layers * counts["hits"]}
    got = {k: launches[k] for k in want_counts if k in launches}
    got["generic not_usable"] = counts[
        "dot_product_attention generic not_usable"]
    if got != want_counts or not (full and counts["hits"]
                           and counts["decode_steps"]):
        problems.append(f"launches and dispatches {got}, want {want_counts} "
                        f"({counts})")
    line = {"phase": "serve_cluster", "card": smi,
            "model": "GptConfig.base()", "dtype": "float32", "engines": 2,
            "engine": dict(PREFIX_KW, **PREFIX_CACHE_KW),
            "plan": {c: sum(p[0] == c for p in plan) for c in (
                "interactive", "standard", "batch")},
            "engine_death_after": CLUSTER_DEATH_AT,
            "death_s": death_s, "wall_s": wall, "routed": routed,
            "deaths": router.deaths, "migrations": router.migrations,
            "sheds": sheds, "frontend_state": fe.state,
            "tokens_equal_reference": sum(
                list(r.tokens) == list(want[i]) for i, r in served),
            "served": len(served), "divergences": divergences,
            "launches": launches, "run_counts": counts,
            "new_shape": new_shape, "problems": problems}
    return problems, line, launches


def _cluster_counts(observe) -> dict:
    """The process-wide serving counts serve_cluster reads before and
    after its run: admissions (prefix lookups), prefix hits, decode steps
    and the generic attention dispatches a shape refused."""
    m = observe.metrics()
    return {"lookups": int(m.counter("dl4j_tpu_prefix_lookups_total").value),
            "hits": int(m.counter("dl4j_tpu_prefix_hits_total").value),
            "decode_steps": m.histogram(
                "dl4j_tpu_serving_decode_step_seconds").count,
            **{k: dispatch_tally().get(k, 0) for k in (
                "dot_product_attention generic not_usable",
                "dot_product_attention cuda usable",
                "dot_product_attention generic crossover",
                "paged_decode_attention cuda usable",
                "paged_decode_attention generic crossover")}}


def lenet_bf16_phase(dev, smi):
    """``LeNet()`` under the "bfloat16" policy: bfloat16 parameters,
    float32 input promoting each op to float32 (as jnp does), 3 steps
    ``helper_mode="generic"`` then 3 counted steps through the fused
    updater on the bfloat16 leaves: losses and parameters bit-equal.
    Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.testing import sequential as S

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    conf = LeNet().conf()
    conf.dtype = "bfloat16"
    net = tnn.MultiLayerNetwork(conf, device=dev).init()
    n_leaves = sum(len(p) for p in net.params)
    batch, steps = S.LENET["batch"], S.LENET["steps"]
    batches = S.lenet_batches(batch, steps)
    start, generic, kernel, launches, leaves, tally, capture = (
        _mln_main_path(net, batches))
    problems = (updater_count_problems(launches["fused_updater"], leaves,
                                       n_leaves, steps)
                if dev.type == "cuda" else []) + capture[0]
    dtypes = sorted({str(x.dtype) for _, x in leaf_paths(kernel[2])}
                    | {str(x.dtype) for _, x in leaf_paths(net.opt_state)})
    if dtypes != ["torch.bfloat16"]:
        problems.append(f"leaves in {dtypes}, not bfloat16")
    diff = _max_diff(kernel[2], generic[2])
    if kernel[0] != generic[0] or diff != 0.0:
        problems.append(f"not bit-equal to generic: losses {kernel[0]} vs "
                        f"{generic[0]}, params {diff}")
    out = net.output(batches[0].features)
    if out.dtype != np.float32 or not np.isfinite(out).all():
        problems.append(f"output {out.dtype}")
    line = {"phase": "lenet_bf16", "card": smi,
            "model": "LeNet() with dtype('bfloat16')", "batch": batch,
            "steps": steps, "leaves": n_leaves, "launches": launches,
            "fused_updater_leaves": leaves, "dispatch": tally,
            "leaf_dtypes": dtypes, "losses_generic": generic[0],
            "losses_kernel": kernel[0], "param_max_abs_diff": diff,
            "bit_equal": not problems,
            "step_p50_ms": float(np.percentile(kernel[1], 50)) * 1e3,
            "generic_step_p50_ms": float(np.percentile(generic[1], 50))
            * 1e3, **capture[1], "smoke_reading": f"{steps} steps, no spread",
            "problems": problems}
    del net
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return problems, line, launches


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _first_output(out):
    return out[0] if isinstance(out, list) else out


def _zoo_run(net, start, mode, batches, *, dev, listeners=(), eager=False):
    """``net.fit`` over ``batches`` (one ``fit`` call each) from the
    ``start`` state (copied into the network's tensors), the dropout
    generator reseeded, under ``helper_mode=mode``, captured under
    ``"auto"`` and op by op for the reference and with ``eager``:
    (scores, host seconds a step, parameters, the whole state)."""
    from deeplearning4j_tpu_torch.environment import environment

    env = environment()
    env.helper_mode = mode
    net.params = _load(net.params, start[0])
    net.opt_state = _load(net.opt_state, start[1])
    net.net_state = _load(net.net_state, start[2])
    net.iteration_count = 0
    net._gen.manual_seed(net.conf.seed)
    net.set_listeners(*listeners)
    scores, times = [], []
    try:
        with _eager_if(eager or mode != "auto"):
            for x, y in batches:
                _sync(dev)
                t0 = time.perf_counter()
                net.fit(x, y, batch_size=x.shape[0])
                _sync(dev)
                times.append(time.perf_counter() - t0)
                scores.append(net.score())
    finally:
        env.helper_mode = "auto"
        net.set_listeners()
    return (scores, times, _clone_tree(net.params),
            _clone_tree([net.params, net.opt_state, net.net_state]))


def _cpu_copy(name, net, kwargs):
    """The port's network of the same zoo model on the CPU, with
    ``net``'s parameters and layer state."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models._tree import params_from_numpy

    cpu = getattr(zoo, name)(device="cpu", **kwargs).init(net.params)
    cpu.net_state = params_from_numpy(net.net_state, "cpu")
    return cpu


def _card_vs_cpu(name, net, kwargs, x) -> tuple:
    """``output`` on the card and on the CPU copy, elementwise within
    ZOO_CPU_ATOL × max(1, max |cpu|) + ZOO_CPU_RTOL × |cpu| (a raw
    detection head is not a probability: its absolute rounding scales
    with its largest value). Returns (max abs diff, max |cpu|,
    problems)."""
    card = _first_output(net.output(x))
    cpu = _first_output(_cpu_copy(name, net, kwargs).output(x))
    diff = np.abs(card - cpu)
    scale = float(np.abs(cpu).max())
    lim = ZOO_CPU_ATOL * max(1.0, scale) + ZOO_CPU_RTOL * np.abs(cpu)
    problems = []
    if not np.isfinite(card).all() or card.shape != cpu.shape:
        problems.append(f"card output {card.shape} not finite or not the "
                        f"CPU's {cpu.shape}")
    elif (diff > lim).any():
        problems.append(f"card vs CPU output {float(diff.max())} beyond "
                        f"{ZOO_CPU_ATOL:g} x max(1, {scale}) + "
                        f"{ZOO_CPU_RTOL:g} x |cpu|")
    return float(diff.max()), scale, problems


def zoo_train_case(name, batch, updater, dev, smi, kwargs=None):
    """One trainable zoo model at its defaults: generic run, counted run
    with the listeners, card vs CPU, ``evaluate``. Returns (problems, line, updater launches)."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.eval import RegressionEvaluation
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.nn import listeners as L
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.testing import zoo_cnn as Z

    t_start = time.perf_counter()
    kwargs = kwargs or {}
    model = getattr(zoo, name)(device=dev, **kwargs)
    net = model.init()
    problems = []
    if type(net.conf.updater).__name__ != updater:
        problems.append(f"zoo updater {type(net.conf.updater).__name__} "
                        f"!= {updater}")
    n_leaves = len(list(leaf_paths(net.params)))
    batches, held = Z.batches(model, batch, ZOO_STEPS)
    start = (_clone_tree(net.params), _clone_tree(net.opt_state),
             _clone_tree(net.net_state))
    observe.reset()
    _zoo_run(net, start, "auto", batches[:1], dev=dev)  # warm-up, capture
    generic = _zoo_run(net, start, "generic", batches, dev=dev)
    collect = L.CollectScoresIterationListener()
    perf = L.PerformanceListener(frequency=1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2 ** 30
    cu.fused_updater.launches = cu.fused_updater.leaves = 0
    kernel = _zoo_run(net, start, "auto", batches, dev=dev,  # counted
                      listeners=(collect, perf))
    launches = cu.fused_updater.launches
    leaves = cu.fused_updater.leaves                           # ... ends
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 - before
            if dev.type == "cuda" else None)
    problems += updater_count_problems(launches, leaves, n_leaves, ZOO_STEPS)
    cap_problems, cap_fields = capture_fields(
        net._steps.units, kernel,
        _zoo_run(net, start, "auto", batches, dev=dev, eager=True),
        observe.ledger().events(), ("train",))
    problems += cap_problems
    line = {"phase": "zoo_cnn", "card": smi, "model": f"{name}()",
            "input": list(model.input_shape), "batch": batch,
            "updater": updater, "steps": ZOO_STEPS, "leaves": n_leaves,
            "params": net.num_params(),
            "launches": {"fused_updater": launches},
            "fused_updater_leaves": leaves,
            "losses_generic": generic[0], "losses_kernel": kernel[0]}
    agree, line["against_generic"] = _train_a_agreement(start, generic,
                                                        kernel)
    problems += agree
    if name == "UNet":  # no loss layer in the reference's UNet
        if any(kernel[0] + generic[0]) or _max_diff(start[0], kernel[2]):
            problems.append("UNet moved: the reference's has no loss layer")
    scores = [s for _, s in collect.scores]
    if ([i for i, _ in collect.scores] != list(range(1, ZOO_STEPS + 1))
            or scores != kernel[0]):
        problems.append(f"listener scores {collect.scores} != losses "
                        f"{kernel[0]}")
    if len(perf.history) != ZOO_STEPS - 1:
        problems.append(f"PerformanceListener {len(perf.history)} records")
    # the card against the CPU, on the trained parameters
    net.params = _load(net.params, kernel[2])
    cpu_diff, cpu_scale, cpu_problems = _card_vs_cpu(
        name, net, kwargs, held[0][:ZOO_CPU_IMAGES])
    problems += cpu_problems
    # evaluate on the held batch
    out = _first_output(net.output(held[0]))
    if name == "UNet":
        ev = net.evaluate(DataSet(*held), RegressionEvaluation())
        got = ev.average_mean_squared_error()
        want = float(((out.astype(np.float64) - held[1]) ** 2).mean())
        ok = math.isclose(got, want, rel_tol=1e-12)
        ev_line = {"evaluation": "RegressionEvaluation",
                   "average_mse": got, "numpy_mse": want}
    else:
        ev = net.evaluate(DataSet(*held))
        got = ev.accuracy()
        want = float((out.argmax(-1) == held[1].argmax(-1)).mean())
        ok = got == want
        ev_line = {"evaluation": type(ev).__name__, "accuracy": got,
                   "numpy_argmax_agreement": want}
    if not ok:
        problems.append(f"evaluate {got} != numpy {want}")
    flops = Z.step_flops(net, batch)
    p50 = float(np.percentile(kernel[1], 50))
    wall = time.perf_counter() - t_start
    line.update({
        "card_vs_cpu_max_abs_diff": cpu_diff, "cpu_max_abs": cpu_scale,
        "card_vs_cpu_tol": ZOO_CPU_TOL_TEXT,
        "evaluate": ev_line,
        "listener_scores": scores,
        "performance_listener": perf.history,
        "smoke_reading": f"{ZOO_STEPS} steps, no spread",
        "step_p50_ms": p50 * 1e3, "images_per_s": batch / p50,
        "generic_step_p50_ms": float(np.percentile(generic[1], 50)) * 1e3,
        "peak_memory_gib": peak,
        "peak_memory_counted": "the counted run's peak allocation above "
                               "what was allocated before it (the model, "
                               "its updater state and earlier phases' "
                               "leftovers)",
        "flops_per_step": flops["step"],
        "flops_counted": "2 x multiply-adds of the conv and dense layers: "
                         "forward, weight gradient, input gradient (none "
                         "into the network input)",
        "tflops_per_s": flops["step"] / p50 / 1e12,
        "share_of_67_tflops_f32": flops["step"] / p50 / PEAK_FLOPS[
            "float32"], **cap_fields,
        "wall_s": wall, "problems": problems})
    del net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return problems, line, launches


def zoo_detect_case(name, batch, dev, smi, kwargs=None):
    """A detector at its defaults (416×416×3): ``output`` through the
    kernels against the generic and the CPU; ``yolo_loss`` and its
    gradient w.r.t. the prediction. Returns (problems, line)."""
    import torch

    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.testing import zoo_cnn as Z

    t_start = time.perf_counter()
    kwargs = kwargs or {}
    env = environment()
    model = getattr(zoo, name)(device=dev, **kwargs)
    net = model.init()
    _, (x, _) = Z.batches(model, batch, 0)
    env.helper_mode = "generic"
    try:
        _first_output(net.output(x))                     # warm-up
        generic = _first_output(net.output(x))
    finally:
        env.helper_mode = "auto"
    cu.fused_updater.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    out = _first_output(net.output(x))                   # counted
    _sync(dev)
    fwd_s = time.perf_counter() - t0
    problems = []
    if cu.fused_updater.launches:
        problems.append("an inference forward launched the updater")
    gh, gw = model.input_shape[0] // 32, model.input_shape[1] // 32
    depth = model.num_boxes * (5 + model.num_classes)
    if out.shape != (batch, gh, gw, depth) or not np.isfinite(out).all():
        problems.append(f"head {out.shape} not finite or not "
                        f"{(batch, gh, gw, depth)}")
    vs_generic = float(np.abs(out - generic).max())
    if vs_generic > ZOO_CPU_ATOL:
        problems.append(f"output vs generic {vs_generic}")
    cpu_diff, cpu_scale, cpu_problems = _card_vs_cpu(
        name, net, kwargs, x[:ZOO_CPU_IMAGES])
    problems += cpu_problems
    rng = np.random.default_rng(9)
    target = np.zeros((batch, gh, gw, model.num_boxes,
                       5 + model.num_classes), np.float32)
    target[..., :4] = rng.random(target.shape[:-1] + (4,))
    obj = rng.random(target.shape[:-1]) < 0.05
    target[..., 4] = obj
    target[..., 5:] = np.eye(model.num_classes, dtype=np.float32)[
        rng.integers(0, model.num_classes, target.shape[:-1])] * obj[
        ..., None]
    losses = {}
    for mode, pred_np in (("generic", generic), ("auto", out)):
        env.helper_mode = mode
        try:
            pred = torch.tensor(pred_np, device=dev, requires_grad=True)
            loss = model.yolo_loss(pred, torch.from_numpy(target).to(dev))
            (grad,) = torch.autograd.grad(loss, pred)
            losses[mode] = (float(loss.detach()), grad.cpu().numpy())
        finally:
            env.helper_mode = "auto"
    (lg, gg), (lk, gk) = losses["generic"], losses["auto"]
    grad_diff = float(np.abs(gk - gg).max())
    if not (math.isfinite(lk) and np.isfinite(gk).all()):
        problems.append("yolo_loss or its gradient not finite")
    if abs(lk - lg) > TRAIN_A_LOSS_RTOL * abs(lg) or grad_diff > ZOO_CPU_ATOL:
        problems.append(f"yolo_loss {lk} vs generic {lg}, gradient "
                        f"{grad_diff}")
    flops = Z.step_flops(net, batch)
    line = {"phase": "zoo_cnn", "card": smi, "model": f"{name}()",
            "input": list(model.input_shape), "batch": batch,
            "params": net.num_params(), "head": list(out.shape),
            "output_vs_generic_max_abs_diff": vs_generic,
            "card_vs_cpu_max_abs_diff": cpu_diff, "cpu_max_abs": cpu_scale,
            "card_vs_cpu_tol": ZOO_CPU_TOL_TEXT, "yolo_loss": lk,
            "yolo_loss_generic": lg,
            "yolo_grad_vs_generic_max_abs_diff": grad_diff,
            "forward_ms": fwd_s * 1e3, "images_per_s": batch / fwd_s,
            "flops_per_forward": flops["forward"],
            "share_of_67_tflops_f32": flops["forward"] / fwd_s / PEAK_FLOPS[
                "float32"],
            "smoke_reading": "one forward, no spread",
            "wall_s": time.perf_counter() - t_start, "problems": problems}
    del net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return problems, line


def zoo_cnn_phase(dev, smi, train=None, detect=None, kwargs=None):
    """The ``zoo_cnn`` phase: every trainable cell of
    ``testing/zoo_cnn.TRAIN`` and every detector of ``DETECT`` (or the
    ones given), each model's constructor ``kwargs`` its defaults unless
    given. Emits a line a model and a summary; returns (problems,
    launches)."""
    import torch

    from deeplearning4j_tpu_torch.testing import zoo_cnn as Z

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    kwargs = kwargs or {}
    t0 = time.perf_counter()
    problems, launches = [], 0
    for name, batch, updater in (Z.TRAIN if train is None else train):
        found, line, n = zoo_train_case(name, batch, updater, dev, smi,
                                        kwargs.get(name))
        emit(line)
        problems += [f"{name}: {p}" for p in found]
        launches += n
    for name, batch in (Z.DETECT if detect is None else detect):
        found, line = zoo_detect_case(name, batch, dev, smi,
                                      kwargs.get(name))
        emit(line)
        problems += [f"{name}: {p}" for p in found]
    emit({"phase": "zoo_cnn", "card": smi, "summary": True,
          "models": len(Z.TRAIN if train is None else train)
          + len(Z.DETECT if detect is None else detect),
          "fused_updater_launches": launches,
          "seconds": time.perf_counter() - t0, "problems": problems})
    return problems, {"fused_updater": launches}


# ---------------------------------------------------------------------------
# the export cache: cold, populating and warm processes
# ---------------------------------------------------------------------------

AOT_REQUESTS = 16       # aot_warm_boot: run_randomized_replay's requests
#                         (16: shared-prefix requests hit the prefix cache)
AOT_SERVE_LAYERS = 4    # GPT-2-small width, depth cut from 12 (the phase
#                         exports and loads seven step programs per layer)
AOT_SEED = 3
AOT_SAMPLE_EVERY = 4    # every 4th request samples: the plain decode step
AOT_LENET_BATCHES = 6   # one epoch of batch 64: the supervised LeNet run
AOT_LENET_KILL = 3      # the first process is killed after this iteration
AOT_LEG_TIMEOUT = 420   # seconds a leg's process may take


def _aot_dir(name: str) -> str:
    """A fresh directory under ``build/chip_smoke_aot`` (ignored by git)."""
    import pathlib
    import shutil

    d = pathlib.Path(__file__).resolve().parent / "build" / \
        "chip_smoke_aot" / name
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return str(d)


def _spawn_leg(leg: str, cache_dir, out_dir: str):
    """Run one leg in a fresh Python process, the export cache at
    ``cache_dir`` (None: ``$DL4J_TPU_COMPILE_CACHE`` unset). Returns (exit
    code, the leg's record or None, the end of its stderr)."""
    from deeplearning4j_tpu_torch.autodiff.export import ENV_DIR

    env = dict(os.environ)
    env.pop(ENV_DIR, None)
    if cache_dir is not None:
        env[ENV_DIR] = cache_dir
    out = os.path.join(out_dir, f"{leg}.json")
    if os.path.exists(out):
        os.remove(out)
    t_spawn = time.time()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--aot-leg", leg, out_dir, repr(t_spawn)], env=env,
                       capture_output=True, text=True,
                       timeout=AOT_LEG_TIMEOUT)
    rec = None
    if os.path.exists(out):
        with open(out) as f:
            rec = json.load(f)
    return p.returncode, rec, p.stderr[-3000:]


def _leg_launches() -> dict:
    """The counters of the kernels the export cache's paths run."""
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    counts = {k: v for k, v in ca.launch_counts().items()
              if k in ("flash_attn_fwd", "flash_attn_fwd_sm90",
                       "flash_attn_fwd_f32_sm90", "paged_decode")}
    counts.update(
        fused_matmul_bias_act=cm.fused_matmul.launches,
        fused_matmul_bias_act_sm90=cm.fused_matmul.sm90_launches,
        fused_matmul_bias_act_f32_sm90=cm.fused_matmul.sm90_f32_launches,
        fused_updater=cu.fused_updater.launches)
    return counts


def _zero_leg_launches() -> None:
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops import cuda_matmul as cm
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu

    ca.reset_launch_counts()
    cm.fused_matmul.launches = cm.fused_matmul.sm90_launches = 0
    cm.fused_matmul.sm90_f32_launches = 0
    cu.fused_updater.launches = cu.fused_updater.leaves = 0


def _aot_serve_leg(dev, t_spawn: float) -> dict:
    """GPT-2-small width (``GptConfig.base()`` at ``AOT_SERVE_LAYERS``
    layers, random weights drawn as the ``serve`` phase draws them)
    through ``run_randomized_replay`` with the prefix cache and
    speculation armed; the engine warm-boots when the cache is set."""
    import torch

    from deeplearning4j_tpu_torch.models.gpt import (
        GptConfig, GptModel, init_gpt_params)
    from deeplearning4j_tpu_torch.serving.replay import run_randomized_replay

    cfg = GptConfig.base(layers=AOT_SERVE_LAYERS)
    params = init_gpt_params(cfg, seed=0, device=dev,
                             std=2.0 / math.sqrt(cfg.hidden))
    model = GptModel(cfg, params=params, device=dev)
    _zero_leg_launches()  # the main path's run starts here
    t_run = time.time()
    out = run_randomized_replay(n_requests=AOT_REQUESTS, seed=AOT_SEED,
                                model=model, device=dev,
                                sample_every=AOT_SAMPLE_EVERY)
    torch.cuda.synchronize()
    launches = _leg_launches()  # ... and ends here
    first = (t_run - t_spawn + out["boot_s"]
             + (out["ttft_first_ms"] or 0.0) / 1e3)
    return dict(out, launches=launches, process_to_first_output_s=first,
                replay_s=time.time() - t_run)


def _aot_sd_leg(dev, t_spawn: float, out_dir: str, warm: bool) -> dict:
    """onnx_bert (``BERT_BASE_ONNX``, batch 32 × 128) imported; populating
    (``warm`` False): ``export_exec`` and the exported forward, then the
    plain forward of a fresh import in the same process; warm:
    ``warm_boot_samediff`` and the restored forward. The counted forward's
    launches, the output saved for the parent."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.autodiff import export as aot
    from deeplearning4j_tpu_torch.imports import import_onnx
    from deeplearning4j_tpu_torch.testing.onnx_builder import (
        BERT_BASE_ONNX, bert_onnx_feeds)

    cfg = BERT_BASE_ONNX
    model, build_s = _bert_base_onnx()
    feeds = bert_onnx_feeds(cfg["batch"], cfg["seq"], cfg["vocab"])
    rec = {"build_bytes_s": build_s}
    t0 = time.perf_counter()
    sd = import_onnx(model, device=dev)
    torch.cuda.synchronize()
    rec["import_s"] = time.perf_counter() - t0
    observe.reset()
    t0 = time.perf_counter()
    if warm:
        rec["restored"] = aot.warm_boot_samediff(sd, ["y"])
        rec["load_s"] = time.perf_counter() - t0
    else:
        path = aot.export_exec(sd, feeds, ["y"])
        rec["export_s"] = time.perf_counter() - t0
        rec["entry_bytes"] = os.path.getsize(path)
    shim = sd._compiled_fn(("y",))
    rec["batch_ranges"] = getattr(shim, "restored", None) and \
        shim.restored.meta.get("batch_ranges")
    y = sd.output(feeds, ["y"])["y"]  # the first output: captures
    rec["process_to_first_output_s"] = time.time() - t_spawn
    _zero_leg_launches()  # the main path's counted forward starts here
    y2 = sd.output(feeds, ["y"])["y"]
    torch.cuda.synchronize()
    rec["launches"] = _leg_launches()  # ... and ends here
    rec["replay_equal_first"] = bool(np.array_equal(y, y2))
    rec["ledger"] = samediff_ledger(observe)
    rec["restored_marker"] = bool(getattr(shim, "_aot_restored", False))
    covers = getattr(shim, "aot_covers", None)
    rec["fallback"] = covers is None or not covers(
        {k: torch.as_tensor(v) for k, v in feeds.items()})
    times = []
    for _ in range(ONNX_BERT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd.output(feeds, ["y"])
        times.append(time.perf_counter() - t0)
    rec["forward_p50_ms"] = float(np.percentile(times, 50)) * 1e3
    np.save(os.path.join(out_dir, "sd_warm_y.npy" if warm
                         else "sd_populate_y.npy"), y)
    if not warm:
        # the same graph's plain exec in this process: the in-process
        # output the exported one must equal
        del sd, shim
        gc.collect()
        torch.cuda.empty_cache()
        plain = import_onnx(model, device=dev)
        y_plain = plain.output(feeds, ["y"])["y"]
        rec["plain_bits_equal"] = bool(np.array_equal(y, y_plain))
        rec["plain_max_abs_diff"] = float(np.abs(y - y_plain).max())
    rec["y_shape"] = list(y.shape)
    rec["y_finite"] = bool(np.all(np.isfinite(y)))
    return rec


def _lenet_data():
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.testing import sequential as S

    parts = S.lenet_batches(S.LENET["batch"], AOT_LENET_BATCHES)
    x = np.concatenate([d.features for d in parts])
    y = np.concatenate([d.labels for d in parts])
    return (ListDataSetIterator(DataSet(x, y),
                                batch_size=S.LENET["batch"]),
            parts[0])


class _KillAfter:
    """A listener: records each iteration's score and, after iteration
    ``kill_at``, writes the record and kills its own process (SIGKILL)."""

    def __init__(self, kill_at, out, rec):
        self.kill_at, self.out, self.rec = kill_at, out, rec

    def iteration_done(self, model, iteration, epoch, score):
        import signal

        self.rec["scores"][str(iteration)] = float(score)
        self.rec.setdefault("process_to_first_output_s",
                            time.time() - self.rec["t_spawn"])
        if iteration == self.kill_at:
            self.rec["launches"] = _leg_launches()
            with open(self.out, "w") as f:
                json.dump(self.rec, f)
            os.kill(os.getpid(), signal.SIGKILL)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _aot_lenet_leg(dev, t_spawn: float, out_dir: str, resume: bool):
    """``LeNet()`` under ``TrainingSupervisor`` (synchronous saves every
    step) over one epoch of ``AOT_LENET_BATCHES`` batches: the first
    process exports the train step into the cache, trains and is killed
    (SIGKILL) after iteration ``AOT_LENET_KILL``; the second, fresh,
    resumes — the checkpoint and the warm boot — and trains the rest."""
    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.autodiff import export as aot
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.parallel import (
        TrainingCheckpointer, TrainingSupervisor)

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    data, first = _lenet_data()
    net = LeNet(device=dev).init()
    sup = TrainingSupervisor(net, TrainingCheckpointer(
        os.path.join(out_dir, "lenet_ckpt")), save_every=1,
        asynchronous=False)
    rec = {"scores": {}, "t_spawn": t_spawn}
    observe.reset()
    _zero_leg_launches()
    if not resume:
        t0 = time.perf_counter()
        path = aot.export_train_step(net, first.features, first.labels)
        rec["export_s"] = time.perf_counter() - t0
        rec["entry_bytes"] = os.path.getsize(path)
        rec["batch_range"] = net._jit_cache["train_step"].meta["batch_range"]
        sup._attach()  # the checkpoint listener first: a save, then the kill
        net.add_listeners(_KillAfter(AOT_LENET_KILL, os.path.join(
            out_dir, "lenet_kill.json"), rec))
        sup.fit(data, epochs=1, resume=False)
        raise RuntimeError("the killed LeNet process finished its epoch")
    t0 = time.perf_counter()
    rec["resumed_at"] = sup.resume()
    rec["load_s"] = time.perf_counter() - t0
    step = net._jit_cache.get("train_step")
    rec["warm_booted"] = step is not None and bool(step._aot_restored)
    net.add_listeners(_KillAfter(None, None, rec))
    status = sup.fit(data, epochs=1, resume=False)
    torch.cuda.synchronize()
    rec["status"] = status
    rec["launches"] = _leg_launches()
    rec["fell_back"] = step is None or step.plain
    rec["ledger"] = [[ev.key, ev.cause] for ev in observe.ledger().events()
                     if ev.graph == "mln"]
    np.savez(os.path.join(out_dir, "lenet_resumed.npz"),
             *[t.detach().cpu().numpy() for p in net.params
               for t in torch.utils._pytree.tree_leaves(p)])
    return rec


def aot_leg_main(argv) -> int:
    """``chip_smoke.py --aot-leg LEG OUT_DIR T_SPAWN``: one leg of the
    ``aot_warm_boot`` phase in this fresh process; its record lands in
    ``OUT_DIR/LEG.json``."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leg, out_dir, t_spawn = argv[0], argv[1], float(argv[2])
    dev = torch.device("cuda", 0)
    if leg.startswith("serve"):
        rec = _aot_serve_leg(dev, t_spawn)
    elif leg.startswith("sd_"):
        rec = _aot_sd_leg(dev, t_spawn, out_dir, warm=leg == "sd_warm")
    else:
        rec = _aot_lenet_leg(dev, t_spawn, out_dir,
                             resume=leg == "lenet_resume")
    with open(os.path.join(out_dir, f"{leg}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _lenet_oracles(dev, cache_dir):
    """The LeNet run uninterrupted in this process, through the exported
    step (its own cache) and through the plain step: (scores, final
    parameters) of each."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import export as aot
    from deeplearning4j_tpu_torch.models import LeNet

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    for mode in ("exported", "plain"):
        data, first = _lenet_data()
        net = LeNet(device=dev).init()
        if mode == "exported":
            aot.export_train_step(net, first.features, first.labels,
                                  cache=aot.ExportCache(cache_dir))
        log = _StepLog()
        net.set_listeners(log)
        net.fit(data, epochs=1)
        _sync(dev)
        out[mode] = ({str(i): s for i, s in log.calls},
                     [t.detach().cpu().numpy() for p in net.params
                      for t in torch.utils._pytree.tree_leaves(p)])
        del net
    return out


def aot_warm_boot_phase(dev, smi):
    """The export cache (``autodiff/export.py``, ``serving/aot.py``) on
    the card, each leg a fresh process: GPT-2-small serving cold,
    populating and warm; onnx_bert exported and warm-booted; LeNet under
    ``TrainingSupervisor`` killed and resumed warm. Returns (problems,
    line, launches of the restored programs)."""
    out_dir = _aot_dir("legs")
    cache_dir = _aot_dir("cache")
    problems, legs = [], {}
    for leg, cache in (("serve_cold", None), ("serve_populate", cache_dir),
                       ("serve_warm", cache_dir), ("sd_populate", cache_dir),
                       ("sd_warm", cache_dir), ("lenet_kill", cache_dir),
                       ("lenet_resume", cache_dir)):
        rc, rec, err = _spawn_leg(leg, cache, out_dir)
        want_rc = -9 if leg == "lenet_kill" else 0
        if rc != want_rc or rec is None:
            problems.append(f"{leg}: exit {rc} (want {want_rc}), record "
                            f"{rec is not None}: {err}")
            rec = rec or {}
        legs[leg] = rec
    # serving: tokens bit for bit across the legs, the warm leg without a
    # first_compile, no new_shape anywhere, the kernels in every leg
    cold, pop, warm = (legs.get(k, {}) for k in (
        "serve_cold", "serve_populate", "serve_warm"))
    keys = ["decode", "draft_decode", "draft_prefill", "prefill",
            "suffix_prefill", "verify", "write_prompt"]
    if not (cold.get("outputs") and cold.get("outputs") == pop.get(
            "outputs") == warm.get("outputs")):
        problems.append("serving tokens differ across cold, populate and "
                        "warm")
    if warm.get("first_compile_keys") != []:
        problems.append(f"warm serving first_compile "
                        f"{warm.get('first_compile_keys')}")
    if sorted(warm.get("aot", {}).get("restored", [])) != keys or sorted(
            pop.get("aot", {}).get("exported", [])) != keys:
        problems.append(f"restored {warm.get('aot')}, exported "
                        f"{pop.get('aot')}")
    if not (warm.get("prefix_hit_tokens") and cold.get(
            "prefix_hit_tokens") == warm.get("prefix_hit_tokens")
            and "suffix_prefill" in warm.get("cache_hit_keys", [])):
        problems.append(f"prefix hits cold {cold.get('prefix_hit_tokens')}"
                        f", warm {warm.get('prefix_hit_tokens')}; warm "
                        f"cache_hit {warm.get('cache_hit_keys')}")
    for name, r in (("cold", cold), ("populate", pop), ("warm", warm)):
        if r.get("new_shape_events") != 0:
            problems.append(f"serve_{name}: new_shape "
                            f"{r.get('new_shape_events')}")
        if not r.get("all_terminal"):
            problems.append(f"serve_{name}: a request did not finish")
    for k in ("flash_attn_fwd", "flash_attn_fwd_f32_sm90", "paged_decode"):
        n = warm.get("launches", {}).get(k)
        if not n or n != cold.get("launches", {}).get(k) or n != pop.get(
                "launches", {}).get(k):
            problems.append(f"{k} launches cold {cold.get('launches')} "
                            f"populate {pop.get('launches')} warm "
                            f"{warm.get('launches')}")
    # onnx_bert: the restored forward equal to the populating process's
    # exported and plain forwards, 72 + 12 kernel launches a forward
    sdp, sdw = legs.get("sd_populate", {}), legs.get("sd_warm", {})
    layers = 12
    want_sd = {"fused_matmul_bias_act": 6 * layers,
               "fused_matmul_bias_act_f32_sm90": 6 * layers,
               "flash_attn_fwd": layers, "flash_attn_fwd_f32_sm90": layers}
    for name, r in (("sd_populate", sdp), ("sd_warm", sdw)):
        got = {k: r.get("launches", {}).get(k) for k in want_sd}
        if got != want_sd:
            problems.append(f"{name} launches {got} != {want_sd}")
        if not (r.get("y_finite") and r.get("y_shape") == [32, 128, 2]):
            problems.append(f"{name}: output {r.get('y_shape')} not finite")
        if r.get("fallback"):
            problems.append(f"{name}: the restored exec fell back")
        if not r.get("replay_equal_first"):
            problems.append(f"{name}: replay differs from the first call")
    if not sdp.get("plain_bits_equal"):
        problems.append(f"sd_populate: exported forward differs from the "
                        f"plain one by {sdp.get('plain_max_abs_diff')}")
    if not sdw.get("restored") or {c for _, c in sdw.get("ledger", [])} \
            != {"cache_hit"}:
        problems.append(f"sd_warm: restored {sdw.get('restored')}, ledger "
                        f"{sdw.get('ledger')}")
    try:
        y_pop = np.load(os.path.join(out_dir, "sd_populate_y.npy"))
        y_warm = np.load(os.path.join(out_dir, "sd_warm_y.npy"))
        sd_equal = bool(np.array_equal(y_pop, y_warm))
    except OSError as e:
        sd_equal = False
        problems.append(f"onnx_bert outputs missing: {e}")
    if not sd_equal:
        problems.append("sd_warm output differs from sd_populate's")
    # LeNet: killed after AOT_LENET_KILL, resumed warm, every score and
    # the final parameters equal to the uninterrupted exported run's
    kill, res = legs.get("lenet_kill", {}), legs.get("lenet_resume", {})
    oracles = _lenet_oracles(dev, _aot_dir("oracle_cache"))
    o_scores, o_params = oracles["exported"]
    p_scores, p_params = oracles["plain"]
    scores = dict(kill.get("scores", {}))
    scores.update(res.get("scores", {}))
    if scores != o_scores:
        problems.append(f"LeNet scores killed + resumed {scores} != "
                        f"uninterrupted {o_scores}")
    try:
        got = np.load(os.path.join(out_dir, "lenet_resumed.npz"))
        got = [got[f"arr_{i}"] for i in range(len(got.files))]
        lenet_equal = len(got) == len(o_params) and all(
            np.array_equal(a, b) for a, b in zip(got, o_params))
    except OSError as e:
        lenet_equal = False
        problems.append(f"LeNet parameters missing: {e}")
    if not lenet_equal:
        problems.append("LeNet resumed parameters differ from the "
                        "uninterrupted exported run's")
    remaining = AOT_LENET_BATCHES - AOT_LENET_KILL
    if (res.get("resumed_at") != AOT_LENET_KILL or not res.get(
            "warm_booted") or res.get("fell_back")
            or res.get("status") != "completed"):
        problems.append(f"LeNet resume: step {res.get('resumed_at')}, warm "
                        f"{res.get('warm_booted')}, fell back "
                        f"{res.get('fell_back')}, {res.get('status')}")
    if res.get("launches", {}).get("fused_updater") != remaining or kill.get(
            "launches", {}).get("fused_updater") != AOT_LENET_KILL:
        problems.append(f"LeNet updater launches: killed "
                        f"{kill.get('launches')}, resumed "
                        f"{res.get('launches')}")
    if {c for _, c in res.get("ledger", [])} != {"cache_hit"}:
        problems.append(f"LeNet resumed ledger {res.get('ledger')}")
    plain_diff = max(float(np.abs(a - b).max())
                     for a, b in zip(p_params, o_params))
    score_rel = max(abs(p_scores[k] - o_scores[k]) / abs(o_scores[k])
                    for k in o_scores)
    if score_rel > TRAIN_A_LOSS_RTOL:
        problems.append(f"LeNet exported vs plain scores {score_rel} > "
                        f"{TRAIN_A_LOSS_RTOL}")
    strip = ("outputs", "scores", "t_spawn")
    line = {"phase": "aot_warm_boot", "card": smi,
            "legs": {k: {f: v for f, v in r.items() if f not in strip}
                     for k, r in legs.items()},
            "serve": {"model": f"GptConfig.base(layers={AOT_SERVE_LAYERS})",
                      "requests": AOT_REQUESTS,
                      "seed": AOT_SEED,
                      "tokens_equal_cold_populate_warm": not any(
                          "serving tokens" in p for p in problems),
                      "process_to_first_output_s": {
                          k: r.get("process_to_first_output_s")
                          for k, r in (("cold", cold), ("populate", pop),
                                       ("warm", warm))}},
            "onnx_bert": {"restored_equal_populate": sd_equal,
                          "restored_equal_plain": sd_equal and bool(
                              sdp.get("plain_bits_equal")),
                          "process_to_first_output_s": {
                              "populate": sdp.get(
                                  "process_to_first_output_s"),
                              "warm": sdw.get("process_to_first_output_s")}},
            "lenet": {"batches": AOT_LENET_BATCHES,
                      "killed_after": AOT_LENET_KILL,
                      "resumed_equal_uninterrupted": lenet_equal,
                      "exported_vs_plain_max_param_diff": plain_diff,
                      "exported_vs_plain_max_score_rel": score_rel,
                      "plain_bits_equal_exported": plain_diff == 0.0},
            "problems": problems}
    launches = {}
    for r in (warm, sdw, res):
        for k, v in r.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    _drop_ckpt_dirs()
    return problems, line, launches


# ----------------------------------------------------- the last layer types


class _StepClock:
    """A training listener: each step's synchronized host seconds and its
    score (read at once: a replayed step's output buffer is reused)."""

    def __init__(self):
        self.times, self.scores, self._t = [], [], None

    def on_epoch_start(self, model):
        import torch

        torch.cuda.synchronize()
        self._t = time.perf_counter()

    def iteration_done(self, model, iteration, epoch, score):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.times.append(now - self._t)
        self.scores.append(float(score))
        self._t = now

    def on_epoch_end(self, model):
        pass


def keras_bert_transfer_phase(dev, smi, h5):
    """Transfer learning with early stopping on the card, at BERT-base
    width: keras_bert's ``.h5`` bytes imported again with ``validate=True``
    (the checker's seconds printed), ``testing/layer_nets.
    transfer_keras_encoder`` — the 2-way classifier removed, a softmax
    ``OutputLayer(768 → 9)`` on ``pooler`` as the new output, the
    embeddings and blocks 0–7 frozen (``set_feature_extractor(
    "layer_7_output_norm")``), Adam by a ``FineTuneConfiguration`` — then
    ``EarlyStoppingTrainer`` over seeded batches of 32 × 128 (4 training
    batches an epoch, 2 held out; ``MaxEpochsTerminationCondition(3)`` and
    ``ScoreImprovementEpochTerminationCondition(1)``, ``InMemoryModelSaver``),
    captured, with every launch count set to 0 just before and read just
    after; then the same run op by op under ``helper_mode="generic"`` and
    from parameters moved one unit in the last place (the yardstick).
    Checks: every frozen leaf bit-identical, the best model restored with
    its held-out score equal to ``best_score``, losses and trained leaves
    against the generic run, and the flash forward, dq, dk/dv and updater
    launches the steps and held-out scores make. Returns (problems, line,
    launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.imports import keras_import as ki
    from deeplearning4j_tpu_torch.models._tree import leaf_paths
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.testing import keras_builder as kb
    from deeplearning4j_tpu_torch.testing import layer_nets as L

    cfg = dict(kb.BERT_BASE_KERAS, seq=KERAS_BERT_SEQ)
    layers, batch, seq = cfg["layers"], KERAS_BERT_BATCH, KERAS_BERT_SEQ
    env = environment()
    problems = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    src = ki.import_keras_model_and_weights(h5, validate=True, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    report = src.last_check_report
    t0 = time.perf_counter()
    net = L.transfer_keras_encoder(
        tnn, src, freeze_at=KT_FREEZE, classes=KT_CLASSES,
        hidden=cfg["hidden"], updater=tnn.Adam(learning_rate=FINETUNE_LR))
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    del src
    gc.collect()
    frozen = sorted(n.name for n in net.conf.nodes if n.layer is not None
                    and type(n.layer.updater).__name__ == "Frozen"
                    and net.params.get(n.name))
    trainable = sorted(n for n, p in net.params.items()
                       if p and n not in frozen)

    def batches(n, seed):
        out = []
        for i in range(n):
            ids, pos = kb.bert_inputs(batch, seq, cfg["vocab"], seed=seed + i)
            y = np.eye(KT_CLASSES, dtype=np.float32)[
                np.random.RandomState(seed + 50 + i).randint(
                    0, KT_CLASSES, batch)]
            out.append(types.SimpleNamespace(  # a multi-input batch
                features=[ids.astype(np.float32), pos.astype(np.float32)],
                labels=y, features_mask=None, labels_mask=None,
                num_examples=lambda: batch))
        return out

    train, held = batches(KT_TRAIN, 20), batches(KT_HELD_OUT, 40)
    start = (_clone_tree(net.params), _clone_tree(net.opt_state),
             _clone_tree(net.net_state))

    def run(mode, *, nudge=False, counted=False):
        env.helper_mode = mode
        net.params = _load(net.params, _nudged(
            start[0], np.random.default_rng(13)) if nudge else start[0])
        net.opt_state = _load(net.opt_state, start[1])
        net.net_state = _load(net.net_state, start[2])
        net.iteration_count = net.epoch_count = net.batch_in_epoch = 0
        net._gen.manual_seed(net.conf.seed)
        clock = _StepClock()
        net.set_listeners(clock)
        es = tnn.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                tnn.MaxEpochsTerminationCondition(KT_EPOCHS),
                tnn.ScoreImprovementEpochTerminationCondition(1)],
            model_saver=tnn.InMemoryModelSaver())
        info = {}
        try:
            with _eager_if(mode != "auto"):
                if counted:
                    disp0 = dispatch_tally()
                    _zero_counters()  # the main path's run starts here
                t0 = time.perf_counter()
                res = tnn.EarlyStoppingTrainer(es, net, train, held).fit()
                torch.cuda.synchronize()
                info["wall_s"] = time.perf_counter() - t0
                if counted:
                    info["launches"] = _read_counters()  # ... and ends here
                    info["dispatch"] = dispatch_since(disp0)
                again = float(np.mean([net.score(ds) for ds in held]))
        finally:
            env.helper_mode = "auto"
            net.set_listeners()
        info.update(reason=res.termination_reason,
                    details=res.termination_details,
                    best_epoch=res.best_epoch, best_score=res.best_score,
                    total_epochs=res.total_epochs,
                    score_history=res.score_history,
                    held_out_after_restore=again,
                    best_model_is_net=res.best_model is net,
                    step_times=clock.times)
        return (clock.scores, _clone_tree(net.params)), info

    net.fit(train[:1])  # warm-up: the step's capture
    observe.reset()
    kernel, k_info = run("auto", counted=True)
    generic, g_info = run("generic")
    yard, y_info = run("generic", nudge=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # frozen leaves: bit for bit through the kernel run; the best model
    for name in frozen:
        for (path, a), (_, b) in zip(leaf_paths(kernel[1][name]),
                                     leaf_paths(start[0][name])):
            if not torch.equal(a, b):
                problems.append(f"frozen {name}{list(path)} moved")
    for label, info in (("kernel", k_info), ("generic", g_info)):
        if not info["best_model_is_net"] or \
                info["held_out_after_restore"] != info["best_score"]:
            problems.append(f"{label}: the restored model scores "
                            f"{info['held_out_after_restore']} != best "
                            f"{info['best_score']}")
    if (k_info["best_epoch"], k_info["total_epochs"], k_info["reason"]) != (
            g_info["best_epoch"], g_info["total_epochs"], g_info["reason"]):
        problems.append(f"termination {k_info['details']} epoch "
                        f"{k_info['best_epoch']} != generic "
                        f"{g_info['details']} {g_info['best_epoch']}")
    # trained leaves (the best model's) and the losses against generic
    trained = lambda p: {n: p[n] for n in trainable}  # noqa: E731
    more, agree = _rnn_agreement(
        (trained(start[0]),), (generic[0], None, trained(generic[1])),
        (kernel[0], None, trained(kernel[1])),
        (yard[0], None, trained(yard[1])))
    problems += more
    steps = len(kernel[0])
    epochs = k_info["total_epochs"]
    launches = k_info["launches"]
    n_fa, more = gated(k_info["dispatch"], "dot_product_attention",
                       layers * (steps + KT_HELD_OUT * epochs),
                       floor=layers * steps)
    problems += more
    want = {"flash_attn_fwd": n_fa, "flash_attn_fwd_f32_sm90": n_fa,
            "flash_attn_dq": layers * steps,
            "flash_attn_dq_f32_sm90": layers * steps,
            "flash_attn_dkv": layers * steps,
            "flash_attn_dkv_f32_sm90": layers * steps,
            # one multi-tensor launch an updater group a step: Frozen, Adam
            "fused_updater": 2 * steps,
            "fused_updater_leaves": steps * sum(
                1 for p in net.params.values() for _ in leaf_paths(p))}
    got = {k: launches[k] for k in want}
    if got != want:
        problems.append(f"launches {got} != {want}")
    others = {k: v for k, v in launches.items() if k not in want and v}
    if others:
        problems.append(f"other kernels launched: {others}")
    times = k_info["step_times"]
    p50 = float(np.percentile(times, 50))
    line = {"phase": "keras_bert_transfer", "card": smi, "config": cfg,
            "import_s": import_s, "check_s": report.seconds,
            "check_findings": [f.render() for f in report.findings],
            "transfer_s": transfer_s, "frozen_layers": len(frozen),
            "trainable_layers": trainable,
            "params_frozen": sum(t.numel() for n in frozen
                                 for _, t in leaf_paths(net.params[n])),
            "params_trainable": sum(t.numel() for n in trainable
                                    for _, t in leaf_paths(net.params[n])),
            "recipe": f"remove classifier; OutputLayer(768 -> {KT_CLASSES}, "
                      f"softmax, mcxent) on pooler; freeze {KT_FREEZE} and "
                      f"its ancestors; Adam {FINETUNE_LR:g}",
            "early_stopping": f"MaxEpochs({KT_EPOCHS}) + ScoreImprovement(1),"
                              f" InMemoryModelSaver; {KT_TRAIN} batches of "
                              f"{batch} x {seq} an epoch, {KT_HELD_OUT} held "
                              f"out",
            "kernel": {k: v for k, v in k_info.items()
                       if k not in ("dispatch", "step_times")},
            "generic": {k: v for k, v in g_info.items() if k != "step_times"},
            "agreement": agree,
            "frozen_backward": "runs: every leaf is an autograd leaf, so "
                               "the frozen blocks' dq/dk/dv launch and the "
                               "Frozen updater writes their leaves back",
            "launches": launches, "launches_expected": want,
            "step_p50_ms": p50 * 1e3, "step_times_ms": [t * 1e3
                                                         for t in times],
            "tokens_per_s": batch * seq / p50,
            "peak_memory_gib": peak, "peak_memory_own_gib": peak - resident,
            "smoke_reading": f"{len(times)} captured steps, no spread",
            "problems": problems}
    del net, start
    gc.collect()
    torch.cuda.empty_cache()
    return problems, line, {k: v for k, v in launches.items()
                            if k != "fused_updater_leaves"}


def nn_layer_types_phase(dev, smi):
    """The last fourteen layer types on the card, through the networks of
    ``testing/layer_nets`` at their card dims (CapsNet at Sabour et al.
    widths, the VAE on 784 inputs by its ELBO, the attention sequence
    classifier at batch 32 × T 256, the recurrent-attention tagger at T
    64, and one network each of MaskLayer, ElementWiseMultiplicationLayer,
    FrozenLayerWithBackprop, CnnLossLayer, Yolo2OutputLayer at TinyYOLO's
    head and a SameDiffLayer): 3 ``fit`` steps each, captured and counted
    (``_mln_main_path``), held to ``helper_mode="generic"`` and to the
    port's CPU run of the same parameters with the one-ulp yardstick.
    LearnedSelfAttentionLayer must launch the flash forward, dq and dk/dv.
    Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.ops import cuda_updater as cu
    from deeplearning4j_tpu_torch.testing import layer_nets as L

    env = environment()
    problems, nets, total = [], {}, {}
    # the convolutions' backward in one fixed order: the captured steps
    # must equal the eager ones bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for name in L.NETWORKS:
        d = L.CARD[name]
        conf = L.build(name, tnn, d)
        net = tnn.MultiLayerNetwork(conf, device=dev).init()
        cpu = tnn.MultiLayerNetwork(L.build(name, tnn, d),
                                    device="cpu").init(
            params=_to(net.params, "cpu"))
        data = [L.batch(name, d, seed=s) for s in range(LAYERS_STEPS)]
        info = {"layers": [type(lc).__name__ for lc in conf.layers],
                "dims": d,
                "params": net.num_params()}
        if name == "vae":
            eps = [torch.from_numpy(np.random.RandomState(70 + s).randn(
                d["batch"], d["latent"]).astype(np.float32))
                for s in range(LAYERS_STEPS)]
            start = (_clone_tree(net.params), _clone_tree(net.opt_state))

            def elbo_run(target, mode, nudge=False, counted=False):
                env.helper_mode = mode
                p0 = _nudged(start[0], np.random.default_rng(14)) \
                    if nudge else start[0]
                target.params = _to(_clone_tree(p0), target.device)
                target.opt_state = _to(_clone_tree(start[1]), target.device)
                if counted:
                    _zero_counters()
                losses, times = [], []
                try:
                    for s, (x, _, _) in enumerate(data):
                        _sync(target.device)
                        t0 = time.perf_counter()
                        loss = L.fit_elbo(target, x,
                                          eps[s].to(target.device), s)
                        _sync(target.device)
                        times.append(time.perf_counter() - t0)
                        losses.append(float(loss))
                finally:
                    env.helper_mode = "auto"
                counts = _read_counters() if counted else None
                return (losses, times, _to(target.params, dev)), counts

            kernel, counts = elbo_run(net, "auto", counted=True)
            generic, _ = elbo_run(net, "generic")
            yard, _ = elbo_run(net, "generic", nudge=True)
            on_cpu, _ = elbo_run(cpu, "auto")
            first = _to(start[0], dev)
            if counts["fused_updater"] != LAYERS_STEPS:
                problems.append(f"vae: updater launches "
                                f"{counts['fused_updater']} != "
                                f"{LAYERS_STEPS}")
            info["fit"] = "layer_nets.fit_elbo (eager): the negative ELBO"
        else:
            batches = [DataSet(x, y, m, m if y.ndim == 3 else None)
                       for x, y, m in data]
            counts = {}
            start, generic, kernel, _, leaves, tally, capture = \
                _mln_main_path(net, batches, counters=counts)
            problems += [f"{name}: {p}" for p in capture[0]]
            yard = _mln_run(net, start, "generic", batches, nudge=True)
            cpu_scores = []
            for ds in batches:
                cpu.fit(ds, batch_size=ds.num_examples())
                cpu_scores.append(cpu.score())
            on_cpu = (cpu_scores, None, _to(cpu.params, dev))
            first = start[0]
            info["capture"] = capture[1]
            info["dispatch"] = tally
            if counts["fused_updater"] != LAYERS_STEPS:
                problems.append(f"{name}: updater launches "
                                f"{counts['fused_updater']} != "
                                f"{LAYERS_STEPS}")
            if name == "seq_classifier":
                n_fa, more = gated(tally, "dot_product_attention",
                                   LAYERS_STEPS, floor=LAYERS_STEPS)
                problems += [f"{name}: {p}" for p in more]
                for k in ("flash_attn_fwd", "flash_attn_dq",
                          "flash_attn_dkv"):
                    if counts[k] != n_fa:
                        problems.append(f"{name}: {k} {counts[k]} != "
                                        f"{n_fa}")
        for label, run in (("vs_generic", kernel), ("vs_cpu", on_cpu)):
            more, info[label] = _rnn_agreement((first,), generic, run, yard)
            problems += [f"{name} {label}: {p}" for p in more]
        info.update(losses_cpu=on_cpu[0],
                    step_p50_ms=float(np.percentile(kernel[1], 50)) * 1e3,
                    launches={k: v for k, v in counts.items() if v})
        for k, v in counts.items():
            if k != "fused_updater_leaves":
                total[k] = total.get(k, 0) + v
        nets[name] = info
        del net, cpu
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    line = {"phase": "nn_layer_types", "card": smi, "steps": LAYERS_STEPS,
            "updater": "Adam 1e-3", "networks": nets,
            "tol": "the CPU run against the card's generic run by the "
                   "kernel run's yardstick (each network's tol)",
            "problems": problems}
    return problems, line, total


def _moe_conf():
    from deeplearning4j_tpu_torch import nn as tnn

    w = MOE_WIDTH
    return (tnn.builder().seed(26).updater(tnn.Adam(learning_rate=1e-3))
            .list()
            .layer(tnn.DenseLayer(n_out=w["d_model"], activation="gelu"))
            .layer(tnn.MoELayer(d_hidden=w["d_ff"], n_experts=w["experts"],
                                top_k=w["top_k"],
                                capacity_factor=w["capacity_factor"],
                                activation="relu"))
            .layer(tnn.OutputLayer(n_out=MOE_CLASSES, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(tnn.InputType.feed_forward(w["d_model"])).build())


def _sequence_parallel_attention(dev) -> tuple:
    """ring_attention and ulysses_attention at world 1 on (B, H, T, D) =
    SP_ATTN_SHAPE float32 against the plain softmax(QKᵀ/√D)·V: (problems,
    line fields)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import (
        make_mesh, ring_attention, ulysses_attention)

    sh = SP_ATTN_SHAPE
    b, h, t, d = sh["batch"], sh["heads"], sh["t"], sh["d"]
    gen = torch.Generator(device=dev).manual_seed(27)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
               for _ in range(3))
    mesh = make_mesh({"seq": 1}, device=dev)

    def plain():
        return torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d),
                             dim=-1) @ v

    def ring():
        flat = [a.reshape(b * h, t, d) for a in (q, k, v)]
        return ring_attention(*flat, mesh=mesh).reshape(b, h, t, d)

    def uly():
        return ulysses_attention(q, k, v, mesh=mesh)

    with torch.no_grad():
        want = plain()
        errs = {name: (fn() - want).abs().max().item()
                for name, fn in (("ring", ring), ("ulysses", uly))}
        times = {f"{name}_ms": cuda_ms(fn, iters=5) for name, fn in (
            ("ring", ring), ("ulysses", uly), ("plain", plain))}
    problems = [f"{name} attention off the plain one by {e}"
                for name, e in errs.items()
                if not (math.isfinite(e) and e <= SP_ATTN_TOL)]
    return problems, {"shape": sh, "dtype": "float32", "max_abs_err": errs,
                      "tol": SP_ATTN_TOL, **times}


def parallel_moe_phase(dev, smi):
    """A Switch-Base-8-width MoE network (``_moe_conf``) trained through
    ``ParallelWrapper(net, mesh=make_mesh())`` at world 1: 8 captured
    steps, counted, held bit for bit to ``net.fit`` from the same start
    (one rank runs the network's own step), to ``helper_mode="generic"``
    by the one-ulp yardstick (``_rnn_agreement``), one updater launch a
    step, the first loss equal to the data loss plus the layer's aux loss
    at the start, ``_dropped_frac`` in [0, 1]; then sequence-parallel
    attention at world 1. Returns (problems, line, launches)."""
    import torch

    from deeplearning4j_tpu_torch import nn as tnn
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh

    t_phase = time.perf_counter()
    rows = MOE_TOKENS[0] * MOE_TOKENS[1]
    rng = np.random.default_rng(26)
    batches = [DataSet(
        rng.standard_normal((rows, MOE_WIDTH["d_model"])).astype(np.float32),
        np.eye(MOE_CLASSES, dtype=np.float32)[rng.integers(
            0, MOE_CLASSES, rows)]) for _ in range(MOE_STEPS)]
    net = tnn.MultiLayerNetwork(_moe_conf(), device=dev).init()
    pw = ParallelWrapper(net, mesh=make_mesh(device=dev))

    def pw_fit(ds):
        pw.fit([ds])

    observe.reset()
    start = (_clone_tree(net.params), _clone_tree(net.opt_state),
             _clone_tree(net.net_state))
    _mln_run(net, start, "auto", batches[:1], fit=pw_fit)  # the capture
    generic = _mln_run(net, start, "generic", batches, fit=pw_fit)
    yard = _mln_run(net, start, "generic", batches, nudge=True, fit=pw_fit)
    own = _mln_run(net, start, "auto", batches)            # net.fit
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    kernel = _mln_run(net, start, "auto", batches, fit=pw_fit)  # main path
    counts = _read_counters()                                    # ... ends
    peak = torch.cuda.max_memory_allocated()
    moe_state = {k: float(v) for k, v in net.net_state[1].items()}
    unit = net._steps.units["train"]

    problems, agree = _rnn_agreement(start, generic, kernel, yard)
    if kernel[0] != own[0] or not _equal_trees(kernel[-1], own[-1]):
        problems.append(f"ParallelWrapper at world 1 differs from net.fit: "
                        f"losses {kernel[0]} vs {own[0]}, state by "
                        f"{_max_diff(kernel[-1], own[-1])}")
    if counts["fused_updater"] != MOE_STEPS:
        problems.append(f"fused_updater launches {counts['fused_updater']}"
                        f" != {MOE_STEPS} (one group a step)")
    if unit.captures != 1 or unit.moved:
        problems.append(f"train unit: {unit.captures} captures, "
                        f"{unit.moved} moved (one capture, replayed)")
    # the first step's loss: the data loss plus the aux loss at the start
    with torch.no_grad():
        ds = batches[0]
        out, st = net._forward(start[0], start[2], net._feed(ds.features),
                               None, train=True, rng=None)
        data_loss = float(net._loss_fn(out, net._feed(ds.labels), None))
        aux0 = float(st[1]["_aux_loss"])
    if not (aux0 > 0 and abs(kernel[0][0] - (data_loss + aux0))
            <= 1e-5 * abs(kernel[0][0])
            and abs(kernel[0][0] - data_loss) > 0.5 * aux0):
        problems.append(f"first loss {kernel[0][0]} is not the data loss "
                        f"{data_loss} + aux {aux0}")
    if not 0.0 <= moe_state["_dropped_frac"] <= 1.0:
        problems.append(f"_dropped_frac {moe_state['_dropped_frac']}")
    more, attention = _sequence_parallel_attention(dev)
    problems += more
    p50 = float(np.percentile(kernel[1], 50))
    line = {"phase": "parallel_moe", "card": smi,
            "model": "google/switch-base-8 sparse FFN widths",
            "widths": MOE_WIDTH, "rows_a_step": rows,
            "tokens": f"{MOE_TOKENS[0]} x {MOE_TOKENS[1]}",
            "steps": MOE_STEPS, "dtype": "float32", "updater": "Adam 1e-3",
            "params": net.num_params(), "mesh": {"data": 1},
            "step_p50_ms": p50 * 1e3, "tokens_per_s": rows / p50,
            "aux_loss": moe_state["_aux_loss"], "aux_loss_step1": aux0,
            "data_loss_step1": data_loss,
            "dropped_frac": moe_state["_dropped_frac"],
            "peak_memory_mib": peak / 2 ** 20,
            "losses": kernel[0], "losses_net_fit": own[0],
            "bit_equal_net_fit": kernel[0] == own[0],
            "launches": {k: v for k, v in counts.items() if v},
            "graph_unit": unit_memory(unit), "vs_generic": agree,
            "attention": attention,
            "seconds": time.perf_counter() - t_phase, "problems": problems}
    del net, pw
    gc.collect()
    torch.cuda.empty_cache()
    return problems, line, {"fused_updater": counts["fused_updater"]}


def parallel_inference_phase(dev, smi):
    """The zoo ResNet-50 (224×224×3, 1000 classes, float32; its batch-norm
    statistics set from one batch) served by
    ``ParallelInference(net, max_batch=32, window_ms=3.0)``: after one
    warm request, 4 client threads send 64 requests of 1–8 images. Every
    reply must equal ``net.output`` of its own rows, and ``output(x)`` of
    all the rows ``net.output`` of them, within PI_YARDSTICK × the
    largest change one ulp on the input makes to ``net.output``; the
    padded forward captured once and replayed for every batch. Returns
    (problems, line)."""
    import threading

    import torch

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    t_phase = time.perf_counter()
    net = ResNet50(num_classes=CLASSES, input_shape=IMAGE, device=dev).init()
    rng = np.random.default_rng(28)
    # the random network's batch-norm running statistics from train-mode
    # forwards of one batch (weights untouched): with the initial (0, 1)
    # every softmax row is one class at probability 1, and the replies
    # could not tell rows apart
    calib = {net.conf.network_inputs[0]: torch.from_numpy(
        rng.standard_normal((PI_MAX_BATCH,) + IMAGE).astype(
            np.float32)).to(dev)}
    with torch.no_grad():
        for _ in range(PI_CALIBRATION):
            _, net.net_state = net._forward(net.params, net.net_state, calib,
                                            None, train=True)
    sizes = rng.integers(PI_IMAGES[0], PI_IMAGES[1] + 1, PI_REQUESTS)
    requests = [rng.standard_normal((int(n),) + IMAGE).astype(np.float32)
                for n in sizes]
    observe.reset()
    pi = ParallelInference(net, max_batch=PI_MAX_BATCH,
                           window_ms=PI_WINDOW_MS).start()
    replies = [None] * PI_REQUESTS
    latency = [0.0] * PI_REQUESTS
    try:
        pi.predict(requests[0][:1])  # the warm request: the capture

        def client(c):
            for i in range(c, PI_REQUESTS, PI_CLIENTS):
                t0 = time.perf_counter()
                replies[i] = pi.predict(requests[i])
                latency[i] = time.perf_counter() - t0

        m = observe.metrics()
        b0 = m.counter("dl4j_tpu_serving_batches_total").value
        r0 = m.counter("dl4j_tpu_serving_rows_total").value
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PI_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        batches = m.counter("dl4j_tpu_serving_batches_total").value - b0
        served = m.counter("dl4j_tpu_serving_rows_total").value - r0
    finally:
        pi.stop()
    problems = []
    if any(t.is_alive() for t in threads) or any(r is None for r in replies):
        problems.append("clients did not finish")
    every = np.concatenate(requests)
    with torch.no_grad():
        want_all = _first_output(net.output(every))
        yard = float(np.abs(_first_output(net.output(np.nextafter(
            every, np.float32(np.inf)))) - want_all).max())
        direct = pi.output(every)
        errs = [float(np.abs(r - _first_output(net.output(x))).max())
                for x, r in zip(requests, replies) if r is not None]
    limit = PI_YARDSTICK * yard
    direct_err = float(np.abs(direct - want_all).max())
    if not (yard > 0 and max(errs, default=np.inf) <= limit
            and direct_err <= limit):
        problems.append(f"replies off net.output by {max(errs, default=0)}, "
                        f"output(x) by {direct_err} (limit {limit})")
    ledger = [ev.cause for ev in observe.ledger().events()
              if ev.graph == "parallel" and ev.key == "serve"]
    if pi.unit.captures != 1 or ledger != ["first_compile"]:
        problems.append(f"serve unit: {pi.unit.captures} captures, ledger "
                        f"{ledger} (one capture, replayed)")
    images = int(sizes.sum())
    line = {"phase": "parallel_inference", "card": smi,
            "model": "zoo ResNet-50", "input": list(IMAGE),
            "classes": CLASSES, "dtype": "float32",
            "max_batch": PI_MAX_BATCH, "window_ms": PI_WINDOW_MS,
            "clients": PI_CLIENTS, "requests": PI_REQUESTS,
            "images": images, "wall_s": wall,
            "requests_per_s": PI_REQUESTS / wall, "images_per_s":
                images / wall,
            "request_p50_ms": float(np.percentile(latency, 50)) * 1e3,
            "request_p99_ms": float(np.percentile(latency, 99)) * 1e3,
            "batches": int(batches), "rows_served": int(served),
            "batch_occupancy": served / max(1, batches * PI_MAX_BATCH),
            "reply_max_abs_err": max(errs, default=None),
            "output_max_abs_err": direct_err, "yardstick_1ulp": yard,
            "limit": limit, "ledger": ledger,
            "max_probability": float(want_all.max()),
            "classes_predicted": int(len(np.unique(want_all.argmax(-1)))),
            "graph_unit": unit_memory(pi.unit),
            "seconds": time.perf_counter() - t_phase, "problems": problems}
    del net, pi
    gc.collect()
    torch.cuda.empty_cache()
    return problems, line


def _to(tree, device):
    """A parameter tree with every tensor copied to ``device``."""
    from deeplearning4j_tpu_torch.models._tree import map_tree

    return map_tree(lambda t: t.detach().to(device, copy=True), tree)


def export_bindings_phase(dev, smi, int8):
    """The BN/matmul/BN-stats, LayerNorm and int8 kernels through
    ``torch.export`` on the card, as ``torch.library`` operators: a one-op
    module of each of ``bn_matmul_stats`` (the stage-3 c1 convolution of
    ResNet-50 at batch 32) and ``fused_layer_norm`` (4096 × 768, gelu)
    exported, stored in an ``ExportCache``, loaded and run; int8_bert's
    forward (the graph that phase built) exported by ``export_exec`` and
    warm-booted back into it from the cache. Each restored program must
    equal the direct call bit for bit, with the same launch counts (73
    GEMMs and 73 row quantizations an int8 forward). Then
    ``torch.library.opcheck`` of the four operators on CUDA tensors.
    Returns (problems, line, launches of the restored programs)."""
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.autodiff import export as aot
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc
    from deeplearning4j_tpu_torch.ops import cuda_layernorm as cl
    from deeplearning4j_tpu_torch.ops import cuda_quantized as cq
    from deeplearning4j_tpu_torch.ops import library
    from deeplearning4j_tpu_torch.testing import onnx_builder as ob

    problems, cases = [], {}
    tmp = tempfile.mkdtemp(dir=str(_build_dir()))
    cache = aot.ExportCache(tmp)
    g = torch.Generator().manual_seed(21)
    m, k, n, _ = CONVBN_SHAPES["stage3_c1"]
    m //= 4  # batch 32: M % 128 == 0
    conv_args = (torch.randn(m, k, generator=g).to(dev, torch.bfloat16),
                 (torch.rand(k, generator=g) + 0.5).to(dev),
                 (0.1 * torch.randn(k, generator=g)).to(dev),
                 (torch.randn(k, n, generator=g) * k ** -0.5).to(
                     dev, torch.bfloat16),
                 (0.1 * torch.randn(n, generator=g)).to(dev))
    ln_args = (torch.randn(*LN_SHAPE, generator=g).to(dev),
               (1 + 0.1 * torch.randn(LN_SHAPE[1], generator=g)).to(dev),
               (0.1 * torch.randn(LN_SHAPE[1], generator=g)).to(dev))
    one_op = {
        "bn_matmul_stats": (
            lambda *a: cc.bn_matmul_stats_partials(*a, relu=True,
                                                   fuse_prologue=True),
            conv_args, "dl4j_tpu_torch.bn_matmul_stats.default",
            {"bn_matmul_stats": 1, "bn_matmul_stats_sm90": 1}),
        "fused_layer_norm": (
            lambda x, gn, b: cl.fused_layer_norm_kernel(x, gn, b,
                                                        activation="gelu"),
            ln_args, "dl4j_tpu_torch.fused_layer_norm.default",
            {"fused_layer_norm": 1})}
    restored_counts = {}
    for name, (fn, args, target, want) in one_op.items():
        t0 = time.perf_counter()
        exported = aot.export_fn(fn, args)
        export_s = time.perf_counter() - t0
        targets = {str(nd.target) for nd in exported.graph.nodes}
        cache.store("bindings", name, exported)
        restored = cache.load("bindings", name).module()
        _zero_counters()
        direct = fn(*args)
        torch.cuda.synchronize()
        c_direct = {k: v for k, v in _read_counters().items() if v}
        _zero_counters()
        got = restored(*args)
        torch.cuda.synchronize()
        c_restored = {k: v for k, v in _read_counters().items() if v}
        direct = direct if isinstance(direct, tuple) else (direct,)
        got = got if isinstance(got, (tuple, list)) else (got,)
        equal = len(direct) == len(got) and all(
            torch.equal(a, b) for a, b in zip(direct, got))
        cases[name] = {"export_s": export_s, "operator_in_program":
                       target in targets, "bit_equal": equal,
                       "launches_direct": c_direct,
                       "launches_restored": c_restored}
        if target not in targets or not equal:
            problems.append(f"{name}: {cases[name]}")
        if c_restored != c_direct or c_restored != want:
            problems.append(f"{name}: launches {c_restored} (direct "
                            f"{c_direct}, want {want})")
        for key, v in c_restored.items():
            restored_counts[key] = restored_counts.get(key, 0) + v

    # int8_bert's forward, exported and warm-booted from the cache
    sd, feeds, want_y = int8["sd"], int8["feeds"], int8["y"]
    t0 = time.perf_counter()
    path = aot.export_exec(sd, feeds, ["y"], cache=cache)
    export_s = time.perf_counter() - t0
    targets = [str(nd.target) for nd in cache.load(
        aot.samediff_fingerprint(sd, ("y",)), "exec").graph.nodes]
    booted = aot.warm_boot_samediff(sd, ["y"], cache=cache)
    sd.output(feeds, ["y"])  # the restored program's capture
    copies = cq.kmajor_weight.copies
    _zero_counters()
    y = sd.output(feeds, ["y"])["y"]
    torch.cuda.synchronize()
    counts = {k: v for k, v in _read_counters().items() if v}
    layers = ob.BERT_BASE_ONNX["layers"]
    n_dense = 6 * layers + 1
    want = {"matmul_int8": n_dense, "matmul_int8_sm90": n_dense,
            "matmul_int8_row_quantize": n_dense, "flash_attn_fwd": layers,
            "flash_attn_fwd_f32_sm90": layers}
    cases["int8_bert"] = {
        "export_s": export_s, "entry": bool(path), "warm_booted": booted,
        "operators_in_program": {op: targets.count(
            f"dl4j_tpu_torch.{op}.default") for op in (
                "matmul_int8", "matmul_int8_row_quantize", "flash_fwd")},
        "bit_equal": bool(np.array_equal(y, want_y)),
        "launches_restored": counts,
        "kmajor_copies_in_restored_forward": cq.kmajor_weight.copies - copies}
    if not (path and booted and cases["int8_bert"]["bit_equal"]):
        problems.append(f"int8_bert: {cases['int8_bert']}")
    if counts != want:
        problems.append(f"int8_bert: launches {counts} != {want}")
    for key, v in counts.items():
        restored_counts[key] = restored_counts.get(key, 0) + v
    del sd
    int8.clear()

    # opcheck on CUDA tensors, small shapes
    ns = library.ops()
    small = torch.Generator().manual_seed(22)

    def t(*shape, dtype=torch.float32, grad=False):
        return torch.randn(*shape, generator=small).to(dev, dtype) \
            .requires_grad_(grad)

    xq, xs = cq.row_quantize(t(64, 128))
    checks = {
        "bn_matmul_stats": (t(256, 64, dtype=torch.bfloat16), t(64), t(64),
                            t(64, 128, dtype=torch.bfloat16), t(128), True,
                            True, 0),
        "fused_layer_norm": (t(64, 96, grad=True), t(96, grad=True),
                             t(96, grad=True), 1e-5, "gelu"),
        "matmul_int8_row_quantize": (t(64, 128),),
        "matmul_int8": (xq, xs, torch.randint(-127, 128, (128, 64),
                                              dtype=torch.int8,
                                              generator=small).to(dev),
                        t(64).abs(), torch.float32)}
    opcheck = {}
    for name, args in checks.items():
        try:
            torch.library.opcheck(getattr(ns, name).default, args)
            opcheck[name] = "passed"
        except Exception as e:  # noqa: BLE001 — reported as a problem
            opcheck[name] = f"{type(e).__name__}: {e}"[:400]
            problems.append(f"opcheck {name}: {opcheck[name]}")
    shutil.rmtree(tmp, ignore_errors=True)
    line = {"phase": "export_bindings", "card": smi, "cases": cases,
            "opcheck_cuda": opcheck, "schema_digest": library.schema_digest(),
            "problems": problems}
    return problems, line, restored_counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--aot-leg"]:
        return aot_leg_main(sys.argv[2:])
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.environment import environment
    from deeplearning4j_tpu_torch.models.gpt import (
        GptConfig, GptModel, init_gpt_params)
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import cuda_attention as ca
    from deeplearning4j_tpu_torch.ops.capture import disable_capture
    from deeplearning4j_tpu_torch.serving import GenerativeEngine

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    # how a bfloat16 result reaches the host here (nn.dtype.host_array)
    from deeplearning4j_tpu_torch.nn.dtype import host_array

    emit({"host_bfloat16": "ml_dtypes" if host_array(torch.zeros(
        1, dtype=torch.bfloat16)).dtype.name == "bfloat16" else "float32"})

    # ------------------------------------------------------------- build
    secs = _build.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_logs.items()}
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "build", "seconds": secs, "nvcc": nvcc, "ptxas": ptxas})
    # the updater and paged decode keep no stack frame and spill nothing
    # (when built by this process: a library built earlier left no log)
    frames = [ln for n in NO_STACK_KERNELS for ln in ptxas.get(n, ())
              if "stack frame" in ln]
    if any(not ln.startswith("0 bytes stack frame, 0 bytes spill stores, "
                             "0 bytes spill loads") for ln in frames):
        raise SystemExit(f"stack frames or spills in {NO_STACK_KERNELS}: "
                         f"{sorted(set(frames))}")

    # ----------------------------------------------------------- kernels
    entries, failed = [], []
    for dtype in (torch.float32, torch.bfloat16):
        ok, entry = flash_case(dtype, dev)
        entries.append(entry)
        if not ok:
            failed.append(f"{entry['kernel']}[{entry['dtype']}]")
    ok, entry = flash_draft_case(dev)
    entries.append(entry)
    if not ok:
        failed.append(f"{entry['kernel']}[draft decode step]")
    for dtype in (torch.float32, torch.bfloat16):
        ok, paged_entries = paged_case(dtype, dev)
        entries += paged_entries
        if not ok:
            failed.append(f"paged_decode[{dtype}]")
    # float32 at a head dim the sm90_f32 forward refuses: the CUDA-core one
    ok, entry = flash_case(torch.float32, dev, d=FLASH_SIMT_D)
    entries.append(entry)
    if not (ok and entry["design"] == "simt"):
        failed.append(f"{entry['kernel']}[float32, D {FLASH_SIMT_D}]")
    for dtype in (torch.float32, torch.bfloat16):
        ok, upd_entries = updater_case(dtype, dev)
        entries += upd_entries
        if not ok:
            failed.append(f"fused_updater[{dtype}]")
    for dtype in (torch.float32, torch.bfloat16):
        ok, upd_entries = updater_tree_case(dtype, dev)
        entries += upd_entries
        if not ok:
            failed.append(f"fused_updater[whole trees, {dtype}]")
    ok, conv_entries = convbn_case(dev)
    entries += conv_entries
    if not ok:
        failed.append("bn_matmul_stats[bfloat16]")
    for label in BERT_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            # shape A without dropout is onnx_bert's attention
            for rate in (ATTN_DROPOUT, 0.0) if label == "A" else (
                    ATTN_DROPOUT,):
                ok, entry = flash_bert_case(dtype, dev, label, rate)
                entries.append(entry)
                if not ok:
                    failed.append(f"flash_attn_fwd[dropout {rate}, "
                                  f"{label}, {dtype}]")
            ok, bwd_entries = flash_backward_case(dtype, dev, label)
            entries += bwd_entries
            if not ok:
                failed.append(f"flash_attn_dq/dkv[{label}, {dtype}]")
    # the float32 backward's causal branch; and at a head dim the sm90_f32
    # dq and dk/dv refuse, the CUDA-core ones
    ok, bwd_entries = flash_backward_case(torch.float32, dev, "causal")
    entries += bwd_entries
    if not (ok and bwd_entries[0]["design"] == "sm90_f32"):
        failed.append("flash_attn_dq/dkv[causal, float32]")
    ok, bwd_entries = flash_backward_case(torch.float32, dev, "A",
                                          d=FLASH_SIMT_D)
    entries += bwd_entries
    if not (ok and bwd_entries[0]["design"] == "simt"):
        failed.append(f"flash_attn_dq/dkv[A, float32, D {FLASH_SIMT_D}]")
    ok, mm_entries = fused_matmul_case(dev)
    entries += mm_entries
    if not ok:
        failed.append("fused_matmul_bias_act[float32/bfloat16]")
    ok, ln_entries = fused_layer_norm_case(dev)
    entries += ln_entries
    if not ok:
        failed.append("fused_layer_norm[float32/bfloat16]")
    ok, int8_entries = matmul_int8_case(dev)
    entries += int8_entries
    if not ok:
        failed.append("matmul_int8[float32/bfloat16]")
    emit({"phase": "kernels", "card": smi, "entries": entries})
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")

    # ------------------------------------------------------------- tuning
    problems, line = tuning_phase(dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"tuning phase failed: {problems}")

    # ------------------------------------------------------------- serve
    cfg = GptConfig.base()
    params = init_gpt_params(cfg, seed=0, device=dev,
                             std=2.0 / math.sqrt(cfg.hidden))
    model = GptModel(cfg, params=params, device=dev)
    rng = np.random.default_rng(3)
    lengths = np.linspace(8, 512, 12).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    engine_kw = dict(max_slots=8, page_size=16, max_pages_per_seq=64,
                     max_prompt=512, seed=0, device=dev)
    env = environment()
    # warm-up: the process's first cuBLAS/allocator use is not measured
    for mode in ("generic", "auto"):
        env.helper_mode = mode
        GenerativeEngine(model, **engine_kw).generate([prompts[-1]],
                                                      max_new_tokens=2)
    env.helper_mode = "generic"
    ref_results, ref_wall = serve(GenerativeEngine(model, **engine_kw),
                                  prompts)
    env.helper_mode = "auto"

    observe.reset()
    eng = GenerativeEngine(model, **engine_kw)
    disp0 = dispatch_tally()
    ca.reset_launch_counts()          # the main path's run starts here
    results, wall = serve(eng, prompts)
    launches = ca.launch_counts()     # ... and ends here
    serve_disp = dispatch_since(disp0)
    m = observe.metrics()
    decode_steps = m.histogram("dl4j_tpu_serving_decode_step_seconds").count
    admitted = int(m.counter("dl4j_tpu_serving_admitted_total").value)
    # the same engine, op by op
    with disable_capture():
        eager_results, eager_wall = serve(eng, prompts)
    serving_ledger = _serving_ledger(observe)
    step_equal, step_diff, step_p50 = decode_step_case(
        GenerativeEngine(model, **engine_kw), prompts)
    units = {name: unit_memory(u) for name, u in (
        ("prefill", eng._prefill_fn), ("write_prompt", eng._write_fn),
        ("decode", eng._decode_fn))}

    problems = []
    for r in results + ref_results:
        if r.finish_reason not in ("length", "eos"):
            problems.append(f"finish_reason {r.finish_reason}")
        if r.tokens.size and not (0 <= r.tokens.min()
                                  and r.tokens.max() < cfg.vocab_size):
            problems.append("token out of vocab")
    # every prefill an attention a layer and every decode step a paged
    # attention a layer, each sent to its kernel or (below a crossover of
    # the standing tuning table) to the generic; the launches are the
    # kernels' share
    for op, name, least, what in (
            ("dot_product_attention", "flash_attn_fwd",
             cfg.layers * len(prompts), "requests"),
            ("paged_decode_attention", "paged_decode",
             cfg.layers * decode_steps, "decode steps")):
        n = serve_disp.get(f"{op} cuda usable", 0)
        cross = serve_disp.get(f"{op} generic crossover", 0)
        if n + cross < least or not n or launches[name] != n:
            problems.append(f"{name} launches {launches[name]}, {n} calls "
                            f"to the kernel + {cross} by crossover (at "
                            f"least {least}: {cfg.layers} x the {what})")
    # every float32 prefill on the tensor-core sm90_f32 forward
    if launches["flash_attn_fwd_f32_sm90"] != launches["flash_attn_fwd"]:
        problems.append(f"float32 serving launched the CUDA-core forward: "
                        f"{launches}")
    if serving_ledger != {k: ["first_compile"] for k in (
            "prefill", "write_prompt", "decode")}:
        problems.append(f"serving ledger {serving_ledger}")
    if any(u["captures"] != 1 for u in units.values()):
        problems.append(f"captures {units}")
    tokens_equal_eager = sum(list(a.tokens) == list(b.tokens)
                             for a, b in zip(results, eager_results))
    if tokens_equal_eager != len(prompts):
        problems.append(f"captured vs eager greedy tokens: "
                        f"{tokens_equal_eager} of {len(prompts)} equal")
    if not step_equal:
        problems.append(f"decode step on fixed inputs: captured logits "
                        f"differ from eager by {step_diff}")
    if (launches["flash_attn_fwd_sm90"] or launches["flash_attn_dq_sm90"]
            or launches["flash_attn_dkv_sm90"]):
        problems.append(f"float32 serving launched the sm90 kernels: "
                        f"{launches}")
    divergences = []
    for p, a, b in zip(prompts, ref_results, results):
        if list(a.tokens) != list(b.tokens):
            ok, det = explain_divergence(model, p, list(a.tokens),
                                         list(b.tokens))
            divergences.append(det)
            if not ok:
                problems.append(f"greedy tokens diverge without a near-tie: "
                                f"{det}")
    generated = sum(int(r.tokens.size) for r in results)
    ttft = [r.ttft_s for r in results]
    itl = [g for r in results for g in r.intertoken_s]
    dec = m.histogram("dl4j_tpu_serving_decode_step_seconds").percentiles()
    emit({"phase": "serve", "card": smi, "model": "GptConfig.base()",
          "dtype": "float32", "requests": len(prompts),
          "prompt_lens": lengths.tolist(), "max_new_tokens": 32,
          "admitted": admitted, "decode_steps": decode_steps,
          "launches": launches, "generated_tokens": generated,
          "wall_s": wall, "tokens_per_s": generated / wall,
          "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
          "intertoken_p50_ms": float(np.percentile(itl, 50)) * 1e3,
          "decode_step_p50_ms_hist": dec["p50"] * 1e3,
          "generic_tokens_per_s": sum(int(r.tokens.size)
                                      for r in ref_results) / ref_wall,
          "generic_ttft_p50_ms": float(np.percentile(
              [r.ttft_s for r in ref_results], 50)) * 1e3,
          "tokens_equal_generic": sum(list(a.tokens) == list(b.tokens)
                                      for a, b in zip(ref_results, results)),
          "divergences": divergences,
          "captured": {"tokens_per_s": generated / wall,
                       "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
                       "decode_step_p50_ms": step_p50["captured"]},
          "eager": {"tokens_per_s": sum(int(r.tokens.size)
                                        for r in eager_results) / eager_wall,
                    "ttft_p50_ms": float(np.percentile(
                        [r.ttft_s for r in eager_results], 50)) * 1e3,
                    "decode_step_p50_ms": step_p50["eager"]},
          "decode_step_timed": f"{DECODE_TIMED} steps each, 8 slots, "
                               f"host wall of eng.step(), no spread",
          "tokens_equal_eager": tokens_equal_eager,
          "decode_logits_bit_equal_eager": step_equal,
          "serving_ledger": serving_ledger, "graph_units": units,
          "problems": problems})
    if problems:
        raise SystemExit(f"serve phase failed: {problems}")

    # --------------------------------------------------- serve_supervised
    problems, line, supervised_launches, faults_line = (
        serve_supervised_phase(dev, smi, model, engine_kw, prompts, results))
    emit(line)
    emit(faults_line)
    if problems:
        raise SystemExit(f"serve_supervised phase failed: {problems}")

    # -------------------------------- serve_prefix, serve_spec, serve_cluster
    serving_launches = {}
    problems, line, serving_launches["serve_prefix"], traffic = (
        serve_prefix_phase(dev, smi, model))
    emit(line)
    if problems:
        raise SystemExit(f"serve_prefix phase failed: {problems}")
    serve_line = {"tokens_per_s": generated / wall}
    problems, line, serving_launches["serve_spec"] = serve_spec_phase(
        dev, smi, model, engine_kw, prompts, results, serve_line)
    emit(line)
    if problems:
        raise SystemExit(f"serve_spec phase failed: {problems}")
    problems, line, serving_launches["serve_cluster"] = serve_cluster_phase(
        dev, smi, model, traffic)
    emit(line)
    if problems:
        raise SystemExit(f"serve_cluster phase failed: {problems}")

    # ------------------------------------------------------ train, train_fused
    train_launches = {}
    for phase, kw in (("train", dict(fused=False, dtype="float32",
                                     batch=32)),
                      ("train_fused", dict(fused=True, dtype="mixed",
                                           batch=128))):
        problems, line, train_launches[phase] = train_phase(
            phase, dev, smi, **kw)
        emit(line)
        if problems:
            raise SystemExit(f"{phase} phase failed: {problems}")

    # ------------------------------------------------- bert_train, bert_mlm
    for phase, kw in (("bert_train", dict(dtype="float32", batch=32,
                                          seq=128, task="classifier",
                                          min_len=16)),
                      ("bert_mlm", dict(dtype="bfloat16", batch=8, seq=512,
                                        task="mlm", min_len=None))):
        problems, line, train_launches[phase] = bert_phase(
            phase, dev, smi, **kw)
        emit(line)
        if problems:
            raise SystemExit(f"{phase} phase failed: {problems}")

    # ---------------------------------------------------------- onnx_bert
    problems, onnx_line, train_launches["onnx_bert"], float32_out = (
        onnx_bert_phase(dev, smi))
    emit(onnx_line)
    if problems:
        raise SystemExit(f"onnx_bert phase failed: {problems}")

    # ------------------------------------------ onnx_vit, onnx_resnet50
    for phase in ("onnx_vit", "onnx_resnet50"):
        problems, line, train_launches[phase] = onnx_vision_phase(
            phase, dev, smi)
        emit(line)
        if problems:
            raise SystemExit(f"{phase} phase failed: {problems}")

    # --------------------------------------------------- sd_bert_finetune
    problems, line, train_launches["sd_bert_finetune"] = (
        sd_bert_finetune_phase(dev, smi))
    emit(line)
    if problems:
        raise SystemExit(f"sd_bert_finetune phase failed: {problems}")

    # ------------------------------------------------------------ tf_bert
    problems, line, train_launches["tf_bert"] = tf_bert_phase(dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"tf_bert phase failed: {problems}")

    # ------------------------------------------------------ sd_namespaces
    problems, line, train_launches["sd_namespaces"] = sd_namespaces_phase(
        dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"sd_namespaces phase failed: {problems}")

    # --------------------------------------------------------- op_catalog
    problems, line = op_catalog_phase(dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"op_catalog phase failed: {problems}")

    # ---------------------------------------------------------- int8_bert
    int8_keep = {}
    problems, line, train_launches["int8_bert"] = int8_bert_phase(
        dev, smi, onnx_line, float32_out, keep=int8_keep)
    emit(line)
    if problems:
        raise SystemExit(f"int8_bert phase failed: {problems}")

    # ---------------------------------------------------- export_bindings
    t_phase = time.perf_counter()
    problems, line, train_launches["export_bindings"] = (
        export_bindings_phase(dev, smi, int8_keep))
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    if problems:
        raise SystemExit(f"export_bindings phase failed: {problems}")

    # ------------------------------------------------- onnx_bert_autocast
    problems, line, train_launches["onnx_bert_autocast"] = (
        onnx_bert_autocast_phase(dev, smi, onnx_line, float32_out))
    emit(line)
    if problems:
        raise SystemExit(f"onnx_bert_autocast phase failed: {problems}")

    # ------------------- lenet, lenet_bf16, bilstm_tagger, char_lstm
    for phase, fn in (("lenet", lenet_phase),
                      ("lenet_bf16", lenet_bf16_phase),
                      ("bilstm_tagger", bilstm_tagger_phase),
                      ("char_lstm", char_lstm_phase)):
        problems, line, train_launches[phase] = fn(dev, smi)
        emit(line)
        if problems:
            raise SystemExit(f"{phase} phase failed: {problems}")

    # ------------------------------------------------------------ zoo_cnn
    problems, train_launches["zoo_cnn"] = zoo_cnn_phase(dev, smi)
    if problems:
        raise SystemExit(f"zoo_cnn phase failed: {problems}")

    # ------------------------------------ supervised_train, graph_tbptt
    for phase, fn in (("supervised_train", supervised_train_phase),
                      ("graph_tbptt", graph_tbptt_phase)):
        problems, line, train_launches[phase], faults_line = fn(dev, smi)
        emit(line)
        emit(faults_line)
        if problems:
            raise SystemExit(f"{phase} phase failed: {problems}")

    # -------------------------------------- fit_scanned, the coefficients
    problems, line, train_launches["fit_scanned"] = fit_scanned_phase(dev,
                                                                       smi)
    emit(line)
    if problems:
        raise SystemExit(f"fit_scanned phase failed: {problems}")
    problems, line = updater_coefficients_phase(dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"updater_coefficients phase failed: {problems}")

    # --------------------------------------------------------- keras_bert
    keras_keep = {}
    problems, line, train_launches["keras_bert"] = keras_bert_phase(
        dev, smi, keep=keras_keep)
    emit(line)
    if problems:
        raise SystemExit(f"keras_bert phase failed: {problems}")

    # ----------------------------------------------- keras_bert_transfer
    t_phase = time.perf_counter()
    problems, line, train_launches["keras_bert_transfer"] = (
        keras_bert_transfer_phase(dev, smi, keras_keep.pop("h5")))
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    if problems:
        raise SystemExit(f"keras_bert_transfer phase failed: {problems}")

    # ---------------------------------------------------- nn_layer_types
    t_phase = time.perf_counter()
    problems, line, train_launches["nn_layer_types"] = nn_layer_types_phase(
        dev, smi)
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    if problems:
        raise SystemExit(f"nn_layer_types phase failed: {problems}")

    # ------------------------------------- parallel_moe, parallel_inference
    problems, line, train_launches["parallel_moe"] = parallel_moe_phase(
        dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"parallel_moe phase failed: {problems}")
    problems, line = parallel_inference_phase(dev, smi)
    emit(line)
    if problems:
        raise SystemExit(f"parallel_inference phase failed: {problems}")

    # ------------------------------------------------------ aot_warm_boot
    t_aot = time.perf_counter()
    problems, line, train_launches["aot_warm_boot"] = aot_warm_boot_phase(
        dev, smi)
    line["seconds"] = time.perf_counter() - t_aot
    emit(line)
    if problems:
        raise SystemExit(f"aot_warm_boot phase failed: {problems}")

    # ---------------------------------------------- contract lines, last
    # launches of each kernel on each main path that runs it
    # (flash_attn_fwd, flash_attn_dq, flash_attn_dkv, fused_matmul_bias_act,
    # bn_matmul_stats and matmul_int8 count every design: their rows take
    # the CUDA-core / WMMA design's launches, the _sm90 rows the 16-bit (or
    # int8) tensor-core ones, the _f32_sm90 rows the float32 ones)
    by_path = {name: {} for name in (
        "flash_attn_fwd", "flash_attn_fwd_sm90", "flash_attn_fwd_f32_sm90",
        "paged_decode", "fused_updater", "bn_matmul_stats",
        "bn_matmul_stats_sm90", "flash_attn_dq", "flash_attn_dq_sm90",
        "flash_attn_dq_f32_sm90", "flash_attn_dkv", "flash_attn_dkv_sm90",
        "flash_attn_dkv_f32_sm90", "fused_matmul_bias_act",
        "fused_matmul_bias_act_sm90", "fused_matmul_bias_act_f32_sm90",
        "fused_layer_norm", "matmul_int8", "matmul_int8_sm90",
        "matmul_int8_row_quantize")}
    for path, counts in dict(serve=launches,
                             serve_supervised=supervised_launches,
                             **serving_launches, **train_launches).items():
        counts = dict(counts)
        for both in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                     "fused_matmul_bias_act", "bn_matmul_stats",
                     "matmul_int8"):
            if both in counts:
                counts[both] -= (counts.get(both + "_sm90", 0)
                                 + counts.get(both + "_f32_sm90", 0))
        for name, n in counts.items():
            if name in by_path and n:
                by_path[name][path] = n
    sources = {
        "flash_attn_fwd": ("flash_attn_fwd.cu", "pallas_attention.py:194"),
        "flash_attn_fwd_sm90": ("flash_attn_fwd_sm90.cu",
                                "pallas_attention.py:194"),
        "flash_attn_fwd_f32_sm90": ("flash_attn_fwd_f32_sm90.cu",
                                    "pallas_attention.py:194"),
        "paged_decode": ("paged_decode.cu", "pallas_attention.py:683"),
        "fused_updater": ("fused_updater.cu", "pallas_updater.py:84"),
        "bn_matmul_stats": ("bn_matmul_stats.cu", "pallas_convbn.py:49"),
        "bn_matmul_stats_sm90": ("bn_matmul_stats_sm90.cu",
                                 "pallas_convbn.py:49"),
        "flash_attn_dq": ("flash_attn_bwd.cu", "pallas_attention.py:244"),
        "flash_attn_dq_sm90": ("flash_attn_dq_sm90.cu",
                               "pallas_attention.py:244"),
        "flash_attn_dq_f32_sm90": ("flash_attn_dq_f32_sm90.cu",
                                   "pallas_attention.py:244"),
        "flash_attn_dkv": ("flash_attn_bwd.cu", "pallas_attention.py:282"),
        "flash_attn_dkv_sm90": ("flash_attn_dkv_sm90.cu",
                                "pallas_attention.py:282"),
        "flash_attn_dkv_f32_sm90": ("flash_attn_dkv_f32_sm90.cu",
                                    "pallas_attention.py:282"),
        "fused_matmul_bias_act": ("fused_matmul.cu", "pallas_matmul.py:42"),
        "fused_matmul_bias_act_sm90": ("fused_matmul_sm90.cu",
                                       "pallas_matmul.py:42"),
        "fused_matmul_bias_act_f32_sm90": ("fused_matmul_f32_sm90.cu",
                                           "pallas_matmul.py:42"),
        "fused_layer_norm": ("fused_layer_norm.cu",
                             "pallas_layernorm.py:69"),
        "matmul_int8": ("matmul_int8.cu", "quantized.py:122"),
        "matmul_int8_sm90": ("matmul_int8_sm90.cu", "quantized.py:122"),
        # the per-row activation quantization XLA runs before the Pallas
        # kernel (`_row_quantize` at matmul_int8_pallas, quantized.py:173)
        "matmul_int8_row_quantize": ("matmul_int8.cu", "quantized.py:173")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    summary = []
    for name, (source, replaces) in sources.items():
        rows = [e for e in entries if e["kernel"] == name]
        first = rows[0]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{source}",
            "replaces": f"deeplearning4j_tpu/ops/{replaces}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            **{k: first[k] for k in keys},
            **{k: first[k] for k in ("library_chain_ms",) if k in first},
            "dtype": first["dtype"], "shape": first["shape"],
            "other_shapes": [dict({k: r[k] for k in keys},
                                  dtype=r["dtype"], shape=r["shape"],
                                  **{x: r[x] for x in ("bert", "dropout",
                                                       "leaf", "conv",
                                                       "activation",
                                                       "design", "causal",
                                                       "context",
                                                       "path_ms",
                                                       "layout_copies_ms",
                                                       "library_chain_ms")
                                     if x in r})
                             for r in rows[1:]]})
    emit({"seconds": time.perf_counter() - t_start,
          "what": "chip_smoke from main() to its contract lines, the "
                  "kernels' build included"})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
