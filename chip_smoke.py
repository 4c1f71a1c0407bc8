#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one
NVIDIA GPU: RN50 (the reference's default tower), then SigLIP, GradCache
and the soft-target loss, then the device image ops, the raw-uint8
server, zero-shot, the CLI with ``device_augment``, ``torch.export`` and
the encode CLI, then the extensions and knobs: the sparse projection
with the per-eval plots, remat, the one-hot embedding and the LayerNorm
in the compute type; last the host data routes: the native tokenizer,
the repository's RN50 and ViT-L-14 YAMLs through the CLI and the grain
route; data-parallel training across processes: the CLI under
``torchrun`` over NCCL, and 2 and 4 gloo ranks sharing the card; and the
repository's two large-tower YAMLs (ViT-g-14 under the launcher, ViT-H-14
at pp 2) with ViT-bigG-14 served.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each; any failure exits nonzero before the final line:

1. build the CUDA kernels from ``sparsify_clip_tpu_torch/ops/csrc`` (one
   ``nvcc`` a source, all started together);
2. hold the attention forward kernel against its plain PyTorch version at
   the towers' batch-256 shapes (bf16) and once in fp32, and time both
   beside SDPA's forward under each backend that takes the shape (the
   fastest is the yardstick, named);
3. build full-width ViT-B-32 in bf16 from a seed on the card;
4. serve image and token-row requests from several threads through
   ``BatchingEncoderServer`` over ``CLIPEncoder``, check the embeddings
   (finite, unit norm, equal to a direct encode, equal to the plain
   attention path) and that every attention layer ran the kernel;
5. report requests/s and latency beside the card's name and power limit;
6. hold the training kernels against their plain versions at the train
   step's shapes and time both: the attention backward at the vision
   (256, 50, 2304) and causal text (256, 77, 1536) bf16 shapes and once in
   fp32, beside SDPA's backward under each backend that takes the shape
   (flash, efficient, cuDNN; the fastest is the yardstick, named); the
   InfoNCE forward and both backward kernels at (256, 512) fp32, at
   N = 200, which is no multiple of the TPU's 128-row tile or of the
   backward's 32-row tile, and at ViT-L-14-336's (64, 768);
7. train full-width ViT-B-32 (fp32 parameters, bf16 compute) at batch 256
   under ``loss_type: "anchor"`` with a learnable temperature, through
   ``create_train_setup``, ``train_step`` and ``run_training``, on a fixed
   device-resident synthetic batch.  First one step's gradients on the
   kernels against the same step with every kernel swapped for its plain
   version (that pass must launch no kernel; loss, temperature gradient
   and each parameter's gradient direction must agree); then warm-up
   steps through ``train_step`` and one timed epoch through
   ``run_training``, whose losses must be finite and fall, with exactly
   24 ``mha_fwd``, 24 ``mha_bwd`` and one launch of each InfoNCE kernel
   per step.  Step ms, pairs/s and peak device memory are printed beside
   the card's name and power limit;
8. hold the fused uniformity forward and backward kernels against their
   plain versions at phase 6's shapes, fp32 unit rows, and time both;
9. train full-width ViT-B-32 at batch 256 under the exp-6 configuration
   (``only_lunif_n_then_anchor+lalign+lunif(centroids)``, one warm epoch,
   fixed temperature 0.1, bf16 compute) through ``create_train_setup``,
   ``train_step`` and ``run_training``, two epochs of a few steps on a
   fixed device-resident batch: epoch 0 is the warm phase (uniformity
   alone), epoch 1 the main phase.  One warm and one main step are first
   held against the same step with every kernel swapped for its plain
   version (which launches none); the epochs must launch exactly 24
   ``mha_fwd``, 24 ``mha_bwd`` and 2 of each uniformity kernel a warm
   step, and 24, 24, one of each InfoNCE kernel and one of each uniformity
   kernel a main step; losses must be finite.  Step ms and pairs/s of each
   phase and the peak device memory are printed beside the card;
10. the per-epoch eval inside that ``run_training``: ``evaluate_model``
   over ``make_eval_model(model)``, the fp32 twin on the training
   parameters, over 512 synthetic pairs in two batches of 256, before
   training and after each epoch.  The 13 metrics must be present and
   finite, each eval must launch 24 ``mha_fwd`` a batch and nothing else,
   and the final eval must agree with the same eval on the plain
   attention;
11. hold the head-group attention kernels (``ops/csrc/mha_fwd.cu``'s
   head-group entry point and ``ops/csrc/mha_head_group.cu``,
   the route of sequences whose packed qkv is over 3 MB a sample) against
   their plain versions and time them beside SDPA and their bound: the
   forward at the ViT-L-14-336 vision shape (64, 577, 3072) in bf16,
   causal and not, and at (32, 577, 3072) and the eval's (64, 577, 3072)
   in fp32, beside SDPA's forward under each backend as phase 2; the
   backward at
   (64, 577, 3072) bf16 and (8, 577, 3072) fp32, beside SDPA's backward
   under each backend as phase 6.  Check that the route
   sends (577, 3072, 16 heads) in bf16 and fp32 to the head-group pair and
   the text tower's (77, 2304, 12 heads) to the whole-width pair;
12. build full-width ViT-L-14-336 in bf16 from a seed (the init time is
   printed) and serve 256 image and 256 token-row requests from several
   threads, ``max_batch`` 64, with phase 4's checks; each image batch must
   launch 24 ``mha_fwd_head_group`` and nothing else, each text batch 12
   ``mha_fwd`` and nothing else;
13. train full-width ViT-L-14-336 under exp 6 at batch 64 as phase 9 does,
   over one warm and one main epoch of 4 steps: a warm step launches
   24 ``mha_fwd_head_group``, 24 ``mha_bwd_head_group``, 12 ``mha_fwd``,
   12 ``mha_bwd`` and 2 of each uniformity kernel, a main step the same
   attention, one of each InfoNCE kernel and one of each uniformity
   kernel.  The warm and the main step held against the plain versions
   run at batch 8: at 64 the plain attention's (64, 16, 577, 577) fp32
   scores, saved for autograd in every layer, would not fit the card;
14. the eval inside that run, as phase 10: every batch launches 24 fp32
   ``mha_fwd_head_group`` and 12 fp32 ``mha_fwd`` and no backward;
15. hold the fused LayerNorm + qkv kernel (``ops/csrc/ln_qkv.cu``) against
   its plain version and time it beside the unfused pair
   ``F.linear(F.layer_norm(x))`` (two library calls) and its bound: the
   ViT-L-14-336 shapes at batch 64, vision (36928, 1024) → 3072 and text
   (4928, 768) → 2304 in bf16, vision in fp32 (the eval twin), and 1000
   rows at W 1664 in bf16 (the widest tower, a ragged last tile); then the
   backward's LayerNorm kernel (same source) against autograd of its plain
   version at the vision and text bf16 shapes and the vision fp32 one,
   timed beside ``native_layer_norm_backward`` fed the fast-variance row
   statistics plus ``F.layer_norm`` for y's recompute (two library calls)
   and its bound; two runs of each kernel must agree bit for bit;
16. train ViT-L-14-336 under exp 6 at batch 64 as phase 13, with
   ``fused_ln_qkv: true``: every train step launches phase 13's kernels,
   36 ``ln_qkv_fwd`` (24 vision, 12 text) and, in the backward, 36
   ``ln_fast_bwd``.  The warm and the main step at batch 8 are held
   against the plain versions (which launch nothing) and against the same
   step on the unfused blocks (kernels and all, no ``ln_qkv_fwd`` or
   ``ln_fast_bwd``);
17. the eval inside that run, as phase 14, plus 36 fp32 ``ln_qkv_fwd`` a
   batch and no ``ln_fast_bwd``;
18. run the port's CLI (``sparsify_clip_tpu_torch.cli``) on
   ``configs/smoke_tiny.yaml`` with ``--smoke`` in a temporary directory:
   the JSONL records in the JAX CLI's order, three finite 13-metric evals,
   the epoch and final npz and the full-state checkpoint, and the launches
   of each step (4 ``mha_fwd``, 4 ``mha_bwd``, one of each InfoNCE kernel)
   and of each eval (4 ``mha_fwd``);
19. the CLI on a YAML written to a temporary directory: full-width
   ViT-B-32 under exp 6 at batch 256, 1024 synthetic pairs (4 steps an
   epoch), 256 eval pairs, one warm and one main epoch, a checkpoint
   after the last epoch.  One train record a step, finite evals before
   training, after each epoch and at the end, the last epoch's npz, a
   final npz and the full-state directory, and the launches of phase 9
   in each warm and each main step.  Then the host's loader alone (ms a
   batch over its first 2), the host→device copy of a batch, the CLI's
   step ms and pairs/s from its meter, phase 9's step on a
   device-resident batch, and a ``torch.profiler`` account of two CLI
   steps (kernel-busy ms, copy ms,
   idle share), beside the card (phase 40 sends SIGTERM and resumes
   this run under the launcher);
20. build full-width RN50 (the reference's default tower) in bf16 from a
   seed, its BatchNorm parameters and running statistics in fp32, and
   serve 1024 image and 1024 token-row requests from 8 threads with phase
   4's checks: each image batch launches no kernel (the ResNet tower has
   no attention), each text batch 12 ``mha_fwd``; requests/s and p50/p99
   beside the card;
21. train full-width RN50 under exp 6 at batch 256 as phase 9 does, over
   one warm and one main epoch of 8 steps: phase 9's launches less the
   vision tower's (12 ``mha_fwd`` and 12 ``mha_bwd`` a step, the loss
   kernels as there, at (256, 1024)).  The kernel-vs-plain step check
   moves the BatchNorm running statistics; they are put back before the
   epochs.  The attention pool's key bias, whose true gradient is 0, is
   left out of the gradient-direction check;
22. the eval inside that run, as phase 10 (12 ``mha_fwd`` a batch), the
   fp32 twin reading the trained running statistics; step ms, pairs/s,
   peak memory and eval seconds beside the card;
23. RN50 through the CLI from a YAML: exp 6 at batch 256, 2 epochs of 2
   steps on synthetic pairs, 256 eval pairs, a checkpoint after the last
   epoch; the
   launches of phase 21 a step and 12 ``mha_fwd`` an eval; the final npz
   holds the JAX RN50 parameter keys and no statistics, and the newest
   ``step_<N>.pt`` holds running statistics equal to the model's;
24. train full-width ViT-B-32 at batch 256 with configs/siglip_vitb32.yaml's
   loss fields (``siglip``, scale 10 and bias -10 learned, temperature
   fixed) as phase 9 does, over two epochs of 4 steps with the eval on
   512 pairs: one step on the kernels held against the plain versions
   (loss, both scalars' gradients by phase 7's temperature tolerance
   against the sum of their terms' magnitudes, every parameter's gradient
   direction), exactly 24 ``mha_fwd`` and 24
   ``mha_bwd`` a step and no loss kernel (the sigmoid loss is plain
   PyTorch, as the JAX side's is XLA); ``siglip_scale`` and
   ``siglip_bias`` must move from their inits;
25. full-width ViT-B-32 under exp 6 at batch 256 with ``grad_accum_steps:
   4`` (GradCache) against the one-shot step from the same seed on the
   same batch: a warm and a main step's loss and gradient directions
   within phase 9's tolerances, 192 ``mha_fwd`` and 96 ``mha_bwd`` a step
   (pass 1 and pass 2 each encode the 4 microbatches), the loss kernels
   once a step at the full batch, and the accumulated step's peak memory
   below the one-shot step's; then two main steps of each, timed;
26. full-width ViT-L-14-336 under exp 6 at the reference's batch 256
   through GradCache (4 microbatches of 64, phase 13's batch; the
   one-shot step would not fit the card), as phase 13 does over one warm
   and one main epoch of 2 steps, with the fp32 eval twin on 256 pairs
   in one batch: 192 ``mha_fwd_head_group``, 96 ``mha_bwd_head_group``,
   96 ``mha_fwd`` and 48 ``mha_bwd`` a step, the loss kernels at (256,
   768) once a step; the kernel-vs-plain steps at batch 8 (microbatch 2);
   the peak under the card's memory;
27. the CLI on two YAMLs of full-width ViT-B-32 at batch 256, 2 epochs of
   2 steps, one eval batch: ``anchor-roberta`` with the in-repo provider
   ``_stub_roberta:soft_targets`` and ``adam_mu_dtype: bfloat16`` (its
   full state holds bf16 first and fp32 second moments), and ``siglip``
   (its records carry ``siglip_scale`` / ``siglip_bias``, its full state
   ``loss_scalars``); 24 ``mha_fwd`` and 24 ``mha_bwd`` a step, 24
   ``mha_fwd`` an eval;
28. hold ``ops/image.py`` on the card against the same functions on the
   CPU at batch 256: the ``device_augment`` crop-resize of 256² uint8
   staging images to 224 (with normalization), given the same boxes and
   flips, and ``eval_resize_batch`` from 480×640, both within 1e-5 on [0,
   1] pixels and timed with CUDA events beside the CPU's time and their
   bound (the bytes they move and their nonzero taps);
29. time the host's cost of a no-grad attention call through its custom
   op against its wrapper called directly, at a serving batch's shape;
   build full-width ViT-B-32 in bf16 from a seed and serve 1024 images of
   224² from 8 threads through ``submit_image`` (pixels normalized on the
   host) and through ``submit_image_u8`` (raw uint8), then 1024 uint8
   requests of a 224² / 256² / 480×640 mix: every batch launches 12
   ``mha_fwd`` and nothing else and holds one shape, the shapes' queues
   drain away, the embeddings are finite unit vectors, the uint8 ones
   agree with the fp32 path on the same pixels and each mixed request with
   its pixels resized on the host (phase 4's cosine); requests/s and
   p50/p99 of the three bursts beside phase 5's; then a zero-shot
   classifier over 10 class names × 7 templates (one text batch of 70
   prompts, 12 ``mha_fwd``) on 64 images, whose probabilities sum to 1;
30. the CLI on a YAML of full-width ViT-B-32 under exp 6 at batch 256 with
   ``device_augment: true`` (uint8 staging at 256): 2 epochs of 4 steps on
   1024 synthetic pairs, 256 eval pairs, no epoch checkpoint; phase 9's
   launches a step, the
   loss falling within each epoch (the warm and the main phase's losses
   are different functions); the loader alone, the host→device copy of a
   uint8 batch, the CLI step and a ``torch.profiler`` idle share beside
   phase 19's;
31. export that ViT-B-32 with a symbolic batch and its weights baked in,
   and once with ``uint8_input``; load both in one child process that
   imports only torch and ``sparsify_clip_tpu_torch.ops`` (checked from
   its ``sys.modules``), whose batches of 1, 7 and 64 must agree with the
   live ``CLIPEncoder`` and launch 12 ``mha_fwd`` a call; then the encode
   CLI (``sparsify_clip_tpu_torch.encode.main``, in this process) on 64
   PNG and JPEG files of several
   sizes, written with PIL, and a captions file: its npz holds unit rows
   equal to the live encoder's on the same decoded pixels;
32. the CLI on a YAML of full-width ViT-B-32 under exp 6 at batch 256 with
   ``sparse_projection: topk``, ``sparse_topk`` 64, ``sparse_after_epoch``
   1, 2 epochs of 2 steps on 512 synthetic pairs, 256 eval pairs, and
   ``plot_embeddings: true`` where matplotlib is installed (the UMAP,
   t-SNE and PCA PNGs of each of the 4 eval passes, on the host): phase
   19's launches a step, finite evals, the CLI step beside phase 19's;
   without matplotlib, the same YAML with ``plot_embeddings: true`` is
   refused by name before any file is written; the trained model's
   embeddings of one batch projected as the step does (at least 64
   nonzeros a row, exactly 64 unless ties, unit norm); a main step on the
   kernels held against the same step with every kernel swapped for its
   plain version, in fp32 towers (phase 9's tolerances; in bf16 the two
   paths' roundings move components across the 64th magnitude, and the
   rows whose mask differs are counted); then the ``topk`` and the ``l1``
   step timed on a device-resident batch;
33. full-width ViT-L-14-336 under exp 6 at the reference's batch 256 in
   one shot under ``remat: true`` (policy ``nothing``), through
   ``run_training`` over one warm and one main epoch of 2 steps: the
   backward recomputes each block, so a step launches 48
   ``mha_fwd_head_group``, 24 ``mha_fwd`` and phase 13's backwards; step
   ms, pairs/s and peak beside phase 26's GradCache step; two main steps
   with ``fused_ln_qkv`` (72 ``ln_qkv_fwd``, 36 ``ln_fast_bwd`` a step);
   at batch 64 the remat step against the same step without remat (loss,
   every gradient, the largest difference, phase 9's tolerances) and the
   step ms and peak of no remat and of the policies ``nothing``,
   ``dots_no_batch`` and ``attn_out``; at 256 the policies ``dots`` and
   ``dots_no_batch``, whose saved products may not fit (an out-of-memory
   is printed as a reading);
34. full-width RN50 under exp 6 at batch 256 with and without ``remat``
   from the same seed: after two steps the running statistics, the last
   gradients and the losses agree (phase 9's tolerances; bit-identical or
   not, printed), 24 ``mha_fwd`` a remat step; step ms and peak beside
   phase 21's;
35. full-width ViT-B-32 under exp 6 at batch 256 with ``onehot_embed`` and
   with ``ln_fp32: false`` (and ``fused_ln_qkv: true``, which such blocks
   bypass: no ``ln_qkv_fwd``) against the default step from the same
   seed: the one-hot embedding and the text tower's output equal to the
   gather's to the bit, each main step's loss and gradient directions
   within phase 9's tolerances, phase 9's launches, step ms and peak
   beside phase 9's;
36. the native tokenizer (``text/native.py``) built with ``g++`` into
   ``sparsify_clip_tpu_torch/_build/`` (the seconds printed): its ids
   equal the Python tokenizer's on 4096 synthetic captions, and both
   tokenizers' rows a second; without a C++ compiler, ``tokenizer:
   native`` must raise by name and ``auto`` take the Python tokenizer;
37. ``configs/rn50_tpu_baseline.yaml`` through the CLI (full-width RN50,
   batch 256, ``anchor``, ``device_augment``, ``tokenizer`` and
   ``image_backend`` both ``auto``), 2 epochs of 2 steps, one eval
   batch: the first record names the routes taken (the native tokenizer
   where phase 36 built it; the synthetic set hands out no JPEG bytes, so
   the PIL/numpy image route), finite losses and evals, 12 ``mha_fwd``,
   12 ``mha_bwd`` and one of each InfoNCE kernel a step, 12 ``mha_fwd``
   an eval; the CLI step ms beside phase 23's;
38. ``loader_backend: grain`` through the CLI on phase 19's ViT-B-32
   exp-6 YAML, 2 epochs of 4 steps: float32 images, int32 tokens and
   captions blanked in the loader's batches, phase 19's launches a step,
   finite evals; the loader's ms a batch (in process: the pipeline
   passes no worker count) and the CLI step beside phase 19's;
39. ``configs/vitl14_single_chip.yaml`` through the CLI at full width
   (ViT-L-14 at 224, batch 128, ``anchor`` at a fixed temperature,
   ``device_augment``, no remat), 2 epochs of 2 steps, 128 eval pairs.
   First rows 1 and 3 at (128, 257, 3072) bf16 (the whole-width route at
   L = 257: the forward's last 64-key stage holds one key, the
   backward's last 32-row tile one row) and row 2 in fp32 at (128, 257,
   3072) (the eval twin's head-group route) against their plain versions
   under phase 2's and phase 6's tolerances, timed beside SDPA under each
   backend.  Then the CLI: 36 ``mha_fwd``, 36 ``mha_bwd`` and one of each
   InfoNCE kernel a step; 24 fp32 ``mha_fwd_head_group`` and 12 fp32
   ``mha_fwd`` an eval batch; two main steps under
   ``utils.profiling.trace`` (a Chrome trace written), the five largest
   kernels by device ms, step ms, pairs/s, peak GiB and the idle share;
40. the CLI under ``torchrun --standalone --nproc_per_node=<card count>``
   (``python -m torch.distributed.run``) over NCCL at world = the card
   count, on phase 19's YAML (full-width ViT-B-32 exp 6 at global batch
   256, 2 epochs of 4 steps) with 256 eval pairs: rank 0 (the CLI's entry
   point wrapped to count each step's launches) is sent SIGTERM after its
   fifth train record (the first main-phase step, so the counted steps
   launch rows 1, 3 and 5-9); then ``python -m torch.distributed.run ...
   -m sparsify_clip_tpu_torch.cli`` resumes with ``resume_checkpoint:
   "auto"``.  Both first records name ``nccl``, the world size and the
   loss route (``kernel`` at one rank); at one rank the per-step losses
   and the final npz are bit-identical to phase 19's run without the
   launcher, and the steps launch phase 9's kernels.  Its processes run
   beside phases 41-42's (driven from a thread, after phase 42's kernel
   timings), so its seconds are not those of the launcher alone;
41. gloo over card tensors, 2 and then 4 ranks on card 0 under the
   launcher (NCCL refuses two ranks on one device): the ring losses
   (``ring_infonce_loss``, ``ring_lunif_loss`` alone and on the
   centroids, SigLIP on gathered embeddings) at global (256, 512) fp32
   against the kernels (rows 5-9) and ``siglip_loss`` on the whole batch,
   value and every gradient, the scalars' included, at the CPU tests'
   tolerances; full-width ViT-B-32 (2 and 4 ranks) and RN50 (2 ranks,
   global BatchNorm) exp 6 in fp32 compute, 3 steps at global batch 256
   against the one-process step on the same batches: the first step's
   loss within 1e-5 and its gradient directions within phase 9's
   tolerance, the later losses within 5e-3 (AdamW walks RN50's
   BatchNorm coordinates whose gradient is rounding noise, a sign a
   step, each side its own way), the running statistics within phase 9's
   tolerance, every parameter within AdamW's reach of 3 steps
   (2·lr·steps and the decay), and
   every rank's parameters and buffers bit-identical (a sha256); the
   sharded eval at 2 ranks against the
   one-process eval, every metric within one 4-decimal step.  The step ms
   of each world is printed beside the one-process step: gloo moves the
   bytes of every collective through the host, so these are not
   multi-GPU speeds (and the 2 and the 4 ranks run at once);
42. the sharded layouts (ROADMAP Queue 1, 'Multi-GPU'), extra jobs of
   phase 41's launches: first (before phases 40-41) rows 1, 3, 10 and 11
   at the tensor-parallel
   shapes of ViT-B-32 at tp 2 (vision (256, 50, 1152) over 6 heads, text
   (256, 77, 768) causal over 4; the fused LN+qkv's 3W/tp columns) against
   their plain versions, timed; then full-width ViT-B-32 exp 6 at global
   batch 256 for 3 steps: ZeRO-1 at 2 ranks in bf16 (bit-identical to
   phase 41's data-parallel run, which gives it its gates' readings), FSDP at 2 ranks in
   bf16 (under phase 41's gates), dp 1 × tp 2 in bf16 with
   ``fused_ln_qkv`` against the one-process fused step (24 ``mha_fwd``,
   24 ``mha_bwd``, 24 ``ln_qkv_fwd`` and 24 ``ln_fast_bwd`` a step on each
   rank, and phase 9's loss kernels), and dp 2 × tp 2 with FSDP at 4 ranks
   in fp32 against the one-process fp32 step; each run's parameters put
   back together are bit-identical on every rank.  GPipe on the model
   axis (``pipeline``, ``scan_layers``, the default 2 microbatches): pp 2
   at 2 ranks in bf16 and dp 2 × pp 2 with ZeRO-1 at 4 ranks in fp32,
   under phase 41's gates of their model and type (microbatching changes
   the products' shapes: not bit for bit); each rank holds its stage's
   blocks (its parameter bytes under 0.75× one process's) and launches
   ``2·M·L/S`` ``mha_fwd`` and ``M·L/S`` ``mha_bwd`` a tower a step (each
   stage's forward runs again in the backward), with phase 9's loss
   kernels at dp 1 and none at dp 2 (the ring route); the log gives each
   rank's parameter and moment bytes and peak GiB beside one process's,
   and the bubble share (S−1)/(M+S−1);
43. the repository's two large-tower YAMLs and the widest tower served,
   at full width: first rows 1 and 3 at their shapes against their plain
   versions, timed beside SDPA and their bound (vision head_dim 88, 80
   and 104 take the kernels' head_dim-128 instantiation on the
   whole-width route, bf16, and the fp32 eval twins'; the causal text
   towers at head_dim 64, bigG's over 20 heads); then
   ``configs/vitg14_fsdp_pod.yaml`` (ViT-g-14, 1.37 B parameters: FSDP,
   a bf16 first moment, ``scan_layers``, ``device_augment``,
   ``multihost``) through the CLI's entry point under ``python -m
   torch.distributed.run --nproc_per_node=<card count>``: one epoch of 3
   steps at the YAML's batch 64, one eval batch a pass, the final weights
   file (the JAX ``layers_scan`` layout, 5.47 GB); the first record names
   the layout, the knobs and each tower's attention route; 64
   ``mha_fwd`` and 64 ``mha_bwd`` a step, 64 ``mha_fwd`` an eval batch;
44. ``configs/vith14_pipeline.yaml`` (ViT-H-14, GPipe at ``mesh_model:
   2`` over 4 microbatches, bf16) through the CLI's ``main`` in 2 gloo
   ranks on card 0 (one card holds one NCCL rank): 3 steps of the YAML's
   global batch 32, one eval batch a pass, the final save through the
   full view's stage gather; held against the one-process step (rank 0,
   ``pipeline: false``, no collective, the same seed and batches) under
   phase 42's gates; each rank launches ``2·M·L/S`` ``mha_fwd`` and
   ``M·L/S`` ``mha_bwd`` a step (L/S = 16 + 12 blocks) and ``M·L/S``
   ``mha_fwd`` an eval batch;
45. ViT-bigG-14 (2.54 B parameters) in bf16 from the seed on the card, a
   batch of 64 images and one of 64 token rows through
   ``BatchingEncoderServer``, phase 4's checks; requests/s, p50/p99 and
   the peak.  The script's total seconds and each phase's are printed
   last before the kernels line.

Phases 6 and 8 also hold the loss kernels at RN50's (256, 1024), the
main path's shape, at ViT-L-14-336's (256, 768) of phase 26, and at
ViT-g-14's (64, 1024) and each ViT-H-14 stage's (32, 1024) of phases
43-44.  The kernels line reports each kernel at the case its
``case`` key names: the RN50 path's shape where that path runs the
kernel (the loss rows at (256, 1024); ``mha_fwd`` and ``mha_bwd`` at the
causal text shape (256, 77, 1536) bf16), else ViT-B-32's vision shape.
Three more entries hold phase 39's L = 257 cases (``mha_fwd/vision-257``,
``mha_bwd/vision-257``, ``mha_fwd_head_group/fp32-257``), each with the
ViT-L-14 CLI's launches of its kernel (vision and text towers alike);
phases 43-45's cases (``mha_fwd/g14-vision`` … ``infonce_fwd/32x1024``)
each count their path's launches of their kernel the same way.

Depth cuts of the ViT-L-14-336 phases: 2 epochs of 4 steps (the
reference trains 100); the eval set is 256 pairs in 4 batches of 64
(the reference's 512), evaluated 3 times (before training and after
each epoch).  Phase 19 trains 2 epochs of 4 steps on 1024 synthetic
pairs (the reference trains 100 epochs on COCO; cut from 8 steps an
epoch to make room for phases 40-41) and evaluates 256 pairs 4 times.
The CLI runs of phases 19, 23 and 27 write the full state and the epoch
npz after the last epoch only, those of phases 30, 32 and 38 after none
(each save of ViT-B-32's full state is 1.8 GB); phases 19, 30 and 38
time the loader alone over 2 batches, phases 19 and 30 profile 2 CLI
steps.  RN50 runs at full depth; phases 21-22 train 2 epochs of
8 steps (the reference trains 100 on COCO), phase 23 2 of 2 on 512
synthetic pairs.  Phases 24-27 cut the depth of a run alone: SigLIP 2
epochs of 4 steps, the GradCache ViT-L-14-336 run 2 of 2 (eval 256 pairs,
not 512), the two CLIs 2 of 2 with one eval batch of 256.  Phases 28-31
run ViT-B-32 at full width and depth; phase 30 cuts training to 2
epochs of 4 steps on 1024 synthetic pairs (8 steps an epoch before phases
43-45), 256 eval pairs 4 times.  Phases 32-35 run at full width: phase 32
cuts training to 2 epochs of 2 steps on 512 synthetic pairs (8 steps an
epoch before phases 40-41, 4 before phases 43-45) with 256 eval pairs
(the plots of 512 points take the host seconds a pass), phase 33 trains
2 epochs of 2 steps, phases 34-35 a few
steps.  Phases 36-39 cut depth alone: phase 37 trains 2 epochs of 2
steps on 512 synthetic pairs with 256 eval pairs (the YAML: 100 epochs
on COCO, 512 eval pairs), phase 38 2 epochs of 4 steps (phase 19's YAML
otherwise), phase 39 2 epochs of 2 steps on 256 synthetic pairs with 128
eval pairs (the YAML: 100 epochs on COCO, 512 eval pairs) and profiles 2
steps.  Phases 40-41 cut depth alone: phase 40 runs phase 19's YAML,
phase 41 3 steps.  The
earlier phases run as they did.

The last lines are a JSON object of per-kernel results (time, plain time,
library time, the card's least time for the work, launches on the main
paths; for the loss kernels of phases 6 and 8 also ``device_ms``, the
card's own time a call, apart from the host's time to issue it), the
card's ``nvidia-smi`` name and power limit, and ``{"ok":
true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script fails.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

SEED = 0
N_IMAGES = 1024
N_TOKENS = 1024
SUBMIT_THREADS = 8
MAX_BATCH = 256
# kernel vs plain version: one bf16 rounding step (2^-8 relative) where
# the two fp32 sums, taken in different orders, straddle a boundary
KERNEL_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-5, 1e-5)}  # (rtol, atol)
# served vs direct encode and kernel vs plain attention path, on unit
# bf16-tower embeddings: batch composition and the attention path change
# only bf16 rounding inside the towers
MIN_COSINE = 0.999
NORM_TOL = 1e-3
# attention backward kernel vs plain version: as the forward (one bf16
# rounding of fp32 sums taken in other orders); fp32 sums over L <= 77
BWD_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 2e-5)}  # (rtol, atol)
# the loss kernels' shapes (phases 6 and 8): ViT-B-32's batch 256 and 512-wide
# embeddings, N = 200 (no multiple of any tile), ViT-L-14-336's batch 64 and
# 768-wide embeddings, RN50's batch 256 and 1024-wide embeddings (the main
# path's, phases 21-23), ViT-L-14-336's batch 256 through GradCache (phase 26),
# ViT-g-14's and ViT-H-14's (phases 43-44), ViT-bigG-14's batch 64 and 1280-wide
# embeddings (phase 49)
LOSS_SHAPES = ((256, 512), (200, 512), (64, 768), (256, 1024), (256, 768), (64, 1024),
               (32, 1024), (64, 1280))
MAIN_LOSS_SHAPE = "256x1024"
# InfoNCE kernels vs plain versions, all fp32: other summation orders over
# D <= 1024 and N <= 256; gradients against their largest entry
NCE_TOL = (1e-4, 1e-6)
NCE_GRAD_TOL = (1e-4, 1e-5)  # atol relative to the gradient's largest entry
# training phase
TRAIN_BATCH = 256
TRAIN_STEPS_PER_EPOCH = 20   # one epoch of 20: LR warmup over steps 0-3, then cosine
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# kernel step vs plain step on the same state and batch (bf16 towers):
# the two paths round the same fp32 sums to bf16 in other orders
TRAIN_LOSS_RTOL = 2e-3
TRAIN_DT_RTOL = 2e-2
TRAIN_MIN_GRAD_COSINE = 0.99
# uniformity kernels vs plain versions, all fp32: S sums N(N-1) weights in
# another order, and each Gram entry is an FMA chain in another order than
# cuBLAS's; dx against its largest entry (r∘x − Wx cancels)
LUNIF_S_RTOL, LUNIF_LOSS_ATOL = 1e-5, 1e-5
LUNIF_DX_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry
# exp 6 as scripts/_bench.py:81-87 defines it (copied: that module imports
# the JAX package)
EXP6 = {
    "model": "ViT-B-32", "batch_size": 256, "epochs": 100,
    "learning_rate": 1e-4,
    "loss_type": "only_lunif_n_then_anchor+lalign+lunif(centroids)",
    "only_lunif_epochs": 1, "anchor_temperature": 0.1,
    "fp16": True, "seed": 42,
}
EXP6_EPOCHS, EXP6_STEPS_PER_EPOCH = 2, 8  # depth cut: one warm and one main epoch
EVAL_PAIRS = 512  # the reference's eval set (sparsify_clip_tpu/eval.py:241-242)
# kernel eval vs plain-attention eval on the same fp32 twin: fp32 towers whose
# attention sums run in other orders (embeddings ~1e-6 apart); a rank can
# flip only on a near-tie, so each recall may move by two pairs (the
# tolerance is set from the eval set's size in phase_exp6)
EVAL_GEOMETRY_ATOL = 1e-4
EVAL_MIN_COSINE = 0.99999
# ViT-L-14-336 (phases 12-14): serving, and exp 6 at the batch of the JAX
# package's ViT-L-14-336 train audit (BASELINE.md:416-419)
L336 = "ViT-L-14-336"
L336_REQUESTS = 256             # of each kind
L336_MAX_BATCH = 64
L336_BATCH = 64
L336_CHECK_BATCH = 8            # kernel step vs plain step
L336_STEPS_PER_EPOCH = 4
L336_EVAL_PAIRS = 256
# head-group backward vs plain version in fp32: against the largest entry
# (dS = P∘(dP − Dr) cancels; sums over 577 keys in other orders)
HG_BWD_FP32_TOL = (1e-4, 1e-5)  # rtol, atol relative to the largest entry
# the backward's LayerNorm kernel vs autograd of its plain version: y and dx
# are fp32 values rounded once to their type from row statistics summed in
# other orders (one step of the type, plus 1e-5 of the largest entry where
# the fp32 terms cancel); dscale and dbias sum N rows in another order
LN_BWD_STEP = {"bfloat16": 2.0 ** -7, "float32": 2.0 ** -23}
LN_BWD_CANCEL = 1e-5            # of the largest entry, y and dx
LN_BWD_GRAD_TOL = (1e-4, 1e-5)  # dscale, dbias: rtol, atol relative to the largest entry
# the CLI phases (19, 30, 32): exp 6 from a YAML at batch 256; phases 19
# and 30 at 4 steps an epoch (30 cut from 8 for phases 43-45), phase 32 at
# 2 (cut from 4, the same); one eval batch a pass; the full state and the
# epoch npz written after the last epoch only (phases 19, 23, 27 read them;
# 30, 32 and 38 write none: NO_EPOCH_SAVES)
CLI_TRAIN_SAMPLES = 1024
CLI_EXP6_SAMPLES = 1024
SPARSE_SAMPLES = 512
CLI_EVAL_PAIRS = 256
CLI_LOADER_BATCHES = 2          # batches of the loader timed alone
CLI_PROFILE_STEPS = 2           # main-phase steps under torch.profiler
NO_EPOCH_SAVES = dict(save_checkpoint_every_n_epochs=EXP6_EPOCHS + 1)
CLI_PROCESS_TIMEOUT = 300       # seconds, phase 31's child process
# RN50 through the CLI (phase 23): 2 steps an epoch, one eval batch
RN50_CLI_STEPS = 2
RN50_CLI_EVAL_PAIRS = 256
# SigLIP (phase 24): configs/siglip_vitb32.yaml's loss fields on ViT-B-32 at
# batch 256, 2 epochs of 4 steps
SIGLIP_FIELDS = ("loss_type", "siglip_logit_scale_init", "siglip_logit_bias_init",
                 "only_lunif_epochs", "anchor_temperature", "anchor_temperature_learnable")
SIGLIP_STEPS_PER_EPOCH = 4
# GradCache (phases 25-26): 4 microbatches; ViT-L-14-336 at the reference's
# batch 256 (microbatch 64, phase 13's batch), 2 epochs of 2 steps
GRADCACHE_STEPS = 4
L336_GRADCACHE_BATCH = 256
L336_GRADCACHE_STEPS_PER_EPOCH = 2
# the two loss CLIs (phase 27): 2 steps an epoch, one eval batch
CLI_LOSS_STEPS = 2
CLI_LOSS_EVAL_PAIRS = 256
# the host data routes (phases 36-39): captions for the tokenizers' rates,
# the grain CLI's steps an epoch, configs/vitl14_single_chip.yaml's batch
# with its depth cut (steps an epoch, eval pairs, profiled main steps)
TOKENIZER_CAPTIONS = 4096
GRAIN_STEPS = 4
VITL14_BATCH = 128
VITL14_STEPS = 2
VITL14_EVAL_PAIRS = 128
VITL14_PROFILE_STEPS = 2
REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


PHASE_ENDS: dict = {}  # phase number -> seconds at its last line, in order


def log(phase: str, **fields) -> None:
    """One line a reading; ``t`` is the seconds since the script started."""
    t = time.perf_counter() - T0
    fields["t"] = f"{t:.1f}"
    words = phase.split()
    if words[0] == "phase":
        PHASE_ENDS[words[1]] = t
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_seconds() -> dict:
    """Each phase's seconds, from the line before its first to its last
    (phases that run inside another count with the one that ends later)."""
    out, before = {}, 0.0
    for phase, end in sorted(PHASE_ENDS.items(), key=lambda item: item[1]):
        out[phase] = round(end - before, 1)
        before = end
    return out


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """The card's time a call of ``fn``, without the host's: the calls are
    queued behind a sleep kernel long enough for the host to enqueue them
    all, so the card runs them back to back (``cuda_ms`` times calls as
    the host issues them, which is the host's time where it is longer)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, dtype: str):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for the inputs'
    type → (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(l: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through a head."""
    return l * (l + 1) // 2 if causal else l * l


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backend_ms(run, what: str, iters: int, warmup: int):
    """``run()`` timed under each backend of ``SDPA_BACKENDS`` that takes
    its shape → ({backend: ms}, the fastest backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                times[name.lower()] = cuda_ms(run(), iters=iters, warmup=warmup)
        except RuntimeError:  # the backend does not take this shape or type
            continue
    if not times:
        raise AssertionError(f"no SDPA backend takes {what}")
    return times, min(times, key=times.get)


def sdpa_qkv(qkv, heads: int):
    """(B, H, L, D) copies of q, k and v from a packed (B, L, 3W) qkv."""
    b, l, w3 = qkv.shape
    return qkv.view(b, l, 3, heads, w3 // (3 * heads)).permute(2, 0, 3, 1, 4).contiguous()


def sdpa_fwd_ms(qkv, heads: int, causal: bool, iters: int, warmup: int):
    """PyTorch's fused attention forward on (B, H, L, D) copies, timed under
    each backend that takes the shape → ({backend: ms}, the fastest).  A
    yardstick only: the port never calls it."""
    q, k, v = sdpa_qkv(qkv, heads)

    def run():
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)

    return sdpa_backend_ms(run, f"{tuple(qkv.shape)} {qkv.dtype}", iters, warmup)


def sdpa_bwd_ms(qkv, dout, heads: int, causal: bool, iters: int, warmup: int):
    """The backward of PyTorch's fused attention, from its own forward on
    (B, H, L, D) leaves, timed under each backend that takes the shape (the
    backend picked for the forward runs the backward too) → ({backend: ms},
    the fastest backend).  A yardstick only: the port never calls it."""
    b, l, w3 = qkv.shape
    q, k, v = (t.detach().requires_grad_(True) for t in sdpa_qkv(qkv, heads))
    do = dout.view(b, l, heads, w3 // (3 * heads)).transpose(1, 2).contiguous()

    def run():
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    return sdpa_backend_ms(run, f"{tuple(qkv.shape)} {qkv.dtype}", iters, warmup)


def phase_build():
    from sparsify_clip_tpu_torch.ops import _build

    t = time.perf_counter()
    path, build_log = _build.build()
    _build.library()
    usage = _build.ptxas_usage(build_log)
    log("phase 1 build", ok=True, seconds=f"{time.perf_counter() - t:.3f}",
        library=path.name, ptxas=json.dumps(usage),
        spilling=json.dumps([u["kernel"] for u in usage if u.get("spill_stores")]),
        serialized_wgmma=json.dumps([ln for ln in build_log.splitlines() if "C752" in ln]))


def phase_kernel():
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd, mha_fwd_reference

    cases = [
        ("vision", 256, 50, 12, 64, False, torch.bfloat16),
        ("text", 256, 77, 8, 64, True, torch.bfloat16),
        ("vision-fp32", 256, 50, 12, 64, False, torch.float32),
    ]
    results = {}
    rng = np.random.default_rng(SEED)
    for name, b, l, heads, head_dim, causal, dtype in cases:
        host = rng.standard_normal((b, l, 3 * heads * head_dim), dtype=np.float32)
        qkv = torch.from_numpy(host).to("cuda", dtype)
        got, got_lse = mha_fwd(qkv, heads, causal, with_lse=True)
        want, want_lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: mha_fwd(qkv, heads, causal))
        plain_ms = cuda_ms(lambda: mha_fwd_reference(qkv, heads, causal))
        # yardstick: SDPA's forward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_fwd_ms(qkv, heads, causal, iters=50, warmup=5)
        library_ms = sdpa_ms[library]
        item = qkv.element_size()
        bound_ms, bound_by = bound(
            b * l * 4 * heads * head_dim * item,  # qkv read, context written
            2 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S and P.V
            str(dtype).split(".")[1],
        )
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 2 kernel", case=name, shape=list(qkv.shape), heads=heads,
            causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_fwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    return results


def token_rows(rng, n, context, vocab):
    """SOT, random ids, EOT at a random position, zero padding after it."""
    rows = rng.integers(1, vocab - 2, size=(n, context)).astype(np.int32)
    rows[:, 0] = vocab - 2
    eot = rng.integers(1, context, size=n)
    for i, e in enumerate(eot):
        rows[i, e] = vocab - 1
        rows[i, e + 1:] = 0
    return rows


def min_cosine(a, b) -> float:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return float((a * b).sum(-1).min())


def encode_direct(fn, rows, chunk):
    return np.concatenate([fn(rows[i:i + chunk]).float().cpu().numpy()
                           for i in range(0, len(rows), chunk)])


class _BatchLaunches:
    """An encoder for the server that records each batch's kind and the
    kernel launches it made.  The server's one runner thread serves its
    one replica, so batches run one at a time and the counts are exact."""

    def __init__(self, encoder):
        self.encoder, self.device, self.batches = encoder, encoder.device, []
        self.u8_shapes = []  # (H, W) of each raw-uint8 batch

    def encode_images(self, images):
        return self._run("image", self.encoder.encode_images, images)

    def encode_images_u8(self, images):
        self.u8_shapes.append(tuple(images.shape[1:3]))
        return self._run("image_u8", self.encoder.encode_images_u8, images)

    def encode_tokens(self, tokens):
        return self._run("tokens", self.encoder.encode_tokens, tokens)

    def _run(self, kind, fn, x):
        before = read_counts()
        out = fn(x)
        after = read_counts()
        self.batches.append((kind, {k: after[k] - before[k] for k in after}))
        return out


def phase_serve(model, phase: str, n_images: int, n_tokens: int, max_batch: int,
                per_batch: dict):
    """Serve ``n_images`` image and ``n_tokens`` token-row requests from
    several threads; check the embeddings and that each batch of a kind
    launched exactly ``per_batch[kind]`` (kernel → count, the rest 0)."""
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.models import layers
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd_reference
    from sparsify_clip_tpu_torch.serving import BatchingEncoderServer

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    size = cfg.image_size
    images = rng.standard_normal((n_images, size, size, 3), dtype=np.float32)
    tokens = token_rows(rng, n_tokens, cfg.context_length, cfg.vocab_size)
    requests = [("image", i) for i in range(n_images)] + [("tokens", i) for i in range(n_tokens)]
    order = rng.permutation(len(requests))

    encoder = CLIPEncoder(model)
    recorder = _BatchLaunches(encoder)
    server = BatchingEncoderServer(recorder, max_batch=max_batch)
    futures = [None] * len(requests)
    errors = []

    def submit(worker):
        try:
            for j in order[worker::SUBMIT_THREADS]:
                kind, i = requests[j]
                futures[j] = (server.submit_image(images[i]) if kind == "image"
                              else server.submit_tokens(tokens[i]))
        except Exception as exc:  # reported and failed below
            errors.append(exc)

    try:
        server.warmup((size, size, 3), cfg.context_length)
        recorder.batches.clear()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submit, args=(w,)) for w in range(SUBMIT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"submission failed: {errors}")
        rows = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        launches = read_counts()
        stats = server.stats()
    finally:
        server.close()

    served_img = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "image"])
    served_txt = np.stack([rows[j] for j, (k, _) in enumerate(requests) if k == "tokens"])
    served = np.concatenate([served_img, served_txt])
    norms = np.linalg.norm(served, axis=-1)
    if served.shape != (n_images + n_tokens, cfg.embed_dim) or not np.isfinite(served).all():
        raise AssertionError(f"bad embeddings: shape {served.shape}, finite {np.isfinite(served).all()}")
    if np.abs(norms - 1).max() > NORM_TOL:
        raise AssertionError(f"norms off 1 by {np.abs(norms - 1).max()}")
    if stats.errors or stats.requests != len(requests):
        raise AssertionError(f"server stats {stats}")
    zero = dict.fromkeys(KERNELS, 0)
    wrong = [(kind, c) for kind, c in recorder.batches if c != dict(zero, **per_batch[kind])]
    if wrong or len(recorder.batches) != stats.batches:
        raise AssertionError(f"batches launched {wrong[:3]}, expected {per_batch} a batch of "
                             f"each kind ({len(recorder.batches)} recorded, {stats.batches} run)")

    direct_img = encode_direct(encoder.encode_images, images, max_batch)
    direct_txt = encode_direct(encoder.encode_tokens, tokens, max_batch)
    cos_served = min(min_cosine(served_img, direct_img), min_cosine(served_txt, direct_txt))
    # the same encoder with the towers' attention core swapped for the
    # plain version
    kernel_core, kernel_launches = layers.attention_core, read_counts()
    layers.attention_core = lambda qkv, heads, causal=False: mha_fwd_reference(qkv, heads, causal)[0]
    try:
        plain_img = encode_direct(encoder.encode_images, images, max_batch)
        plain_txt = encode_direct(encoder.encode_tokens, tokens, max_batch)
    finally:
        layers.attention_core = kernel_core
    if read_counts() != kernel_launches:
        raise AssertionError("the plain attention pass launched a kernel")
    cos_plain = min(min_cosine(direct_img, plain_img), min_cosine(direct_txt, plain_txt))
    kinds = [kind for kind, _ in recorder.batches]
    log(phase, ok=True, model=cfg.name, requests=stats.requests, batches=stats.batches,
        image_batches=kinds.count("image"), text_batches=kinds.count("tokens"),
        histogram=json.dumps(stats.batch_histogram), mean_batch=f"{stats.mean_batch:.2f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        per_batch=json.dumps(per_batch), max_norm_err=float(np.abs(norms - 1).max()),
        min_cos_served_vs_direct=cos_served, min_cos_kernel_vs_plain=cos_plain,
        max_abs_served_vs_direct=float(max(np.abs(served_img - direct_img).max(),
                                           np.abs(served_txt - direct_txt).max())))
    if cos_served < MIN_COSINE or cos_plain < MIN_COSINE:
        raise AssertionError(f"cosine below {MIN_COSINE}: served {cos_served}, plain {cos_plain}")
    return dict(launches=launches, wall=wall, stats=stats)


def phase_train_kernels():
    """Phase 6: the attention backward and the InfoNCE kernels against
    their plain versions at the train step's shapes, timed."""
    from sparsify_clip_tpu_torch.ops.attention import mha_bwd, mha_bwd_reference, mha_fwd
    from sparsify_clip_tpu_torch.ops.infonce import (
        infonce_bwd_dimg, infonce_bwd_dimg_reference, infonce_bwd_dtxt,
        infonce_bwd_dtxt_reference, infonce_fwd, infonce_fwd_reference,
    )

    results = {}
    rng = np.random.default_rng(SEED + 2)
    cases = [
        ("vision", 256, 50, 12, 64, False, torch.bfloat16),
        ("text", 256, 77, 8, 64, True, torch.bfloat16),
        ("vision-fp32", 256, 50, 12, 64, False, torch.float32),
    ]
    for name, b, l, heads, head_dim, causal, dtype in cases:
        width = heads * head_dim
        qkv = torch.from_numpy(rng.standard_normal((b, l, 3 * width), dtype=np.float32)).to(
            "cuda", dtype)
        dout = torch.from_numpy(rng.standard_normal((b, l, width), dtype=np.float32)).to(
            "cuda", dtype)
        _, lse = mha_fwd(qkv, heads, causal, with_lse=True)
        got = mha_bwd(qkv, lse, dout, heads, causal)
        want = mha_bwd_reference(qkv, lse, dout, heads, causal)
        torch.cuda.synchronize()
        rtol, atol = BWD_TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: mha_bwd(qkv, lse, dout, heads, causal), iters=20)
        plain_ms = cuda_ms(lambda: mha_bwd_reference(qkv, lse, dout, heads, causal), iters=20)
        # yardstick: SDPA's backward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_bwd_ms(qkv, dout, heads, causal, iters=20, warmup=5)
        library_ms = sdpa_ms[library]
        item = qkv.element_size()
        bound_ms, bound_by = bound(
            b * l * (3 * width * 2 + width) * item + b * l * heads * 4,  # qkv, dout, lse; dqkv
            5 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S, dP, dV, dQ, dK
            str(dtype).split(".")[1],
        )
        results[f"mha_bwd/{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=library_ms, library=f"sdpa/{library}",
                                          bound_ms=bound_ms, bound_by=bound_by)
        log("phase 6 kernel", kernel="mha_bwd", case=name, shape=list(qkv.shape), heads=heads,
            causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_bwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)

    for n, d in LOSS_SHAPES:
        emb = rng.standard_normal((2, n, d), dtype=np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        img, txt = torch.from_numpy(emb).cuda()
        temp = torch.tensor(0.1, device="cuda")
        g = torch.ones((), device="cuda")
        fwd_args = (img, txt, temp)
        _, row_lse, col_lse = infonce_fwd_reference(*fwd_args)
        bwd_args = (img, txt, temp, row_lse, col_lse, g)
        emb_bytes = 2 * n * d * 4
        checks = [
            # name, kernel, plain, bytes, flops
            ("infonce_fwd", lambda: infonce_fwd(*fwd_args), lambda: infonce_fwd_reference(*fwd_args),
             emb_bytes + 2 * n * 4 + 8, 2 * n * n * d),
            ("infonce_bwd_dimg", lambda: infonce_bwd_dimg(*bwd_args),
             lambda: infonce_bwd_dimg_reference(*bwd_args),
             emb_bytes + 2 * n * 4 + n * d * 4 + 12, 4 * n * n * d),
            ("infonce_bwd_dtxt", lambda: infonce_bwd_dtxt(*bwd_args),
             lambda: infonce_bwd_dtxt_reference(*bwd_args),
             emb_bytes + 2 * n * 4 + n * d * 4 + 8, 4 * n * n * d),
        ]
        for name, kernel, plain, n_bytes, flops in checks:
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = 0.0
            for a, w in zip(got, want):
                if name == "infonce_fwd":
                    torch.testing.assert_close(a, w, rtol=NCE_TOL[0], atol=NCE_TOL[1])
                else:
                    scale = w.abs().max().item()
                    torch.testing.assert_close(a, w, rtol=NCE_GRAD_TOL[0],
                                               atol=NCE_GRAD_TOL[1] * scale)
                err = max(err, (a - w).abs().max().item())
            ms, plain_ms, dev_ms = cuda_ms(kernel), cuda_ms(plain), device_ms(kernel)
            bound_ms, bound_by = bound(n_bytes, flops, "float32")
            results[f"{name}/{n}x{d}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                              device_ms=dev_ms, library_ms=None,
                                              bound_ms=bound_ms, bound_by=bound_by)
            log("phase 6 kernel", kernel=name, n=n, d=d, max_abs_err=err,
                ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    return results


KERNELS = ("mha_fwd", "mha_bwd", "infonce_fwd", "infonce_bwd_dimg", "infonce_bwd_dtxt",
           "lunif_fwd", "lunif_bwd", "mha_fwd_head_group", "mha_bwd_head_group", "ln_qkv_fwd",
           "ln_fast_bwd")


def counters():
    from sparsify_clip_tpu_torch.ops import attention, infonce, ln_qkv, lunif

    return {"mha_fwd": attention.mha_fwd, "mha_bwd": attention.mha_bwd,
            "infonce_fwd": infonce.infonce_fwd, "infonce_bwd_dimg": infonce.infonce_bwd_dimg,
            "infonce_bwd_dtxt": infonce.infonce_bwd_dtxt, "lunif_fwd": lunif.lunif_fwd,
            "lunif_bwd": lunif.lunif_bwd, "mha_fwd_head_group": attention.mha_fwd_head_group,
            "mha_bwd_head_group": attention.mha_bwd_head_group,
            "ln_qkv_fwd": ln_qkv.ln_qkv_fwd, "ln_fast_bwd": ln_qkv.ln_fast_bwd}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def _plain_ln_qkv(x, *args):
    from sparsify_clip_tpu_torch.ops.ln_qkv import ln_qkv_reference

    return ln_qkv_reference(x.reshape(-1, x.shape[-1]), *args).reshape(*x.shape[:-1], -1)


def _plain_paths():
    """Swap the towers' attention core and fused LN+qkv and the loss's
    fused InfoNCE and uniformity for their plain versions (autograd
    differentiates them); returns the function that puts the kernels
    back."""
    from sparsify_clip_tpu_torch.losses import contrastive_loss, dispatch
    from sparsify_clip_tpu_torch.losses.unif import lunif_loss
    from sparsify_clip_tpu_torch.models import layers
    from sparsify_clip_tpu_torch.ops.attention import mha_fwd_reference

    kept = layers.attention_core, layers.ln_qkv_core, dispatch.infonce_loss, dispatch.lunif_loss
    layers.attention_core = lambda qkv, heads, causal=False: mha_fwd_reference(qkv, heads, causal)[0]
    layers.ln_qkv_core = _plain_ln_qkv
    dispatch.infonce_loss, dispatch.lunif_loss = contrastive_loss, lunif_loss

    def restore():
        (layers.attention_core, layers.ln_qkv_core, dispatch.infonce_loss,
         dispatch.lunif_loss) = kept

    return restore


def _set_fused_ln_qkv(model, on: bool) -> None:
    """Switch every block of ``model`` between the fused LN+qkv and the
    unfused ln_1 + in_proj, over the same parameters."""
    from sparsify_clip_tpu_torch.models.layers import ResidualAttentionBlock

    for block in model.modules():
        if isinstance(block, ResidualAttentionBlock):
            block.fused_ln_qkv = on


# tensors whose true gradient is 0: softmax is shift-invariant over the keys,
# so the attention pool's key bias gets rounding noise alone (the CPU
# locksteps leave it out too); logged, not checked for direction
ZERO_GRADIENT = ("visual.attnpool.k_proj.bias",)


def _worst(names, cosines) -> int:
    """The index of the least gradient cosine among the tensors checked."""
    return min((i for i, n in enumerate(names) if n not in ZERO_GRADIENT),
               key=cosines.__getitem__)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    denom = (a.norm() * b.norm()).item()
    return 1.0 if denom == 0 else (a.flatten() @ b.flatten()).item() / denom


def _grad_cosines(params, grads_a) -> list:
    """Each parameter's cosine between ``grads_a`` and its current .grad."""
    return [_cosine(ga, p.grad.detach()) for p, ga in zip(params, grads_a)]


def phase_train():
    """Phase 7: the anchor train step of full-width ViT-B-32 at batch 256."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup, run_training

    config = ExperimentConfig.from_dict(dict(
        model="ViT-B-32", batch_size=TRAIN_BATCH, epochs=1, learning_rate=1e-4,
        loss_type="anchor", anchor_temperature=0.1, anchor_temperature_learnable=True,
        fp16=True, seed=SEED, log_every_n_steps=TRAIN_TIMED,  # metrics read once, at the end
    ))
    t = time.perf_counter()
    setup = create_train_setup(config, steps_per_epoch=TRAIN_STEPS_PER_EPOCH, device="cuda")
    cfg = setup.model.cfg
    batch = batch_to_device(synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                            seed=SEED), setup.device)
    torch.cuda.synchronize()
    state = setup.state
    params = [p for p in state.model.parameters()]
    depth = cfg.vision_layers[0] + cfg.text_layers
    per_step = dict(dict.fromkeys(KERNELS, 0), mha_fwd=depth, mha_bwd=depth, infonce_fwd=1,
                    infonce_bwd_dimg=1, infonce_bwd_dtxt=1)
    log("phase 7 setup", name=cfg.name, params=sum(p.numel() for p in params),
        param_dtype=str(params[0].dtype), compute_dtype=str(setup.model.dtype),
        batch=TRAIN_BATCH, seconds=f"{time.perf_counter() - t:.3f}")

    # one step's gradients on the kernels, then on the plain versions
    reset_counts()
    loss_k = setup.train_step.loss_and_grads(state, batch)[0].detach()
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != per_step:
        raise AssertionError(f"kernel step launched {counts}, expected {per_step}")
    grads_k = [p.grad.detach().clone() for p in params]
    dt_k = state.temperature.grad.detach().clone()
    # the same step with every kernel swapped for its plain version
    restore = _plain_paths()
    try:
        reset_counts()
        loss_p = setup.train_step.loss_and_grads(state, batch)[0].detach()
        torch.cuda.synchronize()
    finally:
        restore()
    if any(read_counts().values()):
        raise AssertionError(f"the plain step launched kernels: {read_counts()}")
    cosines = _grad_cosines(params, grads_k)
    dt_p = state.temperature.grad.detach()
    loss_gap = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    dt_gap = abs(dt_k.item() - dt_p.item()) / abs(dt_p.item())
    names = [n for n, _ in state.model.named_parameters()]
    worst = int(np.argmin(cosines))
    log("phase 7 plain", loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
        loss_rel_gap=loss_gap, rtol=TRAIN_LOSS_RTOL, dT_kernel=dt_k.item(), dT_plain=dt_p.item(),
        dT_rel_gap=dt_gap, dT_rtol=TRAIN_DT_RTOL, min_grad_cosine=cosines[worst],
        min_at=names[worst], tensors=len(cosines))
    if loss_gap > TRAIN_LOSS_RTOL or dt_gap > TRAIN_DT_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
        raise AssertionError("kernel step and plain step disagree")
    state.optimizer.zero_grad(set_to_none=True)
    del grads_k

    # the main path: warm-up steps through train_step, then one epoch of
    # timed steps through run_training (which synchronises at its end)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = setup.train_step(state, batch)
        losses.append(float(metrics["train_loss"]))
    records = []
    t0 = time.perf_counter()
    state = run_training(setup, lambda epoch: iter([batch] * TRAIN_TIMED),
                         log_fn=records.append)
    wall = time.perf_counter() - t0
    launches = read_counts()
    step_records = [r for r in records if "train_loss" in r]
    losses = np.array(losses + [r["train_loss"] for r in step_records])
    steps = TRAIN_WARMUP + len(step_records)
    step_ms = wall / TRAIN_TIMED * 1e3
    peak = torch.cuda.max_memory_allocated()
    log("phase 7 train", steps=steps, losses=json.dumps([float(x) for x in losses]),
        lr_last=step_records[-1]["learning_rate"],
        temperature=step_records[-1]["temperature"],
        launches=json.dumps(launches), step_ms=f"{step_ms:.3f}",
        pairs_per_s=f"{TRAIN_BATCH / (step_ms / 1e3):.1f}",
        max_memory_allocated_gib=f"{peak / 2**30:.3f}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    expected = {k: v * steps for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"{launches} launches in {steps} steps, expected {expected}")
    return dict(launches=launches, step_ms=step_ms, peak=peak)


def phase_lunif_kernels():
    """Phase 8: the uniformity kernels against their plain versions at the
    exp-6 step's shapes, timed."""
    from sparsify_clip_tpu_torch.ops.lunif import (
        lunif_bwd, lunif_bwd_reference, lunif_fwd, lunif_fwd_reference,
    )

    results = {}
    rng = np.random.default_rng(SEED + 3)
    for n, d in LOSS_SHAPES:
        x = rng.standard_normal((n, d), dtype=np.float32)
        x = torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True)).cuda()
        g = torch.ones((), device="cuda")
        s, loss = lunif_fwd(x)
        want_s, want_loss = lunif_fwd_reference(x)
        dx, want_dx = lunif_bwd(x, want_s, g), lunif_bwd_reference(x, want_s, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(s, want_s, rtol=LUNIF_S_RTOL, atol=0)
        torch.testing.assert_close(loss, want_loss, rtol=0, atol=LUNIF_LOSS_ATOL)
        scale = want_dx.abs().max().item()
        torch.testing.assert_close(dx, want_dx, rtol=LUNIF_DX_TOL[0], atol=LUNIF_DX_TOL[1] * scale)
        errors = {"lunif_fwd": max((s - want_s).abs().item(), (loss - want_loss).abs().item()),
                  "lunif_bwd": (dx - want_dx).abs().max().item()}
        # the least work: x·xᵀ is symmetric, so the i<j half of the Gram
        # (N(N−1)/2 dot products) and the N norms; the backward adds the
        # full W·x (N²·D FMAs).  An FMA is two operations.
        half_gram = n * (n - 1) * d + 2 * n * d
        checks = [
            # name, kernel, plain, bytes (x read, outputs written), flops
            ("lunif_fwd", lambda: lunif_fwd(x), lambda: lunif_fwd_reference(x),
             n * d * 4 + 8, half_gram),
            ("lunif_bwd", lambda: lunif_bwd(x, want_s, g),
             lambda: lunif_bwd_reference(x, want_s, g), 2 * n * d * 4 + 8,
             half_gram + 2 * n * n * d),
        ]
        for name, kernel, plain, n_bytes, flops in checks:
            ms, plain_ms, dev_ms = cuda_ms(kernel), cuda_ms(plain), device_ms(kernel)
            bound_ms, bound_by = bound(n_bytes, flops, "float32")
            results[f"{name}/{n}x{d}"] = dict(max_abs_err=errors[name], ms=ms, plain_ms=plain_ms,
                                              device_ms=dev_ms, library_ms=None,
                                              bound_ms=bound_ms, bound_by=bound_by)
            log("phase 8 kernel", kernel=name, n=n, d=d, max_abs_err=errors[name],
                s_rtol=LUNIF_S_RTOL, loss_atol=LUNIF_LOSS_ATOL, dx_tol=json.dumps(LUNIF_DX_TOL),
                ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
    return results


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _scalar_trainables(state) -> dict:
    """The step's trainable scalars: a learnable temperature and SigLIP's
    log-scale and bias."""
    scalars = dict(state.loss_scalars or {})
    if state.temperature.requires_grad:
        scalars["temperature"] = state.temperature
    return scalars


def _scalar_grad_scales(state, batch) -> dict:
    """SigLIP's scalar gradients are sums over the B² pairs whose terms
    cancel (the true pairs against the rest), so each is compared against
    the sum of its terms' magnitudes on this batch: with w = σ(−z·l) the
    weight of a pair's logit l = s·cos + b, Σw/B for the bias and
    Σ w·|s·cos|/B for the log-scale (its gradient's terms are w·s·cos)."""
    from sparsify_clip_tpu_torch.utils.numerics import l2_normalize

    if state.loss_scalars is None:
        return {}
    with torch.no_grad():
        img, txt = state.model(batch["images"], batch["tokens"])
        cos = l2_normalize(img) @ l2_normalize(txt).T
        scale = torch.exp(state.loss_scalars["logit_scale"])
        z = 2 * torch.eye(cos.shape[0], device=cos.device) - 1
        w = torch.sigmoid(-z * (scale * cos + state.loss_scalars["logit_bias"]))
        n = cos.shape[0]
        return {"logit_scale": ((w * (scale * cos).abs()).sum() / n).item(),
                "logit_bias": (w.sum() / n).item()}


def _kernel_grads(train_step, state, batch, expected: dict, what: str) -> dict:
    """One step's loss and gradients on the kernels (the optimizer does
    not step), which must launch exactly ``expected``; the gradients are
    kept as copies, the scalars' as floats."""
    reset_counts()
    loss, aux, _, _ = train_step.loss_and_grads(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected:
        raise AssertionError(f"{what} launched {counts}, expected {expected}")
    return dict(loss=loss, aux=aux,
                grads=[p.grad.detach().clone() for p in state.model.parameters()],
                scalars={n: t.grad.item() for n, t in _scalar_trainables(state).items()},
                scalar_scales=_scalar_grad_scales(state, batch))


def _hold_against_plain(train_step, state, inputs, kernel: dict, names, phase: str, **fields):
    """The same step on the plain versions (no kernel may launch) held
    against :func:`_kernel_grads`'s ``kernel`` readings under phase 9's
    tolerances: the loss and its components, the trainable scalars'
    gradients, each parameter's gradient direction."""
    restore = _plain_paths()
    try:
        reset_counts()
        loss_p, aux_p, _, _ = train_step.loss_and_grads(state, inputs)
        torch.cuda.synchronize()
    finally:
        restore()
    if any(read_counts().values()):
        raise AssertionError(f"{phase}: the plain step launched kernels: {read_counts()}")
    loss_k, aux_k, scalars_k = kernel["loss"], kernel["aux"], kernel["scalars"]
    cosines = _grad_cosines(list(state.model.parameters()), kernel["grads"])
    gaps = {k: _rel_gap(aux_k[k].item(), aux_p[k].item()) for k in aux_k}
    gaps["loss"] = _rel_gap(loss_k.item(), loss_p.item())
    # the scalars' gradients by phase 7's temperature tolerance, each
    # against its own size or, for SigLIP's, the size of its terms
    scales = kernel["scalar_scales"]
    scalar_gaps = {n: abs(g - t.grad.item()) / max(abs(t.grad.item()), scales.get(n, 0.0), 1e-12)
                   for (n, t), g in zip(_scalar_trainables(state).items(), scalars_k.values())}
    worst = _worst(names, cosines)
    unchecked = {n: c for n, c in zip(names, cosines) if n in ZERO_GRADIENT}
    log(phase, **fields, loss_kernel=loss_k.item(), loss_plain=loss_p.item(),
        components_kernel=json.dumps({k: v.item() for k, v in aux_k.items()}),
        rel_gaps=json.dumps(gaps), rtol=TRAIN_LOSS_RTOL, scalar_grads_kernel=json.dumps(
            scalars_k), scalar_grad_term_scales=json.dumps(scales),
        scalar_grad_rel_gaps=json.dumps(scalar_gaps),
        scalar_rtol=TRAIN_DT_RTOL, min_grad_cosine=cosines[worst],
        min_at=names[worst], tensors=len(cosines), unchecked=json.dumps(unchecked),
        lowest_five=json.dumps(sorted(zip(cosines, names))[:5]))
    if (max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE
            or max(scalar_gaps.values(), default=0.0) > TRAIN_DT_RTOL):
        raise AssertionError(f"{phase} {fields}: kernel step and plain step disagree")
    return dict(gaps=gaps, min_grad_cosine=cosines[worst])


def phase_exp6(smi: str, model: str, phases, batch_size: int, check_batch: int,
               steps_per_epoch: int, eval_pairs: int, warm_step: dict, main_step: dict,
               per_eval_batch: dict, overrides: Optional[dict] = None):
    """Phases 9 and 10 (13 and 14, 16 and 17, 21 and 22, 24, 26): the step
    of a full-width model at ``batch_size`` over two epochs of
    ``steps_per_epoch``, under exp 6 (one warm and one main epoch) or the
    config ``overrides`` (SigLIP: two main epochs; ``grad_accum_steps``),
    with the per-epoch eval over ``eval_pairs`` in batches of
    ``batch_size``.  A warm (where the loss has one) and a main step at
    ``check_batch`` are held against the plain versions first, the
    gradients of the trainable scalars (temperature, SigLIP's two) with
    them, and, with ``fused_ln_qkv`` among the ``overrides``, against the
    same step on the unfused blocks.  ``warm_step``, ``main_step`` and
    ``per_eval_batch`` are the launches of each kernel (the rest 0)."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.eval import (
        GEOMETRY_KEYS, compute_all_metrics, encode_eval_set, evaluate_model, make_eval_model,
        metric_values,
    )
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup, run_training

    train_phase, eval_phase = (f"phase {n}" for n in phases)
    spe = steps_per_epoch
    config = ExperimentConfig.from_dict(dict(EXP6, model=model, batch_size=batch_size,
                                             epochs=EXP6_EPOCHS, log_every_n_steps=spe,
                                             **(overrides or {})))
    t = time.perf_counter()
    setup = create_train_setup(config, steps_per_epoch=spe, device="cuda")
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t
    cfg, state = setup.model.cfg, setup.state
    size, context = cfg.image_size, cfg.context_length
    batch = batch_to_device(synthetic_batch(batch_size, size, context, seed=SEED), setup.device)
    check = batch_to_device(synthetic_batch(check_batch, size, context, seed=SEED), setup.device)
    eval_batches = [batch_to_device(synthetic_batch(batch_size, size, context, seed=SEED + 10 + k),
                                    setup.device) for k in range(eval_pairs // batch_size)]
    torch.cuda.synchronize()
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    zero = dict.fromkeys(KERNELS, 0)
    warm_step, main_step = dict(zero, **warm_step), dict(zero, **main_step)
    warm_epochs = config.only_lunif_epochs
    log(f"{train_phase} setup", name=cfg.name, loss_type=config.loss_type,
        only_lunif_epochs=config.only_lunif_epochs, temperature=config.anchor_temperature,
        learnable=config.anchor_temperature_learnable, batch=batch_size, check_batch=check_batch,
        grad_accum_steps=config.grad_accum_steps,
        steps_per_epoch=spe, epochs=config.epochs, fused_ln_qkv=config.fused_ln_qkv,
        params=sum(p.numel() for p in params), seconds=f"{setup_seconds:.3f}")

    # one warm and one main step's gradients on the kernels, then on the
    # plain versions (loss_and_grads neither steps the optimizer nor
    # advances the step count).  Each is a train-mode forward, which moves a
    # ResNet tower's BatchNorm running statistics: they are put back after
    # the checks, so the run below starts from fresh statistics
    running_stats = {n: b.clone() for n, b in setup.model.named_buffers()}
    checks = [("warm", 0, warm_step)] if warm_epochs else []
    for phase, step, expected in checks + [("main", spe, main_step)]:
        state.step = step
        kernel = _kernel_grads(setup.train_step, state, check, expected, f"{phase} kernel step")
        loss_k, aux_k, grads_k = kernel["loss"], kernel["aux"], kernel["grads"]
        if config.fused_ln_qkv:
            # the same step on the unfused blocks: the card's version of the
            # JAX test_block_fused_path_matches_unfused.  The fused path
            # rounds the qkv product and then its bias sum, the unfused one
            # adds the bias inside the product's fp32 epilogue: bf16 apart
            _set_fused_ln_qkv(setup.model, False)
            try:
                reset_counts()
                loss_u, aux_u, _, _ = setup.train_step.loss_and_grads(state, check)
                torch.cuda.synchronize()
            finally:
                _set_fused_ln_qkv(setup.model, True)
            unfused_expected = dict(expected, ln_qkv_fwd=0, ln_fast_bwd=0)
            if read_counts() != unfused_expected:
                raise AssertionError(f"the unfused {phase} step launched {read_counts()}, "
                                     f"expected {unfused_expected}")
            cosines = _grad_cosines(params, grads_k)
            gaps = {k: _rel_gap(aux_k[k].item(), aux_u[k].item()) for k in aux_k}
            gaps["loss"] = _rel_gap(loss_k.item(), loss_u.item())
            worst = _worst(names, cosines)
            log(f"{train_phase} unfused", loss_phase=phase, step=step, batch=check_batch,
                loss_fused=loss_k.item(), loss_unfused=loss_u.item(), rel_gaps=json.dumps(gaps),
                rtol=TRAIN_LOSS_RTOL, min_grad_cosine=cosines[worst], min_at=names[worst],
                min_cosine=TRAIN_MIN_GRAD_COSINE, tensors=len(cosines))
            if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
                raise AssertionError(f"{phase}: fused step and unfused step disagree")
        _hold_against_plain(setup.train_step, state, check, kernel, names,
                            f"{train_phase} plain", loss_phase=phase, step=step,
                            batch=check_batch)
        if phase == "warm" and (aux_k["anchor"].item() != 0 or aux_k["lalign"].item() != 0):
            raise AssertionError(f"the warm step is not uniformity alone: {aux_k}")
        del kernel, grads_k
    state.step = 0
    del check
    state.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        for name, buffer in setup.model.named_buffers():
            buffer.copy_(running_stats[name])

    # the main path: run_training over the warm and the main epoch, with the
    # eval before training and after each epoch.  The counts are set to 0
    # before each segment (training, eval) and read after it.
    eval_model = make_eval_model(setup.model, config.eval_fp32)
    segments, evals, records = [], [], []

    def eval_fn(st):
        segments.append(("train", read_counts()))
        reset_counts()
        t_eval = time.perf_counter()
        metrics = evaluate_model(eval_model, eval_batches)
        evals.append(dict(step=st.step, metrics=metrics, seconds=time.perf_counter() - t_eval))
        segments.append(("eval", read_counts()))
        reset_counts()
        return metrics

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = run_training(setup, lambda epoch: iter([batch] * spe), eval_fn=eval_fn,
                         log_fn=records.append)
    segments.append(("train", read_counts()))
    peak = torch.cuda.max_memory_allocated()
    train_segments = [c for kind, c in segments if kind == "train"]
    eval_segments = [c for kind, c in segments if kind == "eval"]
    kinds = ["warm" if e < warm_epochs else "main" for e in range(EXP6_EPOCHS)]
    expected_train = [zero] + [{k: v * spe for k, v in (warm_step if kind == "warm"
                                                         else main_step).items()}
                               for kind in kinds] + [zero]
    if train_segments != expected_train:
        raise AssertionError(f"training launched {train_segments}, expected {expected_train}")
    per_eval = dict(zero, **{k: v * len(eval_batches) for k, v in per_eval_batch.items()})
    if eval_segments != [per_eval] * (EXP6_EPOCHS + 1):
        raise AssertionError(f"evals launched {eval_segments}, expected {per_eval} each")
    step_records = [r for r in records if "train_loss" in r]
    epoch_records = [r for r in records if "step_time_ms" in r]
    losses = np.array([r["train_loss"] for r in step_records])
    if len(step_records) != EXP6_EPOCHS * spe or not np.isfinite(losses).all():
        raise AssertionError(f"losses not finite: {losses}")
    warm_records = step_records[:spe * warm_epochs]
    main_records = step_records[spe * warm_epochs:]
    if any(r["anchor"] != 0 for r in warm_records) or any(r["anchor"] <= 0 for r in main_records):
        raise AssertionError("the warm/main switch did not follow the epoch")
    # epochs of one kind are told apart by their index
    labels = kinds if len(set(kinds)) == len(kinds) else [f"{k}{e}" for e, k in enumerate(kinds)]
    rates = {label: dict(step_ms=r["step_time_ms"], pairs_per_s=r["pairs_per_sec"])
             for label, r in zip(labels, epoch_records)}
    log(f"{train_phase} train", steps=len(step_records), losses=json.dumps(losses.tolist()),
        components_last=json.dumps({k: main_records[-1][k] for k in ("anchor", "lalign", "lunif")}),
        lr_last=step_records[-1]["learning_rate"],
        launches_by_epoch=json.dumps(dict(zip(labels, train_segments[1:-1]))))
    for label in labels:
        log(f"{train_phase} rate", loss_phase=label, step_ms=f"{rates[label]['step_ms']:.3f}",
            pairs_per_s=f"{rates[label]['pairs_per_s']:.1f}",
            max_memory_allocated_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))

    # phase 10: the 13 metrics of every eval, and the last eval against the
    # same eval on the plain attention at the final weights
    # a rank can flip only on a near-tie: each recall may move by two pairs
    recall_atol = 2 * 100 / eval_pairs
    keys = set(evals[0]["metrics"])
    for e in evals:
        if len(keys) != 13 or set(e["metrics"]) != keys or not np.isfinite(
                list(e["metrics"].values())).all():
            raise AssertionError(f"eval at step {e['step']}: {e['metrics']}")
    img_k, txt_k = encode_eval_set(eval_model, eval_batches)
    restore = _plain_paths()
    try:
        reset_counts()
        img_p, txt_p = encode_eval_set(eval_model, eval_batches)
        torch.cuda.synchronize()
    finally:
        restore()
    if any(read_counts().values()):
        raise AssertionError(f"the plain eval launched kernels: {read_counts()}")
    cos = min(torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
              for a, b in ((img_k, img_p), (txt_k, txt_p)))
    values_k, values_p = metric_values(img_k, txt_k), metric_values(img_p, txt_p)
    rounded_k, rounded_p = compute_all_metrics(img_k, txt_k), compute_all_metrics(img_p, txt_p)
    geometry_gap = max(abs(values_k[k].item() - values_p[k].item()) for k in GEOMETRY_KEYS)
    recall_gap = max(abs(rounded_k[k] - rounded_p[k]) for k in keys if k not in GEOMETRY_KEYS)
    ranks_moved = sum(int((values_k[k] != values_p[k]).sum()) for k in ("rank_f", "rank_b"))
    log(f"{eval_phase} eval", evals=len(evals), pairs=eval_pairs,
        metrics_first=json.dumps(evals[0]["metrics"]), metrics_last=json.dumps(evals[-1]["metrics"]),
        eval_seconds=json.dumps([round(e["seconds"], 3) for e in evals]),
        launches_each=json.dumps(eval_segments[0]), min_cos_kernel_vs_plain=cos,
        geometry_max_abs_gap=geometry_gap, geometry_atol=EVAL_GEOMETRY_ATOL,
        recall_max_abs_gap=recall_gap, recall_atol=f"{recall_atol:.4f}",
        ranks_moved=ranks_moved, card=json.dumps(smi))
    if cos < EVAL_MIN_COSINE or geometry_gap > EVAL_GEOMETRY_ATOL or recall_gap > recall_atol:
        raise AssertionError("kernel eval and plain-attention eval disagree")
    return dict(train=train_segments[1:-1], eval=eval_segments, rates=rates, peak=peak,
                eval_seconds=[e["seconds"] for e in evals], records=step_records)


def phase_gradcache_equality(smi: str):
    """Phase 25: full-width ViT-B-32 under exp 6 at batch 256 with
    ``grad_accum_steps`` 4 against the one-shot step (1), from the same
    seed on the same batch: a warm and a main step's loss and gradient
    directions, each step's launches, and the peak memory of a step of
    each (the accumulated one holds a microbatch's activations)."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup

    spe = EXP6_STEPS_PER_EPOCH
    setups = {}
    for accum in (1, GRADCACHE_STEPS):
        config = ExperimentConfig.from_dict(dict(EXP6, epochs=EXP6_EPOCHS,
                                                 grad_accum_steps=accum))
        setups[accum] = create_train_setup(config, steps_per_epoch=spe, device="cuda")
    one, acc = setups[1], setups[GRADCACHE_STEPS]
    cfg = one.model.cfg
    batch = batch_to_device(synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                            seed=SEED), one.device)
    names = [n for n, _ in one.model.named_parameters()]
    for p, q in zip(one.model.parameters(), acc.model.parameters()):
        if not torch.equal(p, q):
            raise AssertionError("the two setups do not start from the same weights")
    zero = dict.fromkeys(KERNELS, 0)
    depth = cfg.vision_layers[0] + cfg.text_layers
    attention = dict(mha_fwd=depth, mha_bwd=depth)
    # pass 1 and pass 2 each run the encoders' forward over every microbatch
    accumulated = dict(mha_fwd=2 * GRADCACHE_STEPS * depth, mha_bwd=GRADCACHE_STEPS * depth)
    warm_loss = dict(lunif_fwd=2, lunif_bwd=2)
    main_loss = dict(infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1, lunif_fwd=1,
                     lunif_bwd=1)
    expected = {("warm", 1): dict(zero, **attention, **warm_loss),
                ("main", 1): dict(zero, **attention, **main_loss),
                ("warm", GRADCACHE_STEPS): dict(zero, **accumulated, **warm_loss),
                ("main", GRADCACHE_STEPS): dict(zero, **accumulated, **main_loss)}
    peaks = {}
    for phase, step in (("warm", 0), ("main", spe)):
        out, grads = {}, {}
        for accum, setup in setups.items():
            setup.state.step = step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            loss, aux, _, _ = setup.train_step.loss_and_grads(setup.state, batch)
            torch.cuda.synchronize()
            peaks[phase, accum] = torch.cuda.max_memory_allocated()
            _expect_launches(read_counts(), expected[phase, accum],
                             f"the {phase} step at grad_accum_steps {accum}")
            out[accum] = loss.item(), {k: v.item() for k, v in aux.items()}
            # held in host memory, so the other setup's peak does not carry them
            grads[accum] = [p.grad.detach().cpu() for p in setup.model.parameters()]
            setup.state.optimizer.zero_grad(set_to_none=True)
        cosines = [_cosine(a, b) for a, b in zip(grads[GRADCACHE_STEPS], grads[1])]
        gaps = {k: _rel_gap(out[GRADCACHE_STEPS][1][k], out[1][1][k]) for k in out[1][1]}
        gaps["loss"] = _rel_gap(out[GRADCACHE_STEPS][0], out[1][0])
        worst = _worst(names, cosines)
        log("phase 25 gradcache", loss_phase=phase, step=step, batch=TRAIN_BATCH,
            grad_accum_steps=GRADCACHE_STEPS, loss_one_shot=out[1][0],
            loss_accumulated=out[GRADCACHE_STEPS][0], rel_gaps=json.dumps(gaps),
            rtol=TRAIN_LOSS_RTOL, min_grad_cosine=cosines[worst], min_at=names[worst],
            min_cosine=TRAIN_MIN_GRAD_COSINE, tensors=len(cosines),
            launches_accumulated=json.dumps(expected[phase, GRADCACHE_STEPS]),
            peak_gib_one_shot=f"{peaks[phase, 1] / 2**30:.3f}",
            peak_gib_accumulated=f"{peaks[phase, GRADCACHE_STEPS] / 2**30:.3f}")
        if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
            raise AssertionError(f"{phase}: the accumulated step and the one-shot step disagree")
        if peaks[phase, GRADCACHE_STEPS] >= peaks[phase, 1]:
            raise AssertionError(f"{phase}: the accumulated step's peak {peaks[phase, GRADCACHE_STEPS]}"
                                 f" is not below the one-shot step's {peaks[phase, 1]}")
    # the main path: two main steps of each through train_step, the second timed
    launches, rates = {}, {}
    for accum, setup in setups.items():
        setup.state.step = spe
        reset_counts()
        for k in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            setup.state, metrics = setup.train_step(setup.state, batch)
            float(metrics["train_loss"])
            rates[accum] = (time.perf_counter() - t) * 1e3
        launches[accum] = read_counts()
        _expect_launches(launches[accum], {k: 2 * v for k, v in expected["main", accum].items()},
                         f"two main steps at grad_accum_steps {accum}")
    log("phase 25 rate", step_ms_one_shot=f"{rates[1]:.3f}",
        step_ms_accumulated=f"{rates[GRADCACHE_STEPS]:.3f}",
        pairs_per_s_one_shot=f"{TRAIN_BATCH / rates[1] * 1e3:.1f}",
        pairs_per_s_accumulated=f"{TRAIN_BATCH / rates[GRADCACHE_STEPS] * 1e3:.1f}",
        card=json.dumps(smi))
    return dict(launches=launches[GRADCACHE_STEPS], peaks=peaks)


def phase_head_group_kernels(smi: str):
    """Phase 11: the route at the ViT-L-14-336 shapes, and the head-group
    kernels against their plain versions at the vision tower's shapes,
    timed beside SDPA and their bound."""
    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd_head_group, mha_bwd_head_group_reference, mha_fwd_head_group,
        mha_fwd_head_group_reference, use_head_group,
    )

    routes = {"vision_bf16": use_head_group(577, 3072, 2, 16),
              "vision_fp32": use_head_group(577, 3072, 4, 16),
              "text_bf16": use_head_group(77, 2304, 2, 12)}
    log("phase 11 route", head_group=json.dumps(routes))
    if routes != {"vision_bf16": True, "vision_fp32": True, "text_bf16": False}:
        raise AssertionError(f"ViT-L-14-336 routes {routes}")

    results = {}
    rng = np.random.default_rng(SEED + 4)
    l, heads, head_dim = 577, 16, 64
    width = heads * head_dim

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    # fp32 at batch 32 (the shape timed before, kept comparable) and at the eval's 64
    for name, b, causal, dtype in [("vision", 64, False, torch.bfloat16),
                                   ("vision-causal", 64, True, torch.bfloat16),
                                   ("vision-fp32", 32, False, torch.float32),
                                   ("vision-fp32-b64", L336_BATCH, False, torch.float32)]:
        dname = str(dtype).split(".")[1]
        qkv = normal((b, l, 3 * width), dtype)
        got = mha_fwd_head_group(qkv, heads, causal)
        want = mha_fwd_head_group_reference(qkv, heads, causal)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL[dname]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: mha_fwd_head_group(qkv, heads, causal), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: mha_fwd_head_group_reference(qkv, heads, causal), iters=5,
                           warmup=1)
        # yardstick: SDPA's forward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_fwd_ms(qkv, heads, causal, iters=20, warmup=2)
        library_ms = sdpa_ms[library]
        bound_ms, bound_by = bound(
            b * l * 4 * width * qkv.element_size(),  # qkv read, context written
            2 * 2 * b * heads * attention_pairs(l, causal) * head_dim,  # S and P.V
            dname,
        )
        results[f"mha_fwd_head_group/{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 11 kernel", kernel="mha_fwd_head_group", case=name, shape=list(qkv.shape),
            heads=heads, causal=causal, dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library=f"sdpa/{library}", sdpa_fwd_ms=json.dumps(sdpa_ms),
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, card=json.dumps(smi))
        del qkv

    for name, b, dtype in [("vision", 64, torch.bfloat16), ("vision-fp32", 8, torch.float32)]:
        dname = str(dtype).split(".")[1]
        qkv, dout = normal((b, l, 3 * width), dtype), normal((b, l, width), dtype)
        got = mha_bwd_head_group(qkv, dout, heads)
        want = mha_bwd_head_group_reference(qkv, dout, heads)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            rtol, atol = BWD_TOL[dname]
        else:
            rtol, atol = HG_BWD_FP32_TOL[0], HG_BWD_FP32_TOL[1] * want.abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: mha_bwd_head_group(qkv, dout, heads), iters=5, warmup=1)
        plain_ms = cuda_ms(lambda: mha_bwd_head_group_reference(qkv, dout, heads), iters=3,
                           warmup=1)
        # yardstick: SDPA's backward, the fastest backend that takes the shape
        sdpa_ms, library = sdpa_bwd_ms(qkv, dout, heads, False, iters=10, warmup=2)
        library_ms = sdpa_ms[library]
        bound_ms, bound_by = bound(
            b * l * (3 * width * 2 + width) * qkv.element_size(),  # qkv, dout; dqkv
            5 * 2 * b * heads * attention_pairs(l, False) * head_dim,  # S, dP, dV, dQ, dK
            dname,
        )
        results[f"mha_bwd_head_group/{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library=f"sdpa/{library}", bound_ms=bound_ms, bound_by=bound_by)
        log("phase 11 kernel", kernel="mha_bwd_head_group", case=name, shape=list(qkv.shape),
            heads=heads, causal=False, dtype=str(dtype), max_abs_err=err, rtol=rtol,
            atol=f"{atol:.3g}", ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{library_ms:.5f}", library=f"sdpa/{library}",
            sdpa_bwd_ms=json.dumps(sdpa_ms), bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
            card=json.dumps(smi))
        del qkv, dout
    return results


def phase_ln_qkv_kernels(smi: str):
    """Phase 15: the fused LN+qkv kernel and the backward's LayerNorm
    kernel against their plain versions at the ViT-L-14-336 batch-64
    shapes, timed beside their library yardsticks and their bound."""
    from sparsify_clip_tpu_torch.ops.ln_qkv import (
        ln_fast_bwd, ln_fast_bwd_reference, ln_qkv_fwd, ln_qkv_reference, row_stats_reference,
    )

    F = torch.nn.functional
    eps = 1e-5
    results = {}
    rng = np.random.default_rng(SEED + 5)

    def normal(shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).cuda()

    for name, n, w, dtype in [("vision", 64 * 577, 1024, torch.bfloat16),
                              ("text", 64 * 77, 768, torch.bfloat16),
                              ("vision-fp32", 64 * 577, 1024, torch.float32),
                              ("wide-ragged", 1000, 1664, torch.bfloat16)]:
        dname = str(dtype).split(".")[1]
        # a training model's operands: x in the compute type, fp32 parameters
        x = normal((n, w)).to(dtype)
        scale, bias = 1 + normal((w,), 0.1), normal((w,), 0.1)
        weight, kbias = normal((3 * w, w), w ** -0.5), normal((3 * w,), 0.1)
        args = (x, scale, bias, weight, kbias, eps, dtype)
        got, want = ln_qkv_fwd(*args), ln_qkv_reference(*args)
        torch.cuda.synchronize()
        # KERNEL_TOL: bf16 rounds the product and then the bias sum, each
        # at most one step apart; fp32 sums W terms in another order
        rtol, atol = KERNEL_TOL[dname]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, ln_qkv_fwd(*args)):
            raise AssertionError(f"ln_qkv_fwd/{name}: two runs differ")
        del got, want
        slow = dtype == torch.float32
        ms = cuda_ms(lambda: ln_qkv_fwd(*args), iters=5 if slow else 20, warmup=2)
        plain_ms = cuda_ms(lambda: ln_qkv_reference(*args), iters=5 if slow else 20, warmup=2)
        # yardstick: the unfused pair, two library calls, on operands cast
        # to the compute type beforehand
        sc, bi, wt, kb = (t.to(dtype) for t in (scale, bias, weight, kbias))
        library_ms = cuda_ms(lambda: F.linear(F.layer_norm(x, (w,), sc, bi, eps), wt, kb),
                             iters=5 if slow else 20, warmup=2)
        item = x.element_size()
        bound_ms, bound_by = bound(
            (n * w + 3 * w * w + 3 * w + n * 3 * w) * item + 2 * w * 4,  # x, W, b; out; LN fp32
            2 * n * w * 3 * w,
            dname,
        )
        results[f"ln_qkv_fwd/{name}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             library_ms=library_ms, bound_ms=bound_ms,
                                             bound_by=bound_by,
                                             library="F.linear(F.layer_norm(x)), two calls")
        log("phase 15 kernel", kernel="ln_qkv_fwd", case=name, shape=[n, w, 3 * w],
            dtype=str(dtype), max_abs_err=err, rtol=rtol, atol=atol, ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
            library="F.linear(F.layer_norm(x)), two calls", bound_ms=f"{bound_ms:.5f}",
            bound_by=bound_by, card=json.dumps(smi))
        del x, args, weight, wt

    # the backward's LayerNorm: from x and dy = g.W, y again, dx, dscale, dbias
    for name, n, w, dtype in [("vision", 64 * 577, 1024, torch.bfloat16),
                              ("text", 64 * 77, 768, torch.bfloat16),
                              ("vision-fp32", 64 * 577, 1024, torch.float32)]:
        dname = str(dtype).split(".")[1]
        x, dy = normal((n, w)).to(dtype), normal((n, w)).to(dtype)
        scale, bias = 1 + normal((w,), 0.1), normal((w,), 0.1)
        args = (x, dy, scale, bias, eps, dtype)
        got, want = ln_fast_bwd(*args), ln_fast_bwd_reference(*args)
        torch.cuda.synchronize()
        errs = {}
        for part, a, b in zip(("y", "dx", "dscale", "dbias"), got, want):
            big = b.float().abs().max().item()
            if part in ("y", "dx"):
                tol = dict(rtol=LN_BWD_STEP[dname], atol=LN_BWD_CANCEL * big)
            else:
                tol = dict(rtol=LN_BWD_GRAD_TOL[0], atol=LN_BWD_GRAD_TOL[1] * big)
            torch.testing.assert_close(a.float(), b.float(), msg=f"ln_fast_bwd/{name} {part}",
                                       **tol)
            errs[part] = (a.float() - b.float()).abs().max().item()
        if not all(torch.equal(a, b) for a, b in zip(got, ln_fast_bwd(*args))):
            raise AssertionError(f"ln_fast_bwd/{name}: two runs differ")
        del got, want
        ms = cuda_ms(lambda: ln_fast_bwd(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: ln_fast_bwd_reference(*args), iters=5, warmup=2)
        # yardstick: LayerNorm's backward fed the fast-variance statistics,
        # and y's recompute, two library calls on operands in the compute type
        sc, bi = scale.to(dtype), bias.to(dtype)
        _, m0, _ = torch.native_layer_norm(x, [w], sc, bi, eps)  # the statistics' type and shape
        stats = row_stats_reference(x, eps).to(m0.dtype)
        mean, rstd = stats[:, :1].reshape(m0.shape), stats[:, 1:].reshape(m0.shape)
        del m0

        def library():
            torch.ops.aten.native_layer_norm_backward(dy, x, [w], mean, rstd, sc, bi,
                                                      [True, True, True])
            F.layer_norm(x, (w,), sc, bi, eps)

        library_ms = cuda_ms(library, iters=20, warmup=2)
        item = x.element_size()
        bound_ms, bound_by = bound(
            4 * n * w * item + 4 * w * 4,  # x, dy read; y, dx written; scale, bias; dscale, dbias
            14 * n * w,  # x̂, y, dŷ, dx and the four sums, a few operations an element
            dname,
        )
        results[f"ln_fast_bwd/{name}"] = dict(
            max_abs_err=errs["dx"], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            library="native_layer_norm_backward + F.layer_norm, two calls")
        log("phase 15 kernel", kernel="ln_fast_bwd", case=name, shape=[n, w], dtype=str(dtype),
            max_abs_err=json.dumps(errs), ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{library_ms:.5f}",
            library="native_layer_norm_backward + F.layer_norm, two calls",
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, card=json.dumps(smi))
        del x, dy, args, stats, mean, rstd
    return results


def _jsonl(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _check_evals(records: list, expected: int, what: str) -> list:
    """The 13-metric eval records: ``expected`` of them, all finite."""
    evals = [r for r in records if "forward_r1" in r]
    metric_keys = [sorted(k for k in r if not k.startswith("_")) for r in evals]
    if len(evals) != expected or any(len(k) != 13 for k in metric_keys) or not all(
            np.isfinite([r[k] for k in keys]).all() for r, keys in zip(evals, metric_keys)):
        raise AssertionError(f"{what}: expected {expected} finite 13-metric evals, got {evals}")
    return evals


class _PerStepCounts:
    """Record the kernel launches of every train step and every eval the
    CLI runs in this process (deltas of the wrappers' counts; the counts
    themselves keep running).  With ``timed``, also each step's ms and
    each eval's seconds on the host clock between two synchronizations;
    ``after_step(state, batch, metrics)`` runs after each step's counts
    are read."""

    def __init__(self, timed: bool = False, after_step=None):
        from sparsify_clip_tpu_torch import eval as port_eval
        from sparsify_clip_tpu_torch.train import TrainStep

        # the last step's state and TrainStep
        self.steps, self.evals, self.state, self.train_step = [], [], None, None
        self.step_ms, self.eval_seconds = [], []
        step_call, evaluate = TrainStep.__call__, port_eval.evaluate_model

        def fence():
            if timed:
                torch.cuda.synchronize()
            return time.perf_counter()

        def counted_step(step_self, state, batch):
            before, at, t = read_counts(), state.step, fence()
            out = step_call(step_self, state, batch)
            self.step_ms.append((fence() - t) * 1e3)
            self.steps.append((at, _delta(before, read_counts())))
            self.state, self.train_step = state, step_self
            if after_step is not None:
                after_step(state, batch, out[1])
            return out

        def counted_eval(*args, **kwargs):
            before, t = read_counts(), fence()
            out = evaluate(*args, **kwargs)
            self.eval_seconds.append(fence() - t)
            self.evals.append(_delta(before, read_counts()))
            return out

        TrainStep.__call__, port_eval.evaluate_model = counted_step, counted_eval
        self._restore = lambda: (setattr(TrainStep, "__call__", step_call),
                                 setattr(port_eval, "evaluate_model", evaluate))

    def close(self):
        self._restore()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _expect_launches(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")


def _run_cli(argv, cwd: Optional[str] = None):
    """The port's CLI in this process (cwd changed for the run)."""
    import os

    from sparsify_clip_tpu_torch import cli

    here = os.getcwd()
    try:
        if cwd is not None:
            os.chdir(cwd)
        cli.cli(argv)
    finally:
        os.chdir(here)


def phase_cli_smoke(smi: str):
    """Phase 18: ``sparsify_clip_tpu_torch.cli`` on configs/smoke_tiny.yaml
    with ``--smoke`` in a temporary directory."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY

    config_path = os.path.join(REPO, "configs", "smoke_tiny.yaml")
    cfg = MODEL_REGISTRY["tiny-test"]
    depth = cfg.vision_layers[0] + cfg.text_layers
    with tempfile.TemporaryDirectory() as tmp:
        counter = _PerStepCounts()
        t = time.perf_counter()
        try:
            reset_counts()
            _run_cli(["--config", config_path, "--smoke"], cwd=tmp)
            launches = read_counts()
        finally:
            counter.close()
        seconds = time.perf_counter() - t
        records = _jsonl(os.path.join(tmp, "logs", "smoke-tiny", "smoke-tiny-smoke.jsonl"))
        files = sorted(os.listdir(os.path.join(tmp, "models", "smoke-tiny")))
        full = sorted(os.listdir(os.path.join(tmp, "models", "smoke-tiny", "smoke-tiny-smoke")))
    kinds = [r.get("event") or ("train" if "train_loss" in r else "eval" if "forward_r1" in r
                                else "rate" if "step_time_ms" in r else next(
                                    k for k in r if not k.startswith("_"))) for r in records]
    expected_kinds = ["run_start", "eval", "train", "train", "rate", "eval", "train_time_s",
                      "eval", "artifact", "run_end"]
    if kinds != expected_kinds:
        raise AssertionError(f"smoke_tiny records {kinds}, expected {expected_kinds}")
    evals = _check_evals(records, 3, "smoke_tiny")
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    if not np.isfinite(losses).all():
        raise AssertionError(f"smoke_tiny losses {losses}")
    if files != ["smoke-tiny-smoke", "smoke-tiny-smoke.npz", "smoke-tiny-smoke_epoch_1.npz"] \
            or full != ["step_2.pt"]:
        raise AssertionError(f"smoke_tiny files {files} {full}")
    zero = dict.fromkeys(KERNELS, 0)
    per_step = dict(zero, mha_fwd=depth, mha_bwd=depth, infonce_fwd=1, infonce_bwd_dimg=1,
                    infonce_bwd_dtxt=1)
    per_eval = dict(zero, mha_fwd=depth)  # one batch of 64 an eval
    _expect_launches([c for _, c in counter.steps], [per_step] * 2, "smoke_tiny's steps")
    _expect_launches(counter.evals, [per_eval] * 3, "smoke_tiny's evals")
    _expect_launches(launches, {k: 2 * per_step[k] + 3 * per_eval[k] for k in KERNELS},
                     "smoke_tiny")
    log("phase 18 cli", ok=True, config="configs/smoke_tiny.yaml --smoke", records=len(records),
        kinds=json.dumps(kinds), losses=json.dumps(losses),
        eval_last=json.dumps(evals[-1]), launches=json.dumps(launches),
        seconds=f"{seconds:.3f}", card=json.dumps(smi))
    return dict(launches=launches)


def _write_exp6_yaml(directory: str, **fields) -> str:
    import os

    config = dict(EXP6, run_name="exp6-vitb32", project_name="chip_smoke",
                  num_train_samples=CLI_TRAIN_SAMPLES, num_test_samples=CLI_EVAL_PAIRS,
                  epochs=EXP6_EPOCHS, save_checkpoint_every_n_epochs=EXP6_EPOCHS,
                  dataset="synthetic",
                  log_backend="jsonl", plot_embeddings=False,
                  log_dir=os.path.join(directory, "logs"),
                  checkpoint_dir=os.path.join(directory, "models"))
    config.update(fields)
    path = os.path.join(directory, "exp6.yaml")
    with open(path, "w") as fh:  # flat key: value lines, as configs/*.yaml
        for key, value in config.items():
            fh.write(f"{key}: {json.dumps(value)}\n")
    return path


def _time_loader(loader):
    """The first ``CLI_LOADER_BATCHES`` batches of ``loader``'s epoch 0
    alone → (the batches, ms a batch)."""
    import itertools

    t = time.perf_counter()
    epoch = loader.epoch(0)
    batches = list(itertools.islice(epoch, CLI_LOADER_BATCHES))
    ms = (time.perf_counter() - t) / len(batches) * 1e3
    epoch.close()
    return batches, ms


def _npz_digest(arrays) -> str:
    """A sha256 of an npz's keys and array bytes (equal only for equal
    files' contents)."""
    import hashlib

    h = hashlib.sha256()
    for key in sorted(arrays.keys() if hasattr(arrays, "keys") else arrays.files):
        h.update(key.encode())
        h.update(np.ascontiguousarray(arrays[key]).tobytes())
    return h.hexdigest()


def _profile_cli_steps(config, steps: int, tracer=None):
    """The card's own account of the CLI's train loop: ``run_training``
    fed by the CLI's loader (threads, host transforms, tokenizer, the
    host→device copy) over ``steps`` steps under ``torch.profiler`` →
    kernel-busy ms, host→device copy ms and window ms a step.  ``tracer``
    (a context manager yielding the profiler, as
    ``utils.profiling.trace``) replaces the plain profiler; the profile
    then comes back too, under ``prof``."""
    import dataclasses
    import itertools

    from torch.profiler import ProfilerActivity, profile

    from sparsify_clip_tpu_torch.data import dataset_loader
    from sparsify_clip_tpu_torch.train import create_train_setup, run_training

    config = dataclasses.replace(config, epochs=1)
    train_loader, _ = dataset_loader(config, image_size=224)
    setup = create_train_setup(config, steps_per_epoch=len(train_loader), device="cuda")
    setup.state.step = len(train_loader) * config.only_lunif_epochs  # a main-phase step
    warm = list(itertools.islice(train_loader.epoch(1), 2))
    run_training(setup, lambda epoch: iter(warm), log_fn=lambda m: None)  # cuBLAS, allocator
    torch.cuda.synchronize()
    with (tracer() if tracer is not None else
          profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])) as prof:
        t = time.perf_counter()
        run_training(setup, lambda epoch: itertools.islice(train_loader.epoch(2), steps),
                     log_fn=lambda m: None)
        wall = time.perf_counter() - t
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.name.startswith("Optimizer.")
              and not getattr(e, "is_user_annotation", False)]
    copies = [e for e in events if "Memcpy HtoD" in e.name]
    kernels = [e for e in events if "Memcpy" not in e.name and "Memset" not in e.name]

    def union_us(evs):
        spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
        if not spans:
            return 0.0
        busy, (cur_s, cur_e) = 0.0, spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return busy + cur_e - cur_s

    out = dict(kernel_ms=union_us(kernels) / 1e3 / steps, copy_ms=union_us(copies) / 1e3 / steps,
               busy_ms=union_us(kernels + copies) / 1e3 / steps, wall_ms=wall * 1e3 / steps,
               copies=len(copies) / steps)
    if tracer is not None:
        out["prof"] = prof
    return out


def phase_cli_exp6(smi: str, device_resident: dict):
    """Phase 19: the CLI on a YAML of full-width ViT-B-32 under exp 6 at
    batch 256, and where the time of the CLI step goes (phase 40 sends
    SIGTERM and resumes under the launcher)."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.data import dataset_loader
    from sparsify_clip_tpu_torch.train import batch_to_device

    spe = CLI_EXP6_SAMPLES // EXP6["batch_size"]
    run = "exp6-vitb32"
    with tempfile.TemporaryDirectory() as tmp:
        main_dir = os.path.join(tmp, "main")
        os.makedirs(main_dir)
        yaml_path = _write_exp6_yaml(main_dir, num_train_samples=CLI_EXP6_SAMPLES)
        config = load_config(yaml_path)

        # the loader alone: decode, crop, resize, flip, normalize and
        # tokenize 256 pairs at 224 px, four threads, as the CLI builds it
        train_loader, _ = dataset_loader(config, image_size=224)
        batches, loader_ms = _time_loader(train_loader)
        one = batches[0]
        copy_ms = cuda_ms(lambda: batch_to_device(one, torch.device("cuda")), iters=10, warmup=2)
        del batches

        # the uninterrupted run, in this process
        counter = _PerStepCounts()
        t = time.perf_counter()
        try:
            reset_counts()
            _run_cli(["--config", yaml_path])
            launches = read_counts()
        finally:
            counter.close()
        cli_seconds = time.perf_counter() - t
        records = _jsonl(os.path.join(main_dir, "logs", f"{run}.jsonl"))
        step_records = [r for r in records if "train_loss" in r]
        if len(step_records) != EXP6_EPOCHS * spe or not np.isfinite(
                [r["train_loss"] for r in step_records]).all():
            raise AssertionError(f"expected {EXP6_EPOCHS * spe} finite train records, "
                                 f"got {step_records}")
        evals = _check_evals(records, EXP6_EPOCHS + 2, "exp 6")  # before, each epoch, final
        models = os.path.join(main_dir, "models")
        # saved after the last epoch only (save_checkpoint_every_n_epochs)
        want_files = sorted([run, f"{run}.npz", f"{run}_epoch_{EXP6_EPOCHS}.npz"])
        full_steps = sorted(os.listdir(os.path.join(models, run)))
        if sorted(os.listdir(models)) != want_files or full_steps != [
                f"step_{spe * EXP6_EPOCHS}.pt"]:
            raise AssertionError(f"files {sorted(os.listdir(models))} {full_steps}")
        zero = dict.fromkeys(KERNELS, 0)
        warm = dict(zero, mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2)
        main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                    infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
        want_steps = [(k, warm if k < spe else main) for k in range(EXP6_EPOCHS * spe)]
        per_eval = dict(zero, mha_fwd=24 * (CLI_EVAL_PAIRS // EXP6["batch_size"]))
        _expect_launches(counter.steps, want_steps, "the exp-6 CLI's steps")
        _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), "the exp-6 CLI's evals")
        total = {k: spe * (warm[k] + main[k]) + (EXP6_EPOCHS + 2) * per_eval[k] for k in KERNELS}
        _expect_launches(launches, total, "the exp-6 CLI")
        rates = [r for r in records if "step_time_ms" in r]
        log("phase 19 cli", ok=True, model=config.model, loss_type=config.loss_type,
            batch=config.batch_size, steps=len(step_records), evals=len(evals),
            losses=json.dumps([r["train_loss"] for r in step_records]),
            eval_first=json.dumps(evals[0]), eval_last=json.dumps(evals[-1]),
            files=json.dumps(want_files), full_state=json.dumps(full_steps),
            launches_warm_step=json.dumps(warm), launches_main_step=json.dumps(main),
            launches=json.dumps(launches), seconds=f"{cli_seconds:.3f}")

        # where the time of the CLI step goes, from the card's own readings
        prof = _profile_cli_steps(config, CLI_PROFILE_STEPS)
        main_rate = rates[-1]
        idle = 1 - prof["busy_ms"] / main_rate["step_time_ms"]
        log("phase 19 rate", loader_ms_per_batch=f"{loader_ms:.3f}",
            host_to_device_ms=f"{copy_ms:.3f}",
            cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
            cli_pairs_per_s=json.dumps([round(r["pairs_per_sec"], 1) for r in rates]),
            device_resident_step_ms=json.dumps({k: round(v["step_ms"], 3)
                                                for k, v in device_resident.items()}),
            profiled_kernel_ms=f"{prof['kernel_ms']:.3f}",
            profiled_copy_ms=f"{prof['copy_ms']:.3f}", profiled_busy_ms=f"{prof['busy_ms']:.3f}",
            profiled_wall_ms=f"{prof['wall_ms']:.3f}", copies_per_step=prof["copies"],
            idle_share_profiled=f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}",
            idle_share_vs_cli_step=f"{idle:.4f}", card=json.dumps(smi))

        with np.load(os.path.join(models, f"{run}.npz")) as a:
            full = {k: a[k] for k in a.files}
    return dict(launches=launches, loader_ms=loader_ms, copy_ms=copy_ms, rates=rates,
                profile=prof, losses=[r["train_loss"] for r in step_records],
                npz_digest=_npz_digest(full))


def phase_cli_rn50(smi: str):
    """Phase 23: the CLI on a YAML of full-width RN50 under exp 6 at batch
    256: one warm and one main epoch of ``RN50_CLI_STEPS`` steps on
    synthetic pairs, ``RN50_CLI_EVAL_PAIRS`` eval pairs, a checkpoint each
    epoch.  The final npz holds the JAX RN50 parameter keys and no
    statistics; the newest full state holds the model's running statistics."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.checkpoints import jax_paths
    from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY

    run, batch = "exp6-rn50", EXP6["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path = _write_exp6_yaml(tmp, model="RN50", run_name=run,
                                     num_train_samples=RN50_CLI_STEPS * batch,
                                     num_test_samples=RN50_CLI_EVAL_PAIRS)
        counter = _PerStepCounts()
        t = time.perf_counter()
        try:
            reset_counts()
            _run_cli(["--config", yaml_path])
            launches = read_counts()
        finally:
            counter.close()
        seconds = time.perf_counter() - t
        model, counter.state = counter.state.model, None
        records = _jsonl(os.path.join(tmp, "logs", f"{run}.jsonl"))
        step_records = [r for r in records if "train_loss" in r]
        if len(step_records) != EXP6_EPOCHS * RN50_CLI_STEPS or not np.isfinite(
                [r["train_loss"] for r in step_records]).all():
            raise AssertionError(f"RN50 CLI train records {step_records}")
        evals = _check_evals(records, EXP6_EPOCHS + 2, "RN50 exp 6")
        models = os.path.join(tmp, "models")
        # saved after the last epoch only (save_checkpoint_every_n_epochs)
        want_files = sorted([run, f"{run}.npz", f"{run}_epoch_{EXP6_EPOCHS}.npz"])
        full_steps = sorted(os.listdir(os.path.join(models, run)))
        want_steps = [f"step_{RN50_CLI_STEPS * EXP6_EPOCHS}.pt"]
        if sorted(os.listdir(models)) != want_files or full_steps != want_steps:
            raise AssertionError(f"RN50 files {sorted(os.listdir(models))} {full_steps}")
        with np.load(os.path.join(models, f"{run}.npz")) as data:
            npz_keys = set(data.files)
        payload = torch.load(os.path.join(models, run, want_steps[-1]), map_location="cpu",
                             weights_only=True)
    with torch.device("meta"):
        reference = CLIP(MODEL_REGISTRY["RN50"])
    jax_keys = {path for path, _ in jax_paths(reference).values()}
    stat_keys = [k for k in npz_keys if k.endswith(("/mean", "/var"))]
    if npz_keys != jax_keys or stat_keys:
        raise AssertionError(f"the RN50 npz keys differ from the JAX parameters: "
                             f"{sorted(npz_keys ^ jax_keys)[:5]}, statistics {stat_keys[:5]}")
    buffers = dict(model.named_buffers())
    saved = {k: v for k, v in payload["model"].items() if k.endswith(("running_mean", "running_var"))}
    if set(saved) != set(buffers) or not all(torch.equal(saved[k], buffers[k].cpu()) for k in saved):
        raise AssertionError("the full state's running statistics are not the model's")
    if all(torch.equal(b, torch.ones_like(b)) for k, b in buffers.items() if k.endswith("var")):
        raise AssertionError("the running statistics never moved")
    del model
    zero = dict.fromkeys(KERNELS, 0)
    text = MODEL_REGISTRY["RN50"].text_layers
    warm = dict(zero, mha_fwd=text, mha_bwd=text, lunif_fwd=2, lunif_bwd=2)
    main = dict(zero, mha_fwd=text, mha_bwd=text, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    want = [(k, warm if k < RN50_CLI_STEPS else main) for k in range(EXP6_EPOCHS * RN50_CLI_STEPS)]
    per_eval = dict(zero, mha_fwd=text * (RN50_CLI_EVAL_PAIRS // batch))
    _expect_launches(counter.steps, want, "the RN50 CLI's steps")
    _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), "the RN50 CLI's evals")
    rates = [r for r in records if "step_time_ms" in r]
    log("phase 23 cli", ok=True, model="RN50", loss_type=EXP6["loss_type"], batch=batch,
        steps=len(step_records), evals=len(evals),
        losses=json.dumps([r["train_loss"] for r in step_records]),
        eval_last=json.dumps(evals[-1]), files=json.dumps(want_files),
        full_state=json.dumps(full_steps), npz_keys=len(npz_keys),
        running_statistics=len(saved), launches=json.dumps(launches),
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        seconds=f"{seconds:.3f}", card=json.dumps(smi))
    return dict(launches=launches, cli_step_ms=[round(r["step_time_ms"], 3) for r in rates])


def phase_cli_losses(smi: str):
    """Phase 27: the CLI on two YAMLs of full-width ViT-B-32 at batch 256,
    each 2 epochs of ``CLI_LOSS_STEPS`` steps on synthetic pairs with one
    eval batch: ``anchor-roberta`` with the in-repo soft-target provider
    ``_stub_roberta:soft_targets`` (tests/, put on the import path as the
    JAX tests put it) and ``adam_mu_dtype: bfloat16``, then ``siglip``
    with configs/siglip_vitb32.yaml's loss fields.  Each step launches the
    two towers' attention and no loss kernel (both losses are plain
    PyTorch, as the JAX side's are XLA)."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config

    siglip = load_config(os.path.join(REPO, "configs", "siglip_vitb32.yaml"))
    runs = {
        "roberta-vitb32": dict(loss_type="anchor-roberta", only_lunif_epochs=0,
                               soft_targets_provider="_stub_roberta:soft_targets",
                               adam_mu_dtype="bfloat16"),
        "siglip-vitb32": {k: getattr(siglip, k) for k in SIGLIP_FIELDS},
    }
    batch = EXP6["batch_size"]
    zero = dict.fromkeys(KERNELS, 0)
    per_step = dict(zero, mha_fwd=24, mha_bwd=24)
    per_eval = dict(zero, mha_fwd=24 * (CLI_LOSS_EVAL_PAIRS // batch))
    steps = EXP6_EPOCHS * CLI_LOSS_STEPS
    tests_dir = os.path.join(REPO, "tests")
    launches, out = dict(zero), {}
    for run, fields in runs.items():
        with tempfile.TemporaryDirectory() as tmp:
            yaml_path = _write_exp6_yaml(tmp, run_name=run, num_train_samples=CLI_LOSS_STEPS * batch,
                                         num_test_samples=CLI_LOSS_EVAL_PAIRS,
                                         log_loss_components=True, **fields)
            counter = _PerStepCounts()
            sys.path.insert(0, tests_dir)
            t = time.perf_counter()
            try:
                reset_counts()
                _run_cli(["--config", yaml_path])
                counts = read_counts()
            finally:
                sys.path.remove(tests_dir)
                counter.close()
            seconds = time.perf_counter() - t
            counter.state = None
            records = _jsonl(os.path.join(tmp, "logs", f"{run}.jsonl"))
            full_dir = os.path.join(tmp, "models", run)
            payload = torch.load(os.path.join(full_dir, f"step_{steps}.pt"), map_location="cpu",
                                 weights_only=True)
        step_records = [r for r in records if "train_loss" in r]
        evals = _check_evals(records, EXP6_EPOCHS + 2, run)
        if len(step_records) != steps or not np.isfinite(
                [v for r in step_records for k, v in r.items() if not k.startswith("_")]).all():
            raise AssertionError(f"{run}: train records {step_records}")
        _expect_launches([c for _, c in counter.steps], [per_step] * steps, f"{run}'s steps")
        _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), f"{run}'s evals")
        _expect_launches(counts, {k: steps * per_step[k] + (EXP6_EPOCHS + 2) * per_eval[k]
                                  for k in KERNELS}, run)
        moments = list(payload["optimizer"]["state"].values())
        mu_dtypes = sorted({str(m["exp_avg"].dtype) for m in moments})
        nu_dtypes = sorted({str(m["exp_avg_sq"].dtype) for m in moments})
        scalars = {k: float(v) for k, v in (payload.get("loss_scalars") or {}).items()}
        if run.startswith("roberta"):
            if mu_dtypes != ["torch.bfloat16"] or nu_dtypes != ["torch.float32"]:
                raise AssertionError(f"{run}: moments {mu_dtypes} {nu_dtypes}")
        else:
            last = step_records[-1]
            if set(scalars) != {"logit_scale", "logit_bias"} or "siglip_scale" not in last \
                    or last["siglip_bias"] == siglip.siglip_logit_bias_init \
                    or last["siglip_scale"] == siglip.siglip_logit_scale_init:
                raise AssertionError(f"{run}: scalars {scalars}, last record {last}")
        log("phase 27 cli", ok=True, run=run, model=EXP6["model"], batch=batch,
            fields=json.dumps(fields), steps=len(step_records), evals=len(evals),
            losses=json.dumps([r["train_loss"] for r in step_records]),
            last_record=json.dumps({k: v for k, v in step_records[-1].items()
                                    if not k.startswith("_")}),
            eval_last=json.dumps(evals[-1]), exp_avg_dtypes=json.dumps(mu_dtypes),
            exp_avg_sq_dtypes=json.dumps(nu_dtypes), loss_scalars=json.dumps(scalars),
            cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in records
                                    if "step_time_ms" in r]),
            launches=json.dumps(counts), seconds=f"{seconds:.3f}", card=json.dumps(smi))
        out[run] = counts
    return out


# slice 10: the rest of inference, serving and export (phases 28-31)
IMAGE_BATCH = 256                # phase 28: the train batch, and a serving batch
IMAGE_STAGING = 256              # device_augment_staging's default
IMAGE_FRAME = (480, 640)         # a camera frame, squash-resized to the tower's 224
# crop-resize and resize on the card vs the same function on the CPU: fp32
# sums of a few taps in other orders, on [0, 1] pixels (normalized: / std)
IMAGE_ATOL = 1e-5
U8_SHAPES = ((224, 224), (256, 256), IMAGE_FRAME)  # phase 29's client shapes
U8_REQUESTS = 1024               # a burst of each path at 224², then the shape mix
ZERO_SHOT_CLASSES = ("dog", "cat", "car", "bus", "bird", "horse", "ship", "truck",
                     "airplane", "kitchen")
DISPATCH_CALLS, DISPATCH_ROUNDS = 200, 5  # phase 29: the custom op's host cost a call
EXPORT_BATCHES = (1, 7, 64)      # phase 31: an artifact against the live encoder
ENCODE_FILES = 64                # phase 31: the encode CLI's folder (PNG and JPEG)


def _resample_flops(case: str, args) -> int:
    """The operations phase 28's function needs on these inputs, not those
    of its dense products: a multiply-add (2) for each nonzero tap of the
    separable weights (rows over the input's columns, then columns over
    the output's rows; each sample's own matrices for the crop boxes) a
    channel, and the normalize's subtract and divide (2) an output value."""
    from sparsify_clip_tpu_torch.ops import image

    images = args[0]
    _, height, width, channels = images.shape
    size = 224
    if case == "augment":  # crop_resize's matrices
        top, left, h, w = (t.float() for t in args[1])
        scale_y, scale_x = size / h, size / w
        rows = image.weight_matrix(height, size, 1.0 / scale_y, -top * scale_y, antialias=False)
        cols = image.weight_matrix(width, size, 1.0 / scale_x, -left * scale_x, antialias=False)
        per_sample = 1
    else:  # eval_resize_batch's, one pair for the batch
        rows, cols = (image.weight_matrix(n, size, 1.0 / (size / n), 0.0, antialias=True)
                      for n in (height, width))
        per_sample = len(images)
    taps = per_sample * (rows.count_nonzero() * width + cols.count_nonzero() * size) * channels
    return int(2 * taps + 2 * len(images) * size * size * channels)


def phase_image_ops(smi: str):
    """Phase 28: ``ops/image.py`` on the card against the same functions on
    the CPU at batch 256: the staging 256² → 224 crop-resize of
    ``device_augment`` given the same boxes and flips, and
    ``eval_resize_batch`` from 480×640; both timed with CUDA events."""
    from sparsify_clip_tpu_torch.ops import image

    rng = np.random.default_rng(SEED + 28)
    gen = torch.Generator().manual_seed(SEED)
    results = {}
    staging = rng.integers(0, 256, (IMAGE_BATCH, IMAGE_STAGING, IMAGE_STAGING, 3), np.uint8)
    u, u_flip = image.augment_uniforms(gen, IMAGE_BATCH)
    boxes = image.crop_boxes_from_uniforms(u[:, 0], u[:, 1], u[:, 2], u[:, 3],
                                           IMAGE_STAGING, IMAGE_STAGING)
    flips = u_flip < 0.5
    frames = rng.integers(0, 256, (IMAGE_BATCH, *IMAGE_FRAME, 3), np.uint8)
    cases = {
        "augment": (lambda x, bx, fl: image.normalize_batch(image.crop_resize(x, bx, fl, 224)),
                    (torch.from_numpy(staging), boxes, flips)),
        "eval_resize": (lambda x: image.eval_resize_batch(x, 224), (torch.from_numpy(frames),)),
    }
    std = torch.as_tensor(image.CLIP_STD)
    for name, (fn, cpu_args) in cases.items():
        t = time.perf_counter()
        want = fn(*cpu_args)
        cpu_ms = (time.perf_counter() - t) * 1e3
        dev_args = tuple(a.cuda() if isinstance(a, torch.Tensor) else
                         tuple(t.cuda() for t in a) for a in cpu_args)
        got = fn(*dev_args)
        torch.cuda.synchronize()
        err = ((got.cpu() - want) * std).abs().max().item()  # on [0, 1] pixels
        ms = cuda_ms(lambda: fn(*dev_args), iters=20, warmup=3)
        bound_ms, bound_by = bound(dev_args[0].numel() + 4 * got.numel(),
                                   _resample_flops(name, cpu_args), "float32")
        results[name] = dict(max_abs_err=err, ms=ms, cpu_ms=cpu_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        log("phase 28 image", case=name, input=list(dev_args[0].shape), output=list(got.shape),
            max_abs_err_pixels=err, atol=IMAGE_ATOL, ms=f"{ms:.5f}", cpu_ms=f"{cpu_ms:.3f}",
            bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, card=json.dumps(smi))
        if not err <= IMAGE_ATOL:
            raise AssertionError(f"phase 28 {name}: card vs CPU {err} > {IMAGE_ATOL}")
    return results


def _burst(server, payloads, submit):
    """Submit ``payloads`` from ``SUBMIT_THREADS`` threads → (rows in
    order, wall seconds)."""
    futures, errors = [None] * len(payloads), []

    def run(worker):
        try:
            for j in range(worker, len(payloads), SUBMIT_THREADS):
                futures[j] = submit(payloads[j])
        except Exception as exc:  # reported and failed below
            errors.append(exc)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(w,)) for w in range(SUBMIT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"submission failed: {errors}")
    rows = np.stack([f.result(timeout=600) for f in futures])
    return rows, time.perf_counter() - t0


def _dispatch_us(smi: str, model) -> dict:
    """Host µs a call of the no-grad attention forward as serving, eval and
    GradCache's first pass reach it, through its custom op
    (``sparsify_clip::mha_fwd``), against the same wrapper called directly,
    at a serving batch's vision shape: the same kernel, so the difference
    is the op's dispatch.  Each timing issues its calls without waiting
    (the launch queue holds them) and the medians of interleaved rounds are
    reported."""
    from sparsify_clip_tpu_torch.ops import attention

    width, heads = model.cfg.vision_width, model.cfg.vision_heads
    tokens = (model.cfg.image_size // model.cfg.patch_size) ** 2 + 1
    qkv = torch.randn((MAX_BATCH, tokens, 3 * width), device="cuda", dtype=torch.bfloat16)
    calls = {"custom_op": lambda: attention.mha_fwd_op(qkv, heads, False),
             "wrapper": lambda: attention.mha_fwd(qkv, heads, False)[0]}
    if not torch.equal(calls["custom_op"](), calls["wrapper"]()):
        raise AssertionError("phase 29: the custom op and its wrapper differ")
    rounds = {name: [] for name in calls}
    for _ in range(DISPATCH_ROUNDS):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t) / DISPATCH_CALLS * 1e6)
            torch.cuda.synchronize()
    us = {name: float(np.median(v)) for name, v in rounds.items()}
    us["added"] = us["custom_op"] - us["wrapper"]
    log("phase 29 dispatch", shape=list(qkv.shape), calls=DISPATCH_CALLS,
        rounds=DISPATCH_ROUNDS, custom_op_us=f"{us['custom_op']:.2f}",
        wrapper_us=f"{us['wrapper']:.2f}", added_us=f"{us['added']:.2f}",
        added_ms_per_batch=f"{us['added'] * model.cfg.vision_layers[0] / 1e3:.4f}",
        spread_us=json.dumps({k: [round(min(v), 2), round(max(v), 2)]
                              for k, v in rounds.items()}), card=json.dumps(smi))
    return us


def phase_serve_u8(smi: str, model, fp32_rate: dict):
    """Phase 29: ``submit_image_u8`` from 8 threads through full-width bf16
    ViT-B-32: a burst at 224² against the same pixels normalized on the
    host through ``submit_image``, then a mix of 224², 256² and 480×640
    clients; every batch launches 12 ``mha_fwd`` and nothing else and holds
    one shape; then zero-shot over 10 classes × 7 templates."""
    from sparsify_clip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
    from sparsify_clip_tpu_torch.inference import (
        DEFAULT_TEMPLATES, CLIPEncoder, build_zero_shot_classifier, zero_shot_classify,
    )
    from sparsify_clip_tpu_torch.ops.image import eval_resize_batch
    from sparsify_clip_tpu_torch.serving import BatchingEncoderServer
    from sparsify_clip_tpu_torch.text import get_tokenizer

    rng = np.random.default_rng(SEED + 29)
    encoder = CLIPEncoder(model, get_tokenizer(model.cfg.name))
    recorder = _BatchLaunches(encoder)
    zero = dict.fromkeys(KERNELS, 0)
    per_batch = dict(zero, mha_fwd=model.cfg.vision_layers[0])
    square = rng.integers(0, 256, (U8_REQUESTS, 224, 224, 3), np.uint8)
    host = ((square.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    mix = [rng.integers(0, 256, (*U8_SHAPES[i % 3], 3), np.uint8) for i in range(U8_REQUESTS)]
    rates, launches = {}, dict(zero)
    dispatch = _dispatch_us(smi, model)
    server = BatchingEncoderServer(recorder, max_batch=MAX_BATCH)
    try:
        server.warmup((224, 224, 3), model.cfg.context_length, include_u8=True)
        for shape in U8_SHAPES[1:]:  # the other shapes' first batches off the clock
            server.submit_image_u8(np.zeros((*shape, 3), np.uint8)).result(60)
        for name, payloads, submit in (
                ("fp32_224", host, server.submit_image),
                ("u8_224", square, server.submit_image_u8),
                ("u8_mix", mix, server.submit_image_u8)):
            before = server.stats()
            recorder.batches.clear()
            recorder.u8_shapes.clear()
            reset_counts()
            rows, wall = _burst(server, payloads, submit)
            counts = read_counts()
            stats = server.stats()
            batches = list(recorder.batches)
            wrong = [c for _, c in batches if c != per_batch]
            if wrong or len(batches) != stats.batches - before.batches:
                raise AssertionError(f"phase 29 {name}: batches launched {wrong[:3]}, "
                                     f"expected {per_batch}")
            lat = server._latencies
            recent = sorted(list(lat)[-len(payloads):])
            rates[name] = dict(rows=rows, wall=wall, batches=len(batches),
                               requests_per_s=len(payloads) / wall,
                               p50_ms=1e3 * recent[len(recent) // 2],
                               p99_ms=1e3 * recent[min(len(recent) - 1,
                                                       int(0.99 * len(recent)))],
                               shapes=sorted(set(recorder.u8_shapes)))
            if name != "fp32_224":
                launches = {k: launches[k] + counts[k] for k in KERNELS}
        queues = sorted(str(k) for k in server._queues)
    finally:
        server.close()
    if queues != ["image", "tokens"]:
        raise AssertionError(f"phase 29: the uint8 queues did not drain away: {queues}")
    if rates["u8_mix"]["shapes"] != sorted((s[0], s[1]) for s in U8_SHAPES):
        raise AssertionError(f"phase 29: batch shapes {rates['u8_mix']['shapes']}")
    served = np.concatenate([rates["u8_224"]["rows"], rates["u8_mix"]["rows"]])
    norms = np.linalg.norm(served, axis=-1)
    if not np.isfinite(served).all() or np.abs(norms - 1).max() > NORM_TOL:
        raise AssertionError(f"phase 29: norms off 1 by {np.abs(norms - 1).max()}")
    cos_host = min_cosine(rates["u8_224"]["rows"], rates["fp32_224"]["rows"])
    # each mixed-shape request against its pixels resized and normalized on
    # the host, encoded as fp32 pixels
    cos_mix = 1.0
    for shape in U8_SHAPES:
        idx = [i for i in range(U8_REQUESTS) if mix[i].shape[:2] == shape]
        pixels = eval_resize_batch(torch.from_numpy(np.stack([mix[i] for i in idx])), 224)
        want = encode_direct(encoder.encode_images, pixels.numpy(), MAX_BATCH)
        cos_mix = min(cos_mix, min_cosine(rates["u8_mix"]["rows"][idx], want))

    # zero-shot: 10 classes × 7 templates, 64 images
    before = read_counts()
    classifier = build_zero_shot_classifier(encoder, ZERO_SHOT_CLASSES)
    images = host[:64]
    out = zero_shot_classify(encoder, images, classifier)
    zs_counts = _delta(before, read_counts())
    probs = out["probs"]
    sums = probs.sum(-1)
    cls_norms = torch.linalg.vector_norm(classifier, dim=-1).cpu().numpy()
    ok = (probs.shape == (64, len(ZERO_SHOT_CLASSES)) and np.isfinite(probs).all()
          and np.abs(sums - 1).max() < 1e-5 and np.abs(cls_norms - 1).max() < NORM_TOL
          and out["predictions"].shape == (64,))
    log("phase 29 zero-shot", ok=ok, classes=len(ZERO_SHOT_CLASSES),
        templates=len(DEFAULT_TEMPLATES), images=64, max_prob_sum_err=float(np.abs(sums - 1).max()),
        launches=json.dumps({k: v for k, v in zs_counts.items() if v}))
    if not ok or zs_counts != dict(zero, mha_fwd=2 * model.cfg.text_layers):
        raise AssertionError(f"phase 29 zero-shot: {out['predictions']}, launches {zs_counts}")
    launches = {k: launches[k] + zs_counts[k] for k in KERNELS}
    for name in ("fp32_224", "u8_224", "u8_mix"):
        r = rates[name]
        log("phase 29 rate", path=name, requests=U8_REQUESTS, batches=r["batches"],
            requests_per_s=f"{r['requests_per_s']:.1f}", wall_s=f"{r['wall']:.3f}",
            p50_ms=f"{r['p50_ms']:.3f}", p99_ms=f"{r['p99_ms']:.3f}",
            phase_5_fp32=json.dumps(fp32_rate), card=json.dumps(smi))
    log("phase 29 serve-u8", ok=True, min_cos_u8_vs_host_fp32=cos_host,
        min_cos_mix_vs_host_resized=cos_mix, min_cosine=MIN_COSINE,
        max_norm_err=float(np.abs(norms - 1).max()), per_batch=json.dumps(per_batch),
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        dispatch_added_ms_per_batch=f"{dispatch['added'] * per_batch['mha_fwd'] / 1e3:.4f}",
        u8_224_ms_per_batch=f"{1e3 * rates['u8_224']['wall'] / rates['u8_224']['batches']:.3f}")
    if cos_host < MIN_COSINE or cos_mix < MIN_COSINE:
        raise AssertionError(f"phase 29: cosine {cos_host} / {cos_mix} below {MIN_COSINE}")
    return dict(launches=launches, rates={k: {kk: vv for kk, vv in v.items() if kk != "rows"}
                                          for k, v in rates.items()})


def phase_cli_augment(smi: str, phase19: dict):
    """Phase 30: the CLI on a YAML of full-width ViT-B-32 under exp 6 at
    batch 256 with ``device_augment: true`` (uint8 staging at 256): 2
    epochs of 4 steps on synthetic pairs, phase 9's launches a step, the
    loss falling within each epoch; the loader alone, the host→device copy
    of a uint8 batch, the CLI step and the idle share beside phase 19's."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.data import dataset_loader
    from sparsify_clip_tpu_torch.train import batch_to_device

    spe = CLI_TRAIN_SAMPLES // EXP6["batch_size"]
    run = "exp6-vitb32-augment"
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path = _write_exp6_yaml(tmp, run_name=run, device_augment=True,
                                     device_augment_staging=IMAGE_STAGING, **NO_EPOCH_SAVES)
        config = load_config(yaml_path)
        train_loader, _ = dataset_loader(config, image_size=224)
        batches, loader_ms = _time_loader(train_loader)
        one = batches[0]
        if one["images"].dtype != np.uint8 or one["images"].shape[1:] != (
                IMAGE_STAGING, IMAGE_STAGING, 3):
            raise AssertionError(f"staging batch {one['images'].dtype} {one['images'].shape}")
        copy_ms = cuda_ms(lambda: batch_to_device(one, torch.device("cuda")), iters=10, warmup=2)
        del batches
        counter = _PerStepCounts()
        t = time.perf_counter()
        try:
            reset_counts()
            _run_cli(["--config", yaml_path])
            launches = read_counts()
        finally:
            counter.close()
        seconds = time.perf_counter() - t
        records = _jsonl(os.path.join(tmp, "logs", f"{run}.jsonl"))
    steps = [r for r in records if "train_loss" in r]
    losses = [r["train_loss"] for r in steps]
    evals = _check_evals(records, EXP6_EPOCHS + 2, "exp 6 with device_augment")
    epochs = [losses[e * spe:(e + 1) * spe] for e in range(EXP6_EPOCHS)]
    if len(losses) != EXP6_EPOCHS * spe or not np.isfinite(losses).all() or not all(
            e[-1] < e[0] for e in epochs):
        raise AssertionError(f"exp 6 with device_augment: losses {losses}")
    zero = dict.fromkeys(KERNELS, 0)
    warm = dict(zero, mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2)
    main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    per_eval = dict(zero, mha_fwd=24 * (CLI_EVAL_PAIRS // EXP6["batch_size"]))
    _expect_launches(counter.steps, [(k, warm if k < spe else main)
                                     for k in range(EXP6_EPOCHS * spe)], "phase 30's steps")
    _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), "phase 30's evals")
    rates = [r for r in records if "step_time_ms" in r]
    prof = _profile_cli_steps(config, CLI_PROFILE_STEPS)
    log("phase 30 cli", ok=True, model=config.model, batch=config.batch_size,
        device_augment=config.device_augment, staging=config.device_augment_staging,
        steps=len(steps), losses=json.dumps(losses), eval_last=json.dumps(evals[-1]),
        launches=json.dumps(launches), seconds=f"{seconds:.3f}")
    log("phase 30 rate", loader_ms_per_batch=f"{loader_ms:.3f}",
        host_to_device_ms=f"{copy_ms:.3f}",
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        cli_pairs_per_s=json.dumps([round(r["pairs_per_sec"], 1) for r in rates]),
        profiled_kernel_ms=f"{prof['kernel_ms']:.3f}", profiled_copy_ms=f"{prof['copy_ms']:.3f}",
        profiled_wall_ms=f"{prof['wall_ms']:.3f}",
        idle_share_profiled=f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}",
        phase_19=json.dumps(dict(loader_ms_per_batch=round(phase19["loader_ms"], 3),
                                 host_to_device_ms=round(phase19["copy_ms"], 3),
                                 cli_step_ms=[round(r["step_time_ms"], 3)
                                              for r in phase19["rates"]],
                                 idle_share_profiled=round(
                                     1 - phase19["profile"]["busy_ms"]
                                     / phase19["profile"]["wall_ms"], 4))),
        card=json.dumps(smi))
    return dict(launches=launches)


_EXPORT_CHILD = r"""
import json, sys
import numpy as np
import torch
import sparsify_clip_tpu_torch.ops
from sparsify_clip_tpu_torch.ops import attention

import os
result = {}
args = sys.argv[1:]
for artifact, inputs, out in zip(args[0::3], args[1::3], args[2::3]):
    mine = result[os.path.basename(artifact)] = {}
    with np.load(inputs) as data:
        arrays = {k: data[k] for k in data.files}
    for kind in ("image", "text"):
        batches = {k: x for k, x in arrays.items() if k.startswith(kind)}
        if not batches:
            continue
        program = torch.export.load(f"{artifact}/{kind}_encoder.pt2").module()
        for key, x in sorted(batches.items()):
            before = attention.mha_fwd.launches
            with torch.inference_mode():
                y = program(torch.from_numpy(x).cuda())
            torch.cuda.synchronize()
            mine[key] = dict(launches=attention.mha_fwd.launches - before)
            np.save(f"{out}/{key}.npy", y.cpu().numpy())
result["modules"] = sorted(m for m in sys.modules if m.startswith("sparsify_clip"))
print(json.dumps(result))
"""


def _encode_cli(model, encoder, tmp: str, rng):
    """Phase 31's encode CLI on ``ENCODE_FILES`` PNG and JPEG files of
    several sizes and a captions file in ``tmp`` → (its npz's arrays, the
    live encoder's image and text rows, the captions, the files, seconds,
    what it printed)."""
    import contextlib
    import io

    from PIL import Image

    from sparsify_clip_tpu_torch import encode
    from sparsify_clip_tpu_torch.checkpoints import save_weights

    cfg = model.cfg
    folder = os.path.join(tmp, "images")
    os.makedirs(folder)
    for i in range(ENCODE_FILES):
        h, w = (224, 224) if i % 4 == 0 else (int(rng.integers(100, 640)),
                                               int(rng.integers(100, 640)))
        pixels = rng.integers(0, 256, (h, w, 3), np.uint8)
        Image.fromarray(pixels).save(os.path.join(folder, f"img_{i:02d}.png" if i % 2
                                                  else f"img_{i:02d}.jpg"), quality=95)
    captions = [f"a photo of a {c} number {i}" for i, c in enumerate(ZERO_SHOT_CLASSES * 3)]
    texts = os.path.join(tmp, "captions.txt")
    with open(texts, "w") as fh:
        fh.write("\n".join(captions) + "\n")
    weights = save_weights(model, os.path.join(tmp, "weights.npz"))
    npz = os.path.join(tmp, "embeddings.npz")
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        encode.main(["--model", cfg.name, "--weights", weights, "--images", folder,
                     "--texts", texts, "--out", npz])
    encode_s = time.perf_counter() - t
    with np.load(npz) as data:
        got = {k: data[k] for k in data.files}
    files = list(got["image_files"])
    want_img = encode_direct(encoder.encode_images,
                             encode._load_image_batch(files, cfg.image_size), 64)
    want_txt = encoder.encode_texts(list(got["texts"])).cpu().numpy()
    return got, want_img, want_txt, captions, files, encode_s, printed


def phase_export(smi: str, model):
    """Phase 31: full-width bf16 ViT-B-32 exported with a symbolic batch
    (weights baked in), once with ``uint8_input``; both loaded in one child
    process that imports torch and the port's op module alone, whose
    batches of 1, 7 and 64 must agree with the live encoder and launch 12
    ``mha_fwd`` a call; then the encode CLI
    (``sparsify_clip_tpu_torch.encode.main``, what ``python -m`` runs) on a
    folder of 64 PNG and JPEG files and a captions file, whose npz must
    hold unit rows equal to the live encoder's."""
    import os
    import tempfile

    from sparsify_clip_tpu_torch.export import save_exported
    from sparsify_clip_tpu_torch.inference import CLIPEncoder
    from sparsify_clip_tpu_torch.text import get_tokenizer

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 31)
    encoder = CLIPEncoder(model, get_tokenizer(cfg.name))
    env = dict(os.environ, PYTHONPATH=REPO)
    layers = cfg.vision_layers[0]
    launches = dict.fromkeys(KERNELS, 0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exported, child_args = {}, []
        for name, uint8_input in (("symbolic", False), ("symbolic_uint8", True)):
            artifact = os.path.join(tmp, name)
            t = time.perf_counter()
            save_exported(model, artifact, model_name=cfg.name, uint8_input=uint8_input)
            export_s = time.perf_counter() - t
            size_mb = sum(os.path.getsize(os.path.join(artifact, f))
                          for f in os.listdir(artifact)) / 2**20
            inputs, want = {}, {}
            for b in EXPORT_BATCHES:
                raw = rng.integers(0, 256, (b, cfg.image_size, cfg.image_size, 3), np.uint8)
                if uint8_input:
                    inputs[f"image_{b}"] = raw
                    want[f"image_{b}"] = encoder.encode_images_u8(raw).cpu().numpy()
                else:
                    pixels = rng.standard_normal(raw.shape, dtype=np.float32)
                    inputs[f"image_{b}"] = pixels
                    want[f"image_{b}"] = encoder.encode_images(pixels).cpu().numpy()
                    tokens = token_rows(rng, b, cfg.context_length, cfg.vocab_size)
                    inputs[f"text_{b}"] = tokens
                    want[f"text_{b}"] = encoder.encode_tokens(tokens).cpu().numpy()
            path = os.path.join(tmp, f"{name}_inputs.npz")
            np.savez(path, **inputs)
            outputs = os.path.join(tmp, f"{name}_outputs")
            os.makedirs(outputs)
            child_args += [artifact, path, outputs]
            exported[name] = dict(export_s=export_s, size_mb=size_mb, want=want, outputs=outputs)
        # the child loads both artifacts while this process runs the encode CLI
        t = time.perf_counter()
        streams = [os.path.join(tmp, f"child.{k}") for k in ("out", "err")]
        with open(streams[0], "w") as out_fh, open(streams[1], "w") as err_fh:
            child = subprocess.Popen([sys.executable, "-c", _EXPORT_CHILD, *child_args],
                                     cwd=REPO, env=env, stdout=out_fh, stderr=err_fh)
            try:
                encoded = _encode_cli(model, encoder, tmp, rng)
                child.wait(timeout=CLI_PROCESS_TIMEOUT)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        child_s = time.perf_counter() - t
        with open(streams[0]) as out_fh, open(streams[1]) as err_fh:
            stdout, stderr = out_fh.read(), err_fh.read()
        if child.returncode != 0:
            raise AssertionError(f"phase 31: the child failed:\n{stderr[-4000:]}")
        results = json.loads(stdout.strip().splitlines()[-1])
        bad_modules = [m for m in results["modules"] if m.startswith((
            "sparsify_clip_tpu_torch.models", "sparsify_clip_tpu_torch.export",
            "sparsify_clip_tpu."))]
        for name, e in exported.items():
            export_s, size_mb, want, outputs = e["export_s"], e["size_mb"], e["want"], e["outputs"]
            result = results[name]
            errs, cosines = {}, {}
            for key, w in want.items():
                got = np.load(os.path.join(outputs, f"{key}.npy"))
                errs[key] = float(np.abs(got - w).max())
                cosines[key] = min_cosine(got, w)
                norms = np.linalg.norm(got, axis=-1)
                if got.shape != w.shape or np.abs(norms - 1).max() > NORM_TOL:
                    raise AssertionError(f"phase 31 {name} {key}: shape {got.shape}, norms {norms}")
                if result[key]["launches"] != layers:
                    raise AssertionError(f"phase 31 {name} {key}: {result[key]} mha_fwd, "
                                         f"expected {layers}")
                launches["mha_fwd"] += result[key]["launches"]
            log("phase 31 export", ok=not bad_modules, artifact=name, batches=list(EXPORT_BATCHES),
                export_s=f"{export_s:.3f}", child_s_both=f"{child_s:.3f}",
                size_mib=f"{size_mb:.1f}", max_abs_err=json.dumps(errs),
                min_cosine=json.dumps(cosines),
                launches=json.dumps({k: v["launches"] for k, v in result.items()}),
                child_modules=json.dumps(results["modules"]), card=json.dumps(smi))
            if bad_modules or min(cosines.values()) < MIN_COSINE:
                raise AssertionError(f"phase 31 {name}: modules {bad_modules}, cosines {cosines}")
            out[name] = dict(export_s=export_s, child_s=child_s)

    got, want_img, want_txt, captions, files, encode_s, printed = encoded
    rows = np.concatenate([got["image_embeddings"], got["text_embeddings"]])
    norms = np.linalg.norm(rows, axis=-1)
    cos = min(min_cosine(got["image_embeddings"], want_img),
              min_cosine(got["text_embeddings"], want_txt))
    ok = (got["image_embeddings"].shape == (ENCODE_FILES, cfg.embed_dim)
          and len(got["texts"]) == len(captions) and np.abs(norms - 1).max() <= NORM_TOL
          and cos >= MIN_COSINE)
    log("phase 31 encode", ok=ok, images=len(files), texts=len(got["texts"]),
        keys=json.dumps(sorted(got)), min_cos_vs_live=cos,
        max_norm_err=float(np.abs(norms - 1).max()), seconds=f"{encode_s:.3f}",
        retrieval=json.dumps([ln for ln in printed.getvalue().splitlines()
                              if ln.startswith("image ")]))
    if not ok:
        raise AssertionError("phase 31: the encode CLI's npz disagrees with the live encoder")
    return dict(launches=launches, **out)


# slice 11: the extensions and knobs (phases 32-35)
SPARSE_TOPK = 64                 # phase 32: sparse_topk, on 512-wide embeddings
SPARSE_EVAL_PAIRS = 256          # phase 32: eval pairs a pass (plots of 512 points)
PLOTS_PER_EVAL = ("umap", "tsne", "pca")
REMAT_BATCH = 256                # phase 33: the reference's batch, one shot
REMAT_STEPS_PER_EPOCH = 2        # phase 33: one warm and one main epoch of 2 steps
REMAT_CHECK_BATCH = 64           # phase 33: fits without remat (phase 13's batch)
REMAT_POLICIES = ("dots_no_batch", "attn_out")  # timed at REMAT_CHECK_BATCH
REMAT_TRIED_AT_256 = ("dots", "dots_no_batch")  # may not fit: an OOM is a reading
RN50_REMAT_STEPS = 2             # phase 34
KNOB_STEPS = 3                   # phase 35: timed main steps of each setup


def _read_train_counts(fn):
    """Run ``fn`` with every count set to 0 and return (its result, the
    counts it launched)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def _set_remat(model, on: bool, policy: Optional[str] = "nothing") -> None:
    """Switch every transformer stack and Bottleneck of ``model`` between
    remat under ``policy`` and the plain blocks, over the same parameters
    (what ``create_model(remat=..., remat_policy=...)`` builds)."""
    from sparsify_clip_tpu_torch.models.layers import Transformer, resolve_remat_policy
    from sparsify_clip_tpu_torch.models.resnet import Bottleneck

    for module in model.modules():
        if isinstance(module, (Transformer, Bottleneck)):
            module.remat = on
            module.policy = resolve_remat_policy(policy) if on else None
        if isinstance(module, Transformer):
            for block in module.resblocks:
                block.tag_attn_out = on and policy == "attn_out"


def _timed_steps(setup, batch, steps: int, first_step: int):
    """``steps`` steps through ``train_step`` from ``first_step``, the last
    ``steps - 1`` timed on the host clock (each ends in a read of its
    loss) → (ms a step, peak bytes, losses, launches of the timed steps)."""
    setup.state.step = first_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, t = [], None
    reset_counts()
    for k in range(steps):
        if k == 1:
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
        setup.state, metrics = setup.train_step(setup.state, batch)
        losses.append(float(metrics["train_loss"]))
    ms = (time.perf_counter() - t) / (steps - 1) * 1e3
    return ms, torch.cuda.max_memory_allocated(), losses, read_counts()


def phase_cli_sparse(smi: str, phase19: dict):
    """Phase 32: the CLI on a YAML of full-width ViT-B-32 under exp 6 at
    batch 256 with ``sparse_projection: topk`` (``sparse_topk`` 64,
    ``sparse_after_epoch`` 1) and the per-eval plots where matplotlib is
    installed; the projected embeddings of one batch; one step held
    against the plain versions; one ``l1`` step."""
    import dataclasses
    import importlib.util
    import os
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.ops.sparsify import make_projection
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup
    from sparsify_clip_tpu_torch.utils.numerics import l2_normalize

    spe, batch = SPARSE_SAMPLES // EXP6["batch_size"], EXP6["batch_size"]
    plots = importlib.util.find_spec("matplotlib") is not None
    run = "exp6-topk"
    sparse = dict(sparse_projection="topk", sparse_topk=SPARSE_TOPK, sparse_after_epoch=1,
                  num_train_samples=SPARSE_SAMPLES)
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path = _write_exp6_yaml(tmp, run_name=run, num_test_samples=SPARSE_EVAL_PAIRS,
                                     plot_embeddings=plots, **sparse, **NO_EPOCH_SAVES)
        config = load_config(yaml_path)
        counter = _PerStepCounts()
        t = time.perf_counter()
        try:
            reset_counts()
            _run_cli(["--config", yaml_path])
            launches = read_counts()
        finally:
            counter.close()
        seconds = time.perf_counter() - t
        model, counter.state = counter.state.model, None
        records = _jsonl(os.path.join(tmp, "logs", f"{run}.jsonl"))
        images = [r for r in records if r.get("event") == "image"]
        png_sizes = [os.path.getsize(r["path"]) for r in images if os.path.exists(r["path"])]
    step_records = [r for r in records if "train_loss" in r]
    if len(step_records) != EXP6_EPOCHS * spe or not np.isfinite(
            [r["train_loss"] for r in step_records]).all():
        raise AssertionError(f"topk CLI train records {step_records}")
    n_evals = EXP6_EPOCHS + 2
    evals = _check_evals(records, n_evals, "exp 6 topk")
    want_keys = list(PLOTS_PER_EVAL) * n_evals if plots else []
    if [r["key"] for r in images] != want_keys or len(png_sizes) != len(want_keys) \
            or min(png_sizes, default=1001) <= 1000:
        raise AssertionError(f"plots: {images}, sizes {png_sizes}")
    zero = dict.fromkeys(KERNELS, 0)
    warm = dict(zero, mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2)
    main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    per_eval = dict(zero, mha_fwd=24 * (SPARSE_EVAL_PAIRS // batch))
    _expect_launches(counter.steps, [(k, warm if k < spe else main)
                                     for k in range(EXP6_EPOCHS * spe)], "the topk CLI's steps")
    _expect_launches(counter.evals, [per_eval] * n_evals, "the topk CLI's evals")
    rates = [r for r in records if "step_time_ms" in r]
    refused = None
    if not plots:
        # without matplotlib the CLI refuses plot_embeddings: true by name,
        # before it writes any file
        with tempfile.TemporaryDirectory() as tmp:
            yaml_path = _write_exp6_yaml(tmp, run_name=run, plot_embeddings=True, **sparse)
            try:
                _run_cli(["--config", yaml_path])
            except NotImplementedError as e:
                refused = str(e)
            written = os.listdir(tmp)
        if refused is None or "matplotlib" not in refused or written != ["exp6.yaml"]:
            raise AssertionError(f"plot_embeddings without matplotlib: {refused!r}, {written}")
    log("phase 32 cli", ok=True, model=config.model, batch=batch, **sparse,
        plot_embeddings=plots, refused_without_matplotlib=json.dumps(refused),
        steps=len(step_records), evals=len(evals), plots=len(images),
        png_bytes_min=min(png_sizes, default=0),
        losses=json.dumps([r["train_loss"] for r in step_records]),
        eval_last=json.dumps(evals[-1]), launches=json.dumps(launches),
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        phase19_cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in phase19["rates"]]),
        seconds=f"{seconds:.3f}", card=json.dumps(smi))

    # the trained model's embeddings of one batch, projected as the step does
    cfg = model.cfg
    held = batch_to_device(synthetic_batch(batch, cfg.image_size, cfg.context_length,
                                           seed=SEED + 5), torch.device("cuda"))
    project = make_projection("topk", SPARSE_TOPK)
    with torch.no_grad():
        img, txt = model(held["images"], held["tokens"])
        projected = torch.cat([project(l2_normalize(img)), project(l2_normalize(txt))])
    nonzeros = (projected != 0).sum(-1)
    norm_err = (projected.norm(dim=-1) - 1).abs().max().item()
    log("phase 32 projection", rows=projected.shape[0], width=projected.shape[1],
        nonzeros_min=int(nonzeros.min()), nonzeros_max=int(nonzeros.max()),
        rows_over_k=int((nonzeros > SPARSE_TOPK).sum()), max_norm_err=norm_err,
        norm_tol=NORM_TOL)
    if nonzeros.min().item() < SPARSE_TOPK or norm_err > NORM_TOL:
        raise AssertionError("phase 32: the projected rows are not k-sparse unit vectors")
    del model, img, txt, projected

    # one main step (past sparse_after_epoch) on the kernels against the same
    # step on the plain versions, in fp32 towers: in bf16 the two paths'
    # roundings move components across the k-th magnitude (the mask flips,
    # and the gradient with it), which the flip count below shows
    check = create_train_setup(dataclasses.replace(config, fp16=False), steps_per_epoch=spe,
                               device="cuda")
    check.state.step = spe
    (loss_k, aux_k, _, _), counts = _read_train_counts(
        lambda: check.train_step.loss_and_grads(check.state, held))
    _expect_launches(counts, main, "the fp32 topk main step")
    params = list(check.model.parameters())
    names = [n for n, _ in check.model.named_parameters()]
    grads_k = [p.grad.detach().clone() for p in params]
    with torch.no_grad():
        emb_k = torch.cat([l2_normalize(e) for e in check.model(held["images"], held["tokens"])])
    restore = _plain_paths()
    try:
        (loss_p, aux_p, _, _), plain_counts = _read_train_counts(
            lambda: check.train_step.loss_and_grads(check.state, held))
        with torch.no_grad():
            emb_p = torch.cat([l2_normalize(e)
                               for e in check.model(held["images"], held["tokens"])])
    finally:
        restore()
    if any(plain_counts.values()):
        raise AssertionError(f"the plain topk step launched {plain_counts}")
    flips = int(((project(emb_k) != 0) != (project(emb_p) != 0)).any(-1).sum())
    cosines = _grad_cosines(params, grads_k)
    gaps = {k: _rel_gap(aux_k[k].item(), aux_p[k].item()) for k in aux_k}
    gaps["loss"] = _rel_gap(loss_k.item(), loss_p.item())
    worst = _worst(names, cosines)
    log("phase 32 plain", step=spe, batch=batch, dtype="float32", loss_kernel=loss_k.item(),
        loss_plain=loss_p.item(), rel_gaps=json.dumps(gaps), rtol=TRAIN_LOSS_RTOL,
        min_grad_cosine=cosines[worst], min_at=names[worst], min_cosine=TRAIN_MIN_GRAD_COSINE,
        rows_whose_mask_differs=flips, rows=emb_k.shape[0])
    if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
        raise AssertionError("phase 32: the topk step on the kernels and the plain versions "
                             "disagree")
    del check, grads_k, params, emb_k, emb_p
    torch.cuda.empty_cache()

    # the topk and the l1 step timed on the device-resident batch (bf16 towers)
    out = {}
    for kind in ("topk", "l1"):
        setup = create_train_setup(dataclasses.replace(config, sparse_projection=kind),
                                   steps_per_epoch=spe, device="cuda")
        setup.state.step = spe
        (loss_k, aux_k, _, _), counts = _read_train_counts(
            lambda: setup.train_step.loss_and_grads(setup.state, held))
        _expect_launches(counts, main, f"the {kind} main step")
        setup.state.optimizer.zero_grad(set_to_none=True)
        ms, peak, losses, counts = _timed_steps(setup, held, 3, spe)
        _expect_launches(counts, {k: 2 * v for k, v in main.items()}, f"two {kind} steps")
        if not np.isfinite([loss_k.item()] + losses).all():
            raise AssertionError(f"phase 32: {kind} losses {losses}")
        out[kind] = dict(loss=loss_k.item(), step_ms=ms, launches=counts)
        log("phase 32 step", projection=kind, step=spe, batch=batch, loss=loss_k.item(),
            components=json.dumps({k: v.item() for k, v in aux_k.items()}),
            losses=json.dumps(losses), step_ms=f"{ms:.3f}",
            max_memory_allocated_gib=f"{peak / 2**30:.3f}", card=json.dumps(smi))
        del setup
        torch.cuda.empty_cache()
    return dict(launches=launches, steps=out)


def phase_remat_l336(smi: str, gradcache_l336: dict):
    """Phase 33: full-width ViT-L-14-336 under exp 6 at the reference's
    batch 256 in one shot under ``remat: true`` (policy ``nothing``),
    unfused and with ``fused_ln_qkv``, beside phase 26's GradCache step;
    at batch 64 the remat step against the same step without remat, and
    the selective policies' peaks and step times; at 256 the policies
    that keep the projections' outputs, which may not fit."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup, run_training

    spe = REMAT_STEPS_PER_EPOCH
    config = ExperimentConfig.from_dict(dict(EXP6, model=L336, batch_size=REMAT_BATCH,
                                             epochs=EXP6_EPOCHS, log_every_n_steps=spe,
                                             remat=True, remat_policy="nothing"))
    t = time.perf_counter()
    setup = create_train_setup(config, steps_per_epoch=spe, device="cuda")
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t
    cfg, model = setup.model.cfg, setup.model
    batch = batch_to_device(synthetic_batch(REMAT_BATCH, cfg.image_size, cfg.context_length,
                                            seed=SEED), setup.device)
    zero = dict.fromkeys(KERNELS, 0)
    vision, text = cfg.vision_layers[0], cfg.text_layers
    # the backward recomputes each block's forward: the forwards run twice
    attention = dict(mha_fwd_head_group=2 * vision, mha_bwd_head_group=vision,
                     mha_fwd=2 * text, mha_bwd=text)
    warm_step = dict(zero, **attention, lunif_fwd=2, lunif_bwd=2)
    main_step = dict(zero, **attention, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                     lunif_fwd=1, lunif_bwd=1)
    fused_step = dict(main_step, ln_qkv_fwd=2 * (vision + text), ln_fast_bwd=vision + text)

    # the main path: run_training over one warm and one main epoch
    records = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run_training(setup, lambda epoch: iter([batch] * spe), log_fn=records.append)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    _expect_launches(launches, {k: spe * (warm_step[k] + main_step[k]) for k in KERNELS},
                     "the remat run")
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    rates = [r for r in records if "step_time_ms" in r]
    if len(losses) != 2 * spe or not np.isfinite(losses).all():
        raise AssertionError(f"phase 33 losses {losses}")
    gc_peak = gradcache_l336["peak"]
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    log("phase 33 remat", model=L336, batch=REMAT_BATCH, remat_policy="nothing",
        setup_seconds=f"{setup_seconds:.3f}", losses=json.dumps(losses),
        launches_warm_step=json.dumps(warm_step), launches_main_step=json.dumps(main_step),
        step_ms=json.dumps({k: round(r["step_time_ms"], 3) for k, r in zip(("warm", "main"),
                                                                           rates)}),
        pairs_per_s=json.dumps({k: round(r["pairs_per_sec"], 1) for k, r in zip(
            ("warm", "main"), rates)}),
        max_memory_allocated_gib=f"{peak / 2**30:.3f}",
        gradcache_step_ms=json.dumps({k: round(v["step_ms"], 3)
                                      for k, v in gradcache_l336["rates"].items()}),
        gradcache_max_memory_allocated_gib=f"{gc_peak / 2**30:.3f}",
        card_memory_gib=f"{card_bytes / 2**30:.3f}", card=json.dumps(smi))
    if peak >= card_bytes:
        raise AssertionError("phase 33: the remat step does not fit the card")

    # the same, with the fused LN+qkv: two main steps timed
    _set_fused_ln_qkv(model, True)
    try:
        setup.state.optimizer.zero_grad(set_to_none=True)
        fused_ms, fused_peak, fused_losses, fused_launches = _timed_steps(setup, batch, 3, spe)
    finally:
        _set_fused_ln_qkv(model, False)
    _expect_launches(fused_launches, {k: 2 * v for k, v in fused_step.items()},
                     "two fused remat steps")
    log("phase 33 remat fused", batch=REMAT_BATCH, step_ms=f"{fused_ms:.3f}",
        pairs_per_s=f"{REMAT_BATCH / fused_ms * 1e3:.1f}",
        max_memory_allocated_gib=f"{fused_peak / 2**30:.3f}",
        launches_step=json.dumps(fused_step), losses=json.dumps(fused_losses),
        card=json.dumps(smi))

    # batch 64: the remat step against the step without remat (same state)
    small = batch_to_device(synthetic_batch(REMAT_CHECK_BATCH, cfg.image_size,
                                            cfg.context_length, seed=SEED + 1), setup.device)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    small_main = dict(main_step)
    grads = {}
    for remat in (False, True):
        _set_remat(model, remat)
        setup.state.step = spe
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (loss, aux, _, _), counts = _read_train_counts(
            lambda: setup.train_step.loss_and_grads(setup.state, small))
        want = small_main if remat else dict(small_main, mha_fwd_head_group=vision,
                                             mha_fwd=text)
        _expect_launches(counts, want, f"the batch-64 step with remat {remat}")
        grads[remat] = (loss.item(), {k: v.item() for k, v in aux.items()},
                        [p.grad.detach().clone() for p in params],
                        torch.cuda.max_memory_allocated())
        setup.state.optimizer.zero_grad(set_to_none=True)
    (loss0, aux0, g0, peak0), (loss1, aux1, g1, peak1) = grads[False], grads[True]
    max_diff = max((a - b).abs().max().item() for a, b in zip(g0, g1))
    identical = loss0 == loss1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    cosines = [_cosine(a, b) for a, b in zip(g1, g0)]
    worst = _worst(names, cosines)
    gaps = {k: _rel_gap(aux1[k], aux0[k]) for k in aux0}
    gaps["loss"] = _rel_gap(loss1, loss0)
    log("phase 33 equality", batch=REMAT_CHECK_BATCH, step=spe, loss_remat=loss1,
        loss_plain=loss0, bit_identical=identical, max_abs_grad_diff=max_diff,
        rel_gaps=json.dumps(gaps), rtol=TRAIN_LOSS_RTOL, min_grad_cosine=cosines[worst],
        min_at=names[worst], min_cosine=TRAIN_MIN_GRAD_COSINE,
        peak_gib_plain=f"{peak0 / 2**30:.3f}", peak_gib_remat=f"{peak1 / 2**30:.3f}")
    if max(gaps.values()) > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE:
        raise AssertionError("phase 33: the remat step and the plain step disagree")
    del g0, g1, grads

    # each policy's peak and step at batch 64, and without remat
    policies = {}
    for policy in (None, "nothing") + REMAT_POLICIES:
        _set_remat(model, policy is not None, policy)
        setup.state.optimizer.zero_grad(set_to_none=True)
        ms, peak_p, _, counts = _timed_steps(setup, small, 3, spe)
        want = small_main if policy is not None else dict(small_main, mha_fwd_head_group=vision,
                                                          mha_fwd=text)
        _expect_launches(counts, {k: 2 * v for k, v in want.items()},
                         f"two batch-64 steps under {policy}")
        policies[str(policy)] = dict(step_ms=round(ms, 3), peak_gib=round(peak_p / 2**30, 3))
    log("phase 33 policies", batch=REMAT_CHECK_BATCH, policies=json.dumps(policies),
        card=json.dumps(smi))

    # batch 256 under the policies that keep the projections' outputs
    at_256 = {}
    for policy in REMAT_TRIED_AT_256:
        _set_remat(model, True, policy)
        setup.state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        try:
            ms, peak_p, _, _ = _timed_steps(setup, batch, 2, spe)
            at_256[policy] = dict(step_ms=round(ms, 3), peak_gib=round(peak_p / 2**30, 3))
        except torch.cuda.OutOfMemoryError:
            # a measured fact: the policy's saved products do not fit at 256
            at_256[policy] = dict(out_of_memory=True,
                                  peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
        setup.state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    _set_remat(model, True, "nothing")
    log("phase 33 policies at 256", batch=REMAT_BATCH, policies=json.dumps(at_256),
        card=json.dumps(smi))
    fused_launches_total = {k: fused_launches[k] for k in KERNELS}
    del setup, model, batch, small
    torch.cuda.empty_cache()
    return dict(launches=launches, fused_launches=fused_launches_total, peak=peak,
                rates=rates, fused_ms=fused_ms)


def phase_remat_rn50(smi: str, exp6_rn50: dict):
    """Phase 34: full-width RN50 under exp 6 at batch 256 with and without
    ``remat`` from the same seed: after two steps the running statistics,
    the last gradients and the losses agree; step ms and peak beside phase
    21's."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup

    spe = EXP6_STEPS_PER_EPOCH
    runs, launches = {}, None
    for remat in (False, True):
        config = ExperimentConfig.from_dict(dict(EXP6, model="RN50", epochs=EXP6_EPOCHS,
                                                 remat=remat))
        setup = create_train_setup(config, steps_per_epoch=spe, device="cuda")
        cfg = setup.model.cfg
        batch = batch_to_device(synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                                seed=SEED), setup.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = []
        for _ in range(RN50_REMAT_STEPS):
            setup.state, metrics = setup.train_step(setup.state, batch)
            losses.append(float(metrics["train_loss"]))
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = {n: b.detach().clone() for n, b in setup.model.named_buffers()}
        grads = {n: p.grad.detach().clone() for n, p in setup.model.named_parameters()}
        setup.state.optimizer.zero_grad(set_to_none=True)
        ms, _, _, _ = _timed_steps(setup, batch, 3, spe)  # main-phase steps
        runs[remat] = dict(losses=losses, stats=stats, grads=grads, peak=peak, step_ms=ms,
                           counts=counts)
        if remat:
            launches = counts
        del setup, batch
        torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    text = MODEL_REGISTRY["RN50"].text_layers
    # the ResNet tower runs no kernel; the text tower's forwards run twice
    want = dict(dict.fromkeys(KERNELS, 0), mha_fwd=2 * text * RN50_REMAT_STEPS,
                mha_bwd=text * RN50_REMAT_STEPS, lunif_fwd=2 * RN50_REMAT_STEPS,
                lunif_bwd=2 * RN50_REMAT_STEPS)
    _expect_launches(remat["counts"], want, "two RN50 remat steps")
    stat_diff = max((remat["stats"][n] - b).abs().max().item() for n, b in plain["stats"].items())
    stat_scale = max(b.abs().max().item() for b in plain["stats"].values())
    stats_identical = all(torch.equal(remat["stats"][n], b) for n, b in plain["stats"].items())
    names = list(plain["grads"])
    cosines = [_cosine(remat["grads"][n], plain["grads"][n]) for n in names]
    worst = _worst(names, cosines)
    grads_identical = all(torch.equal(remat["grads"][n], plain["grads"][n]) for n in names)
    loss_gap = max(_rel_gap(a, b) for a, b in zip(remat["losses"], plain["losses"]))
    moved = any(not torch.equal(b, torch.zeros_like(b)) for n, b in remat["stats"].items()
                if n.endswith("running_mean"))
    log("phase 34 remat rn50", batch=TRAIN_BATCH, steps=RN50_REMAT_STEPS,
        losses_plain=json.dumps(plain["losses"]), losses_remat=json.dumps(remat["losses"]),
        loss_rel_gap=loss_gap, rtol=TRAIN_LOSS_RTOL, stats_bit_identical=stats_identical,
        stats_max_abs_diff=stat_diff, stats_scale=stat_scale, stats_moved=moved,
        grads_bit_identical=grads_identical, min_grad_cosine=cosines[worst],
        min_at=names[worst], min_cosine=TRAIN_MIN_GRAD_COSINE,
        step_ms_plain=f"{plain['step_ms']:.3f}", step_ms_remat=f"{remat['step_ms']:.3f}",
        peak_gib_plain=f"{plain['peak'] / 2**30:.3f}",
        peak_gib_remat=f"{remat['peak'] / 2**30:.3f}",
        phase21_step_ms=json.dumps({k: round(v["step_ms"], 3)
                                    for k, v in exp6_rn50["rates"].items()}),
        phase21_max_memory_allocated_gib=f"{exp6_rn50['peak'] / 2**30:.3f}",
        launches=json.dumps(launches), card=json.dumps(smi))
    if (loss_gap > TRAIN_LOSS_RTOL or cosines[worst] < TRAIN_MIN_GRAD_COSINE or not moved
            or stat_diff > TRAIN_LOSS_RTOL * stat_scale):
        raise AssertionError("phase 34: the RN50 remat steps and the plain steps disagree")
    return dict(launches=launches)


def phase_knobs(smi: str, exp6: dict):
    """Phase 35: full-width ViT-B-32 under exp 6 at batch 256 with
    ``onehot_embed`` and with ``ln_fp32: false`` against the default step
    from the same seed: the one-hot embedding equal to the gather's to the
    bit, each step's loss within the bf16 step tolerance, step ms and peak
    beside phase 9's."""
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup

    spe = EXP6_STEPS_PER_EPOCH
    zero = dict.fromkeys(KERNELS, 0)
    main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    out, launches, ref = {}, {}, None
    for name, fields in (("default", {}), ("onehot_embed", dict(onehot_embed=True)),
                         ("ln_fp32_false", dict(ln_fp32=False, fused_ln_qkv=True))):
        config = ExperimentConfig.from_dict(dict(EXP6, epochs=EXP6_EPOCHS, **fields))
        setup = create_train_setup(config, steps_per_epoch=spe, device="cuda")
        cfg = setup.model.cfg
        batch = batch_to_device(synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                                seed=SEED), setup.device)
        text = setup.model.text
        with torch.no_grad():
            if name == "onehot_embed":
                # the one-hot product against the gather, on the same table
                tokens = batch["tokens"]
                table = text.token_embedding.weight
                flat = tokens.reshape(-1, 1).long()
                onehot = torch.zeros(flat.shape[0], table.shape[0], dtype=text.dtype,
                                     device=flat.device).scatter_(1, flat, 1.0)
                product = onehot @ table.to(text.dtype)
                gathered = table[flat[:, 0]].to(text.dtype)
                embed_identical = torch.equal(product, gathered)
                del onehot, product, gathered
                tower = text(tokens)
                text.onehot_embed = False
                tower_gather = text(tokens)
                text.onehot_embed = True
                tower_identical = torch.equal(tower, tower_gather)
                log("phase 35 onehot", rows=flat.shape[0], vocab=table.shape[0],
                    onehot_bytes=flat.shape[0] * table.shape[0] * 2,
                    embedding_bit_identical=embed_identical,
                    text_tower_bit_identical=tower_identical)
                if not (embed_identical and tower_identical):
                    raise AssertionError("phase 35: the one-hot embedding differs from the "
                                         "gather's")
        setup.state.step = spe
        (loss, aux, _, _), counts = _read_train_counts(
            lambda: setup.train_step.loss_and_grads(setup.state, batch))
        _expect_launches(counts, main, f"the {name} main step")
        grads = [p.grad.detach().clone() for p in setup.model.parameters()]
        setup.state.optimizer.zero_grad(set_to_none=True)
        ms, peak, losses, counts = _timed_steps(setup, batch, KNOB_STEPS + 1, spe)
        _expect_launches(counts, {k: KNOB_STEPS * v for k, v in main.items()},
                         f"{KNOB_STEPS} {name} steps")
        launches[name] = counts
        result = dict(loss=loss.item(), step_ms=ms, peak=peak)
        if ref is None:
            ref = dict(result, grads=grads, names=[n for n, _ in setup.model.named_parameters()])
            gaps, cos = {}, 1.0
        else:
            gaps = {"loss": _rel_gap(loss.item(), ref["loss"])}
            cosines = [_cosine(a, b) for a, b in zip(grads, ref["grads"])]
            worst = _worst(ref["names"], cosines)
            cos = cosines[worst]
            if gaps["loss"] > TRAIN_LOSS_RTOL or cos < TRAIN_MIN_GRAD_COSINE:
                raise AssertionError(f"phase 35: the {name} step and the default step disagree")
        log("phase 35 step", knobs=name, batch=TRAIN_BATCH, step=spe, loss=loss.item(),
            loss_rel_gap_vs_default=gaps.get("loss", 0.0), rtol=TRAIN_LOSS_RTOL,
            min_grad_cosine_vs_default=cos, min_cosine=TRAIN_MIN_GRAD_COSINE,
            losses=json.dumps(losses), step_ms=f"{ms:.3f}",
            pairs_per_s=f"{TRAIN_BATCH / ms * 1e3:.1f}",
            max_memory_allocated_gib=f"{peak / 2**30:.3f}",
            phase9_step_ms=json.dumps({k: round(v["step_ms"], 3)
                                       for k, v in exp6["rates"].items()}),
            phase9_max_memory_allocated_gib=f"{exp6['peak'] / 2**30:.3f}", card=json.dumps(smi))
        out[name] = result
        del setup, batch, grads
        torch.cuda.empty_cache()
    return dict(launches=launches, steps=out)


def _tokens_per_s(tokenizer, captions, repeats: int = 3) -> float:
    """Token rows a second of ``tokenizer`` over ``captions``, after one
    warm-up pass (the Python tokenizer's pattern tables and BPE cache)."""
    tokenizer(captions)
    t = time.perf_counter()
    for _ in range(repeats):
        tokenizer(captions)
    return repeats * len(captions) / (time.perf_counter() - t)


def phase_native_tokenizer(smi: str):
    """Phase 36: the native tokenizer built with ``g++`` into ``_build/``,
    its ids against the Python tokenizer's on the synthetic set's
    captions, and both tokenizers' rate.  Without a C++ compiler,
    ``tokenizer: native`` must raise by name and ``auto`` take the Python
    tokenizer."""
    import dataclasses
    import shutil

    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.data.pipeline import _select_tokenizer
    from sparsify_clip_tpu_torch.data.synthetic import make_caption
    from sparsify_clip_tpu_torch.text import get_tokenizer, native
    from sparsify_clip_tpu_torch.utils import profiling

    rng = np.random.default_rng(SEED)
    captions = [make_caption(rng) for _ in range(TOKENIZER_CAPTIONS)]
    config = ExperimentConfig.from_dict({"model": "ViT-B-32"})
    compiler = shutil.which(os.environ.get("CXX") or "g++")
    if compiler is None:
        try:
            _select_tokenizer(dataclasses.replace(config, tokenizer="native"))
        except RuntimeError as exc:
            if "native tokenizer" not in str(exc):
                raise
        else:
            raise AssertionError("tokenizer: native did not raise without a C++ compiler")
        auto = _select_tokenizer(dataclasses.replace(config, tokenizer="auto"))
        if auto.backend != "python":
            raise AssertionError(f"tokenizer: auto took {auto.backend} without a compiler")
        log("phase 36 tokenizer", ok=True, compiler=None, native="raises by name",
            auto=auto.backend)
        return dict(native=False)
    compiled = not native.native_build.library_path(native.SOURCE, native.CXXFLAGS, ()).exists()
    path, build_s = profiling.log_compile_time(native.build_library, label="clip_bpe")
    fast, python = native.NativeCLIPTokenizer(), get_tokenizer("ViT-B-32")
    got, want = fast(captions), python(captions)
    mismatched = int((got != want).any(axis=1).sum())
    if mismatched:
        raise AssertionError(f"the native tokenizer differs from the Python one on "
                             f"{mismatched} of {len(captions)} captions")
    auto = _select_tokenizer(dataclasses.replace(config, tokenizer="auto"))
    if auto.backend != "native":
        raise AssertionError(f"tokenizer: auto took {auto.backend} where g++ builds the library")
    rates = {"native": _tokens_per_s(fast, captions), "python": _tokens_per_s(python, captions)}
    log("phase 36 tokenizer", ok=True, compiler=compiler, library=path.name,
        compiled=compiled, build_s=f"{build_s:.3f}", captions=len(captions), mismatched=0,
        rows_per_s=json.dumps({k: round(v, 1) for k, v in rates.items()}),
        speedup=f"{rates['native'] / rates['python']:.2f}", card=json.dumps(smi))
    return dict(native=True, rates=rates, build_s=build_s)


def _repo_yaml(name: str, directory: str, phase: str, **fields) -> str:
    """``configs/<name>`` copied into ``directory`` with the fields a smoke
    run changes (synthetic data, sample counts, epochs, no plots, no
    resume, JSONL logs and files under ``directory``), each change
    printed."""
    import yaml

    with open(os.path.join(REPO, "configs", name)) as fh:
        config = yaml.safe_load(fh)
    changes = dict(dataset="synthetic", plot_embeddings=False, resume_checkpoint=False,
                   log_backend="jsonl", log_dir=os.path.join(directory, "logs"),
                   checkpoint_dir=os.path.join(directory, "models"), **fields)
    for key, value in changes.items():
        log(phase, config=f"configs/{name}", field=key,
            was=json.dumps(config.get(key, "(default)")), now=json.dumps(value))
    config.update(changes)
    path = os.path.join(directory, name)
    with open(path, "w") as fh:  # flat key: value lines, as configs/*.yaml
        for key, value in config.items():
            fh.write(f"{key}: {json.dumps(value)}\n")
    return path


def _cli_in_process(yaml_path: str):
    """The CLI on ``yaml_path`` in this process with the launches of every
    step and every eval → (counter, all launches, seconds, peak bytes)."""
    counter = _PerStepCounts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        reset_counts()
        _run_cli(["--config", yaml_path])
        launches = read_counts()
    finally:
        counter.close()
    return counter, launches, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def _cli_records(directory: str, run: str, steps: int, evals: int, what: str):
    """The run's records: ``steps`` finite train records and ``evals``
    finite 13-metric evals → (records, train records, evals, rates)."""
    records = _jsonl(os.path.join(directory, "logs", f"{run}.jsonl"))
    step_records = [r for r in records if "train_loss" in r]
    if len(step_records) != steps or not np.isfinite(
            [r["train_loss"] for r in step_records]).all():
        raise AssertionError(f"{what}: expected {steps} finite train records, got {step_records}")
    return records, step_records, _check_evals(records, evals, what), [
        r for r in records if "step_time_ms" in r]


def phase_cli_rn50_yaml(smi: str, tokenizer: dict, phase23: dict):
    """Phase 37: ``configs/rn50_tpu_baseline.yaml`` through the CLI
    (full-width RN50, batch 256, ``anchor``, ``device_augment``, both
    ``auto`` routes), 2 epochs of 2 steps with one eval batch."""
    import tempfile

    from sparsify_clip_tpu_torch.data import native_imaging
    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY

    batch, text = 256, MODEL_REGISTRY["RN50"].text_layers
    with tempfile.TemporaryDirectory() as tmp:
        path = _repo_yaml("rn50_tpu_baseline.yaml", tmp, "phase 37 cli",
                          num_train_samples=RN50_CLI_STEPS * batch,
                          num_test_samples=RN50_CLI_EVAL_PAIRS, epochs=EXP6_EPOCHS)
        counter, launches, seconds, peak = _cli_in_process(path)
        counter.state = None
        records, steps, evals, rates = _cli_records(
            tmp, "rn50-tpu-baseline", EXP6_EPOCHS * RN50_CLI_STEPS, EXP6_EPOCHS + 2,
            "the RN50 baseline YAML")
    routes = records[0].get("data_routes")
    want_image = "pil"  # the synthetic set hands out no JPEG bytes
    want = {"loader": "threads", "tokenizer": "native" if tokenizer["native"] else "python",
            "image": want_image}
    if records[0].get("event") != "run_start" or routes != {"train": want, "eval": want}:
        raise AssertionError(f"the first record's routes {routes}, expected {want} twice")
    zero = dict.fromkeys(KERNELS, 0)
    step = dict(zero, mha_fwd=text, mha_bwd=text, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1)
    per_eval = dict(zero, mha_fwd=text * (RN50_CLI_EVAL_PAIRS // batch))
    _expect_launches([c for _, c in counter.steps], [step] * len(steps),
                     "the RN50 baseline's steps")
    _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), "the RN50 baseline's evals")
    log("phase 37 cli", ok=True, config="configs/rn50_tpu_baseline.yaml", batch=batch,
        routes=json.dumps(routes), imaging_library=native_imaging.get_pipeline() is not None,
        imaging_error=json.dumps(str(native_imaging.build_error() or "")[-200:]),
        losses=json.dumps([r["train_loss"] for r in steps]), eval_last=json.dumps(evals[-1]),
        launches_step=json.dumps(step), launches=json.dumps(launches),
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        phase23_cli_step_ms=json.dumps(phase23["cli_step_ms"]),
        max_memory_allocated_gib=f"{peak / 2**30:.3f}", seconds=f"{seconds:.3f}",
        card=json.dumps(smi))
    return dict(launches=launches, routes=routes)


def phase_cli_grain(smi: str, phase19: dict):
    """Phase 38: ``loader_backend: grain`` through the CLI on phase 19's
    ViT-B-32 exp-6 YAML, 2 epochs of ``GRAIN_STEPS`` steps."""
    import dataclasses
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.data import dataset_loader
    from sparsify_clip_tpu_torch.data.grain_loader import GrainDataLoader

    batch, run = EXP6["batch_size"], "exp6-vitb32"
    with tempfile.TemporaryDirectory() as tmp:
        path = _write_exp6_yaml(tmp, loader_backend="grain",
                                num_train_samples=GRAIN_STEPS * batch, **NO_EPOCH_SAVES)
        config = load_config(path)
        train_loader, test_loader = dataset_loader(config, image_size=224)
        if not isinstance(train_loader, GrainDataLoader):
            raise AssertionError(f"loader_backend: grain built {type(train_loader).__name__}")
        batches, loader_ms = _time_loader(train_loader)
        one = batches[0]
        if one["images"].dtype != np.float32 or one["images"].shape != (batch, 224, 224, 3) \
                or one["tokens"].dtype != np.int32 or set(one["captions"]) != {""}:
            raise AssertionError(f"grain batch {one['images'].dtype} {one['images'].shape} "
                                 f"{one['tokens'].dtype} captions {set(one['captions'])}")
        del batches, one
        counter, launches, seconds, peak = _cli_in_process(path)
        counter.state = None
        records, steps, evals, rates = _cli_records(
            tmp, run, EXP6_EPOCHS * GRAIN_STEPS, EXP6_EPOCHS + 2, "the grain CLI")
    routes = records[0].get("data_routes")
    if routes["train"]["loader"] != "grain" or routes["eval"]["loader"] != "grain":
        raise AssertionError(f"the grain CLI's routes {routes}")
    zero = dict.fromkeys(KERNELS, 0)
    warm = dict(zero, mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2)
    main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    per_eval = dict(zero, mha_fwd=24 * (CLI_EVAL_PAIRS // batch))
    _expect_launches(counter.steps, [(k, warm if k < GRAIN_STEPS else main)
                                     for k in range(EXP6_EPOCHS * GRAIN_STEPS)],
                     "the grain CLI's steps")
    _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2), "the grain CLI's evals")
    log("phase 38 cli", ok=True, loader_backend="grain", batch=batch, routes=json.dumps(routes),
        losses=json.dumps([r["train_loss"] for r in steps]), eval_last=json.dumps(evals[-1]),
        captions_blank=True, launches=json.dumps(launches),
        loader_ms_per_batch=f"{loader_ms:.3f}",
        phase19_loader_ms_per_batch=f"{phase19['loader_ms']:.3f}",
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        phase19_cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in phase19["rates"]]),
        max_memory_allocated_gib=f"{peak / 2**30:.3f}", seconds=f"{seconds:.3f}",
        card=json.dumps(smi))
    return dict(launches=launches, loader_ms=loader_ms, rates=rates)


def phase_l257_kernels(smi: str):
    """Phase 39, first part: rows 1 and 3 at (VITL14_BATCH, 257, 3072)
    bf16 (the whole-width route) and row 2 in fp32 at the same shape (the
    eval twin's, on the head-group route) against their plain versions,
    under phase 2's and phase 6's tolerances, timed beside SDPA."""
    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd, mha_bwd_reference, mha_fwd, mha_fwd_head_group,
        mha_fwd_head_group_reference, mha_fwd_reference, use_head_group,
    )

    b, l, heads, head_dim = VITL14_BATCH, 257, 16, 64
    width = heads * head_dim
    routes = {"bf16": use_head_group(l, 3 * width, 2, heads),
              "fp32": use_head_group(l, 3 * width, 4, heads)}
    log("phase 39 route", head_group=json.dumps(routes))
    if routes != {"bf16": False, "fp32": True}:
        raise AssertionError(f"ViT-L-14 vision routes {routes}")
    rng = np.random.default_rng(SEED + 7)

    def normal(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)

    results = {}
    fwd_bound = bound(b * l * 4 * width * 2, 2 * 2 * b * heads * l * l * head_dim, "bfloat16")
    qkv = normal((b, l, 3 * width), torch.bfloat16)
    got, got_lse = mha_fwd(qkv, heads, False, with_lse=True)
    want, want_lse = mha_fwd_reference(qkv, heads, False, with_lse=True)
    torch.cuda.synchronize()
    rtol, atol = KERNEL_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
    err = (got.float() - want.float()).abs().max().item()
    del got, want, want_lse
    ms = cuda_ms(lambda: mha_fwd(qkv, heads, False), iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: mha_fwd_reference(qkv, heads, False), iters=5, warmup=1)
    sdpa_ms, library = sdpa_fwd_ms(qkv, heads, False, iters=20, warmup=3)
    results["mha_fwd/vision-257"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms[library],
        library=f"sdpa/{library}", bound_ms=fwd_bound[0], bound_by=fwd_bound[1])

    dout = normal((b, l, width), torch.bfloat16)
    got = mha_bwd(qkv, got_lse, dout, heads, False)
    want = mha_bwd_reference(qkv, got_lse, dout, heads, False)
    torch.cuda.synchronize()
    brtol, batol = BWD_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=brtol, atol=batol)
    bwd_err = (got.float() - want.float()).abs().max().item()
    del got, want
    bwd_ms = cuda_ms(lambda: mha_bwd(qkv, got_lse, dout, heads, False), iters=10, warmup=2)
    bwd_plain_ms = cuda_ms(lambda: mha_bwd_reference(qkv, got_lse, dout, heads, False),
                           iters=3, warmup=1)
    sdpa_bwd, bwd_library = sdpa_bwd_ms(qkv, dout, heads, False, iters=10, warmup=2)
    bwd_bound = bound(b * l * (3 * width * 2 + width) * 2 + b * l * heads * 4,
                      5 * 2 * b * heads * l * l * head_dim, "bfloat16")
    results["mha_bwd/vision-257"] = dict(
        max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=sdpa_bwd[bwd_library],
        library=f"sdpa/{bwd_library}", bound_ms=bwd_bound[0], bound_by=bwd_bound[1])
    del qkv, dout, got_lse

    qkv = normal((b, l, 3 * width), torch.float32)
    got = mha_fwd_head_group(qkv, heads, False)
    want = mha_fwd_head_group_reference(qkv, heads, False)
    torch.cuda.synchronize()
    frtol, fatol = KERNEL_TOL["float32"]
    torch.testing.assert_close(got, want, rtol=frtol, atol=fatol)
    hg_err = (got - want).abs().max().item()
    del got, want
    hg_ms = cuda_ms(lambda: mha_fwd_head_group(qkv, heads, False), iters=10, warmup=2)
    hg_plain_ms = cuda_ms(lambda: mha_fwd_head_group_reference(qkv, heads, False), iters=3,
                          warmup=1)
    sdpa_hg, hg_library = sdpa_fwd_ms(qkv, heads, False, iters=10, warmup=2)
    hg_bound = bound(b * l * 4 * width * 4, 2 * 2 * b * heads * l * l * head_dim, "float32")
    results["mha_fwd_head_group/vision-fp32-257"] = dict(
        max_abs_err=hg_err, ms=hg_ms, plain_ms=hg_plain_ms, library_ms=sdpa_hg[hg_library],
        library=f"sdpa/{hg_library}", bound_ms=hg_bound[0], bound_by=hg_bound[1])
    del qkv
    for case, r in results.items():
        kernel, name = case.split("/")
        log("phase 39 kernel", kernel=kernel, case=name, shape=json.dumps([b, l, 3 * width]),
            heads=heads, max_abs_err=r["max_abs_err"], ms=f"{r['ms']:.5f}",
            plain_ms=f"{r['plain_ms']:.5f}", library_ms=f"{r['library_ms']:.5f}",
            library=r["library"], bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
            sdpa_ms=json.dumps({"mha_fwd": sdpa_ms, "mha_bwd": sdpa_bwd,
                                "mha_fwd_head_group": sdpa_hg}[kernel]),
            card=json.dumps(smi))
    return results


def _kernel_groups(prof, steps: int, top: int = 5) -> list:
    """The ``top`` kernel names by device ms a step in a profile."""
    totals = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or "Memcpy" in e.name \
                or "Memset" in e.name or getattr(e, "is_user_annotation", False):
            continue
        totals[e.name] = totals.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [{"kernel": name[:90], "ms_per_step": round(us / 1e3 / steps, 3)}
            for name, us in ranked]


def phase_cli_vitl14(smi: str):
    """Phase 39: ``configs/vitl14_single_chip.yaml`` through the CLI at
    full width (ViT-L-14, 224, batch 128, ``anchor`` at a fixed
    temperature, ``device_augment``, no remat), 2 epochs of
    ``VITL14_STEPS`` steps and ``VITL14_EVAL_PAIRS`` eval pairs, after
    the L = 257 kernel checks; then two main steps under
    ``utils.profiling.trace``."""
    import tempfile

    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.utils import profiling

    kernels = phase_l257_kernels(smi)
    torch.cuda.empty_cache()
    batch, run = VITL14_BATCH, "vitl14-single-chip"
    with tempfile.TemporaryDirectory() as tmp:
        path = _repo_yaml("vitl14_single_chip.yaml", tmp, "phase 39 cli",
                          num_train_samples=VITL14_STEPS * batch,
                          num_test_samples=VITL14_EVAL_PAIRS, epochs=EXP6_EPOCHS)
        config = load_config(path)
        if config.batch_size != batch or config.model != "ViT-L-14":
            raise AssertionError(f"the YAML trains {config.model} at {config.batch_size}")
        counter, launches, seconds, peak = _cli_in_process(path)
        counter.state = None
        records, steps, evals, rates = _cli_records(
            tmp, run, EXP6_EPOCHS * VITL14_STEPS, EXP6_EPOCHS + 2, "ViT-L-14")
        torch.cuda.empty_cache()
        zero = dict.fromkeys(KERNELS, 0)
        step = dict(zero, mha_fwd=24 + 12, mha_bwd=24 + 12, infonce_fwd=1, infonce_bwd_dimg=1,
                    infonce_bwd_dtxt=1)
        batches = VITL14_EVAL_PAIRS // batch
        per_eval = dict(zero, mha_fwd_head_group=24 * batches, mha_fwd=12 * batches)
        _expect_launches([c for _, c in counter.steps], [step] * len(steps),
                         "the ViT-L-14 CLI's steps")
        _expect_launches(counter.evals, [per_eval] * (EXP6_EPOCHS + 2),
                         "the ViT-L-14 CLI's evals")
        log("phase 39 cli", ok=True, config="configs/vitl14_single_chip.yaml", batch=batch,
            routes=json.dumps(records[0].get("data_routes")),
            losses=json.dumps([r["train_loss"] for r in steps]),
            eval_last=json.dumps(evals[-1]), launches_step=json.dumps(step),
            launches_eval=json.dumps(per_eval), launches=json.dumps(launches),
            cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
            cli_pairs_per_s=json.dumps([round(r["pairs_per_sec"], 1) for r in rates]),
            max_memory_allocated_gib=f"{peak / 2**30:.3f}", seconds=f"{seconds:.3f}",
            card=json.dumps(smi))
        prof = _profile_cli_steps(config, VITL14_PROFILE_STEPS,
                                  tracer=lambda: profiling.trace(os.path.join(tmp, "trace")))
        trace_files = os.listdir(os.path.join(tmp, "trace"))
    groups = _kernel_groups(prof.pop("prof"), VITL14_PROFILE_STEPS)
    log("phase 39 rate", step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        pairs_per_s=json.dumps([round(r["pairs_per_sec"], 1) for r in rates]),
        max_memory_allocated_gib=f"{peak / 2**30:.3f}",
        profiled_kernel_ms=f"{prof['kernel_ms']:.3f}", profiled_busy_ms=f"{prof['busy_ms']:.3f}",
        profiled_wall_ms=f"{prof['wall_ms']:.3f}",
        idle_share_profiled=f"{1 - prof['busy_ms'] / prof['wall_ms']:.4f}",
        top_kernels=json.dumps(groups), chrome_trace=json.dumps(trace_files),
        card=json.dumps(smi))
    if len(trace_files) != 1:
        raise AssertionError(f"utils.profiling.trace wrote {trace_files}")
    return dict(launches=launches, kernels=kernels, rates=rates, peak=peak, profile=prof,
                groups=groups)


# --------------------------------------------------------------------
# Phases 40-41: data-parallel training across processes
# --------------------------------------------------------------------

DP_WORLDS = (2, 4)               # phase 41: gloo ranks on card 0
DP_STEPS, DP_SPE = 3, 2          # phase 41: 3 steps, 2 an epoch (warm, warm, main)
DP_LOSS_SHAPE = (256, 512)       # phase 41: the ring losses' global (N, D)
DP_EVAL_PAIRS = 512              # phase 41: two eval batches of 256
DP_PROCESS_TIMEOUT = 420         # seconds, each launcher call
# the CPU tests' tolerances (tests/test_torch_port_dist_losses.py)
DP_VALUE_RTOL, DP_GRAD_TOL, DP_SCALAR_RTOL = 1e-5, (1e-4, 1e-6), 1e-4
DP_EVAL_ATOL = 1e-4              # one 4-decimal rounding step
DP_RING_FNS = ("ring_infonce", "ring_lunif", "ring_lunif_centroids", "gathered_siglip")
# the data-parallel steps held against one process: (model, compute type,
# worlds).  ViT-B-32 in bf16 is the users' step; in fp32 the comparison sees
# the collectives and not bf16 rounding.  RN50 runs fp32 only: in bf16 AdamW
# walks its BatchNorm coordinates whose gradient is rounding noise (a sign a
# step, tests/test_torch_port_rn50.py) each side its own way.
DP_STEP_RUNS = (("ViT-B-32", "bf16", (2,)), ("RN50", "fp32", (2,)), ("ViT-B-32", "fp32", (4,)))
# the gates of a data-parallel run against one process, each limit above
# the sound readings on the card, below the readings of the faults it must
# catch (scripts/dp_gate_faults.py; both in PERF.md §6):
# - the first step's loss, from the same parameters and batch;
DP_FIRST_LOSS_RTOL = 1e-5
# - the later steps' losses, once AdamW has stepped (RN50: its noise
#   coordinates, above, in fp32 too);
DP_LATER_LOSS_RTOL = {("ViT-B-32", "bf16"): 5e-4, ("ViT-B-32", "fp32"): 1e-5,
                      ("RN50", "fp32"): 5e-3}
# - the first step's gradient, per tensor: its cosine, and its norm by
#   value (a cosine cannot see a gradient W times or 1/W its size);
DP_GRAD_NORM_RTOL = {("ViT-B-32", "bf16"): 5e-3, ("ViT-B-32", "fp32"): 1e-4,
                     ("RN50", "fp32"): 1e-2}
# - the parameters after the last step: |Δ_W − Δ_1| / |Δ_1| over every
#   parameter, Δ the change from the seed's parameters;
DP_UPDATE_RTOL = {("ViT-B-32", "bf16"): 0.2, ("ViT-B-32", "fp32"): 1e-3,
                  ("RN50", "fp32"): 0.5}
# - the running statistics: TRAIN_LOSS_RTOL of their largest entry.

# Phase 42: the sharded layouts, extra jobs of phase 41's launches, each
# (name, world, model, compute type, config fields); held against the
# one-process step of the same model, type and fused_ln_qkv
DP_LAYOUT_RUNS = (
    ("zero1", 2, "ViT-B-32", "bf16", dict(shard_opt_state=True)),
    ("fsdp", 2, "ViT-B-32", "bf16", dict(fsdp=True)),
    ("tp2_fused", 2, "ViT-B-32", "bf16", dict(mesh_model=2, fused_ln_qkv=True)),
    ("pp2", 2, "ViT-B-32", "bf16", dict(mesh_model=2, pipeline=True, scan_layers=True)),
    ("dp2tp2_fsdp", 4, "ViT-B-32", "fp32", dict(mesh_model=2, fsdp=True)),
    ("dp2pp2_zero1", 4, "ViT-B-32", "fp32",
     dict(mesh_model=2, pipeline=True, scan_layers=True, shard_opt_state=True)),
)
# a pipelined rank's parameter bytes against one process's: the
# replicated parameters and half of ViT-B-32's blocks are 0.59×
DP_PP_PARAM_SHARE = 0.75
# ZeRO-1 and FSDP split no product: phase 41's gates of their model and
# type.  Tensor parallelism splits the row-parallel products' sums over
# the model ranks (in bf16 each partial product is rounded before the fp32
# sum): its own gates, each still below a gradient W times or 1/W its size
# layouts held bit for bit to the plain data-parallel step of their model
# and type in the same launch: they take its tensors' readings and save none
DP_SAME_AS_STEP = ("zero1",)
DP_TP_GATES = {
    "tp2_fused": dict(first=TRAIN_LOSS_RTOL, later=TRAIN_LOSS_RTOL, grad_norm=5e-2, update=0.5),
    "dp2tp2_fsdp": dict(first=1e-5, later=1e-4, grad_norm=1e-3, update=5e-2),
}
# ViT-B-32 at tp 2: (name, batch, L, local heads, causal) of rows 1 and 3,
# (name, rows, W, local columns) of rows 10 and 11
TP_ATTENTION = (("vision", 256, 50, 6, False), ("text", 256, 77, 4, True))
TP_LN_QKV = (("vision", 256 * 50, 768, 1152), ("text", 256 * 77, 512, 768))


def _launcher(nproc: int, args, out_dir: str, log_path: Optional[str] = None,
              stop_after: int = 0):
    """``python -m torch.distributed.run --standalone --nproc_per_node=N``
    (``torchrun``) in a child process; with ``stop_after``, SIGTERM to rank
    0 (its pid in ``out_dir/pid_rank0``) once ``log_path`` holds that many
    train records.  Returns (exit code, seconds, records seen, output)."""
    import signal

    launch = _launch(nproc, args)
    proc, seen = launch["proc"], None
    try:
        while stop_after and proc.poll() is None:
            n = 0
            if os.path.exists(log_path):
                n = sum(1 for r in _jsonl(log_path) if "train_loss" in r)
            pid_file = os.path.join(out_dir, "pid_rank0")
            if n >= stop_after and os.path.exists(pid_file):
                os.kill(int(open(pid_file).read()), signal.SIGTERM)
                seen = n
                break
            time.sleep(0.02)
    except BaseException:
        _launch_stop(launch)
        raise
    rc, seconds, output = _launch_wait(launch)
    return rc, seconds, seen, output


def _launch(nproc: int, args) -> dict:
    """Start ``torchrun --standalone --nproc_per_node=N args`` in a child
    process, its output read on a thread; :func:`_launch_wait` ends it."""
    env = dict(os.environ, PYTHONPATH=REPO, WANDB_MODE="disabled", OMP_NUM_THREADS="2")
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={nproc}", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    output: list = []
    reader = threading.Thread(target=lambda: output.extend(proc.stdout), daemon=True)
    reader.start()
    return dict(proc=proc, output=output, reader=reader, t=t, result=None)


def _launch_stop(launch: dict) -> None:
    proc = launch["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _launch_wait(launch: dict):
    """Wait for a :func:`_launch` (at most ``DP_PROCESS_TIMEOUT`` seconds;
    a launch past it is killed) → (exit code, seconds, output)."""
    if launch["result"] is None:
        try:
            rc = launch["proc"].wait(timeout=DP_PROCESS_TIMEOUT)
        finally:
            _launch_stop(launch)
        seconds = time.perf_counter() - launch["t"]
        launch["reader"].join(timeout=10)
        output = launch["output"]
        if rc != 0:
            print("".join(output[-80:]), file=sys.stderr)
        launch["result"] = (rc, seconds, "".join(output))
    return launch["result"]


class _TimedSetupAndSaves:
    """Time the CLI's ``create_train_setup`` (the model drawn from the seed
    on the card, the optimizer) and each ``checkpoints.save_weights``
    (the full view put together, the JAX layout, the npz written) in this
    process; :meth:`close` puts both back."""

    def __init__(self):
        from sparsify_clip_tpu_torch import checkpoints, train

        self.setup_s, self.saves = [], []
        setup, save = train.create_train_setup, checkpoints.save_weights

        def timed_setup(*args, **kwargs):
            t = time.perf_counter()
            out = setup(*args, **kwargs)
            torch.cuda.synchronize()
            self.setup_s.append(time.perf_counter() - t)
            return out

        def timed_save(model, path):
            t = time.perf_counter()
            out = save(model, path)
            self.saves.append(dict(path=out, seconds=time.perf_counter() - t))
            return out

        train.create_train_setup, checkpoints.save_weights = timed_setup, timed_save
        self._restore = lambda: (setattr(train, "create_train_setup", setup),
                                 setattr(checkpoints, "save_weights", save))

    def close(self):
        self._restore()


def cli_rank_main(yaml_path: str, out_dir: str, go: str = "") -> int:
    """One rank of phases 40 and 43: ``sparsify_clip_tpu_torch.cli``'s
    entry point under the launcher, with the kernels' launches of every
    step and eval counted and written to ``out_dir/counts_rank<r>.json``
    beside each step's ms and each eval's seconds (between two
    synchronizations), the setup's and each weights save's seconds and
    the peak device memory; ``go``: held at that gate first."""
    from sparsify_clip_tpu_torch import cli

    if go:
        _wait_for_go(go)
    rank = os.environ.get("RANK", "0")
    with open(os.path.join(out_dir, f"pid_rank{rank}"), "w") as fh:
        fh.write(str(os.getpid()))
    counter, timers = _PerStepCounts(timed=True), _TimedSetupAndSaves()
    try:
        reset_counts()
        cli.cli(["--config", yaml_path])
        launches = read_counts()
    finally:
        counter.close()
        timers.close()
    with open(os.path.join(out_dir, f"counts_rank{rank}.json"), "w") as fh:
        json.dump(dict(launches=launches, steps=counter.steps, evals=counter.evals,
                       step_ms=counter.step_ms, eval_seconds=counter.eval_seconds,
                       setup_s=timers.setup_s, saves=timers.saves,
                       peak=torch.cuda.max_memory_allocated()), fh)
    return 0


def phase_torchrun_nccl(smi: str, phase19: dict):
    """Phase 40: the CLI under ``torchrun`` at world = the card count over
    NCCL, on phase 19's YAML (full-width ViT-B-32 exp 6 at global batch
    256): SIGTERM after the first main-phase train record, then
    ``resume_checkpoint: "auto"`` through ``python -m
    torch.distributed.run ... -m sparsify_clip_tpu_torch.cli``; the per-step
    losses and the final npz against phase 19's run without the launcher
    (bit-identical at world 1)."""
    import tempfile

    world = torch.cuda.device_count()
    run = "exp6-vitb32"
    spe = CLI_EXP6_SAMPLES // EXP6["batch_size"]
    # phase 19's YAML with one eval batch and no epoch-end full state (1.8
    # GB a save), which change no train number: the SIGTERM writes the
    # full state the resume reads
    fields = dict(num_train_samples=CLI_EXP6_SAMPLES, num_test_samples=EXP6["batch_size"],
                  save_checkpoint_every_n_epochs=EXP6_EPOCHS + 1)
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "logs", f"{run}.jsonl")
        rc, stop_seconds, seen, out = _launcher(
            world, [os.path.join(REPO, "chip_smoke.py"), "--cli-rank",
                    _write_exp6_yaml(tmp, **fields), tmp],
            tmp, log_path, stop_after=spe + 1)
        stopped = _jsonl(log_path)
        saved = sorted(os.listdir(os.path.join(tmp, "models", run)))
        if rc != 0 or not any(r.get("preempted") for r in stopped) or len(saved) != 1:
            raise AssertionError(f"phase 40: the torchrun SIGTERM run exited {rc} with {saved}")
        with open(os.path.join(tmp, "counts_rank0.json")) as fh:
            counts = json.load(fh)
        stopped_at = len([r for r in stopped if "train_loss" in r])
        rc, resume_seconds, _, out = _launcher(
            world, ["-m", "sparsify_clip_tpu_torch.cli", "--config",
                    _write_exp6_yaml(tmp, resume_checkpoint="auto", **fields)], tmp)
        if rc != 0:
            raise AssertionError(f"phase 40: the torchrun resume exited {rc}")
        records = _jsonl(log_path)
        with np.load(os.path.join(tmp, "models", f"{run}.npz")) as f:
            npz_identical = _npz_digest(f) == phase19["npz_digest"]
    starts = [r for r in records if r.get("event") == "run_start"]
    route = "kernel" if world == 1 else "ring"
    want_parallel = {"world_size": world, "backend": "nccl", "loss_route": route}
    if len(starts) != 2 or any(r["parallel"] != want_parallel for r in starts):
        raise AssertionError(f"phase 40: run_start records {[r.get('parallel') for r in starts]}"
                             f", expected {want_parallel}")
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    want = phase19["losses"]
    # the stopped run: before training and after each epoch it finished;
    # the resumed run: before, after each epoch left, and the final one
    expected = 1 + (stopped_at - 1) // spe + 1 + (EXP6_EPOCHS - stopped_at // spe) + 1
    evals = _check_evals(records, expected, "the torchrun runs")
    identical = losses == want
    zero = dict.fromkeys(KERNELS, 0)
    warm = dict(zero, mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2)
    main = dict(zero, mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
    if world == 1:  # over several ranks the rings replace the loss kernels
        _expect_launches([tuple(s) for s in counts["steps"]],
                         [(k, warm if k < spe else main) for k in range(stopped_at)],
                         "the torchrun run's steps")
    log("phase 40 torchrun", world=world, backend="nccl", loss_route=route,
        sigterm_after_records=seen, stopped_at_step=stopped_at, full_state=json.dumps(saved),
        losses=json.dumps(losses), losses_without_launcher=json.dumps(want),
        losses_bit_identical=identical, npz_bit_identical=npz_identical, evals=len(evals),
        launches=json.dumps(counts["launches"]), stop_run_s=f"{stop_seconds:.3f}",
        resume_run_s=f"{resume_seconds:.3f}", card=json.dumps(smi))
    if stopped_at <= spe:
        raise AssertionError(f"phase 40: the counted run stopped at step {stopped_at}, before "
                             "a main-phase step")
    if len(losses) != EXP6_EPOCHS * spe or (world == 1 and not (identical and npz_identical)):
        raise AssertionError("phase 40: the torchrun run and the run without the launcher "
                             "disagree")
    if world > 1 and max(_rel_gap(a, b) for a, b in zip(losses, want)) > TRAIN_LOSS_RTOL:
        raise AssertionError("phase 40: the NCCL data-parallel losses left phase 9's tolerance")
    return dict(launches=counts["launches"])


def _dp_unit_rows(seed: int):
    rng = np.random.default_rng(seed)
    n, d = DP_LOSS_SHAPE
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dp_ring_losses(mesh, device):
    """The ring losses (and the gathered SigLIP) on this rank's rows of
    the global (256, 512) batch → values, scalar gradients and the rows'
    gradients; at one rank, the kernels (rows 5-9) and ``siglip_loss`` on
    the whole batch."""
    from sparsify_clip_tpu_torch.losses import normalized_centroids, siglip_loss
    from sparsify_clip_tpu_torch.ops.infonce import infonce_loss
    from sparsify_clip_tpu_torch.ops.lunif import lunif_loss
    from sparsify_clip_tpu_torch.parallel import dist_losses as dl
    from sparsify_clip_tpu_torch.parallel.mesh import all_gather

    img_all, txt_all = _dp_unit_rows(SEED + 40), _dp_unit_rows(SEED + 41)
    rows = slice(None) if mesh is None else mesh.batch_slice(img_all.shape[0])
    ring = mesh is not None
    fns = {
        "ring_infonce": lambda i, t, s: (dl.ring_infonce_loss(i, t, s["T"], mesh) if ring
                                         else infonce_loss(i, t, s["T"])),
        "ring_lunif": lambda i, t, s: dl.ring_lunif_loss(i, mesh) if ring else lunif_loss(i),
        "ring_lunif_centroids": lambda i, t, s: (
            dl.ring_lunif_loss(dl.global_normalized_centroids(i, t), mesh) if ring
            else lunif_loss(normalized_centroids(i, t))),
        "gathered_siglip": lambda i, t, s: siglip_loss(
            *((all_gather(i, mesh), all_gather(t, mesh)) if ring else (i, t)),
            s["scale"], s["bias"]),
    }
    values, arrays = {}, {}
    for name, fn in fns.items():
        i = torch.tensor(img_all[rows], device=device, requires_grad=True)
        t = torch.tensor(txt_all[rows], device=device, requires_grad=True)
        scalars = {k: torch.tensor(v, device=device, requires_grad=True)
                   for k, v in (("T", 0.1), ("scale", 10.0), ("bias", -10.0))}
        loss = fn(i, t, scalars)
        loss.backward()
        values[name] = {"loss": loss.item(),
                        **{f"d{k}": (0.0 if v.grad is None else v.grad.item())
                           for k, v in scalars.items()}}
        arrays[f"{name}/dimg"] = i.grad.cpu().numpy()
        arrays[f"{name}/dtxt"] = (t.grad if t.grad is not None
                                  else torch.zeros_like(t)).cpu().numpy()
    return values, arrays


_DP_BATCHES: dict = {}  # (image size, context, step) -> the global batch of that step


def _dp_batch(cfg, k: int) -> dict:
    """The global batch of step ``k`` of ``_dp_steps`` for a model of
    ``cfg``'s input shapes, made once a process (every run here reads it)."""
    from sparsify_clip_tpu_torch.data import synthetic_batch

    key = (cfg.image_size, cfg.context_length, k)
    if key not in _DP_BATCHES:
        _DP_BATCHES[key] = synthetic_batch(TRAIN_BATCH, cfg.image_size, cfg.context_length,
                                           seed=SEED + k)
    return _DP_BATCHES[key]


def _dp_steps(model: str, dtype: str, mesh, device, keep: bool = False,
              fields: Optional[dict] = None):
    """``DP_STEPS`` exp-6 steps of full-width ``model`` at global batch 256
    on this rank's rows, in ``dtype`` (``"bf16"`` or ``"fp32"``) compute,
    with the config ``fields`` (a layout, ``fused_ln_qkv``): the losses,
    the launches a step, the timed steps' ms, a sha256 of the parameters
    and buffers, the bytes of this rank's parameters and AdamW moments,
    its peak device memory over the steps, and, with ``keep``, the first
    step's gradients and the final parameters and running statistics on
    the host (under ``saved``; one process also keeps the seed's
    parameters).  A laid-out model's parameters and gradients are put
    back together first (every rank takes part)."""
    from sparsify_clip_tpu_torch.checkpoints import full_parameters
    from sparsify_clip_tpu_torch.config import ExperimentConfig
    from sparsify_clip_tpu_torch.parallel.mesh import digest
    from sparsify_clip_tpu_torch.train import batch_to_device, create_train_setup

    t0 = time.perf_counter()
    config = ExperimentConfig.from_dict(dict(EXP6, model=model, epochs=EXP6_EPOCHS,
                                             fp16=dtype == "bf16", **(fields or {})))
    setup = create_train_setup(config, steps_per_epoch=DP_SPE, device=device, mesh=mesh)
    setup_s = time.perf_counter() - t0
    cfg = setup.model.cfg
    layout = getattr(setup.model, "layout", None)

    def full_grads():
        grads = {n: p.grad.detach() for n, p in setup.model.named_parameters()}
        if layout is not None:  # a pipeline's other stages' blocks too
            grads = layout.full_named(grads)
        return {n: g.cpu() for n, g in grads.items()}

    saved = {}
    if keep and mesh is None:
        saved["init"] = {n: p.detach().cpu() for n, p in setup.model.named_parameters()}
    losses, counts, ms = [], [], []
    params_bytes = sum(p.numel() * p.element_size() for p in setup.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in range(DP_STEPS):
        batch = _dp_batch(cfg, k)
        if mesh is not None:
            batch = {key: v[mesh.batch_slice(TRAIN_BATCH)] for key, v in batch.items()}
        batch = batch_to_device(batch, device)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        setup.state, metrics = setup.train_step(setup.state, batch)
        losses.append(float(metrics["train_loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        counts.append(read_counts())
        if k == 0 and (keep or layout is not None):
            grads = full_grads()
            if keep:
                saved["grads"] = grads
    peak = torch.cuda.max_memory_allocated()
    moments = [t for st in setup.state.optimizer.state.values() for key, t in st.items()
               if key in ("exp_avg", "exp_avg_sq")]
    params = full_parameters(setup.model)
    out = dict(losses=losses, counts=counts, step_ms=ms,
               digest=digest([params[n] for n in sorted(params)]
                             + list(setup.model.buffers())), setup_s=setup_s,
               bytes=dict(params=params_bytes,
                          moments=sum(t.numel() * t.element_size() for t in moments)),
               peak_gib=peak / 2**30)
    if keep:
        saved["params"] = {n: p.detach().cpu() for n, p in params.items()}
        saved["buffers"] = {n: b.detach().cpu() for n, b in setup.model.named_buffers()}
        out["saved"] = saved
    del setup
    torch.cuda.empty_cache()
    return out


def _dp_eval(mesh, device):
    """The 13 metrics of ViT-B-32's fp32 eval twin (from the seed) over
    ``DP_EVAL_PAIRS`` synthetic pairs, each rank encoding its rows."""
    from sparsify_clip_tpu_torch.data import synthetic_batch
    from sparsify_clip_tpu_torch.eval import evaluate_model, make_eval_model
    from sparsify_clip_tpu_torch.models.clip import create_model

    model = create_model("ViT-B-32", dtype=torch.bfloat16, device=device, seed=SEED,
                         param_dtype=torch.float32)
    twin = make_eval_model(model)
    batches = []
    for k in range(DP_EVAL_PAIRS // TRAIN_BATCH):
        batch = synthetic_batch(TRAIN_BATCH, 224, 77, seed=SEED + 20 + k)
        if mesh is not None:
            batch = {key: v[mesh.batch_slice(TRAIN_BATCH)] for key, v in batch.items()}
        batches.append(batch)
    reset_counts()
    metrics = evaluate_model(twin, batches, mesh=mesh)
    launches = read_counts()
    del model, twin
    torch.cuda.empty_cache()
    return metrics, launches


def dp_rank_main(plan_path: str) -> int:
    """One gloo rank of phase 41 on card 0 (under the launcher): the plan's
    jobs on this rank's rows, written to the plan's directory."""
    from sparsify_clip_tpu_torch.parallel.mesh import create_mesh
    from sparsify_clip_tpu_torch.parallel.multihost import (
        initialize_distributed, shutdown_distributed,
    )

    with open(plan_path) as fh:
        plan = json.load(fh)
    if plan.get("fault"):
        _dp_fault(plan["fault"])
    if plan.get("go"):
        _wait_for_go(plan["go"])
    t = time.perf_counter()
    device = initialize_distributed(None, backend="gloo")
    mesh = create_mesh()
    out_dir, result = plan["dir"], {"device": str(device), "backend": mesh.backend}
    seconds = result["seconds"] = {"init": time.perf_counter() - t}
    t = time.perf_counter()
    if "losses" in plan["jobs"]:
        result["losses"], arrays = _dp_ring_losses(mesh, device)
        np.savez(os.path.join(out_dir, f"losses_rank{mesh.rank}.npz"), **arrays)
        seconds["losses"], t = time.perf_counter() - t, time.perf_counter()
    for job in plan["jobs"]:
        if job.startswith("step:"):  # step:<model>:<dtype>
            _, model, dtype = job.split(":")
            result[job] = _dp_steps(model, dtype, mesh, device, keep=mesh.rank == 0)
            if mesh.rank == 0:  # rank 0's tensors for the comparison
                torch.save(result[job].pop("saved"), os.path.join(out_dir, f"{model}_{dtype}.pt"))
            seconds[job], t = time.perf_counter() - t, time.perf_counter()
    for job in plan["jobs"]:
        if job.startswith("layout:"):  # layout:<name> of DP_LAYOUT_RUNS
            name, _, model, dtype, fields = _layout_run(job.split(":")[1])
            lmesh = create_mesh(model=fields.get("mesh_model", 1))
            keep = lmesh.rank == 0 and name not in DP_SAME_AS_STEP
            result[job] = _dp_steps(model, dtype, lmesh, device, keep=keep, fields=fields)
            result[job]["mesh"] = [lmesh.data, lmesh.model]
            if keep:
                torch.save(result[job].pop("saved"), os.path.join(out_dir, f"layout_{name}.pt"))
            else:
                result[job].pop("saved", None)
            seconds[job], t = time.perf_counter() - t, time.perf_counter()
    for job in plan["jobs"]:
        if job.startswith("cli_pp:"):  # cli_pp:<yaml>, phase 44
            result[job] = _cli_pp_job(job.split(":", 1)[1], mesh.rank, device)
            seconds[job], t = time.perf_counter() - t, time.perf_counter()
    if "eval" in plan["jobs"]:
        result["eval"], result["eval_launches"] = _dp_eval(mesh, device)
        seconds["eval"] = time.perf_counter() - t
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as fh:
        json.dump(result, fh)
    shutdown_distributed()
    return 0


def _layout_run(name: str):
    return next(run for run in DP_LAYOUT_RUNS if run[0] == name)


def _layout_reference_key(model: str, dtype: str, fields: dict) -> tuple:
    """The one-process run a layout run is held against."""
    return (model, dtype, "fused") if fields.get("fused_ln_qkv") else (model, dtype)


def _dp_fault(name: str) -> None:
    """Break this rank's data-parallel step on purpose, for
    ``scripts/dp_gate_faults.py``: ``grad_mean`` averages the gradients
    over the ranks (DDP's mean: every gradient 1/W of the global loss's),
    ``no_grad_allreduce`` steps each rank on its own rows' share of the
    gradient, ``local_bn`` takes RN50's BatchNorm statistics over the
    rank's rows."""
    from sparsify_clip_tpu_torch import train

    summed = train.all_reduce_gradients
    if name == "grad_mean":
        def mean(params, mesh):
            params = list(params)
            summed(params, mesh)
            for p in params:
                p.grad.div_(mesh.data)
        train.all_reduce_gradients = mean
    elif name == "no_grad_allreduce":
        train.all_reduce_gradients = lambda params, mesh: None
    elif name == "local_bn":
        train.set_data_parallel = lambda model, mesh: None
    else:
        raise ValueError(f"unknown fault {name!r}")


def _dp_grad_readings(grads_a: dict, grads_b: dict, world: int) -> dict:
    """Per-tensor first-step gradients of a data-parallel run (a) against
    one process (b): the worst cosine and the largest relative norm gap,
    each with its tensor, and that gap if a's gradients were W times or
    1/W their size (the smaller of the two).  Left out: the attention
    pool's key bias and the key third of each fused qkv bias (true
    gradient 0), and a tensor whose gradient is under 1e-4 of the largest
    tensor gradient's norm (a BatchNorm bias that feeds a conv and another
    train-mode BatchNorm: its gradient is rounding noise,
    tests/test_torch_port_rn50.py)."""
    floor = 1e-4 * max(b.norm().item() for b in grads_b.values())
    worst, worst_cos, widest, norm_gap, scaled = None, 2.0, None, 0.0, {world: 0.0, 1 / world: 0.0}
    for name, a in grads_a.items():
        b = grads_b[name]
        if name in ZERO_GRADIENT or b.norm().item() < floor:
            continue
        if name.endswith("in_proj_bias"):
            w = a.shape[0] // 3
            a, b = torch.cat([a[:w], a[2 * w:]]), torch.cat([b[:w], b[2 * w:]])
        cos = _cosine(a.cuda(), b.cuda())
        if cos < worst_cos:
            worst, worst_cos = name, cos
        ratio = a.norm().item() / b.norm().item()
        if abs(ratio - 1) > norm_gap:
            widest, norm_gap = name, abs(ratio - 1)
        for k in scaled:
            scaled[k] = max(scaled[k], abs(k * ratio - 1))
    return dict(min_grad_cosine=worst_cos, min_at=worst, grad_norm_rel_gap=norm_gap,
                norm_gap_at=widest, grad_norm_rel_gap_if_scaled=min(scaled.values()))


def _dp_step_readings(runs: list, got: dict, ref_run: dict, ref: dict, world: int) -> dict:
    """Every gate's reading of a data-parallel run (``runs``: each rank's
    results; ``got``: rank 0's tensors) against the one-process run from
    the same seed and batches (``ref_run``, ``ref``)."""
    gaps = [_rel_gap(a, b) for a, b in zip(runs[0]["losses"], ref_run["losses"])]
    num = sum(((got["params"][n] - p).double().square().sum().item()
               for n, p in ref["params"].items()))
    den = sum(((p - ref["init"][n]).double().square().sum().item()
               for n, p in ref["params"].items()))
    stats = ref["buffers"]
    return dict(
        first_loss_rel_gap=gaps[0], later_loss_rel_gap=max(gaps[1:]),
        **_dp_grad_readings(got["grads"], ref["grads"], world),
        update_rel_gap=math.sqrt(num / den),
        stats_max_abs_diff=max(((got["buffers"][n] - b).abs().max().item()
                                for n, b in stats.items()), default=0.0),
        stats_scale=max((b.abs().max().item() for b in stats.values()), default=0.0),
        ranks_bit_identical=len({r["digest"] for r in runs}) == 1)


def _dp_gates(key: tuple) -> dict:
    """Phase 41's limits for (model, dtype) ``key``."""
    return dict(first=DP_FIRST_LOSS_RTOL, later=DP_LATER_LOSS_RTOL[key],
                grad_norm=DP_GRAD_NORM_RTOL[key], update=DP_UPDATE_RTOL[key])


def _dp_gates_fired(key: tuple, r: dict, gates: Optional[dict] = None) -> list:
    """The gates that a data-parallel run's readings ``r`` fire, for
    (model, dtype) ``key`` (or the limits ``gates``)."""
    g = gates or _dp_gates(key)
    fired = {
        "ranks_bit_identical": not r["ranks_bit_identical"],
        "first_loss": r["first_loss_rel_gap"] > g["first"],
        "later_loss": r["later_loss_rel_gap"] > g["later"],
        "grad_cosine": r["min_grad_cosine"] < TRAIN_MIN_GRAD_COSINE,
        "grad_norm": r["grad_norm_rel_gap"] > g["grad_norm"],
        "update": r["update_rel_gap"] > g["update"],
        "running_stats": r["stats_max_abs_diff"] > TRAIN_LOSS_RTOL * r["stats_scale"],
    }
    return [name for name, bad in fired.items() if bad]


def _dp_references(device, step_runs=DP_STEP_RUNS, layout_runs=DP_LAYOUT_RUNS):
    """The one-process runs phase 41 holds the ranks against: the ring
    losses on the whole batch, each (model, dtype) step run with its
    tensors (and the fused one phase 42's ``layout_runs`` need), the
    eval's metrics, and their seconds."""
    t = time.perf_counter()
    losses, arrays = _dp_ring_losses(None, device)
    steps = {(m, d): _dp_steps(m, d, None, device, keep=True) for m, d, _ in step_runs}
    # phase 42's tensor-parallel run takes the fused LN+qkv
    for _, _, model, dtype, fields in layout_runs:
        key = _layout_reference_key(model, dtype, fields)
        if key not in steps:
            steps[key] = _dp_steps(model, dtype, None, device, keep=True,
                                   fields=dict(fused_ln_qkv=bool(fields.get("fused_ln_qkv"))))
    saved = {key: run.pop("saved") for key, run in steps.items()}
    metrics, _ = _dp_eval(None, device)
    torch.cuda.empty_cache()
    return dict(losses=losses, arrays=arrays, steps=steps, saved=saved, eval=metrics,
                seconds=time.perf_counter() - t)


def _dp_launch(world: int, jobs: list, fault: Optional[str] = None):
    """``world`` gloo ranks on card 0 running ``jobs`` (with ``fault``, a
    broken step) → (each rank's results, its ring-loss arrays, rank 0's
    step tensors by (model, dtype), seconds)."""
    return _dp_launch_finish(_dp_launch_start(world, jobs, fault))


def _dp_launch_start(world: int, jobs: list, fault: Optional[str] = None,
                     go: Optional[str] = None) -> dict:
    """Start :func:`_dp_launch`'s ranks (with ``go``, held at that gate,
    :func:`_wait_for_go`); :func:`_dp_launch_finish` reads them."""
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    plan = os.path.join(tmp.name, "plan.json")
    with open(plan, "w") as fh:
        json.dump(dict(dir=tmp.name, jobs=jobs, fault=fault, go=go), fh)
    launch = _launch(world, [os.path.join(REPO, "chip_smoke.py"), "--dp-rank", plan])
    return dict(launch=launch, tmp=tmp, world=world, jobs=jobs, go=go)


def _dp_launch_finish(pending: dict):
    world, jobs, tmp = pending["world"], pending["jobs"], pending["tmp"].name
    try:
        rc, seconds, _ = _launch_wait(pending["launch"])
        if rc != 0:
            raise AssertionError(f"phase 41: {world} gloo ranks exited {rc}")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        rows = ([dict(np.load(os.path.join(tmp, f"losses_rank{r}.npz"))) for r in range(world)]
                if "losses" in jobs else [])
        saved = {}
        for job in jobs:
            if job.startswith("step:"):
                _, model, dtype = job.split(":")
                saved[(model, dtype)] = torch.load(os.path.join(tmp, f"{model}_{dtype}.pt"))
            if job.startswith("layout:") and job.split(":")[1] not in DP_SAME_AS_STEP:
                name = job.split(":")[1]
                saved[name] = torch.load(os.path.join(tmp, f"layout_{name}.pt"))
    finally:
        pending["tmp"].cleanup()
    if any(not r["device"].startswith("cuda") or r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"phase 41: ranks on {[r['device'] for r in ranks]}")
    return ranks, rows, saved, seconds


def phase_tp_kernels(smi: str):
    """Phase 42, first part: rows 1 and 3 at ViT-B-32's tensor-parallel
    shapes at tp 2 (each rank's heads) and rows 10 and 11 at its local
    3W/tp columns, in bf16, against their plain versions under phase 2's,
    phase 6's and phase 15's tolerances, timed beside their library
    yardsticks and their bound."""
    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd, mha_bwd_reference, mha_fwd, mha_fwd_reference,
    )
    from sparsify_clip_tpu_torch.ops.ln_qkv import (
        ln_fast_bwd, ln_fast_bwd_reference, ln_qkv_fwd, ln_qkv_reference,
    )

    F = torch.nn.functional
    rng = np.random.default_rng(SEED + 42)
    dt = torch.bfloat16

    def normal(shape, std=1.0, dtype=dt):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(
            "cuda", dtype)

    results = {}
    rtol, atol = KERNEL_TOL["bfloat16"]
    for name, b, l, heads, causal in TP_ATTENTION:
        head_dim = 64
        width = heads * head_dim
        pairs = b * heads * attention_pairs(l, causal)
        qkv = normal((b, l, 3 * width))
        got, got_lse = mha_fwd(qkv, heads, causal, with_lse=True)
        want, want_lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
        err = (got.float() - want.float()).abs().max().item()
        del got, want, want_lse
        ms = cuda_ms(lambda: mha_fwd(qkv, heads, causal), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: mha_fwd_reference(qkv, heads, causal), iters=5, warmup=1)
        sdpa_ms, library = sdpa_fwd_ms(qkv, heads, causal, iters=20, warmup=3)
        fb = bound(b * l * 4 * width * 2, 2 * 2 * pairs * head_dim, "bfloat16")
        results[f"mha_fwd/tp2-{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms[library],
            library=f"sdpa/{library}", bound_ms=fb[0], bound_by=fb[1],
            shape=[b, l, 3 * width], heads=heads, causal=causal)
        dout = normal((b, l, width))
        got = mha_bwd(qkv, got_lse, dout, heads, causal)
        want = mha_bwd_reference(qkv, got_lse, dout, heads, causal)
        torch.cuda.synchronize()
        brtol, batol = BWD_TOL["bfloat16"]
        torch.testing.assert_close(got.float(), want.float(), rtol=brtol, atol=batol)
        bwd_err = (got.float() - want.float()).abs().max().item()
        del got, want
        bwd_ms = cuda_ms(lambda: mha_bwd(qkv, got_lse, dout, heads, causal), iters=10, warmup=2)
        bwd_plain = cuda_ms(lambda: mha_bwd_reference(qkv, got_lse, dout, heads, causal),
                            iters=3, warmup=1)
        sdpa_bwd, bwd_library = sdpa_bwd_ms(qkv, dout, heads, causal, iters=10, warmup=2)
        bb = bound(b * l * (3 * width * 2 + width) * 2 + b * l * heads * 4,
                   5 * 2 * pairs * head_dim, "bfloat16")
        results[f"mha_bwd/tp2-{name}"] = dict(
            max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain,
            library_ms=sdpa_bwd[bwd_library], library=f"sdpa/{bwd_library}",
            bound_ms=bb[0], bound_by=bb[1], shape=[b, l, 3 * width], heads=heads, causal=causal)
        del qkv, dout, got_lse

    eps = 1e-5
    for name, n, w, cols in TP_LN_QKV:
        x = normal((n, w))
        scale, bias = 1 + normal((w,), 0.1, torch.float32), normal((w,), 0.1, torch.float32)
        weight = normal((cols, w), w ** -0.5, torch.float32)
        kbias = normal((cols,), 0.1, torch.float32)
        args = (x, scale, bias, weight, kbias, eps, dt)
        got, want = ln_qkv_fwd(*args), ln_qkv_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        err = (got.float() - want.float()).abs().max().item()
        if got.shape != (n, cols) or not torch.equal(got, ln_qkv_fwd(*args)):
            raise AssertionError(f"ln_qkv_fwd/tp2-{name}: shape {tuple(got.shape)} or two runs "
                                 "differ")
        del got, want
        ms = cuda_ms(lambda: ln_qkv_fwd(*args), iters=20, warmup=2)
        plain_ms = cuda_ms(lambda: ln_qkv_reference(*args), iters=20, warmup=2)
        sc, bi, wt, kb = (t.to(dt) for t in (scale, bias, weight, kbias))
        library_ms = cuda_ms(lambda: F.linear(F.layer_norm(x, (w,), sc, bi, eps), wt, kb),
                             iters=20, warmup=2)
        lb = bound((n * w + cols * w + cols + n * cols) * 2 + 2 * w * 4, 2 * n * w * cols,
                   "bfloat16")
        results[f"ln_qkv_fwd/tp2-{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library="F.linear(F.layer_norm(x)), two calls", bound_ms=lb[0], bound_by=lb[1],
            shape=[n, w, cols])
        # the backward's LayerNorm at the rank's rows: dy = g·W over its columns
        dy = torch.matmul(normal((n, cols)), weight.to(dt))
        bargs = (x, dy, scale, bias, eps, dt)
        got, want = ln_fast_bwd(*bargs), ln_fast_bwd_reference(*bargs)
        torch.cuda.synchronize()
        errs = {}
        for part, a, ref in zip(("y", "dx", "dscale", "dbias"), got, want):
            big = ref.float().abs().max().item()
            tol = (dict(rtol=LN_BWD_STEP["bfloat16"], atol=LN_BWD_CANCEL * big)
                   if part in ("y", "dx")
                   else dict(rtol=LN_BWD_GRAD_TOL[0], atol=LN_BWD_GRAD_TOL[1] * big))
            torch.testing.assert_close(a.float(), ref.float(),
                                       msg=f"ln_fast_bwd/tp2-{name} {part}", **tol)
            errs[part] = (a.float() - ref.float()).abs().max().item()
        del got, want
        bwd_ms = cuda_ms(lambda: ln_fast_bwd(*bargs), iters=20, warmup=2)
        bwd_plain = cuda_ms(lambda: ln_fast_bwd_reference(*bargs), iters=5, warmup=2)
        mean_rstd = torch.native_layer_norm(x, [w], sc, bi, eps)[1:]

        def library():
            torch.ops.aten.native_layer_norm_backward(dy, x, [w], *mean_rstd, sc, bi,
                                                      [True, True, True])
            F.layer_norm(x, (w,), sc, bi, eps)

        bwd_library = cuda_ms(library, iters=20, warmup=2)
        bbound = bound(4 * n * w * 2 + 4 * w * 4, 14 * n * w, "bfloat16")
        results[f"ln_fast_bwd/tp2-{name}"] = dict(
            max_abs_err=errs["dx"], ms=bwd_ms, plain_ms=bwd_plain, library_ms=bwd_library,
            library="native_layer_norm_backward + F.layer_norm, two calls",
            bound_ms=bbound[0], bound_by=bbound[1], shape=[n, w])
        del x, dy, args, bargs, weight, wt, mean_rstd
    for case, r in results.items():
        kernel, name = case.split("/")
        log("phase 42 kernel", kernel=kernel, case=name, shape=json.dumps(r["shape"]),
            max_abs_err=r["max_abs_err"], ms=f"{r['ms']:.5f}", plain_ms=f"{r['plain_ms']:.5f}",
            library_ms=f"{r['library_ms']:.5f}", library=r["library"],
            bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"], card=json.dumps(smi))
    torch.cuda.empty_cache()
    return results


class _Background:
    """``fn(*args)`` on a thread from now; :meth:`join` returns its result
    or raises what it raised."""

    def __init__(self, fn, *args):
        self.result, self.error = None, None

        def run():
            try:
                self.result = fn(*args)
            except BaseException as e:  # re-raised in join
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def _dp_jobs(world: int):
    """Phase 41's and 42's runs at ``world`` ranks → (the (model, dtype)
    steps, the layout runs, the jobs of the launch)."""
    steps = [(m, d) for m, d, worlds in DP_STEP_RUNS if world in worlds]
    layouts = [run for run in DP_LAYOUT_RUNS if run[1] == world]
    jobs = (["losses"] + [f"step:{m}:{d}" for m, d in steps]
            + (["eval"] if world == 2 else []) + [f"layout:{run[0]}" for run in layouts])
    return steps, layouts, jobs


def phase_dp_gloo(smi: str):
    """Phase 41: 2 and 4 ranks on card 0 over gloo, every tensor on the
    card: the ring losses against rows 5-9, full-width ViT-B-32 (bf16 at
    world 2, fp32 at world 4) and RN50 (fp32, world 2) data-parallel steps
    against the one-process step on the same global batch, and the sharded
    eval (world 2) against the one-process eval.  Phase 42 runs in the
    same launches: the sharded layouts of ``DP_LAYOUT_RUNS``.  The
    launches of every world run at once, beside phase 40's, and this
    process reads them in turn."""
    # the ranks start first: their start-up (the interpreter, the imports)
    # runs beside the one-process references
    pending = [_dp_launch_start(world, _dp_jobs(world)[2]) for world in DP_WORLDS]
    readings, launches, failed = {}, {}, []
    try:
        ref = _dp_references(torch.device("cuda"))
        while pending:
            world = pending[0]["world"]
            steps, layouts, _ = _dp_jobs(world)
            ranks, rows, saved, seconds = _dp_launch_finish(pending.pop(0))
            _dp_check_world(smi, world, steps, layouts, ranks, rows, saved, seconds, ref,
                            readings, launches, failed)
    finally:
        for launch in pending:
            _launch_stop(launch["launch"])
            launch["tmp"].cleanup()
    log("phase 41 rate", step_ms=json.dumps({k: round(v, 3) for k, v in readings.items()}),
        step_ms_one_process=json.dumps({"_".join(key): round(float(np.mean(run["step_ms"][1:])), 3)
                                        for key, run in ref["steps"].items()}),
        reference_seconds=f"{ref['seconds']:.3f}",
        note="gloo on one card, the ranks beside phase 40's: not a multi-GPU speed",
        card=json.dumps(smi))
    if failed:
        raise AssertionError(f"phase 41: against one process: {failed}")
    return dict(launches=launches)


def _dp_check_world(smi: str, world: int, steps, layouts, ranks, rows, saved, seconds, ref,
                    readings: dict, launches: dict, failed: list) -> None:
    """Phase 41's and 42's readings of the launch at ``world`` ranks against
    the one-process references ``ref``, logged; into ``readings`` each
    run's step ms, into ``launches`` its launches, into ``failed`` what
    failed."""
    # 1. the ring losses against the kernels on the whole batch
    ring = {}
    for name in DP_RING_FNS:
        want = ref["losses"][name]
        values = [r["losses"][name] for r in ranks]
        dimg = np.concatenate([a[f"{name}/dimg"] for a in rows])
        dtxt = np.concatenate([a[f"{name}/dtxt"] for a in rows])
        want_dimg, want_dtxt = ref["arrays"][f"{name}/dimg"], ref["arrays"][f"{name}/dtxt"]
        err = max(float(np.abs(dimg - want_dimg).max()), float(np.abs(dtxt - want_dtxt).max()))
        rtol, atol = DP_GRAD_TOL
        ok = (all(v == values[0] for v in values)
              and _rel_gap(values[0]["loss"], want["loss"]) <= DP_VALUE_RTOL
              and np.allclose(dimg, want_dimg, rtol=rtol, atol=atol)
              and np.allclose(dtxt, want_dtxt, rtol=rtol, atol=atol)
              and all(_rel_gap(values[0][k], want[k]) <= DP_SCALAR_RTOL
                      for k in ("dT", "dscale", "dbias") if want[k] != 0.0))
        ring[name] = dict(loss=values[0]["loss"], loss_one_process=want["loss"],
                          max_abs_grad_err=err, ok=ok)
        if not ok:
            failed.append(f"{name} at {world} ranks")
    log(f"phase 41 rings w{world}", ranks=world, backend="gloo", shape=list(DP_LOSS_SHAPE),
        rings=json.dumps(ring), value_rtol=DP_VALUE_RTOL, grad_tol=list(DP_GRAD_TOL),
        scalar_rtol=DP_SCALAR_RTOL, seconds=f"{seconds:.3f}",
        rank0_seconds=json.dumps({k: round(v, 3) for k, v in ranks[0]["seconds"].items()}))
    # 2-3. the data-parallel steps against the one-process step
    step_readings = {}
    for key in steps:
        model, dtype = key
        runs = [r[f"step:{model}:{dtype}"] for r in ranks]
        r = step_readings[key] = _dp_step_readings(runs, saved[key], ref["steps"][key],
                                                   ref["saved"][key], world)
        fired = _dp_gates_fired(key, r)
        step_ms = float(np.mean(runs[0]["step_ms"][1:]))
        launches[f"train_dp_gloo_{model}_{dtype}_w{world}"] = {
            k: sum(c[k] for c in runs[0]["counts"]) for k in KERNELS}
        readings[f"{model}_{dtype}_w{world}"] = step_ms
        log(f"phase 41 step {model} {dtype} w{world}", ranks=world, backend="gloo",
            global_batch=TRAIN_BATCH, steps=DP_STEPS, losses=json.dumps(runs[0]["losses"]),
            losses_one_process=json.dumps(ref["steps"][key]["losses"]),
            readings=json.dumps(r), gates_fired=json.dumps(fired),
            first_rtol=DP_FIRST_LOSS_RTOL, later_rtol=DP_LATER_LOSS_RTOL[key],
            min_cosine=TRAIN_MIN_GRAD_COSINE, grad_norm_rtol=DP_GRAD_NORM_RTOL[key],
            update_rtol=DP_UPDATE_RTOL[key], stats_rtol=TRAIN_LOSS_RTOL,
            launches_first_step=json.dumps(runs[0]["counts"][0]),
            step_ms=f"{step_ms:.3f}",
            step_ms_one_process=f"{np.mean(ref['steps'][key]['step_ms'][1:]):.3f}",
            note="gloo moves every collective's bytes through the host: not a multi-GPU "
                 "speed", card=json.dumps(smi))
        # a gradient W times or 1/W its size must fire the norm gate
        if fired or r["grad_norm_rel_gap_if_scaled"] <= DP_GRAD_NORM_RTOL[key]:
            failed.append(f"the {model} {dtype} step at {world} ranks: {fired}")
    # 4. the sharded eval
    if world == 2:
        evals = [r["eval"] for r in ranks]
        gaps = {k: abs(evals[0][k] - ref["eval"][k]) for k in ref["eval"]}
        log("phase 41 eval w2", ranks=world, pairs=DP_EVAL_PAIRS, metrics=json.dumps(evals[0]),
            metrics_one_process=json.dumps(ref["eval"]), max_gap=max(gaps.values()),
            atol=DP_EVAL_ATOL, launches=json.dumps(ranks[0]["eval_launches"]))
        if (any(e != evals[0] for e in evals) or set(evals[0]) != set(ref["eval"])
                or max(gaps.values()) > DP_EVAL_ATOL):
            failed.append("the sharded eval")
    # phase 42: the sharded layouts against the one-process step
    for name, _, model, dtype, fields in layouts:
        runs = [r[f"layout:{name}"] for r in ranks]
        key, ref_key = (model, dtype), _layout_reference_key(model, dtype, fields)
        gates = DP_TP_GATES.get(name) or _dp_gates(key)
        if name in DP_SAME_AS_STEP:  # the plain step's readings (held bit for bit below)
            r = dict(step_readings[key],
                     ranks_bit_identical=len({run["digest"] for run in runs}) == 1)
        else:
            r = _dp_step_readings(runs, saved[name], ref["steps"][ref_key],
                                  ref["saved"][ref_key], world)
        fired = _dp_gates_fired(key, r, gates)
        problems = list(fired)
        if r["grad_norm_rel_gap_if_scaled"] <= gates["grad_norm"]:
            problems.append("a gradient W times or 1/W its size passes the norm gate")
        plain = ranks[0].get(f"step:{model}:{dtype}")
        same_as_dp = (plain is not None and runs[0]["losses"] == plain["losses"]
                      and runs[0]["digest"] == plain["digest"])
        if name == "zero1" and not same_as_dp:
            problems.append("ZeRO-1 is not bit-identical to the data-parallel step")
        pipelined = fields.get("pipeline", False)
        if fields.get("mesh_model", 1) > 1 and (fields.get("fused_ln_qkv") or pipelined):
            zero = dict.fromkeys(KERNELS, 0)
            if pipelined:  # M microbatches through the stage's blocks, forward twice
                stages = fields["mesh_model"]
                stage_blocks = (12 + 12) // stages  # ViT-B-32's two towers
                per = stage_blocks * fields.get("pipeline_microbatches", stages)
                blocks = dict(mha_fwd=2 * per, mha_bwd=per)
            else:
                blocks = dict(mha_fwd=24, mha_bwd=24, ln_qkv_fwd=24, ln_fast_bwd=24)
            warm = dict(zero, **blocks, lunif_fwd=2, lunif_bwd=2)
            main = dict(zero, **blocks, infonce_fwd=1, infonce_bwd_dimg=1,
                        infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1)
            if runs[0]["mesh"][0] > 1:  # the ring route launches no loss kernel
                warm = main = dict(zero, **blocks)
            want = [warm if k < DP_SPE else main for k in range(DP_STEPS)]
            for rank, run in enumerate(runs):
                try:
                    _expect_launches(run["counts"], want, f"phase 42 {name} rank {rank}")
                except AssertionError as e:
                    problems.append(str(e))
        if pipelined:
            from sparsify_clip_tpu_torch.parallel.pipeline import bubble_share

            one = ref["steps"][ref_key]
            share = max(run["bytes"]["params"] for run in runs) / one["bytes"]["params"]
            if share >= DP_PP_PARAM_SHARE:
                problems.append(f"a rank holds {share:.3f} of one process's parameter bytes")
            stages = fields["mesh_model"]
            micro = fields.get("pipeline_microbatches", stages)
            log(f"phase 42 pipeline {name}", ranks=world, mesh=json.dumps(runs[0]["mesh"]),
                microbatches=micro, bubble_share=f"{bubble_share(stages, micro):.4f}",
                bytes_by_rank=json.dumps([run["bytes"] for run in runs]),
                bytes_one_process=json.dumps(one["bytes"]), param_share=f"{share:.4f}",
                peak_gib_by_rank=json.dumps([round(run["peak_gib"], 3) for run in runs]),
                peak_gib_one_process=f"{one['peak_gib']:.3f}",
                note="every rank shares card 0: peak is each process's own",
                card=json.dumps(smi))
        step_ms = float(np.mean(runs[0]["step_ms"][1:]))
        launches[f"train_dp_gloo_{name}"] = {
            k: sum(c[k] for c in runs[0]["counts"]) for k in KERNELS}
        readings[f"{name}_w{world}"] = step_ms
        log(f"phase 42 layout {name}", ranks=world, mesh=json.dumps(runs[0]["mesh"]),
            fields=json.dumps(fields), model=model, dtype=dtype, backend="gloo",
            global_batch=TRAIN_BATCH, steps=DP_STEPS, losses=json.dumps(runs[0]["losses"]),
            losses_one_process=json.dumps(ref["steps"][ref_key]["losses"]),
            bit_identical_to_dp_step=same_as_dp, readings=json.dumps(r),
            gates=json.dumps(gates), gates_fired=json.dumps(fired),
            launches_a_step=json.dumps(runs[0]["counts"]), step_ms=f"{step_ms:.3f}",
            step_ms_one_process=f"{np.mean(ref['steps'][ref_key]['step_ms'][1:]):.3f}",
            note="gloo moves every collective's bytes through the host: not a multi-GPU "
                 "speed", card=json.dumps(smi))
        if problems:
            failed.append(f"phase 42 {name} at {world} ranks: {problems}")


# --------------------------------------------------------------------
# Phases 43-45: the repository's two large-tower YAMLs and ViT-bigG-14
# (phases 46-49 add cases at their own shapes: ViT-bigG-14 trained, ViT-B-16)
# --------------------------------------------------------------------

LARGE_STEPS = 3                  # phases 43-44: one epoch of 3 steps at the YAML's batch
BIGG_REQUESTS = 64               # phase 45: one batch of images and one of token rows
# rows 1 and 3 at the large towers' shapes on their paths: (case, batch, L,
# heads, head_dim, causal, dtype, rows); hd 80, 88 and 104 take the kernels'
# head_dim-128 instantiation, whole width (they do not pack into 128 lanes)
LARGE_ATTENTION = (
    ("g14-vision", 64, 257, 16, 88, False, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("g14-text", 64, 77, 16, 64, True, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("g14-vision-fp32", 64, 257, 16, 88, False, "float32", ("mha_fwd",)),
    ("h14-vision", 8, 257, 16, 80, False, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("h14-text", 8, 77, 16, 64, True, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("h14-vision-fp32", 8, 257, 16, 80, False, "float32", ("mha_fwd",)),
    ("bigG-vision", 64, 257, 16, 104, False, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("bigG-text", 64, 77, 20, 64, True, "bfloat16", ("mha_fwd", "mha_bwd")),
    ("bigG-vision-fp32", 64, 257, 16, 104, False, "float32", ("mha_fwd",)),
    ("b16-vision", 256, 197, 12, 64, False, "bfloat16", ("mha_fwd", "mha_bwd")),
)
# the paths whose launches each case's entry of the kernels line counts
LARGE_PATHS = {"g14": ("cli_vitg14",), "h14": ("train_gloo_vith14_pp2",),
               "bigG": ("serve_bigG", "cli_bigG"), "b16": ("train_exp6_b16", "eval_b16")}


def phase_large_kernels(smi: str):
    """Phases 43-49, first part: rows 1 and 3 at ``LARGE_ATTENTION``'s
    shapes against their plain versions under phase 2's and phase 6's
    tolerances (the LSE at 1e-5), timed beside SDPA under each backend
    that takes the shape and beside their bound at the real head_dim."""
    from sparsify_clip_tpu_torch.ops.attention import (
        mha_bwd, mha_bwd_reference, mha_fwd, mha_fwd_reference, use_head_group,
    )

    gen = torch.Generator("cuda").manual_seed(SEED + 43)
    results = {}
    for case, b, l, heads, head_dim, causal, dtype_name, rows in LARGE_ATTENTION:
        t0 = time.perf_counter()
        dtype = getattr(torch, dtype_name)
        width = heads * head_dim
        item = 2 if dtype_name == "bfloat16" else 4
        if use_head_group(l, 3 * width, item, heads):
            raise AssertionError(f"{case} takes the head-group route")
        pairs = b * heads * attention_pairs(l, causal)
        qkv = torch.randn((b, l, 3 * width), generator=gen, device="cuda").to(dtype)
        got, got_lse = mha_fwd(qkv, heads, causal, with_lse=True)
        want, want_lse = mha_fwd_reference(qkv, heads, causal, with_lse=True)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL[dtype_name]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
        err = (got.float() - want.float()).abs().max().item()
        del got, want, want_lse
        fb = bound(b * l * 4 * width * item + b * heads * l * 4, 2 * 2 * pairs * head_dim,
                   dtype_name)
        sdpa, library = sdpa_fwd_ms(qkv, heads, causal, iters=10, warmup=2)
        results[f"mha_fwd/{case}"] = dict(
            max_abs_err=err, rtol=rtol, atol=atol,
            ms=cuda_ms(lambda: mha_fwd(qkv, heads, causal), iters=10, warmup=2),
            plain_ms=cuda_ms(lambda: mha_fwd_reference(qkv, heads, causal), iters=2, warmup=1),
            library_ms=sdpa[library], library=f"sdpa/{library}", sdpa_ms=sdpa,
            bound_ms=fb[0], bound_by=fb[1], shape=[b, l, 3 * width], heads=heads,
            head_dim=head_dim, causal=causal, dtype=dtype_name)
        if "mha_bwd" in rows:
            dout = torch.randn((b, l, width), generator=gen, device="cuda").to(dtype)
            got = mha_bwd(qkv, got_lse, dout, heads, causal)
            want = mha_bwd_reference(qkv, got_lse, dout, heads, causal)
            torch.cuda.synchronize()
            brtol, batol = BWD_TOL[dtype_name]
            torch.testing.assert_close(got.float(), want.float(), rtol=brtol, atol=batol)
            bwd_err = (got.float() - want.float()).abs().max().item()
            del got, want
            bb = bound(b * l * (3 * width * 2 + width) * item + b * heads * l * 4,
                       5 * 2 * pairs * head_dim, dtype_name)
            sdpa, library = sdpa_bwd_ms(qkv, dout, heads, causal, iters=5, warmup=2)
            results[f"mha_bwd/{case}"] = dict(
                max_abs_err=bwd_err, rtol=brtol, atol=batol,
                ms=cuda_ms(lambda: mha_bwd(qkv, got_lse, dout, heads, causal), iters=5,
                           warmup=2),
                plain_ms=cuda_ms(lambda: mha_bwd_reference(qkv, got_lse, dout, heads, causal),
                                 iters=2, warmup=1),
                library_ms=sdpa[library], library=f"sdpa/{library}", sdpa_ms=sdpa,
                bound_ms=bb[0], bound_by=bb[1], shape=[b, l, 3 * width], heads=heads,
                head_dim=head_dim, causal=causal, dtype=dtype_name)
            del dout
        del qkv, got_lse
        results[f"mha_fwd/{case}"]["seconds"] = time.perf_counter() - t0
    for key, r in results.items():
        kernel, case = key.split("/")
        log("phase 43 kernel", kernel=kernel, case=case, shape=json.dumps(r["shape"]),
            heads=r["heads"], head_dim=r["head_dim"], causal=r["causal"], dtype=r["dtype"],
            max_abs_err=r["max_abs_err"], rtol=r["rtol"], atol=r["atol"], ms=f"{r['ms']:.5f}",
            plain_ms=f"{r['plain_ms']:.5f}", library_ms=f"{r['library_ms']:.5f}",
            library=r["library"], sdpa_ms=json.dumps(r["sdpa_ms"]),
            bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
            case_s=f"{r.get('seconds', 0.0):.3f}", card=json.dumps(smi))
    torch.cuda.empty_cache()
    return results


def _npz_shapes(path: str) -> dict:
    """Each array's shape in an ``.npz``, from the headers alone."""
    import zipfile

    shapes = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as fh:
                fmt = np.lib.format
                read = (fmt.read_array_header_1_0 if fmt.read_magic(fh) == (1, 0)
                        else fmt.read_array_header_2_0)
                shape = read(fh)[0]
            shapes[name[:-len(".npy")]] = shape
    return shapes


def _param_count(name: str) -> int:
    from sparsify_clip_tpu_torch.models.clip import CLIP, MODEL_REGISTRY

    with torch.device("meta"):
        return sum(p.numel() for p in CLIP(MODEL_REGISTRY[name]).parameters())


def _check_weights_file(path: str, model: str, what: str) -> dict:
    """The CLI's final npz: the JAX ``layers_scan`` layout (no per-block
    key), every parameter of ``model`` once → its size and shapes' count."""
    shapes = _npz_shapes(path)
    stacked = [k for k in shapes if "/layers_scan/block/" in k]
    values = sum(int(np.prod(s)) for s in shapes.values())
    want = _param_count(model)
    if not stacked or any("resblock_" in k for k in shapes) or values != want:
        raise AssertionError(f"{what}: the weights file holds {len(shapes)} arrays, "
                             f"{len(stacked)} stacked, {values} values ({want} expected)")
    return dict(bytes=os.path.getsize(path), arrays=len(shapes), stacked=len(stacked),
                values=values)


def _large_yaml(name: str, phase: str) -> dict:
    """``configs/<name>`` copied by :func:`_repo_yaml` into a temporary
    directory for ``LARGE_STEPS`` steps of its batch and one eval batch,
    one epoch and no epoch-end save (phase 40's cut): the final weights
    file alone → (the directory, the YAML's path, its config, its batch)."""
    import tempfile

    import yaml

    from sparsify_clip_tpu_torch.config import load_config

    with open(os.path.join(REPO, "configs", name)) as fh:
        batch = yaml.safe_load(fh)["batch_size"]
    tmp = tempfile.TemporaryDirectory()
    path = _repo_yaml(name, tmp.name, phase, num_train_samples=LARGE_STEPS * batch,
                      num_test_samples=batch, epochs=1, save_checkpoint_every_n_epochs=2)
    return dict(tmp=tmp, path=path, config=load_config(path), batch=batch, name=name)


def _wait_for_go(path: str, timeout_s: float = 1100.0) -> None:
    """A process started ahead of its phase: import what its run imports
    (the optimizer's construction imports ``torch._dynamo``, seconds on
    the card's machine), then wait, off the card, until the phase creates
    ``path``."""
    import torch._dynamo  # noqa: F401

    from sparsify_clip_tpu_torch import checkpoints, cli, eval, train  # noqa: F401

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.05)


def _open_gate(pending: dict) -> None:
    with open(pending["go"], "w"):
        pass
    pending["launch"]["t"] = time.perf_counter()  # the launch's seconds from here


def start_large_launches() -> dict:
    """Phases 43 and 44's processes, started ahead and held at their gates
    (:func:`_wait_for_go`) while the phases before them run: ViT-g-14's
    CLI under the launcher at world = the card count, and ViT-H-14's 2
    gloo ranks.  :func:`stop_large_launches` ends what was not run."""
    world = torch.cuda.device_count()
    g14 = _large_yaml("vitg14_fsdp_pod.yaml", "phase 43 cli")
    g14["go"] = os.path.join(g14["tmp"].name, "go")
    g14["launch"] = _launch(world, [os.path.join(REPO, "chip_smoke.py"), "--cli-rank",
                                    g14["path"], g14["tmp"].name, g14["go"]])
    h14 = _large_yaml("vith14_pipeline.yaml", "phase 44 cli")
    h14["dp"] = _dp_launch_start(h14["config"].mesh_model, [f"cli_pp:{h14['path']}"],
                                 go=os.path.join(h14["tmp"].name, "go"))
    h14["go"], h14["launch"] = h14["dp"]["go"], h14["dp"]["launch"]
    return dict(g14=g14, h14=h14)


def stop_large_launches(pending: dict) -> None:
    for run in pending.values():
        _launch_stop(run["launch"])
        if "dp" in run:
            run["dp"]["tmp"].cleanup()
        run["tmp"].cleanup()


def phase_cli_vitg14(smi: str, pending: dict):
    """Phase 43: ``configs/vitg14_fsdp_pod.yaml`` (ViT-g-14: ``fsdp``,
    ``adam_mu_dtype: bfloat16``, ``scan_layers``, ``device_augment``,
    ``handle_preemption``, ``async_checkpoint``, ``multihost``) through
    ``python -m torch.distributed.run --nproc_per_node=<card count> -m
    sparsify_clip_tpu_torch.cli``'s entry point (``pending``: the launch
    :func:`start_large_launches` started): one epoch of ``LARGE_STEPS``
    steps at the YAML's batch, one eval batch a pass, the final weights
    file in the JAX ``layers_scan`` layout."""
    import shutil

    world = torch.cuda.device_count()
    config, batch, name, tmp = pending["config"], pending["batch"], pending["name"], \
        pending["tmp"].name
    knobs = {k: getattr(config, k) for k in ("model", "fsdp", "adam_mu_dtype", "scan_layers",
                                             "device_augment", "handle_preemption",
                                             "async_checkpoint", "multihost", "fp16")}
    if knobs["model"] != "ViT-g-14" or not (config.fsdp and config.multihost):
        raise AssertionError(f"phase 43: the YAML reads {knobs}")
    free = shutil.disk_usage(tmp).free
    torch.cuda.empty_cache()
    _open_gate(pending)
    rc, seconds, _ = _launch_wait(pending["launch"])
    if rc != 0:
        raise AssertionError(f"phase 43: the ViT-g-14 CLI under the launcher exited {rc}")
    with open(os.path.join(tmp, "counts_rank0.json")) as fh:
        counts = json.load(fh)
    records, steps, evals, rates = _cli_records(tmp, config.run_name, LARGE_STEPS, 3, "ViT-g-14")
    weights = _check_weights_file(os.path.join(tmp, "models", f"{config.run_name}.npz"),
                                  "ViT-g-14", "phase 43")
    pending["tmp"].cleanup()
    start = records[0]
    whole = {"vision": "whole-width", "text": "whole-width"}
    first = dict(event=start.get("event"), world_size=start["parallel"]["world_size"],
                 backend=start["parallel"]["backend"],
                 **{k: start["config"][k] for k in ("fsdp", "adam_mu_dtype", "device_augment",
                                                    "scan_layers", "multihost")},
                 attention_routes=start.get("attention_routes"))
    if (first["event"] != "run_start" or first["world_size"] != world or not first["fsdp"]
            or first["adam_mu_dtype"] != "bfloat16" or not first["device_augment"]
            or first["attention_routes"] != {"train": whole, "eval": whole}):
        raise AssertionError(f"phase 43: the first record reads {first}")
    zero = dict.fromkeys(KERNELS, 0)
    blocks = 40 + 24
    step = dict(zero, mha_fwd=blocks, mha_bwd=blocks)
    if world == 1:  # over several ranks the ring replaces the loss kernels
        step.update(infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1)
    _expect_launches([tuple(c) for c in counts["steps"]],
                     [(k, step) for k in range(LARGE_STEPS)], "the ViT-g-14 CLI's steps")
    _expect_launches(counts["evals"], [dict(zero, mha_fwd=blocks)] * 3,
                     "the ViT-g-14 CLI's evals")
    save = counts["saves"][-1]
    step_ms = counts["step_ms"][1:]
    log("phase 43 cli", ok=True, config=f"configs/{name}", model="ViT-g-14",
        params=weights["values"], world=world, batch=batch, batch_yaml=batch,
        knobs=json.dumps(knobs), first_record=json.dumps(first),
        losses=json.dumps([r["train_loss"] for r in steps]), eval_last=json.dumps(evals[-1]),
        launches_step=json.dumps(step), launches=json.dumps(counts["launches"]),
        step_ms_all=json.dumps([round(x, 3) for x in counts["step_ms"]]),
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        eval_pass_s=json.dumps([round(x, 3) for x in counts["eval_seconds"]]),
        setup_s=json.dumps([round(x, 3) for x in counts["setup_s"]]),
        weights_bytes=weights["bytes"], weights_arrays=weights["arrays"],
        weights_stacked=weights["stacked"], save_s=f"{save['seconds']:.3f}",
        tmp_free_gib=f"{free / 2**30:.1f}", launcher_s=f"{seconds:.3f}", card=json.dumps(smi))
    log("phase 43 rate", step_ms=f"{np.mean(step_ms):.3f}",
        steps_2_3_ms=json.dumps([round(x, 3) for x in step_ms]),
        pairs_per_s=f"{batch * world / (np.mean(step_ms) / 1e3):.1f}",
        max_memory_allocated_gib=f"{counts['peak'] / 2**30:.3f}",
        eval_pass_s=f"{np.mean(counts['eval_seconds']):.3f}",
        weights_gb=f"{weights['bytes'] / 1e9:.3f}", save_s=f"{save['seconds']:.3f}",
        card=json.dumps(smi))
    return dict(launches=counts["launches"], step_ms=step_ms, peak=counts["peak"])


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` (a copy on the CPU too: the run goes on updating it)."""
    return t.detach().to("cpu", copy=True)


def _cli_pp_job(yaml_path: str, rank: int, device) -> dict:
    """Phase 44 in a gloo rank: the CLI's ``main`` on ``yaml_path`` under
    this process group (the YAML's pipeline over the model axis), each
    step's launches, ms and loss, the first step's gradients and the final
    parameters put back together, the weights save's seconds; then, on
    rank 0 alone, the one-process step (``pipeline: false``, one model
    rank, no collective) from the same seed over the same batches, and
    phase 42's readings of the pipelined run against it."""
    import dataclasses
    import gc

    from sparsify_clip_tpu_torch import cli
    from sparsify_clip_tpu_torch.checkpoints import full_parameters
    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.models.clip import create_model
    from sparsify_clip_tpu_torch.parallel.mesh import Mesh, digest
    from sparsify_clip_tpu_torch.parallel.sharding import layout_of
    from sparsify_clip_tpu_torch.train import create_train_setup

    config = load_config(yaml_path)
    kept = {"batches": [], "losses": []}

    def after_step(state, batch, metrics):
        kept["batches"].append({k: v.clone() if torch.is_tensor(v) else v
                                for k, v in batch.items()})
        kept["losses"].append(float(metrics["train_loss"]))
        if len(kept["batches"]) == 1:  # the full view: a collective on every rank
            grads = {n: p.grad.detach() for n, p in state.model.named_parameters()}
            grads = layout_of(state.model).full_named(grads)
            if rank == 0:
                kept["grads"] = {n: _host(g) for n, g in grads.items()}

    counter, timers = _PerStepCounts(timed=True, after_step=after_step), _TimedSetupAndSaves()
    torch.cuda.reset_peak_memory_stats()
    seconds, t = {}, time.perf_counter()
    try:
        reset_counts()
        cli.main(config)
        launches = read_counts()
    finally:
        counter.close()
        timers.close()
    peak = torch.cuda.max_memory_allocated()
    seconds["cli"], t = time.perf_counter() - t, time.perf_counter()
    state = counter.state
    counter.state = None
    params = full_parameters(state.model)
    moments = [t for st in state.optimizer.state.values() for key, t in st.items()
               if key in ("exp_avg", "exp_avg_sq")]
    out = dict(losses=kept["losses"], counts=[c for _, c in counter.steps],
               step_ms=counter.step_ms, evals=counter.evals, eval_seconds=counter.eval_seconds,
               launches=launches, setup_s=timers.setup_s, saves=timers.saves,
               # each stage's blocks exist once: the ranks must agree on the rest
               digest=digest([params[n] for n in sorted(params) if ".resblocks." not in n]
                             + list(state.model.buffers())),
               bytes=dict(params=sum(p.numel() * p.element_size()
                                     for p in state.model.parameters()),
                          moments=sum(t.numel() * t.element_size() for t in moments)),
               peak_gib=peak / 2**30, batches=len(kept["batches"]), seconds=seconds)
    seconds["full_view_and_digest"], t = time.perf_counter() - t, time.perf_counter()
    if rank != 0:
        return out
    # the pipelined run's tensors stay where they are (its gradients were
    # copied to the host at step 1, outside the peaks); the readings run
    # on the card
    got = dict(grads=kept.pop("grads"), params={n: p.detach() for n, p in params.items()},
               buffers={n: b.detach() for n, b in state.model.named_buffers()})
    del state, params, moments
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the pipelined run's tensors, left out of its peak
    ref_config = dataclasses.replace(config, pipeline=False, mesh_model=1)
    setup = create_train_setup(ref_config, steps_per_epoch=len(kept["batches"]), device=device,
                               mesh=Mesh())
    ref, one = {}, dict(losses=[], step_ms=[], bytes=dict(
        params=sum(p.numel() * p.element_size() for p in setup.model.parameters())))
    for k, batch in enumerate(kept["batches"]):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        setup.state, metrics = setup.train_step(setup.state, batch)
        one["losses"].append(float(metrics["train_loss"]))
        torch.cuda.synchronize()
        one["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        if k == 0:
            ref["grads"] = {n: _host(p.grad) for n, p in setup.model.named_parameters()}
    ref["params"] = {n: p.detach() for n, p in setup.model.named_parameters()}
    ref["buffers"] = {n: b.detach() for n, b in setup.model.named_buffers()}
    one["bytes"]["moments"] = sum(t.numel() * t.element_size()
                                  for st in setup.state.optimizer.state.values()
                                  for key, t in st.items() if key in ("exp_avg", "exp_avg_sq"))
    one["peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    del setup, kept["batches"]
    torch.cuda.empty_cache()
    out["one_process"] = one
    seconds["one_process"], t = time.perf_counter() - t, time.perf_counter()
    # the seed's parameters drawn again (the same draws on the card as
    # both runs started from), and the gradients back on the card
    ref["init"] = {n: p.detach() for n, p in create_model(
        ref_config.model, dtype=torch.float32, device=device, seed=ref_config.seed,
        param_dtype=torch.float32).named_parameters()}
    for run in (got, ref):
        run["grads"] = {n: g.to(device) for n, g in run["grads"].items()}
    out["readings"] = _dp_step_readings([out], got, one, ref, 2)
    seconds["readings"] = time.perf_counter() - t
    return out


def phase_cli_vith14_pp(smi: str, pending: dict):
    """Phase 44: ``configs/vith14_pipeline.yaml`` (ViT-H-14, ``pipeline``
    at ``mesh_model: 2`` over 4 microbatches, ``scan_layers``, bf16)
    through the CLI's ``main`` in 2 gloo ranks on card 0 (one card holds
    one NCCL rank; ``pending``: the ranks :func:`start_large_launches`
    started): one epoch of ``LARGE_STEPS`` steps of the YAML's global
    batch, one eval batch a pass, the final save through the full view's
    stage gather in the JAX ``layers_scan`` layout; held against the
    one-process step under phase 42's gates."""
    from sparsify_clip_tpu_torch.parallel.pipeline import bubble_share

    config, batch, name, path = pending["config"], pending["batch"], pending["name"], \
        pending["path"]
    stages, micro = config.mesh_model, config.pipeline_microbatches
    if (config.model, stages, micro, config.pipeline) != ("ViT-H-14", 2, 4, True):
        raise AssertionError(f"phase 44: the YAML trains {config.model} at {stages} stages")
    torch.cuda.empty_cache()
    _open_gate(pending)
    ranks, _, _, seconds = _dp_launch_finish(pending["dp"])
    tmp = pending["tmp"].name
    records, steps, evals, _ = _cli_records(tmp, config.run_name, LARGE_STEPS, 3, "ViT-H-14")
    weights = _check_weights_file(os.path.join(tmp, "models", f"{config.run_name}.npz"),
                                  "ViT-H-14", "phase 44")
    pending["tmp"].cleanup()
    runs = [r[f"cli_pp:{path}"] for r in ranks]
    r = dict(runs[0]["readings"], ranks_bit_identical=len({run["digest"] for run in runs}) == 1)
    gates = _dp_gates(("ViT-B-32", "bf16"))  # phase 42's pp 2 limits, as they stand
    problems = list(_dp_gates_fired(("ViT-B-32", "bf16"), r, gates))
    if r["grad_norm_rel_gap_if_scaled"] <= gates["grad_norm"]:
        problems.append("a gradient W times or 1/W its size passes the norm gate")
    if any(run["losses"] != runs[0]["losses"] for run in runs):
        problems.append("the ranks' losses differ")
    if records[0]["parallel"] != {"world_size": stages, "backend": "gloo", "loss_route": "kernel"}:
        problems.append(f"run_start names {records[0]['parallel']}")
    zero = dict.fromkeys(KERNELS, 0)
    stage_blocks = (32 + 24) // stages  # a stage of each tower: 16 + 12 blocks
    step = dict(zero, mha_fwd=2 * micro * stage_blocks, mha_bwd=micro * stage_blocks,
                infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1)
    per_eval = dict(zero, mha_fwd=micro * stage_blocks)
    for rank, run in enumerate(runs):
        for got, want, what in ((run["counts"], [step] * LARGE_STEPS, "steps"),
                                (run["evals"], [per_eval] * 3, "evals")):
            try:
                _expect_launches(got, want, f"phase 44 rank {rank}'s {what}")
            except AssertionError as e:
                problems.append(str(e))
    one = runs[0]["one_process"]
    share = max(run["bytes"]["params"] for run in runs) / one["bytes"]["params"]
    if share >= DP_PP_PARAM_SHARE:
        problems.append(f"a rank holds {share:.3f} of one process's parameter bytes")
    step_ms = runs[0]["step_ms"][1:]
    log("phase 44 cli", config=f"configs/{name}", model="ViT-H-14", params=weights["values"],
        ranks=stages, backend="gloo", mesh=json.dumps([1, stages]), global_batch=batch,
        microbatches=micro, bubble_share=f"{bubble_share(stages, micro):.4f}",
        losses=json.dumps(runs[0]["losses"]), losses_one_process=json.dumps(one["losses"]),
        readings=json.dumps(r), gates=json.dumps(gates), gates_fired=json.dumps(problems),
        eval_last=json.dumps(evals[-1]), launches_step=json.dumps(step),
        launches_eval=json.dumps(per_eval), launches=json.dumps(runs[0]["launches"]),
        bytes_by_rank=json.dumps([run["bytes"] for run in runs]),
        bytes_one_process=json.dumps(one["bytes"]), param_share=f"{share:.4f}",
        peak_gib_by_rank=json.dumps([round(run["peak_gib"], 3) for run in runs]),
        peak_gib_one_process=f"{one['peak_gib']:.3f}",
        eval_pass_s=json.dumps([round(x, 3) for x in runs[0]["eval_seconds"]]),
        setup_s=json.dumps([round(x, 3) for x in runs[0]["setup_s"]]),
        weights_bytes=weights["bytes"], save_s=f"{runs[0]['saves'][-1]['seconds']:.3f}",
        step_ms_all=json.dumps([round(x, 3) for x in runs[0]["step_ms"]]),
        rank0_seconds=json.dumps({k: round(v, 3) for k, v in runs[0]["seconds"].items()}),
        launch_s=f"{seconds:.3f}", card=json.dumps(smi))
    log("phase 44 rate", step_ms=f"{np.mean(step_ms):.3f}",
        steps_2_3_ms=json.dumps([round(x, 3) for x in step_ms]),
        step_ms_one_process=f"{np.mean(one['step_ms'][1:]):.3f}",
        pairs_per_s=f"{batch / (np.mean(step_ms) / 1e3):.1f}",
        bubble_share=f"{bubble_share(stages, micro):.4f}",
        note="gloo moves every collective's bytes through the host: not a multi-GPU speed",
        card=json.dumps(smi))
    if problems:
        raise AssertionError(f"phase 44: against one process: {problems}")
    return dict(launches=runs[0]["launches"])


def phase_serve_bigg(smi: str):
    """Phase 45: ViT-bigG-14 in bf16 from the seed on the card, one batch
    of ``BIGG_REQUESTS`` images and one of as many token rows through
    ``BatchingEncoderServer`` over ``CLIPEncoder`` (phase 4's checks)."""
    from sparsify_clip_tpu_torch.models.clip import create_model

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = create_model("ViT-bigG-14", dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log("phase 45 model", ok=True, name=model.cfg.name, dtype=str(model.dtype), params=params,
        weights_gb=f"{weight_bytes / 1e9:.3f}", seconds=f"{seconds:.3f}",
        create_peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    torch.cuda.reset_peak_memory_stats()
    cfg = model.cfg
    serve = phase_serve(model, "phase 45 serve", BIGG_REQUESTS, BIGG_REQUESTS, BIGG_REQUESTS,
                        per_batch={"image": {"mha_fwd": cfg.vision_layers[0]},
                                   "tokens": {"mha_fwd": cfg.text_layers}})
    peak = torch.cuda.max_memory_allocated()
    stats = serve["stats"]
    log("phase 45 rate", requests_per_s=f"{stats.requests / serve['wall']:.1f}",
        wall_s=f"{serve['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", max_memory_allocated_gib=f"{peak / 2**30:.3f}",
        card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()
    return serve


# --------------------------------------------------------------------
# Phases 46-49: the rest of the model registry
# --------------------------------------------------------------------

# phase 46: every registry name that no other phase builds on the card, each
# served one batch of images and one of token rows; ViT-L-14-336's vision
# tower takes the head-group route (as in phase 12), every other the whole width
SWEEP_TOWERS = ("RN101", "RN50x4", "RN50x16", "ViT-B-16", "RN50-quickgelu", "RN101-quickgelu",
                "ViT-B-32-quickgelu", "ViT-B-16-quickgelu", "ViT-L-14-quickgelu",
                "ViT-L-14-336-quickgelu")
SWEEP_HEAD_GROUP = ("ViT-L-14-336-quickgelu",)
SWEEP_REQUESTS = 16
# phases 47-48: exp 6 from the seed on a device-resident batch, one warm and
# one main epoch of 2 steps, one eval batch a pass; RN50x64 at 448 px under
# remat at the batch PERF.md's prediction fits under 70 GiB
REGISTRY_STEPS = 2
B16_BATCH = RN101_BATCH = 256
RN50X64_BATCH = 64
# phase 49: ViT-bigG-14 exp 6 through the CLI under remat with a bf16 first
# moment, one warm and one main epoch of 2 steps, one eval batch a pass
BIGG_BATCH = 64
BIGG_STEPS = 2


def phase_registry_sweep(smi: str):
    """Phase 46: each of ``SWEEP_TOWERS`` built in bf16 from the seed on the
    card, its parameter count against the meta-device count, served through
    ``BatchingEncoderServer`` over ``CLIPEncoder`` (phase 4's checks)."""
    from sparsify_clip_tpu_torch.models.clip import create_model
    from sparsify_clip_tpu_torch.models.layers import MLP, quick_gelu

    launches, towers = dict.fromkeys(KERNELS, 0), {}
    for name in SWEEP_TOWERS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = create_model(name, dtype=torch.bfloat16, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        cfg = model.cfg
        params, want = sum(p.numel() for p in model.parameters()), _param_count(name)
        # each MLP's activation: quick GELU in every block of a -quickgelu tower
        quick = sorted({m.act is quick_gelu for m in model.modules() if isinstance(m, MLP)})
        log("phase 46 model", name=name, kind=cfg.vision_kind, image_size=cfg.image_size,
            dtype=str(model.dtype), params=params, params_meta=want, quick_gelu=cfg.quick_gelu,
            mlps_quick_gelu=json.dumps(quick), seconds=f"{seconds:.3f}")
        if params != want or quick != [cfg.quick_gelu]:
            raise AssertionError(f"phase 46 {name}: {params} parameters ({want} expected), "
                                 f"quick GELU in the MLPs {quick}")
        if cfg.vision_kind == "resnet":
            image = {}
        else:
            route = "mha_fwd_head_group" if name in SWEEP_HEAD_GROUP else "mha_fwd"
            image = {route: cfg.vision_layers[0]}
        serve = phase_serve(model, f"phase 46 serve {name}", SWEEP_REQUESTS, SWEEP_REQUESTS,
                            SWEEP_REQUESTS,
                            per_batch={"image": image, "tokens": {"mha_fwd": cfg.text_layers}})
        stats = serve["stats"]
        towers[name] = dict(params=params, requests_per_s=stats.requests / serve["wall"],
                            p50_ms=stats.latency_p50_ms, p99_ms=stats.latency_p99_ms,
                            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        for k in KERNELS:
            launches[k] += serve["launches"][k]
        log("phase 46 rate", name=name, requests_per_s=f"{towers[name]['requests_per_s']:.1f}",
            wall_s=f"{serve['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
            p99_ms=f"{stats.latency_p99_ms:.3f}",
            max_memory_allocated_gib=f"{towers[name]['peak_gib']:.3f}", card=json.dumps(smi))
        del model
    torch.cuda.empty_cache()
    return dict(launches=launches, towers=towers)


def _exp6_launches(blocks: int, remat: bool = False) -> dict:
    """Phase 9's launches a step for whole-width towers of ``blocks``
    attention blocks in all: each block one forward and one backward,
    under remat two forwards (the backward's recompute); the loss kernels
    as phase 9's."""
    step = dict(mha_fwd=blocks * (2 if remat else 1), mha_bwd=blocks)
    return dict(warm=dict(step, lunif_fwd=2, lunif_bwd=2),
                main=dict(step, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                          lunif_fwd=1, lunif_bwd=1))


def phase_registry_train(smi: str):
    """Phases 47-48: exp 6 by phase 9's recipe (:func:`phase_exp6`) on
    ViT-B-16 and RN101 at batch 256 and on RN50x64 at 448 px under remat
    at batch ``RN50X64_BATCH``: a warm and a main step held against the
    plain versions, one warm and one main epoch of ``REGISTRY_STEPS``
    steps, one eval batch a pass."""
    from sparsify_clip_tpu_torch.models.clip import MODEL_REGISTRY

    runs = {}
    for phase, name, batch, remat in ((47, "ViT-B-16", B16_BATCH, False),
                                      (48, "RN101", RN101_BATCH, False),
                                      (48, "RN50x64", RN50X64_BATCH, True)):
        cfg = MODEL_REGISTRY[name]
        # a ResNet's vision tower runs no attention kernel
        blocks = cfg.text_layers + (cfg.vision_layers[0] if cfg.vision_kind == "vit" else 0)
        step = _exp6_launches(blocks, remat=remat)
        runs[name] = phase_exp6(
            smi, name, (phase, phase), batch, batch, REGISTRY_STEPS, batch,
            warm_step=step["warm"], main_step=step["main"], per_eval_batch=dict(mha_fwd=blocks),
            overrides=dict(remat=True) if remat else None)
        run = runs[name]
        log(f"phase {phase} {name}", step_ms=json.dumps({k: round(v["step_ms"], 3)
                                                        for k, v in run["rates"].items()}),
            pairs_per_s=json.dumps({k: round(v["pairs_per_s"], 1)
                                    for k, v in run["rates"].items()}),
            max_memory_allocated_gib=f"{run['peak'] / 2**30:.3f}",
            eval_seconds=json.dumps([round(x, 3) for x in run["eval_seconds"]]),
            card=json.dumps(smi))
        torch.cuda.empty_cache()
    return runs


def phase_cli_bigg(smi: str):
    """Phase 49: ViT-bigG-14 under exp 6 through the CLI
    (``sparsify_clip_tpu_torch.cli``'s entry point, as ``python3 -m
    sparsify_clip_tpu_torch.cli --config``) from a YAML written to a
    temporary directory: synthetic data, ``remat: true``, ``adam_mu_dtype:
    bfloat16``, batch ``BIGG_BATCH``, one warm and one main epoch of
    ``BIGG_STEPS`` steps, one eval batch a pass, no epoch-end save.  Each
    step's launches and ms, the peak memory of its forward and backward
    apart from its optimizer's; then, in this process at the final
    weights, a main step on the last batch held against the same step on
    the plain versions under phase 9's tolerances.  The CLI's final weights
    file (10.2 GB) is not written: phase 43 writes and reads ViT-g-14's."""
    import tempfile

    from sparsify_clip_tpu_torch import checkpoints
    from sparsify_clip_tpu_torch.optim import AdamWBf16Mu
    from sparsify_clip_tpu_torch.train import TrainStep

    tmp = tempfile.TemporaryDirectory()
    path = _write_exp6_yaml(tmp.name, model="ViT-bigG-14", run_name="exp6-bigG",
                            batch_size=BIGG_BATCH, num_train_samples=BIGG_STEPS * BIGG_BATCH,
                            num_test_samples=BIGG_BATCH, remat=True, adam_mu_dtype="bfloat16",
                            **NO_EPOCH_SAVES)
    peaks, kept = {"backward": [], "optimizer": []}, {}
    grads_fn, step_fn, save = TrainStep.loss_and_grads, AdamWBf16Mu.step, checkpoints.save_weights

    def measured_grads(self, state, batch):  # the forward and backward's peak from here
        torch.cuda.reset_peak_memory_stats()
        return grads_fn(self, state, batch)

    def measured_step(self, closure=None):
        peaks["backward"].append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = step_fn(self, closure)
        peaks["optimizer"].append(torch.cuda.max_memory_allocated())
        return out

    def unwritten(model, out):
        kept["save"] = out
        return out

    def after_step(state, batch, metrics):
        kept["batch"] = batch

    torch.cuda.empty_cache()
    counter = _PerStepCounts(timed=True, after_step=after_step)
    TrainStep.loss_and_grads, AdamWBf16Mu.step = measured_grads, measured_step
    checkpoints.save_weights = unwritten
    t = time.perf_counter()
    try:
        reset_counts()
        _run_cli(["--config", path])
        launches = read_counts()
    finally:
        counter.close()
        TrainStep.loss_and_grads, AdamWBf16Mu.step = grads_fn, step_fn
        checkpoints.save_weights = save
    seconds = time.perf_counter() - t
    spe = BIGG_STEPS
    records, steps, evals, rates = _cli_records(tmp.name, "exp6-bigG", EXP6_EPOCHS * spe,
                                                EXP6_EPOCHS + 2, "ViT-bigG-14")
    start = records[0]
    whole = {"vision": "whole-width", "text": "whole-width"}
    if start.get("attention_routes") != {"train": whole, "eval": whole} or not (
            start["config"]["remat"] and start["config"]["adam_mu_dtype"] == "bfloat16"):
        raise AssertionError(f"phase 49: the first record reads {start}")
    blocks = 48 + 32
    step = _exp6_launches(blocks, remat=True)
    zero = dict.fromkeys(KERNELS, 0)
    _expect_launches([tuple(c) for c in counter.steps],
                     [(k, dict(zero, **step["warm" if k < spe else "main"]))
                      for k in range(EXP6_EPOCHS * spe)], "the ViT-bigG-14 CLI's steps")
    _expect_launches(counter.evals, [dict(zero, mha_fwd=blocks)] * (EXP6_EPOCHS + 2),
                     "the ViT-bigG-14 CLI's evals")
    if kept.get("save") != os.path.join(tmp.name, "models", "exp6-bigG.npz"):
        raise AssertionError(f"phase 49: the CLI's final save went to {kept.get('save')}")

    # a main step at the final weights on the last batch, kernels then plain
    state, batch = counter.state, kept.pop("batch")
    names = [n for n, _ in state.model.named_parameters()]
    done = state.step
    state.step = spe
    try:
        kernel = _kernel_grads(counter.train_step, state, batch, dict(zero, **step["main"]),
                               "phase 49 kernel step")
        held = _hold_against_plain(counter.train_step, state, batch, kernel, names,
                                   "phase 49 plain", loss_phase="main", step=spe,
                                   batch=BIGG_BATCH)
    finally:
        state.step = done
    del kernel
    state.optimizer.zero_grad(set_to_none=True)
    step_ms = counter.step_ms
    log("phase 49 cli", ok=True, model="ViT-bigG-14", params=sum(p.numel() for p in
                                                                 state.model.parameters()),
        batch=BIGG_BATCH, remat=True, adam_mu_dtype="bfloat16",
        losses=json.dumps([r["train_loss"] for r in steps]), eval_last=json.dumps(evals[-1]),
        launches_step=json.dumps(step), launches=json.dumps(launches),
        step_ms_all=json.dumps([round(x, 3) for x in step_ms]),
        cli_step_ms=json.dumps([round(r["step_time_ms"], 3) for r in rates]),
        eval_pass_s=json.dumps([round(x, 3) for x in counter.eval_seconds]),
        peak_backward_gib=json.dumps([round(x / 2**30, 3) for x in peaks["backward"]]),
        peak_optimizer_gib=json.dumps([round(x / 2**30, 3) for x in peaks["optimizer"]]),
        plain_gaps=json.dumps(held["gaps"]), min_grad_cosine=held["min_grad_cosine"],
        cli_s=f"{seconds:.3f}", card=json.dumps(smi))
    log("phase 49 rate", step_ms=f"{np.mean(step_ms[1:]):.3f}",
        pairs_per_s=f"{BIGG_BATCH / (np.mean(step_ms[1:]) / 1e3):.1f}",
        peak_backward_gib=f"{max(peaks['backward']) / 2**30:.3f}",
        peak_optimizer_gib=f"{max(peaks['optimizer']) / 2**30:.3f}",
        eval_pass_s=f"{np.mean(counter.eval_seconds):.3f}", card=json.dumps(smi))
    counter.state = counter.train_step = None
    del state, batch
    tmp.cleanup()
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, peaks=peaks)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from sparsify_clip_tpu_torch.config import load_config
    from sparsify_clip_tpu_torch.models.clip import create_model
    from sparsify_clip_tpu_torch.models.resnet import BatchNormHalf

    phase_build()
    kernel = phase_kernel()

    t = time.perf_counter()
    model = create_model("ViT-B-32", dtype=torch.bfloat16, device="cuda", seed=SEED)
    log("phase 3 model", ok=True, name=model.cfg.name, dtype=str(model.dtype),
        params=sum(p.numel() for p in model.parameters()),
        seconds=f"{time.perf_counter() - t:.3f}")

    serve = phase_serve(model, "phase 4 serve", N_IMAGES, N_TOKENS, MAX_BATCH,
                        per_batch={"image": {"mha_fwd": 12}, "tokens": {"mha_fwd": 12}})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    stats = stats_b32 = serve["stats"]
    log("phase 5 rate", requests_per_s=f"{stats.requests / serve['wall']:.1f}",
        wall_s=f"{serve['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()

    train_kernels = phase_train_kernels()
    train = phase_train()
    log("phase 7 rate", step_ms=f"{train['step_ms']:.3f}",
        pairs_per_s=f"{TRAIN_BATCH / (train['step_ms'] / 1e3):.1f}",
        max_memory_allocated_gib=f"{train['peak'] / 2**30:.3f}", card=json.dumps(smi))
    torch.cuda.empty_cache()

    lunif_kernels = phase_lunif_kernels()
    exp6 = phase_exp6(
        smi, "ViT-B-32", (9, 10), TRAIN_BATCH, TRAIN_BATCH, EXP6_STEPS_PER_EPOCH, EVAL_PAIRS,
        warm_step=dict(mha_fwd=24, mha_bwd=24, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(mha_fwd=24, mha_bwd=24, infonce_fwd=1, infonce_bwd_dimg=1,
                       infonce_bwd_dtxt=1, lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd=24))
    torch.cuda.empty_cache()

    # phases 43-44's processes start here, while the card-bound phases of
    # ViT-L-14-336 leave the host idle: they import what they run and touch
    # the card only once their phase opens its gate (stopped at exit)
    large = start_large_launches()
    atexit.register(stop_large_launches, large)
    head_group = phase_head_group_kernels(smi)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    model = create_model(L336, dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    log("phase 12 model", ok=True, name=model.cfg.name, dtype=str(model.dtype),
        params=sum(p.numel() for p in model.parameters()),
        seconds=f"{time.perf_counter() - t:.3f}")
    # vision: 577 tokens, the head-group route; text: 77, the whole-width one
    serve_l336 = phase_serve(model, "phase 12 serve", L336_REQUESTS, L336_REQUESTS,
                             L336_MAX_BATCH, per_batch={"image": {"mha_fwd_head_group": 24},
                                                        "tokens": {"mha_fwd": 12}})
    stats = serve_l336["stats"]
    log("phase 12 rate", requests_per_s=f"{stats.requests / serve_l336['wall']:.1f}",
        wall_s=f"{serve_l336['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()

    attention = dict(mha_fwd_head_group=24, mha_bwd_head_group=24, mha_fwd=12, mha_bwd=12)
    exp6_l336 = phase_exp6(
        smi, L336, (13, 14), L336_BATCH, L336_CHECK_BATCH, L336_STEPS_PER_EPOCH, L336_EVAL_PAIRS,
        warm_step=dict(attention, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(attention, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd_head_group=24, mha_fwd=12))
    torch.cuda.empty_cache()

    ln_qkv = phase_ln_qkv_kernels(smi)
    torch.cuda.empty_cache()
    # 24 vision and 12 text blocks each run the fused LN+qkv once a forward
    # and its LayerNorm backward once a backward
    fused = dict(attention, ln_qkv_fwd=36, ln_fast_bwd=36)
    exp6_fused = phase_exp6(
        smi, L336, (16, 17), L336_BATCH, L336_CHECK_BATCH, L336_STEPS_PER_EPOCH, L336_EVAL_PAIRS,
        warm_step=dict(fused, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(fused, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd_head_group=24, mha_fwd=12, ln_qkv_fwd=36),
        overrides=dict(fused_ln_qkv=True))
    torch.cuda.empty_cache()

    cli_smoke = phase_cli_smoke(smi)
    cli_exp6 = phase_cli_exp6(smi, exp6["rates"])
    torch.cuda.empty_cache()

    # RN50, the reference's default tower: serving, exp 6 with its eval, the CLI
    t = time.perf_counter()
    model = create_model("RN50", dtype=torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    bn_dtypes = sorted({str(t.dtype) for m in model.modules() if isinstance(m, BatchNormHalf)
                        for t in (*m.parameters(), *m.buffers())})
    log("phase 20 model", ok=True, name=model.cfg.name, dtype=str(model.dtype),
        params=sum(p.numel() for p in model.parameters()), batchnorm_dtypes=json.dumps(bn_dtypes),
        seconds=f"{time.perf_counter() - t:.3f}")
    if bn_dtypes != ["torch.float32"]:
        raise AssertionError(f"the bf16 RN50 keeps BatchNorm in {bn_dtypes}")
    text = model.cfg.text_layers
    serve_rn50 = phase_serve(model, "phase 20 serve", N_IMAGES, N_TOKENS, MAX_BATCH,
                             per_batch={"image": {}, "tokens": {"mha_fwd": text}})
    stats = serve_rn50["stats"]
    log("phase 20 rate", requests_per_s=f"{stats.requests / serve_rn50['wall']:.1f}",
        wall_s=f"{serve_rn50['wall']:.3f}", p50_ms=f"{stats.latency_p50_ms:.3f}",
        p99_ms=f"{stats.latency_p99_ms:.3f}", card=json.dumps(smi))
    del model
    torch.cuda.empty_cache()
    # phase 9's launches less the vision tower's attention: the ResNet runs none
    attention = dict(mha_fwd=text, mha_bwd=text)
    exp6_rn50 = phase_exp6(
        smi, "RN50", (21, 22), TRAIN_BATCH, TRAIN_BATCH, EXP6_STEPS_PER_EPOCH, EVAL_PAIRS,
        warm_step=dict(attention, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(attention, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd=text))
    log("phase 22 rn50", step_ms=json.dumps({k: round(v["step_ms"], 3)
                                             for k, v in exp6_rn50["rates"].items()}),
        pairs_per_s=json.dumps({k: round(v["pairs_per_s"], 1)
                                for k, v in exp6_rn50["rates"].items()}),
        max_memory_allocated_gib=f"{exp6_rn50['peak'] / 2**30:.3f}",
        eval_seconds=json.dumps([round(x, 3) for x in exp6_rn50["eval_seconds"]]),
        card=json.dumps(smi))
    torch.cuda.empty_cache()
    cli_rn50 = phase_cli_rn50(smi)
    torch.cuda.empty_cache()

    # the rest of the losses and the step knobs: SigLIP, GradCache, the CLI
    siglip_config = load_config(os.path.join(REPO, "configs", "siglip_vitb32.yaml"))
    siglip_fields = {k: getattr(siglip_config, k) for k in SIGLIP_FIELDS}
    b32 = dict(mha_fwd=24, mha_bwd=24)
    siglip = phase_exp6(
        smi, "ViT-B-32", (24, 24), TRAIN_BATCH, TRAIN_BATCH, SIGLIP_STEPS_PER_EPOCH, EVAL_PAIRS,
        warm_step=b32, main_step=b32, per_eval_batch=dict(mha_fwd=24), overrides=siglip_fields)
    first, last = siglip["records"][0], siglip["records"][-1]
    log("phase 24 siglip", siglip_scale_init=siglip_config.siglip_logit_scale_init,
        siglip_bias_init=siglip_config.siglip_logit_bias_init,
        siglip_scale_last=last["siglip_scale"], siglip_bias_last=last["siglip_bias"],
        loss_first=first["train_loss"], loss_last=last["train_loss"],
        max_memory_allocated_gib=f"{siglip['peak'] / 2**30:.3f}",
        eval_seconds=json.dumps([round(x, 3) for x in siglip["eval_seconds"]]),
        card=json.dumps(smi))
    if last["siglip_scale"] == siglip_config.siglip_logit_scale_init \
            or last["siglip_bias"] == siglip_config.siglip_logit_bias_init:
        raise AssertionError("SigLIP's scale and bias did not move from their inits")
    torch.cuda.empty_cache()
    gradcache = phase_gradcache_equality(smi)
    torch.cuda.empty_cache()
    # pass 1 and pass 2 each run both towers over the 4 microbatches
    passes = 2 * GRADCACHE_STEPS
    attention = dict(mha_fwd_head_group=24 * passes, mha_bwd_head_group=24 * GRADCACHE_STEPS,
                     mha_fwd=12 * passes, mha_bwd=12 * GRADCACHE_STEPS)
    gradcache_l336 = phase_exp6(
        smi, L336, (26, 26), L336_GRADCACHE_BATCH, L336_CHECK_BATCH,
        L336_GRADCACHE_STEPS_PER_EPOCH, L336_EVAL_PAIRS,
        warm_step=dict(attention, lunif_fwd=2, lunif_bwd=2),
        main_step=dict(attention, infonce_fwd=1, infonce_bwd_dimg=1, infonce_bwd_dtxt=1,
                       lunif_fwd=1, lunif_bwd=1),
        per_eval_batch=dict(mha_fwd_head_group=24, mha_fwd=12),
        overrides=dict(grad_accum_steps=GRADCACHE_STEPS))
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    log("phase 26 l336", batch=L336_GRADCACHE_BATCH, grad_accum_steps=GRADCACHE_STEPS,
        step_ms=json.dumps({k: round(v["step_ms"], 3) for k, v in gradcache_l336["rates"].items()}),
        pairs_per_s=json.dumps({k: round(v["pairs_per_s"], 1)
                                for k, v in gradcache_l336["rates"].items()}),
        max_memory_allocated_gib=f"{gradcache_l336['peak'] / 2**30:.3f}",
        card_memory_gib=f"{card_bytes / 2**30:.3f}",
        eval_seconds=json.dumps([round(x, 3) for x in gradcache_l336["eval_seconds"]]),
        card=json.dumps(smi))
    if gradcache_l336["peak"] >= card_bytes:
        raise AssertionError("the ViT-L-14-336 GradCache step does not fit the card")
    torch.cuda.empty_cache()
    cli_losses = phase_cli_losses(smi)
    torch.cuda.empty_cache()

    # the rest of inference, serving and export: full-width bf16 ViT-B-32
    image_ops = phase_image_ops(smi)
    model = create_model("ViT-B-32", dtype=torch.bfloat16, device="cuda", seed=SEED)
    fp32_rate = dict(requests_per_s=round(stats_b32.requests / serve["wall"], 1),
                     p50_ms=round(stats_b32.latency_p50_ms, 3),
                     p99_ms=round(stats_b32.latency_p99_ms, 3))
    serve_u8 = phase_serve_u8(smi, model, fp32_rate)
    del model
    torch.cuda.empty_cache()
    cli_augment = phase_cli_augment(smi, cli_exp6)
    torch.cuda.empty_cache()
    model = create_model("ViT-B-32", dtype=torch.bfloat16, device="cuda", seed=SEED)
    exported = phase_export(smi, model)
    del model
    torch.cuda.empty_cache()

    # the extensions and knobs: the sparse projection through the CLI with
    # the plots, remat on ViT-L-14-336 at batch 256 and on RN50, the one-hot
    # embedding and the LayerNorm in the compute type
    cli_sparse = phase_cli_sparse(smi, cli_exp6)
    torch.cuda.empty_cache()
    remat_l336 = phase_remat_l336(smi, gradcache_l336)
    torch.cuda.empty_cache()
    remat_rn50 = phase_remat_rn50(smi, exp6_rn50)
    torch.cuda.empty_cache()
    knobs = phase_knobs(smi, exp6)
    torch.cuda.empty_cache()

    # the host data routes: the native tokenizer, both auto routes through
    # the RN50 baseline YAML, the grain route, and ViT-L-14 from its YAML
    tokenizer = phase_native_tokenizer(smi)
    cli_rn50_yaml = phase_cli_rn50_yaml(smi, tokenizer, cli_rn50)
    torch.cuda.empty_cache()
    cli_grain = phase_cli_grain(smi, cli_exp6)
    torch.cuda.empty_cache()
    vitl14 = phase_cli_vitl14(smi)
    torch.cuda.empty_cache()

    # data-parallel training across processes: rows 1, 3, 10 and 11 at the
    # tensor-parallel shapes, timed alone; then the CLI under torchrun over
    # NCCL at world = the card count (its processes driven from a thread)
    # beside 2 and 4 gloo ranks on card 0
    tp_kernels = phase_tp_kernels(smi)
    torchrun = _Background(phase_torchrun_nccl, smi, cli_exp6)
    try:
        dp_gloo = phase_dp_gloo(smi)
    finally:
        torchrun = torchrun.join()
    torch.cuda.empty_cache()

    # the repository's two large-tower YAMLs and the widest tower served:
    # rows 1 and 3 at their shapes first, then ViT-g-14 under the launcher,
    # ViT-H-14 at pp 2 in gloo ranks (both started at phase 11), ViT-bigG-14
    # behind the server
    large_kernels = phase_large_kernels(smi)
    vitg14 = phase_cli_vitg14(smi, large["g14"])
    vith14 = phase_cli_vith14_pp(smi, large["h14"])
    stop_large_launches(large)
    serve_bigg = phase_serve_bigg(smi)

    # the rest of the model registry: every tower no phase above builds,
    # served; ViT-B-16, RN101 and RN50x64 under exp 6; ViT-bigG-14 trained
    # through the CLI
    sweep = phase_registry_sweep(smi)
    registry = phase_registry_train(smi)
    cli_bigg = phase_cli_bigg(smi)

    # each row's times are at the case named beside it: the RN50 main
    # path's shape where the kernel runs on it (the text tower's causal
    # attention, the loss rows at (256, 1024)), else ViT-B-32's vision shape
    sources = {
        "mha_fwd": ("ops/csrc/mha_fwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:67",
                    kernel, "text"),
        "mha_bwd": ("ops/csrc/mha_bwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:95",
                    train_kernels, "mha_bwd/text"),
        "infonce_fwd": ("ops/csrc/infonce.cu", "sparsify_clip_tpu/ops/pallas_infonce.py:64",
                        train_kernels, f"infonce_fwd/{MAIN_LOSS_SHAPE}"),
        "infonce_bwd_dimg": ("ops/csrc/infonce.cu",
                             "sparsify_clip_tpu/ops/pallas_infonce.py:185",
                             train_kernels, f"infonce_bwd_dimg/{MAIN_LOSS_SHAPE}"),
        "infonce_bwd_dtxt": ("ops/csrc/infonce.cu",
                             "sparsify_clip_tpu/ops/pallas_infonce.py:222",
                             train_kernels, f"infonce_bwd_dtxt/{MAIN_LOSS_SHAPE}"),
        "lunif_fwd": ("ops/csrc/lunif.cu", "sparsify_clip_tpu/ops/pallas_lunif.py:41",
                      lunif_kernels, f"lunif_fwd/{MAIN_LOSS_SHAPE}"),
        "lunif_bwd": ("ops/csrc/lunif.cu", "sparsify_clip_tpu/ops/pallas_lunif.py:91",
                      lunif_kernels, f"lunif_bwd/{MAIN_LOSS_SHAPE}"),
        "mha_fwd_head_group": ("ops/csrc/mha_fwd.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:204",
                               head_group, "mha_fwd_head_group/vision"),
        "mha_bwd_head_group": ("ops/csrc/mha_head_group.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:228",
                               head_group, "mha_bwd_head_group/vision"),
        "ln_qkv_fwd": ("ops/csrc/ln_qkv.cu", "sparsify_clip_tpu/ops/pallas_ln_qkv.py:55",
                       ln_qkv, "ln_qkv_fwd/vision"),
        "ln_qkv_fwd/fp32": ("ops/csrc/ln_qkv.cu", "sparsify_clip_tpu/ops/pallas_ln_qkv.py:55",
                            ln_qkv, "ln_qkv_fwd/vision-fp32"),
        "ln_fast_bwd": ("ops/csrc/ln_qkv.cu",
                        "sparsify_clip_tpu/ops/pallas_ln_qkv.py:135 _vjp_bwd (XLA vjp of the "
                        "twin, no pallas_call)", ln_qkv, "ln_fast_bwd/vision"),
        # ViT-L-14's vision shape (phase 39): the whole-width pair at L = 257
        # in bf16, the head-group forward in fp32 (the eval twin)
        "mha_fwd/vision-257": ("ops/csrc/mha_fwd.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:67",
                               vitl14["kernels"], "mha_fwd/vision-257"),
        "mha_bwd/vision-257": ("ops/csrc/mha_bwd.cu",
                               "sparsify_clip_tpu/ops/pallas_attention.py:95",
                               vitl14["kernels"], "mha_bwd/vision-257"),
        "mha_fwd_head_group/fp32-257": ("ops/csrc/mha_fwd.cu",
                                        "sparsify_clip_tpu/ops/pallas_attention.py:204",
                                        vitl14["kernels"], "mha_fwd_head_group/vision-fp32-257"),
        # ViT-B-32 at tp 2 (phase 42): each rank's heads and 3W/tp columns
        "mha_fwd/tp2": ("ops/csrc/mha_fwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:67",
                        tp_kernels, "mha_fwd/tp2-vision"),
        "mha_bwd/tp2": ("ops/csrc/mha_bwd.cu", "sparsify_clip_tpu/ops/pallas_attention.py:95",
                        tp_kernels, "mha_bwd/tp2-vision"),
        "ln_qkv_fwd/tp2": ("ops/csrc/ln_qkv.cu", "sparsify_clip_tpu/ops/pallas_ln_qkv.py:55",
                           tp_kernels, "ln_qkv_fwd/tp2-vision"),
        "ln_fast_bwd/tp2": ("ops/csrc/ln_qkv.cu",
                            "sparsify_clip_tpu/ops/pallas_ln_qkv.py:135 _vjp_bwd (XLA vjp of the "
                            "twin, no pallas_call)", tp_kernels,
                            "ln_fast_bwd/tp2-vision"),
    }
    # the large towers' shapes (phases 43-45): each case counts its path's
    # launches of its kernel (both towers of that path alike)
    large = {}
    for key in large_kernels:
        kernel, case = key.split("/")
        source = "ops/csrc/mha_fwd.cu" if kernel == "mha_fwd" else "ops/csrc/mha_bwd.cu"
        line = 67 if kernel == "mha_fwd" else 95
        sources[key] = (source, f"sparsify_clip_tpu/ops/pallas_attention.py:{line}",
                        large_kernels, key)
        large[key] = (kernel, lambda path, p=LARGE_PATHS[case.split("-")[0]]: path in p)
    # rows 5-7 at ViT-g-14's (64, 1024), at each ViT-H-14 stage's (32, 1024)
    # and at ViT-bigG-14's (64, 1280), rows 8-9 at ViT-bigG-14's (its exp 6)
    for kernel, line, shapes in (
            ("infonce_fwd", 64, ("64x1024", "32x1024", "64x1280")),
            ("infonce_bwd_dimg", 185, ("64x1024", "32x1024", "64x1280")),
            ("infonce_bwd_dtxt", 222, ("64x1024", "32x1024", "64x1280")),
            ("lunif_fwd", 41, ("64x1280",)), ("lunif_bwd", 91, ("64x1280",))):
        loss = kernel.split("_")[0]
        for shape in shapes:
            tower = {"64x1024": "g14", "32x1024": "h14", "64x1280": "bigG"}[shape]
            key = f"{kernel}/{shape}"
            sources[key] = (f"ops/csrc/{loss}.cu",
                            f"sparsify_clip_tpu/ops/pallas_{loss}.py:{line}",
                            train_kernels if loss == "infonce" else lunif_kernels, key)
            large[key] = (kernel, lambda path, p=LARGE_PATHS[tower]: path in p)
    # the fused LN+qkv runs in bf16 on the train paths and in fp32 (the twin)
    # on the eval paths: each case counts its own paths' launches
    # the L = 257 cases count the ViT-L-14 CLI's launches of their kernel
    # (its vision tower at 257 and its text tower at 77 alike)
    on_vitl14 = lambda path: path == "cli_vitl14"  # noqa: E731
    # (the data-parallel paths of phase 41 run ViT-B-32 and RN50: their
    # attention counts with the whole-width rows, not the L = 257 cases)
    on_tp = lambda path: path == "train_dp_gloo_tp2_fused"  # noqa: E731
    counted = {"ln_qkv_fwd": ("ln_qkv_fwd", lambda path: not path.startswith("eval")),
               "mha_fwd/tp2": ("mha_fwd", on_tp), "mha_bwd/tp2": ("mha_bwd", on_tp),
               "ln_qkv_fwd/tp2": ("ln_qkv_fwd", on_tp), "ln_fast_bwd/tp2": ("ln_fast_bwd", on_tp),
               "ln_qkv_fwd/fp32": ("ln_qkv_fwd", lambda path: path.startswith("eval")),
               "mha_fwd/vision-257": ("mha_fwd", on_vitl14),
               "mha_bwd/vision-257": ("mha_bwd", on_vitl14),
               "mha_fwd_head_group/fp32-257": ("mha_fwd_head_group", on_vitl14), **large}
    entries = []
    for name in (*KERNELS[:KERNELS.index("ln_qkv_fwd") + 1], "ln_qkv_fwd/fp32",
                 *KERNELS[KERNELS.index("ln_qkv_fwd") + 1:], "mha_fwd/vision-257",
                 "mha_bwd/vision-257", "mha_fwd_head_group/fp32-257", "mha_fwd/tp2",
                 "mha_bwd/tp2", "ln_qkv_fwd/tp2", "ln_fast_bwd/tp2", *large):
        source, replaces, results, case = sources[name]
        r = results[case]
        counter, on_path = counted.get(name, (name, lambda path: True))
        by_path = {
            "train": train["launches"][counter],
            "train_exp6": sum(c[counter] for c in exp6["train"]),
            "eval": sum(c[counter] for c in exp6["eval"]),
            "serve": serve["launches"][counter],
            "train_exp6_l336": sum(c[counter] for c in exp6_l336["train"]),
            "eval_l336": sum(c[counter] for c in exp6_l336["eval"]),
            "serve_l336": serve_l336["launches"][counter],
            "train_exp6_l336_fused": sum(c[counter] for c in exp6_fused["train"]),
            "eval_l336_fused": sum(c[counter] for c in exp6_fused["eval"]),
            "cli_smoke": cli_smoke["launches"][counter],
            "cli_exp6": cli_exp6["launches"][counter],
            "serve_rn50": serve_rn50["launches"][counter],
            "train_exp6_rn50": sum(c[counter] for c in exp6_rn50["train"]),
            "eval_rn50": sum(c[counter] for c in exp6_rn50["eval"]),
            "cli_rn50": cli_rn50["launches"][counter],
            "train_siglip": sum(c[counter] for c in siglip["train"]),
            "eval_siglip": sum(c[counter] for c in siglip["eval"]),
            "train_gradcache_b32": gradcache["launches"][counter],
            "train_gradcache_l336": sum(c[counter] for c in gradcache_l336["train"]),
            "eval_gradcache_l336": sum(c[counter] for c in gradcache_l336["eval"]),
            "cli_roberta": cli_losses["roberta-vitb32"][counter],
            "cli_siglip": cli_losses["siglip-vitb32"][counter],
            "serve_u8": serve_u8["launches"][counter],
            "export": exported["launches"][counter],
            "cli_augment": cli_augment["launches"][counter],
            "cli_sparse": cli_sparse["launches"][counter],
            "train_sparse_topk": cli_sparse["steps"]["topk"]["launches"][counter],
            "train_sparse_l1": cli_sparse["steps"]["l1"]["launches"][counter],
            "train_remat_l336": remat_l336["launches"][counter],
            "train_remat_l336_fused": remat_l336["fused_launches"][counter],
            "train_remat_rn50": remat_rn50["launches"][counter],
            "train_onehot": knobs["launches"]["onehot_embed"][counter],
            "train_ln_fp32_false": knobs["launches"]["ln_fp32_false"][counter],
            "cli_rn50_yaml": cli_rn50_yaml["launches"][counter],
            "cli_grain": cli_grain["launches"][counter],
            "cli_vitl14": vitl14["launches"][counter],
            "cli_torchrun_nccl": torchrun["launches"][counter],
            **{path: counts[counter] for path, counts in dp_gloo["launches"].items()},
            "cli_vitg14": vitg14["launches"][counter],
            "train_gloo_vith14_pp2": vith14["launches"][counter],
            "serve_bigG": serve_bigg["launches"][counter],
            "serve_registry": sweep["launches"][counter],
            **{f"{kind}_{tag}": sum(c[counter] for c in registry[name][part])
               for name, tag in (("ViT-B-16", "b16"), ("RN101", "rn101"),
                                 ("RN50x64", "rn50x64"))
               for kind, part in (("train_exp6", "train"), ("eval", "eval"))},
            "cli_bigG": cli_bigg["launches"][counter],
        }
        by_path = {path: count for path, count in by_path.items() if on_path(path)}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"sparsify_clip_tpu_torch/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "device_ms": r.get("device_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": r.get("library"),
            "case": case,
        })
    log("total", seconds=f"{time.perf_counter() - T0:.1f}", limit_s=1200,
        phase_seconds=json.dumps(phase_seconds()))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # a rank of phase 40 or 43, under the launcher
        sys.exit(cli_rank_main(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 41, under the launcher
        sys.exit(dp_rank_main(sys.argv[2]))
    sys.exit(main())
