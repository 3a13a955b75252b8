"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (an H100 is the target) and ``nvcc``. In order:

1. Prints the card's name and power limit, the torch/CUDA versions, and
   builds every kernel under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source: K4 ``flash_attention.cu`` and K5
   ``selective_scan.cu`` first, then K1 ``edge.cu``, K2
   ``edge_pipelined.cu`` and K3 ``edge_stream.cu``, all started together
   in a child process at nice 10 that compiles while phases 6-19 run
   (phase 1b waits for it), printing each source's compile seconds.
   Every phase prints its seconds.
2. Holds K1 (``edge_cuda``) bit-equal (``torch.equal``) to its plain PyTorch
   version (``edge_plain``) on the card: magnitude, components and per-tile
   max, for every operator x variant x directions x padding at 1x1, 2x3,
   37x53 and 237x413 on gray u8, fractional gray f32, RGB u8 and
   fractional RGB f32, and for the default config at 2048x2048 f32 gray and
   1080x1920 RGB u8. The operators are the five built-ins and a 9x9
   separable one, the largest size the kernel takes. Where the wrapper
   picks K1's compile-time instance (the default sobel5, v2, 2 or 4
   directions) the run-time-taps instance (``instance="runtime"``) is held
   to the same outputs too; so in phases 2b, 2c and 2e.
2b. Holds K1's NMS outputs (``out_nms``: thin map, centre components,
   un-thinned magnitude, per-tile max) bit-equal to ``edge_plain`` for
   sizes 3/5/7/9, 2 and 4 directions, every padding, gray u8/f32 and RGB
   u8/f32, at 1x1, 2x3, 37x53 and 70x270 on two tile shapes.
2c. Holds K3 (``edge_stream_cuda``) bit-equal to ``edge_stream_plain`` with
   masks all-0, all-1, random, a clustered block (the motion shape), one
   tile and only the last ragged tile, NMS on and off, on ragged shapes, a
   (1, 1, 1) grid, 4x2048x2048 u8, 8x8 tiles on 4x512x512 (more tiles than
   one chunk of K3's in-kernel scan) and caches one row into a larger
   buffer with ``w`` odd (off 16 bytes); with an all-1 mask K3 must equal
   K1, with an all-0 mask the caches. Both of K3's copy routes (16-byte
   vectors and floats) must have run.
2d. Holds K2 (``edge_cuda(pipeline_depth=d)``, K1's walk fed by a ring of
   windows copied ahead on a persistent grid) bit-equal to ``edge_plain``
   and to K1 at depths 2, 3 and 8, on both instances where K1 has two, for
   every operator x variant x directions x padding on gray u8/f32 and RGB
   u8/f32 at the phase-2 sizes (the 237x413 grid has fewer tiles in a row
   than depth 8) and at 29x96, whose 16-byte rows take the TMA route (an
   offset copy of the same frames the cp.async route; the other sizes take
   cp.async), with NMS off (magnitude, components, per-tile max) and on
   (thin map, components, un-thinned magnitude, per-tile max), and at
   4x2048x2048 f32 and u8 on the FULL 64x256 tile at every depth that fits
   (1,024 tiles, more than the grid has CTAs); both copy routes must have
   run, every depth whose footprint exceeds ``SMEM_MAX`` must raise, and
   ``edge.pipelined_smem_bytes`` and ``pipelined_bands`` must equal the
   source's own layout and band count.
2e. Holds the integer lane (``precision="int"``) of K1 and K2 bit-equal to
   the f32 plain lane for every int-eligible operator x variant x
   directions x padding on u8 gray at the phase-2 sizes, and at
   4x2048x2048 u8.
2f. Holds K1 and K2 with stencil plans (``plan=``: the pre-stages fused
   into the same launch) bit-equal to ``edge_plain(plan=)``, K2 also to K1,
   on both of K1's instances where it has two, at K2 depths 2, 3 and 8: the
   CPU tests' plans (``plan_battery``: ``canny5``, ``blur_sobel5`` and
   custom plans covering every stage kind) x padding x gray u8/f32 and RGB
   u8/f32 at the phase-2b sizes and 237x413 on two tiles, NMS on (thin
   map, components, un-thinned magnitude, per-tile max) and off (magnitude
   or components, per-tile max); the integer lane of the integer plans;
   ``canny5`` and ``blur_sobel5`` at 4x2048x2048 u8 and f32 on the 64x256
   tile at every ring depth, where each depth whose footprint exceeds
   ``SMEM_MAX`` must raise. ``edge.pipelined_smem_bytes(plan=)`` must equal the source's.
3. Drives the facade, ``repro_torch.api.edge_detect`` with the default
   ``EdgeConfig()``, on a 1080p RGB u8 batch and an NTHW gray u8 stack; each
   must equal ``backend="torch"`` on the same device, must agree with
   digests of the JAX reference's output on small inputs, and must launch K1.
3b. ``edge_detect(..., nms=True, hysteresis=True)`` on the card equals the
   torch lane, and 8 frames of 4 full-width streams through
   ``edge_detect_stream`` with ``decay=0`` equal 8 stateless ``edge_detect``
   calls.
3c. This slice's main path: ``edge_detect`` on the sobel-hd FULL config at
   4x2048x2048 with ``pipeline_depth=d`` for every depth that fits, on f32
   and u8 frames, must launch K2 (u8 on its integer lane) and equal the
   torch lane; on u8 with ``precision="auto"`` it must run K1's integer
   lane. Counts are set to 0 just before each call and read just after.
3d. ``tuning.autotune`` of the image server's workload (4 f32 frames of
   2048x2048, ``TUNE_SHAPES`` x depths 0 and 2, best of 3) into this run's
   cache (``REPRO_TUNE_CACHE`` under ``build/chip_smoke``), printing the
   rows of a second sweep of the same candidates; then ``edge_detect`` with no tile must report ``"tuned"``
   and launch the kernel of the recorded depth, and again with the depth
   pinned to 2 (its own tuned slot, K2). Every output equals the torch lane.
3e. The stencil-plan slice's main path, the sobel-hd FULL config at
   4x2048x2048 through ``edge_detect``: ``plan="canny5", hysteresis=True``
   on u8 and f32 frames, ``plan="blur_sobel5"`` (normalized) on both,
   ``("dilate3", "sobel5", "nms")`` on u8 under ``precision="auto"`` (K1's
   integer lane) and ``canny5`` with ``pipeline_depth=2`` on u8 (K2). Counts
   are set to 0 just before each call and read just after: each must be one
   K1 (or K2) launch with pre-stages, equal to the torch lane on the card;
   each prints its shared-memory footprint. Small inputs must match
   digests of the JAX reference's plan outputs (``PLAN_GOLDEN``).
3f. The sharded slice's main path: ``edge_detect(x, cfg, mesh=...)`` on the
   sobel-hd FULL config over meshes 2x2x2, 1x4x2, 1x2x2 and data=8 of
   eight logical devices on the card (``[cuda:0] * 8``, the counterpart
   of the reference tests' 8 forced host devices): 4x2048x2048 f32, u8
   (K1's integer lane under ``precision="auto"``), RGB u8 4x1080x1920,
   ``nms=True, hysteresis=True``, ``canny5`` and ``pipeline_depth=2``
   (K2). Counts are set to 0 just before each call and read just after:
   one K1 (or K2) launch per shard, and each call equal to the
   single-device call and to the torch lane. Each call is timed on CUDA
   events beside the single-device call, with the split between the
   exchange, the per-shard launches and the gather. The distinct-GPU path
   (``cuda:0..N``) runs only where there is more than one card; the
   script says when it did not.
4. Serves sobel-hd at full size (2048x2048 f32 frames, 4 per request, 8
   requests) through ``repro_torch.launch.serve`` in-process, with the
   launch counts set to 0 just before and read just after; the last answer
   must equal the torch lane's on the same frames. One more request runs
   under ``torch.profiler`` and its device time by kernel is printed. Then
   the same server with ``--edges`` (K1's NMS outputs + hysteresis).
4b. The streaming detector, the main path of this slice: ``--streams 4
   --requests 8`` at full width (2048x2048 u8, 64x256 tiles), three runs:
   ``--motion 2``, ``--motion 0`` (the cached path) and ``--decay 0.9``.
   Each run must launch K3 (counts set to 0 just before), degrade and
   retry nothing, account for every frame, and equal, frame by frame, a
   replay of the same frames through the torch lane. Prints per-stream
   compute and transfer p50/p99, the skip rate, and the hysteresis
   iterations.
4c. Times the parts of one stream step of the motion run: the transfer,
   the change test, K3, hysteresis, the epilogue and the whole step.
4d. The same step with hysteresis fractions that leave weak chains to link
   (``WEAK_LOW``/``WEAK_HIGH``): must equal the torch lane and take as many
   dilation steps; prints the steps and the linking loop's time.
4e. The elastic image server on ``[cuda:0] * 8`` with ``--shard 2x2x2``:
   ``--chaos 'loss@3;fail@step:1x2;slow@d1:40'``, then
   ``--simulate-loss-at 3``, then ``--edges`` with the same loss, 8
   requests of 4 FULL frames each, counts set to 0 just before each run.
   Each run must account for every request (``unaccounted=0``), replan at
   least once, launch K1, and answer its last request as the torch lane
   does on the same frames; prints MPS, compute and transfer p50 and the
   re-warm times.
5. Times K1, K1 with ``out_nms``, K2 at every depth that fits at
   4x2048x2048 f32 and u8 in turns with K1 (K1, K2, K2, K1) with its copy
   route, the integer lane of K1 and K2 at 4x2048x2048 u8 (K2's in turns
   with K1's; K1's beside its f32 lane on the same frames, timed again
   after it),
   and K3 (at 0%, the motion run's share and 100% of tiles changed, also
   as device microseconds a launch under the profiler, and at 100% in
   turns with K1's NMS lane on the same frames), K1 and K3 on both
   instances, with
   CUDA events, beside their plain versions and their bounds on the card
   (the NMS lane's operations counted on the pixels each mask needs,
   ``nms_lane_ops``; the integer lane's ladder at the card's INT32 rate,
   ``int_lane_bound``), with a library yardstick for K1 and K2 (cuDNN
   ``F.conv2d`` of the 4-direction bank, which covers the components only
   and is used nowhere in the port; no single PyTorch call computes the
   NMS lane or K3), and prints one JSON line of them. The plan lanes join
   K1's and K2's entries: ``canny5`` (thin map and maxima, as the facade
   asks) and ``blur_sobel5`` on K1, ``canny5`` on K2 at the depths that
   fit, at 4x2048x2048 u8 and f32 in turns with K1's NMS lane on the same
   frames, beside the plain version and the bound (the ladder's and NMS's
   operations plus each pre-stage's, ``plan_pre_ops``), with
   ``blur_sobel5``'s yardstick one cuDNN ``F.conv2d`` of the composed 9x9
   bank (components only, used nowhere in the port). K4 joins it: CUDA-event
   medians at (1, 32, 2048, 64) causal f32, at the LM server's prefill
   shapes (1, 32, S in 8/16/32/64, 64) and at minicpm3-4b's MLA shape
   (1, 40, 2048, 96) with v of 64 (K4 on v zero-padded to 96, the
   yardstick on the 64-wide v), in turns with
   ``F.scaled_dot_product_attention(is_causal=True)`` (the yardstick, used
   nowhere in the port; library, kernel, kernel, library), beside its plain
   version and its bound (``flash_bound``: the 3xTF32 products at the
   dense TF32 rate, the SFU's exponentials and the bytes, each printed, and
   the SIMT bound of the kernel it replaced). K5 joins it: CUDA-event
   medians and device microseconds a launch (profiler, 50 launches) at
   (1, 2048, 8192, 16) and at the ssm server's prefill shapes (1, L in
   8/16/32/64, 8192, 16), f32, beside its plain version and its
   bound (``scan_bound``: bytes, f32 operations and the SFU's exponentials,
   each term printed); no PyTorch call computes a selective scan, so it
   has no yardstick. K4 also at zamba2's (1, 32, 2048, 80) and pixtral's
   (1, 32, 1056, 128) causal and whisper's encoder (1, 20, 1500, 64)
   non-causal, in turns with SDPA of the same mask.
6. Holds K4 (``flash_attention``) to ``flash_attention_plain`` on the card,
   f32 and bf16, causal and not, on the reference test's four shapes,
   ragged lengths 1-200 at head dims 64 and 128, the server's prefill shapes
   and (1, 32, 2048, 64), zamba2's shared block (1, 32, S, 80) for S in
   8/16/32/64/1000/2048, whisper's encoder (4, 20, 1500, 1500, 64), cross-
   (4, 20, 32, 1500, 64) and decoder self-attention (4, 20, 32, 32, 64),
   and pixtral's (4, 32, 1056, 1056, 128): f32 within 2e-5 (abs + rel),
   bf16 within one ulp of the output plus 2e-5. MLA's prefill shapes (1, 40, S, 96), S in
   8/16/32/64/2048, causal f32, v of 64 zero-padded to 96 as
   ``models/attention.py`` pads it: within 2e-5 of the plain version on the
   padded and on the 64-wide v, the 32 padded output columns exactly 0.
7. This slice's main path: the LM server, ``repro_torch.launch.serve
   --arch llama3.2-1b --requests 16 --slots 4 --max-new 16``, FULL width
   and depth in f32, counts set to 0 just before and read just after: K4
   must launch 16 layers x 16 prefills = 256 times and nothing else may
   launch. The same requests on the same weights then run through the
   plain lane on the card: the engine's padded prefills' logits must agree
   within ``LOGIT_TOL``, and the greedy tokens must be equal except where
   the plain lane's top-2 logit gap is below it (the count is printed;
   ``lane_replay``). One engine prefill round and one decode step run
   under the profiler (``profile_engine``).
7b. ``Model.prefill`` at FULL width on prompts of 2,048 and 1,000 tokens
   (``long_prefill``): 16 K4 launches each, logits within ``LOGIT_TOL`` of
   the plain lane. The llama weights are freed after it.
8. Holds K5 (``selective_scan``) to ``selective_scan_plain`` on the card,
   both outputs (y and the final state), f32 and bf16: the reference
   test's shapes and blocks, ragged d_inner (24, 200) x N (1, 4, 16) x L
   (1, 7, 2048), N of 33 and 64 at L = 7 and 2,049, the ssm server's
   prefill shapes (1, L, 8192, 16) for L = 8/16/32/64, and (1, 2048, 8192,
   16). f32 within 3e-5 (abs + rel, the reference test's); bf16 y within
   one ulp plus 3e-5, its f32 state within 3e-5; prints how many cases are
   bit-equal to the plain version and how many launches took cp.async.
9. The ssm slice's main path: first the port's server with ``--arch
   falcon-mamba-7b`` must refuse the reference server's random prompt
   lengths in the reference's words. Then ``repro_torch.serve.Engine`` on
   FULL falcon-mamba-7b in f32 (7,272,665,088 parameters drawn on the card
   from seed 0), 4 slots, 16 requests of 16 new tokens, contexts of bucket
   length (8/16/32/64, ``default_rng(0)``) plus one last token, with the
   counts set to 0 just before and read just after: K5 must launch 64
   layers x 16 prefills = 1,024 times and K1-K4 never. A replay on the
   plain lane on the same weights: prefill logits within ``LOGIT_TOL``,
   tokens equal except where the plain lane's top-2 gap is below it (the
   count is printed). One prefill round and one decode step run under the
   profiler, with K5's share of the device time.
9b. ``Model.prefill`` at FULL falcon-mamba-7b on 2,048 and 1,000 tokens
   (``_pick_chunk(1000, 16)`` = 10): 64 K5 launches each, logits within
   ``LOGIT_TOL`` and the cache's ``h`` and ``conv`` within ``STATE_TOL``
   of the plain lane, with both lanes' seconds.
9c. The same weights with ``ssm_scan_dtype="bfloat16"`` (the reference's
   bf16 scan elements, chunks of 16 steps): the 2,048-token prefill on the
   K5 lane, counts set to 0 just before, K5 exactly 64 launches, all in
   its bf16-element mode; its logits' distance from 9b's f32 ones printed;
   and a 128-token prefill on both lanes within ``LOGIT_TOL`` (cache within
   ``STATE_TOL``). Phase 5 times that mode at (1, 2048, 8192, 16) in turns
   with the f32 mode, beside its plain version and ``scan_bound``.

10. The contract analyzer (``repro_torch.analysis``) on the card:
   ``analyze(full=True, backends=("torch", "cuda"))`` against
   ``analysis_baseline_torch.json``, with the counts set to 0 just before.
   It must report zero new violations, leave no rule unrun, and launch K1,
   K2 and K3; prints the checks, artifacts, the seconds of each part, and
   per K1-K3 instance the ``fma.rn.f32`` count of its PTX (0) and the FFMA
   count of its SASS.
10b. The paper's Fig. 7 check on FULL frames (4x2048x2048 f32): the SSIM
   (``core/ssim.py``) of K1's unnormalized magnitude against the dense
   oracle ``kernels/ref.sobel_ref`` on the plain lane exceeds 0.999999 for
   the ``separable``, ``v1`` and ``v2`` variants.

11. The moe slice's main path: ``repro_torch.serve.Engine`` on
   qwen3-moe-30b-a3b at FULL width and 24 of its 48 layers in f32
   (15,577,227,264 parameters, 62.3 GB, drawn on the card from seed 0; the
   whole model's 122.1 GB do not fit one 80 GB card), 4 slots, the
   reference server's 16 prompts, 16 new tokens, counts set to 0 just
   before and read just after: K4 must launch 24 x 16 = 384 times and
   nothing else may launch. Prints tok/s, prefill and decode-step p50. The
   same weights then run ``lane_replay``, which compares a moe model's
   lanes layer by layer (``layer_local``): at random weights its gates
   carry a last-bit difference from layer to layer, so free-running lanes
   part as far as the plain lane parts from itself with its embeddings
   moved by one ulp. Each block runs on both lanes from the plain lane's
   input: K4's attention output within ``ATTN_TOL``, the router logits
   within ``ROUTER_TOL``, the expert sets apart only where the plain lane's
   margin between its k-th and (k+1)-th router logit is at most
   ``ROUTE_MARGIN`` (2) times the lanes' router-logit difference at that
   layer (the parts are counted), and the last
   layer's logits within ``LOGIT_TOL`` (a prompt whose last layer parted is
   exempt, and counted). Greedy tokens must be equal except where the
   plain lane's top-2 gap is below ``LOGIT_TOL`` plus the one-ulp control's
   logit difference there. Then one profiled decode step with the device's
   idle share.
11b. ``long_prefill`` on those weights: 24 K4 launches a prompt. The
   weights are freed.
11c. phi3.5-moe-42b-a6.6b at FULL width and 8 of its 32 layers in f32
   (10,665,205,760 parameters, 42.7 GB; the whole is 167.5 GB):
   ``long_prefill``, 8 K4 launches a prompt (top-2 of 16 experts,
   layernorm). The weights are freed.
12. The MLA slice's main path: the LM server, ``repro_torch.launch.serve
   --arch minicpm3-4b --requests 16 --slots 4 --max-new 16``, FULL width
   and depth in f32 (4,261,902,848 parameters, 17.0 GB), counts set to 0
   just before and read just after: K4 must launch 62 x 16 = 992 times
   and nothing else may launch; then ``lane_replay``, ``profile_engine``
   and ``long_prefill`` (62 K4 launches a prompt) on the same weights.

13. zamba2-2.7b (hybrid) at FULL width and depth in f32 (2,422,670,240
   parameters, 9.7 GB, drawn on the card from seed 0): the ``Engine`` at
   4 slots on 16 bucket-length prompts (``ssm_prompts``), 16 new tokens,
   counts set to 0 just before and read just after: K4 must launch 9
   shared-block applications x 16 prefills = 144 times and nothing else
   may launch (the Mamba-2 SSD is plain PyTorch, as the reference's is
   XLA). Then ``lane_replay`` (logits within ``LOGIT_TOL``, tokens equal
   but for near ties), ``profile_engine`` (K4's share of the prefills, the
   decode step's idle share) and ``long_prefill`` (9 K4 launches a prompt).
14. whisper-large-v3 (encdec) at FULL width and depth (1,601,198,080
   parameters, 6.4 GB): ``Model.prefill`` of 4 prompts of 32 tokens over
   the whole 1,500-frame window (``lm_batch``'s ``enc_embeds``, seed 0),
   three times, each exactly 96 K4 launches (32 encoder, non-causal; 32
   decoder self; 32 cross, non-causal), then 16 greedy ``decode_step``s
   that launch nothing (``frontend_serve``). The plain lane and a one-ulp
   control run the same; the lanes are held block by block
   (``frontend_layer_local``: attention and cross-attention within
   ``ATTN_TOL``, last-layer logits within ``LOGIT_TOL``), and end to end
   where the control stays within ``LOGIT_TOL``. Prints prefill p50,
   decode-step p50, tok/s, K4's share of a prefill and a decode step's
   idle share. The weights are freed.
15. pixtral-12b (vlm) at FULL width and depth (12,247,782,400 parameters,
   49.0 GB, after every earlier model is freed): the same with 4 prompts
   of 1,024 stub patches + 32 text tokens (``lm_batch``), 40 K4 launches a
   prefill.
16. Training (after every earlier model is freed). 16a: ``k4_attention``
   (``K4Attention``: K4 forward, the plain version recomputed for the
   backward) at llama3.2-1b's training shape (8, 32, 128, 64) causal in f32
   and bf16, the mesh shards of phases 17 and 18 ((4, 16, 128, 64),
   minicpm3-4b's (4, 20, 128, 96) with v of 64 zero-padded, qwen3-moe's
   (4, 16, 128, 128) bf16), phase 19's (zamba2's (4, 16, 128, 80),
   whisper's (4, 10, 128, 64) causal and non-causal, pixtral's (4, 16,
   1152, 128), bf16) and at (2, 20, 64, 1500, 64) non-causal, and
   ``k5_scan`` at (1, 128, 512, 16), phase 18's shard (4, 128, 4096, 16)
   and one device's (8, 128, 8192, 16): forward within phase 6's and 8's
   tolerances, gradients within ``FN_GRAD_REL`` of plain autograd's; K5's
   bf16-element mode at those three shapes (chunks of 16, f32 inputs)
   bit-equal to the plain version's (y and the final state), and its
   ``k5_scan`` gradients within ``FN_GRAD_REL``; a
   bare ``backend="cuda"`` call under grad raises. 16b, the training slice's main path:
   ``repro_torch.launch.train.main(["--arch", "llama3.2-1b", "--steps",
   "8", "--batch", "8", "--seq", "128"])`` at FULL width and depth (f32
   master weights and AdamW moments, the forward in bf16), counts set to
   0 just before and read just after: K4 exactly 32 a step (16 layers,
   each unit's forward run again by remat in the backward: llama3.2-1b
   trains under ``remat_policy="dots"``), nothing else,
   no plain attention call; losses and grad norms finite, grad norms > 0,
   every parameter moved; step p50, tok/s, ``max_memory_allocated`` and
   one step under the profiler. 16c: one f32 step at FULL width on both
   lanes from the same weights, the loss and each leaf's gradient held
   beside a one-ulp control. 16d: the reference's injected-failure
   restart at SMOKE size on the card, checkpoints under ``build/``. 16e:
   one FULL step from the same state and batch under each remat policy
   (``none``, ``minimal``, ``dots``): the bytes the forward keeps
   (``remat.measure_keep``) ordered ``minimal`` < ``dots`` < ``none``,
   K4 16 in the forward and 16 more in a remat step's backward, the
   gradients bit-equal to ``none``'s (or within 16c's one-ulp control;
   it says which held); prints each policy's step p50 and peak memory.
17. Training on a mesh (after phase 16's weights are freed). 17a, the mesh
   slice's main path: ``repro_torch.launch.train.main([..., "--steps", "6",
   "--model-parallel", "2"], devices=[cuda:0] * 4)`` at llama3.2-1b's FULL
   width and depth on a 2x2 (data, model) mesh (TP + FSDP, ZeRO-1
   moments), counts set to 0 just before and read just after: K4 exactly
   16 layers x 4 positions x 2 (remat's recompute) = 128 a step, nothing
   else, no plain attention
   call; losses and grad norms finite, every parameter moved; step p50,
   tok/s, ``max_memory_allocated`` and one step under the profiler, beside
   phase 16b's. 17b: the state resharded onto a 1x2 mesh, every gathered
   leaf bit-equal. 17c: one f32 step's loss and gathered gradients on the
   2x2 mesh against one device, beside the one-ulp control, and every block
   on its own (``mesh_layer_local``). 17d: SMOKE on
   a (2, 2, 2) (pod, data, model) mesh of ``[cuda:0] * 8``.
18. The ssm, MLA and moe families on a mesh (after phase 17's weights are
   freed, each model's before the next): falcon-mamba-7b (4 of 64 layers,
   K5 on each position's 4,096 channels), minicpm3-4b (8 of 62, K4 on
   each position's 20 MLA heads) and qwen3-moe-30b-a3b (2 of 48, K4 on 16
   heads, 64 of the 128 experts a position), each at FULL width on a 2x2
   mesh of ``[cuda:0] * 4`` through the ``Trainer`` and ``DataLoader``
   that ``launch.train`` builds (it has no depth flag), 4 steps of 8 x 128
   tokens, counts set to 0 just before and read just after: K5 exactly 32
   a step, K4 64, K4 16 (each twice a unit: remat's recompute), nothing
   else, no plain attention or scan call;
   losses finite (qwen3-moe's ``moe_aux`` and ``moe_z`` too), every
   parameter moved; step p50, tok/s, ``max_memory_allocated`` and one step
   under the device-only profiler, beside phase 16b's. Then one f32 step
   of each at 2 layers, FULL width, mesh against one device: the loss
   within 1e-4, each leaf's gradient within 1e-3 or within 16x a one-ulp
   control's (``FAMILY_F64_TOL``'s comment says why), at the init's
   weights and again at fan-in scale (``fan_in_params``), where the
   control must stay under ``FAN_IN_CONTROL_MAX`` (not qwen3-moe, whose
   routing flips a near tie there); every block alone the same way at the
   latter weights, its output within 1e-3, aux losses included; for
   qwen3-moe, layer 0's MoE on one input keeps the same (token, expert)
   slots as one device in the 1,024-token group that spans both batch
   shards; and one f64 step at 1 layer on the plain lane with every f32
   part in f64, mesh against one device within 1e-5. Phases 18 and 19
   share one table (``FAMILY_MESH``) and one loop.
19. The hybrid, encdec and vlm families on a mesh, as phase 18 (after its
   weights are freed, each model's before the next), at FULL width:
   zamba2-2.7b (12 of 54 layers, 2 groups: K4 on each position's 16 heads
   of the shared block, Mamba-2's SSD on its 40 of 80 heads),
   whisper-large-v3 (8 of 32 decoder and 8 of 32 encoder layers: K4 on 10
   heads for the non-causal encoder, the causal decoder and the non-causal
   cross-attention over 128 frames) and pixtral-12b (1 of 40 layers at
   1,152 tokens a row, its 1,024 patches and 128 text tokens: K4 on 16
   heads), 4 steps of 8 rows: K4 exactly 16, 192 and 8 a step (remat's
   recompute doubles each), nothing else,
   no plain call; every parameter moved; K4 timed at each shard's shape.
   Then one f32 step of each at 6, 2 + 2 and 1 layers against one device
   as phase 18's (the control moves the frames and patches too), every
   block alone (the encoder's, the shared block's) at fan-in scale, and
   an f64 step at those depths on the plain lane with every f32 part in
   f64 (pixtral at 2 rows), within 1e-5.
20. The paged KV cache, the dry run and the roofline, each where its
   inputs are alive. 20a (after 7b, on phase 7's FULL llama3.2-1b
   weights): an ``Engine`` prefills 4 prompts of 37, 64, 100 and 129
   tokens (K4 once a layer a prefill, nothing else) and runs 16 greedy
   decode steps; a ``PagedKVCache(block_size=16)`` on the card, with just
   the blocks the contexts plus 16 rows need, takes each slot's rows by
   ``append_prompt`` and each step's by ``append``; every ``gather`` is
   bit-equal to the engine's cache rows after the prefill and after every
   step; one more ``allocate`` plus ``append`` raises ``MemoryError``; a
   freed sequence's blocks are reused. Prints the blocks used, each
   sequence's utilization and ``gather``'s CUDA-event median. 20b (after
   17b, on phase 17's trainer): the dry run's plan of phase 17's cell
   (``launch/dryrun.train_state_plan``), each leaf's spec and bytes a
   position equal to the ``Placed`` shards held, weights and both AdamW
   moments; prints ``train_4k``'s planned ``argument_size_in_bytes`` a
   device on both production meshes. 20c (after 19): the MFU of phases
   16b's and 17a's training steps, ``roofline.analysis.model_flops``'
   6*N*D over the step p50 at ``PEAK_FLOPS_BF16``, beside the card's
   name, power limit and memory (a printed line, not a gate).
21. The twins of ``examples/*`` (``examples_torch/``) on the card through
   their ``main``, counts set to 0 just before each and read just after,
   after phase 4e: ``quickstart`` (K1 bit-equal to the torch lane),
   ``edge_service --batch 8 --size 2048`` (K1, or K2 at a tuned depth,
   once a call), ``serve_lm`` (K4 once a layer a prefill), ``long_context
   --tokens 512`` (a plain-PyTorch decode: no launch) and ``train_lm
   --preset 100m --steps 20`` (K4 exactly 12 layers x 20 steps x 2).

Phase 1 builds K4 and K5, then starts the edge kernels' build in a child
process at a lower priority; phases 6-9b, 11-15, 16-19 and 20a-20c run
while it compiles; then 1b waits for it, phases 2-4e and 21 run, then phase 5, then 10
and 10b. The last line is
``{"ok": true, "device": {...}}``. Any failed phase raises,
so the script exits non-zero and prints no result; so does a host without a
CUDA device, and a directory that holds this file without ``src/``.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 33.5e12      # 67 TFLOP/s f32 counts an FMA as 2; --fmad=false runs 1 op per instruction
TF32_FLOPS_PER_S = 494.7e12  # H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
SIZES = ((1, 1), (2, 3), (37, 53), (237, 413))
NMS_SIZES = ((1, 1), (2, 3), (37, 53), (70, 270))
PLAN_SIZES = NMS_SIZES + ((237, 413),)   # phase 2f: 2b's sizes and phase 2's largest
KINDS = ("u8", "f32", "rgb", "rgb_f32")
PADDINGS = ("reflect", "edge", "zero")
OPERATORS = ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7", "sep9")
INT_OPERATORS = ("prewitt3", "scharr3", "sobel3", "sobel5", "sobel7")  # integer taps
K2_DEPTHS = (2, 3, 8)   # with 32x64 tiles the 237x413 grid has gw = 7 < 8
# Phase 2d's sizes: phase 2's, whose widths take K2's cp.async route, and
# one whose rows are 16-byte aligned in every kind (the TMA route).
K2_SIZES = SIZES + ((29, 96),)
# The outputs K2 and the integer lane are held to: magnitude and per-tile
# max; components and max; the NMS lane's thin map, components, un-thinned
# magnitude and max.
LANE_OUTPUTS = (dict(with_max=True), dict(out_components=True, with_max=True),
                dict(out_nms=True, out_components=True, out_mag=True, with_max=True))
# Candidate tiles of phase 3d's sweep at 2048x2048.
TUNE_SHAPES = ((16, 256), (32, 128), (32, 256), (64, 128), (64, 256), (128, 128))

# sha256 of the JAX reference's outputs, repro.api.edge_detect(...,
# EdgeConfig(backend="xla", with_max=True)), on the _golden_inputs() frames;
# tests/test_torch_api.py recomputes them from the reference.
GOLDEN = {
    "rgb_u8": {
        "magnitude": "662f8f004092d192fb6b2e0e5844cadf4d3a019622fb5c78449c4f2faaf83111",
        "peak": "cc6bf93c0491c86d49312035d40581af2406622fe4fe5603e3766700f1fa0051",
    },
    "gray_f32": {
        "magnitude": "a561025f16cdb60360124938a397a59059e3556d3e9c66174745e9c4cfa21f55",
        "peak": "d28b75112bbb3bfd0c5ad2b6817c0137f7e3f9e3b58778b68a20eb871d45c73c",
    },
}


# sha256 of the JAX reference's plan outputs, repro.api.edge_detect(...,
# EdgeConfig(backend="xla", plan=..., with_max=True[, hysteresis=True])), on
# the _golden_inputs() frames; tests/test_torch_plans.py recomputes them.
PLAN_GOLDEN = {
    ("canny5", "rgb_u8"): {
        "magnitude": "0044eada257688e758cdd3230fd111d968779373c197f511b21b22a23bb9a156",
        "peak": "e23a7749ed37423ca4d698b5cb1320f19e5afea740437a1151f81ade6a34d4ff",
        "edges": "7e63f4ae2d4adcb07aac5af7e01388e7390baa9548cea4ea2d205ab2d35f7e1f",
    },
    ("canny5", "gray_f32"): {
        "magnitude": "60d09457ad35eaef262e6e03d642e8e3fe049d86275dbd932b3060a4e4ef27ea",
        "peak": "d5b62f53d5845e91d7be89d668a2bb376fd8346aec71b44c81c56fe20a0a412b",
        "edges": "756b4f367d7b739bdd8484c138649b3e9c08710be12a4d4075749a45935dd5b8",
    },
    ("blur_sobel5", "rgb_u8"): {
        "magnitude": "6e88b1b99240ee3384dd991b8a87232f02d6ca265dcc4d9066a4c63e7d3d7225",
        "peak": "e23a7749ed37423ca4d698b5cb1320f19e5afea740437a1151f81ade6a34d4ff",
    },
    ("blur_sobel5", "gray_f32"): {
        "magnitude": "93308c2f9f8d0b36a334d682386e0502eaea7ae62711f62ffd6c16faa5190c1f",
        "peak": "d5b62f53d5845e91d7be89d668a2bb376fd8346aec71b44c81c56fe20a0a412b",
    },
}
# Plans of the battery the integer lane takes (integer taps).
INT_PLANS = ("erode_abs_sobel3", "dilate_sobel5_nms", "box3_erode_sobel3_nms", "cross3_sobel5")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().astype(np.float32).tobytes()).hexdigest()


def golden_inputs():
    """Small frames from a seed; their reference digests are in GOLDEN."""
    rng = np.random.default_rng(2305)
    rgb = rng.integers(0, 256, (2, 37, 53, 3)).astype(np.uint8)
    noisy = rng.uniform(0, 255, (2, 41, 29)) + rng.normal(0, 2, (2, 41, 29))
    return {"rgb_u8": rgb, "gray_f32": np.clip(noisy, 0, 255).astype(np.float32)}


def frames(kind: str, shape, rng, device):
    if kind == "u8":
        a = rng.integers(0, 256, shape).astype(np.uint8)
    elif kind in ("f32", "rgb_f32"):
        shape = tuple(shape) + ((3,) if kind == "rgb_f32" else ())
        a = np.clip(rng.uniform(0, 255, shape) + rng.normal(0, 2, shape), 0, 255)
        a = a.astype(np.float32)
    else:
        a = rng.integers(0, 256, tuple(shape) + (3,)).astype(np.uint8)
    return torch.from_numpy(a).to(device)


def separable9():
    """A 9x9 operator (OpenCV's getDerivKernels(1, 0, ksize=9)), registered
    under ``sep9``: the largest operator size csrc/edge.cu instantiates."""
    from repro_torch.core.filters import get_operator, make_separable_spec, register_operator

    col = (1.0, 8.0, 28.0, 56.0, 70.0, 56.0, 28.0, 8.0, 1.0)
    row = (-1.0, -6.0, -14.0, -14.0, 0.0, 14.0, 14.0, 6.0, 1.0)
    register_operator("sep9", make_separable_spec("sep9", col, row), overwrite=True)
    return get_operator("sep9")


def plan_battery() -> dict:
    """The CPU tests' plans (tests/test_torch_plans.py), built in the port:
    the built-ins, two pre-stages in a row, window max and min, abs,
    square, an integer separable and a dense linear stage, 3x3 and
    2-direction gradients, with and without NMS."""
    from repro_torch.core import filters as F

    one = np.ones(3, np.float32)
    box3 = F.linear_stage("box3", F.OperatorSpec(
        name="box3", size=3, directions=(1,), variants=("direct", "separable"),
        taps=F._tupleize(np.outer(one, one)[None]),
        sep=((F._tupleize(one), F._tupleize(one)),)))
    cross = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], np.float32)
    cross3 = F.linear_stage("cross3", F.OperatorSpec(
        name="cross3", size=3, directions=(1,), variants=("direct",),
        taps=F._tupleize(cross[None]), sep=(None,)))
    absf, square = F.pointwise_stage("abs", "abs"), F.pointwise_stage("square", "square")
    return {
        "canny5": F.get_plan("canny5"),
        "blur_sobel5": F.get_plan("blur_sobel5"),
        "g3_dilate_sobel5_nms": F.make_plan("g3d", ("gaussian3", "dilate3", "sobel5", "nms")),
        "erode_abs_sobel3": F.make_plan("ea", ("erode3", absf, "sobel3")),
        "square_g3_scharr3_nms": F.make_plan("sq", (square, "gaussian3", "scharr3", "nms")),
        "dilate_sobel5_nms": F.make_plan("dil", ("dilate3", "sobel5", "nms")),
        "box3_erode_sobel3_nms": F.make_plan("box", (box3, "erode3", "sobel3", "nms")),
        "cross3_sobel5": F.make_plan("cross", (cross3, "sobel5")),
    }


def mul_add(taps) -> int:
    """Multiplies and adds of one correlation with ``taps``: zero taps
    skipped, ±1 taps need no multiply."""
    nz = [float(t) for t in np.ravel(taps) if t != 0.0]
    return sum(1 for t in nz if abs(t) != 1.0) + max(0, len(nz) - 1)


def stage_ops(stage) -> int:
    """f32 operations of one pre-stage per pixel of its output plane: a
    linear stage's products and sums (both passes of a separable one), a
    window's compares (2r per pass), abs 1, the fenced square 2."""
    if stage.kind == "linear":
        fac = stage.operator.sep_factors(0)
        if fac is not None:
            return mul_add(fac[1]) + mul_add(fac[0])
        return mul_add(stage.operator.bank(1)[0])
    if stage.kind == "window_reduce":
        return 2 * 2 * stage.radius
    return 1 if stage.op == "abs" else 2


def plan_pre_ops(plan, n: int, h: int, w: int, nms: bool) -> int:
    """The pre-stages' operations of one call on ``n`` frames of ``h x w``:
    each stage over its output plane, the frame extended by the radii still
    to come (and NMS's ring), once a frame (Gaussian5: 18 a pixel)."""
    pad = 1 if nms else 0
    remaining = plan.linear_reach
    total = 0
    for stage in plan.pre_stages:
        remaining -= stage.radius
        total += n * (h + 2 * (remaining + pad)) * (w + 2 * (remaining + pad)) * stage_ops(stage)
    return total


def kernel_ops_per_pixel(spec, variant: str, directions: int, rgb: bool) -> int:
    """f32 multiplies, adds and square roots K1's arithmetic needs per output
    pixel, each distinct row pass counted once (the least work of the
    ladder, not what the simple kernel recomputes). ±1 taps need no multiply."""
    from repro_torch.kernels.edge import _sym_plan

    ops = 5 if rgb else 0   # luma: 3 multiplies, 2 adds
    if variant == "direct":
        ops += sum(mul_add(k) for k in spec.bank(directions))
    else:
        (cx, rx), (cy, ry) = spec.sep_factors(0), spec.sep_factors(1)
        ops += mul_add(rx) + mul_add(cx) + mul_add(ry) + mul_add(cy)
        if directions == 4:
            if variant == "separable":
                ops += mul_add(spec.bank(4)[2]) + mul_add(spec.bank(4)[3])
            else:
                dense = [spec.kd_plus_dense()]
                if variant == "v1":
                    dense.append(spec.kd_minus_dense())
                for dm in dense:
                    passes, pass_of, _neg = _sym_plan(dm)
                    ops += sum(mul_add(p) for p in passes)
                    ops += sum(1 for p in pass_of if p >= 0) - 1
                if variant == "v2":
                    col_f, col_d, row_d = spec.v2_arrays()
                    ops += mul_add(col_f) + mul_add(row_d) + mul_add(col_d) + 1
                ops += 4    # (g+ ± g-) * 0.5
    ops += 2 * directions    # squares and their sum (directions - 1 adds) + sqrt
    return ops


def nms_ops_per_pixel(directions: int) -> int:
    """f32 operations of the sector and the suppression per output pixel:
    4 directions: 4 abs + 6 compares; 2 directions: 2 abs, 2 multiplies by
    tan(pi/8), 2 compares and 2 sign tests; then 2 compares against the
    neighbours."""
    return (10 if directions == 4 else 8) + 2


def magnitude_pixels(mask: np.ndarray, h: int, w: int, bh: int, bw: int) -> int:
    """Pixels of the boundary-extended frames whose magnitude the NMS lane
    needs on ``mask`` (N, gh, gw): each changed tile's pixels and its
    one-pixel ring, each pixel counted once. A ring inside a changed
    neighbour is that neighbour's own work, so only edges that face an
    unchanged tile or the border add pixels: (H+2)(W+2) a frame when every
    tile changed."""
    changed = np.repeat(np.repeat(mask.astype(bool), bh, axis=-2), bw, axis=-1)[..., :h, :w]
    need = np.pad(changed, [(0, 0), (1, 1), (1, 1)])
    rows = need.copy()
    rows[:, 1:] |= need[:, :-1]
    rows[:, :-1] |= need[:, 1:]
    need = rows.copy()
    need[:, :, 1:] |= rows[:, :, :-1]
    need[:, :, :-1] |= rows[:, :, 1:]
    return int(need.sum())


def nms_lane_ops(spec, variant: str, directions: int, rgb: bool, mask: np.ndarray, h: int,
                 w: int, bh: int, bw: int) -> int:
    """Operations of the NMS lane on ``mask`` (K3; all ones for K1
    ``out_nms``): the luma, the sector and the suppression once per pixel of
    a changed tile, the ladder and magnitude once per pixel in
    :func:`magnitude_pixels`."""
    changed_px = int((tile_pixels(h, w, bh, bw)[None] * mask.astype(bool)).sum())
    ladder = kernel_ops_per_pixel(spec, variant, directions, rgb=False)
    per_px = (5 if rgb else 0) + nms_ops_per_pixel(directions)
    return ladder * magnitude_pixels(mask, h, w, bh, bw) + per_px * changed_px


def bound(n_px: int, in_bytes_px: int, out_bytes: int, ops_px: float):
    t_bytes = (n_px * in_bytes_px + out_bytes) / HBM_BYTES_PER_S
    t_ops = n_px * ops_px / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def int32_ops_per_s() -> float:
    """The card's peak 32-bit integer rate: 64 INT32 lanes per SM (half of
    the 128 FP32 lanes) x the SM count x the maximum SM clock that
    ``nvidia-smi`` reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return 64 * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def int_lane_bound(n_px: int, in_bytes_px: int, out_bytes: int, spec, variant: str,
                   directions: int, int_rate: float):
    """The integer lane's bound: the ladder's operations (the f32 count of
    :func:`kernel_ops_per_pixel` without the magnitude) at the 32-bit
    integer rate, the conversions and the magnitude at the f32 rate, the two
    units working side by side; the bytes as for K1."""
    f32_px = 3 * directions   # D conversions to f32, D squares, D - 1 adds, 1 sqrt
    int_px = kernel_ops_per_pixel(spec, variant, directions, rgb=False) - 2 * directions
    t_bytes = (n_px * in_bytes_px + out_bytes) / HBM_BYTES_PER_S
    t_ops = max(n_px * int_px / int_rate, n_px * f32_px / F32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3, int_px)


def fitting_depths(bh: int, bw: int, spec, in_bytes: int, channels: int, nms: bool,
                   plan=None):
    """K2's ring depths whose footprint (with ``plan``, its composed window
    and pre-stage plane) fits a CTA's shared memory."""
    from repro_torch.kernels.edge import PIPELINE_DEPTHS, SMEM_MAX, pipelined_smem_bytes

    return [d for d in PIPELINE_DEPTHS
            if pipelined_smem_bytes(bh, bw, spec.radius, d, in_bytes, channels, nms,
                                    plan=plan) <= SMEM_MAX]


COUNTS = ("k1", "k1_int", "k1_plan", "k2", "k2_int", "k2_plan", "k2_tma", "k2_cp_async", "k3",
          "k4", "k5")


def reset_counts():
    """Every kernel's launch counts to 0 (before a main-path run)."""
    from repro_torch.kernels.edge import edge_cuda, edge_pipelined_cuda, edge_stream_cuda
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan

    for fn in (edge_cuda, edge_pipelined_cuda, edge_stream_cuda, flash_attention,
               selective_scan):
        fn.launches = 0
    edge_cuda.int_launches = edge_pipelined_cuda.int_launches = 0
    edge_cuda.plan_launches = edge_pipelined_cuda.plan_launches = 0
    edge_pipelined_cuda.tma_launches = edge_pipelined_cuda.cp_async_launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.edge import edge_cuda, edge_pipelined_cuda, edge_stream_cuda
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan

    return dict(k1=edge_cuda.launches, k1_int=edge_cuda.int_launches,
                k1_plan=edge_cuda.plan_launches,
                k2=edge_pipelined_cuda.launches, k2_int=edge_pipelined_cuda.int_launches,
                k2_plan=edge_pipelined_cuda.plan_launches,
                k2_tma=edge_pipelined_cuda.tma_launches,
                k2_cp_async=edge_pipelined_cuda.cp_async_launches,
                k3=edge_stream_cuda.launches, k4=flash_attention.launches,
                k5=selective_scan.launches)


def tile_pixels(h: int, w: int, bh: int, bw: int) -> np.ndarray:
    """(gh, gw) in-image pixel count of each tile."""
    rows = np.minimum(bh, h - bh * np.arange(-(-h // bh)))
    cols = np.minimum(bw, w - bw * np.arange(-(-w // bw)))
    return np.outer(rows, cols)


def stream_bound(mask: np.ndarray, h: int, w: int, bh: int, bw: int, in_bytes_px: int,
                 ops: int):
    """K3's bound on this mask: a changed tile reads its input once and
    writes 4 B/px; a spliced tile reads and writes 4 B/px each; the mask is
    read, each tile max written, a spliced tile's cached max read; ``ops``
    are the operations this mask needs (:func:`nms_lane_ops`)."""
    px = tile_pixels(h, w, bh, bw)[None]
    changed = mask.astype(bool)
    changed_px = int((px * changed).sum())
    spliced_px = int((px * ~changed).sum())
    n_tiles = mask.size
    t_bytes = (changed_px * (in_bytes_px + 4) + spliced_px * 8
               + n_tiles * 8 + int((~changed).sum()) * 4) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3, changed_px / (changed_px + spliced_px))


def device_profile(label: str, fn, top: int = 6, kernel: str = "", host: bool = True,
                   again: int = 0):
    """Run ``fn`` once under torch.profiler and print its device time by
    kernel and the device's idle share of the span (host clock, under the
    profiler, which stretches the span); with ``kernel``, also the device
    time and launches of the kernels whose name contains it. ``host=False``
    records the device's activity alone, for a step of ~10^5 launches,
    whose host records take the profiler minutes to sum. With ``again``
    (for an ``fn`` that may run more than once), a window that comes back
    with no device records is run again with ``again`` times the calls,
    twice at most, and says so: on the H100 a short window can lose them
    once the process has profiled before (``launch_device_us``). Returns
    (busy_us, span_us, that kernel's us)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    calls = 1
    for attempt in range(3 if again else 1):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            span_us = (time.perf_counter() - t0) * 1e6
        kernels_run = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels_run)
        if busy_us > 0 or attempt == 2 or not again:
            break
        print(f"  the profiler kept no device record of {label} ({calls} calls); again with "
              f"{again * calls}")
        calls *= again
    kernels_run.sort(key=lambda e: -e.self_device_time_total)
    check(busy_us > 0, f"the profiler saw no device time in {label}")
    print(f"profile of {label}: {len(kernels_run)} device kernels, busy {busy_us:.1f} us "
          f"of its {span_us:.1f} us span (host clock, under the profiler): device idle "
          f"{100 * (1 - busy_us / span_us):.1f}%")
    for e in kernels_run[:top]:
        print(f"  {e.self_device_time_total:9.1f} us  x{e.count}  {e.key[:90]}")
    named = [e for e in kernels_run if kernel and kernel in e.key]
    named_us = sum(e.self_device_time_total for e in named)
    if kernel:
        print(f"  {kernel}: {named_us:.1f} us in {sum(e.count for e in named)} launches, "
              f"{100 * named_us / busy_us:.2f}% of the device time")
    return busy_us, span_us, named_us


def median_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


LM_SOURCES = ("flash_attention", "selective_scan")        # K4, K5: what phases 6-19 launch
EDGE_SOURCES = ("edge", "edge_pipelined", "edge_stream")  # K1-K3: minutes of nvcc
EDGE_BUILD_LOG = ROOT / "build" / "chip_smoke" / "edge_build.json"


def print_build_logs(logs: dict) -> None:
    for name, log in logs.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or line.startswith("nvcc ")):
                print(f"  {name}: {line.strip()}")


def phase_build():
    """Phase 1: K4's and K5's sources built (one ``nvcc`` each, started
    together); then the edge kernels' sources, one ``nvcc`` each, all
    started together in a child process at a lower priority (nice 10),
    returned running: phases 6-19 launch only K4 and K5 and run while it
    compiles, and ``phase_edge_build`` waits for it before phase 2. The
    child runs in a session of its own, killed with its compilers at exit
    if it still runs."""
    import atexit
    import shutil
    import signal

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(list(LM_SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f}s for {sorted(logs) or 'cached libraries'}")
    print_build_logs(logs)
    EDGE_BUILD_LOG.parent.mkdir(parents=True, exist_ok=True)
    EDGE_BUILD_LOG.unlink(missing_ok=True)
    code = ("import json, sys; from repro_torch.kernels import build; "
            f"logs = build.build({list(EDGE_SOURCES)!r}); "
            f"open({str(EDGE_BUILD_LOG)!r}, 'w').write(json.dumps(logs))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    proc = subprocess.Popen([*nice, sys.executable, "-c", code], env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return dict(proc=proc, started=time.perf_counter())


def phase_edge_build(edge: dict):
    """Phase 1b: waits for ``phase_build``'s child and prints its compile
    logs; fails if a source did not build."""
    out, _ = edge["proc"].communicate()
    check(edge["proc"].returncode == 0 and EDGE_BUILD_LOG.exists(),
          f"the edge kernels' build failed (exit {edge['proc'].returncode}):\n{out}")
    logs = json.loads(EDGE_BUILD_LOG.read_text())
    print(f"build: the edge kernels took {time.perf_counter() - edge['started']:.1f}s in the "
          f"background for {sorted(logs) or 'cached libraries'}")
    print_build_logs(logs)


def phase_kernel_vs_plain(rng, dev):
    """Phase 2: K1 against edge_plain; returns the full-size inputs to time."""
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import KMAX, edge_cuda, edge_plain

    t0 = time.perf_counter()
    check(separable9().size == KMAX, f"phase 2 must cover the largest size, {KMAX}")
    cases = mismatches = 0
    for shape in SIZES:
        inputs = {k: frames(k, (2,) + shape, rng, dev) for k in KINDS}
        for op in ("sobel5", "sobel3", "scharr3", "prewitt3", "sobel7", "sep9"):
            spec = get_operator(op)
            for variant in spec.variants:
                for d in spec.directions:
                    for padding in ("reflect", "edge", "zero"):
                        for kind, x in inputs.items():
                            for out_components in (False, True):
                                kw = dict(spec=spec, variant=variant, directions=d,
                                          padding=padding, block_h=32, block_w=64,
                                          rgb=kind.startswith("rgb"),
                                          out_components=out_components,
                                          with_max=True)
                                b, bm = edge_plain(x, **kw)
                                for inst in instances(spec, variant, d):
                                    a, am = edge_cuda(x, instance=inst, **kw)
                                    cases += 1
                                    if not (torch.equal(a, b) and torch.equal(am, bm)):
                                        mismatches += 1
                                        print(f"  MISMATCH {shape} {op} {variant} {d} {padding} "
                                              f"{kind} comps={out_components} {inst}: "
                                              f"{int((a != b).sum())} px, "
                                              f"{int((am != bm).sum())} maxima")
    spec5 = get_operator("sobel5")
    full = {}
    for label, kind, shape in (("2048x2048 f32", "f32", (4, 2048, 2048)),
                               ("1080p rgb u8", "rgb", (4, 1080, 1920))):
        x = frames(kind, shape, rng, dev)
        for block in ((64, 256), (32, 128)):
            for out_components in (False, True):
                kw = dict(spec=spec5, variant="v2", directions=4, padding="reflect",
                          block_h=block[0], block_w=block[1], rgb=kind == "rgb",
                          out_components=out_components, with_max=True)
                b, bm = edge_plain(x, **kw)
                for inst in ("auto", "runtime"):
                    a, am = edge_cuda(x, instance=inst, **kw)
                    cases += 1
                    err = float((a - b).abs().max())
                    if not (torch.equal(a, b) and torch.equal(am, bm)):
                        mismatches += 1
                        print(f"  MISMATCH {label} block={block} comps={out_components} {inst}: "
                              f"{int((a != b).sum())} px, max abs err {err}")
                if block == (64, 256) and not out_components:
                    full[label] = (x, kw, err)
        del a, am, b, bm
    torch.cuda.synchronize()
    print(f"kernel vs plain: {cases} cases, {mismatches} mismatches "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"K1 differs from edge_plain in {mismatches} of {cases} cases")
    return full


def instances(spec, variant: str, directions: int):
    """K1's instances to hold against the plain version for this operator:
    the compile-time one where the wrapper picks it, and the run-time-taps
    one always."""
    from repro_torch.kernels.edge import const_taps_instance

    return ("auto", "runtime") if const_taps_instance(spec, variant, directions) else ("auto",)


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def phase_nms_vs_plain(rng, dev):
    """Phase 2b: K1's NMS outputs against edge_plain."""
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import edge_cuda, edge_plain

    t0 = time.perf_counter()
    cases = mismatches = 0
    extras = (dict(), dict(out_components=True, out_mag=True, with_max=True))
    for shape in NMS_SIZES:
        inputs = {k: frames(k, (2,) + shape, rng, dev) for k in KINDS}
        for op in ("sobel3", "sobel5", "sobel7", "sep9"):
            spec = get_operator(op)
            variant = spec.resolve_variant("auto")
            for d in spec.directions:
                for padding in ("reflect", "edge", "zero"):
                    for kind, x in inputs.items():
                        for block in ((16, 32), (64, 256)):
                            for extra in extras:
                                kw = dict(spec=spec, variant=variant, directions=d,
                                          padding=padding, block_h=block[0], block_w=block[1],
                                          rgb=kind.startswith("rgb"), out_nms=True, **extra)
                                want = edge_plain(x, **kw)
                                for inst in instances(spec, variant, d):
                                    cases += 1
                                    if not _same(edge_cuda(x, instance=inst, **kw), want):
                                        mismatches += 1
                                        print(f"  MISMATCH nms {shape} {op} {d} {padding} {kind} "
                                              f"block={block} {sorted(extra)} {inst}")
    torch.cuda.synchronize()
    print(f"K1 out_nms vs plain: {cases} cases, {mismatches} mismatches "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"K1 out_nms differs from edge_plain in {mismatches} of {cases} cases")


def stream_masks(n: int, gh: int, gw: int, rng, dev) -> dict:
    """Phase 2c's masks on an (n, gh, gw) tile grid: none, all and a random
    half of the tiles changed; a clustered block (the motion run's shape:
    a band of tile rows and columns in every frame); one tile; only the
    last, ragged tile."""
    def grid():
        return np.zeros((n, gh, gw), np.int32)

    block = grid()
    block[:, gh // 3: gh // 3 + max(1, gh // 4), gw // 4: gw // 4 + max(1, gw // 2)] = 1
    single = grid()
    single.flat[int(rng.integers(single.size))] = 1
    last = grid()
    last.flat[-1] = 1
    masks = {"0": grid(), "1": grid() + 1, "random": rng.integers(0, 2, (n, gh, gw)),
             "block": block, "single": single, "last": last}
    return {k: torch.from_numpy(v.astype(np.int32)).to(dev) for k, v in masks.items()}


def phase_stream_vs_plain(rng, dev):
    """Phase 2c: K3 against edge_stream_plain on every mask of
    :func:`stream_masks`, both instances, NMS on and off; against K1 on an
    all-1 mask and against the caches on an all-0 mask. The shapes: ragged
    ones, a (1, 1, 1) grid, the stream server's 4x2048x2048 u8 on 64x256
    (16-byte copies), 8x8 tiles on 4x512x512 (16,384 tiles, more than one
    chunk of the in-kernel scan), and 2x37x53 caches one row into a larger
    buffer (off 16 bytes: scalar copies). Both copy routes must have run."""
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import edge_cuda, edge_stream_cuda, edge_stream_plain

    t0 = time.perf_counter()
    spec = get_operator("sobel5")
    mask_rng = np.random.default_rng(18)
    cases = mismatches = 0
    launches, vector = edge_stream_cuda.launches, edge_stream_cuda.vector_launches
    for kind, shape, block, offset in (
            ("u8", (2, 37, 53), (16, 32), False), ("f32", (2, 70, 270), (64, 256), False),
            ("rgb", (2, 130, 300), (32, 128), False), ("u8", (1, 1, 1), (8, 8), False),
            ("u8", (4, 2048, 2048), (64, 256), False), ("u8", (4, 512, 512), (8, 8), False),
            ("f32", (2, 37, 53), (16, 32), True)):
        x = frames(kind, shape, rng, dev)
        n, h, w = shape
        gh, gw = -(-h // block[0]), -(-w // block[1])
        prev = torch.rand((n, h, w), device=dev) * 50
        prev_max = torch.rand((n, gh, gw), device=dev) * 50
        if offset:
            prev = offset_copy(prev, w)
            check(prev.data_ptr() % 16 != 0, "the offset caches are on 16 bytes")
        for out_nms in (False, True):
            kw = dict(spec=spec, variant="v2", directions=4, block_h=block[0],
                      block_w=block[1], rgb=kind == "rgb", out_nms=out_nms)
            for name, mask in stream_masks(n, gh, gw, mask_rng, dev).items():
                b = edge_stream_plain(x, prev, prev_max, mask, **kw)
                for inst in ("auto", "runtime"):
                    a = edge_stream_cuda(x, prev, prev_max, mask, instance=inst, **kw)
                    cases += 1
                    ok = _same(a, b)
                    if name == "1":
                        ok = ok and _same(a, edge_cuda(x, with_max=True, instance=inst, **kw))
                    if name == "0":
                        ok = ok and torch.equal(a[0], prev) and torch.equal(a[1], prev_max)
                    if not ok:
                        mismatches += 1
                        print(f"  MISMATCH K3 {kind} {shape} block={block} nms={out_nms} "
                              f"mask={name} {inst}{' offset caches' if offset else ''}")
    torch.cuda.synchronize()
    vector = edge_stream_cuda.vector_launches - vector
    scalar = edge_stream_cuda.launches - launches - vector
    print(f"K3 vs plain: {cases} cases, {mismatches} mismatches, {vector} launches copied by "
          f"16-byte vectors, {scalar} by floats ({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"K3 differs from edge_stream_plain in {mismatches} of {cases} cases")
    check(vector > 0 and scalar > 0, f"phase 2c ran one copy route only ({vector} vector, "
          f"{scalar} scalar)")


def k2_against(x, kw: dict, depths, fits, label: str, want=None):
    """K2 at each of ``depths`` on ``x``, on each instance K1 has for the
    call: bit-equal to ``edge_plain`` (``want``, when the caller has it)
    and to K1 where the depth fits, a ``ValueError`` where it does not.
    Returns ``(cases, mismatches, raised)``."""
    from repro_torch.kernels.edge import edge_cuda, edge_plain

    want = edge_plain(x, **kw) if want is None else want
    k1 = edge_cuda(x, **kw)
    cases = mismatches = raised = 0
    for depth in depths:
        if depth not in fits:
            try:
                edge_cuda(x, pipeline_depth=depth, **kw)
            except ValueError:
                raised += 1
                continue
            check(False, f"K2 depth {depth} over the shared-memory budget did not raise ({label})")
        for inst in instances(kw["spec"], kw["variant"], kw["directions"]):
            got = edge_cuda(x, pipeline_depth=depth, instance=inst, **kw)
            cases += 1
            if not (_same(got, want) and _same(got, k1)):
                mismatches += 1
                print(f"  MISMATCH K2 {label} depth={depth} {inst}")
    return cases, mismatches, raised


def offset_copy(x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base is ``offset`` elements into a
    larger buffer: one element past a 16-byte boundary by default, so that
    K2 copies its windows by ``cp.async`` whatever the row pitch; one row
    of odd width in, so that K3 copies its caches by floats."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    y = flat[offset:].view(x.shape)
    y.copy_(x)
    return y


def phase_k2_vs_plain(rng, dev):
    """Phase 2d: K2 against edge_plain and K1 over the whole matrix, and at
    full width on the FULL tile at every depth that fits; a depth whose
    footprint exceeds SMEM_MAX must raise. Returns the full-width inputs."""
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import PIPELINE_DEPTHS

    from repro_torch.kernels.edge import edge_pipelined_cuda

    t0 = time.perf_counter()
    results = []  # (cases, mismatches, raised) of each k2_against
    tma0, cp0 = edge_pipelined_cuda.tma_launches, edge_pipelined_cuda.cp_async_launches
    for shape in K2_SIZES:
        inputs = {k: frames(k, (2,) + shape, rng, dev) for k in KINDS}
        if shape[1] % 16 == 0:  # TMA on every kind: the cp.async route on an offset copy too
            inputs.update({f"{k}@1": offset_copy(v) for k, v in inputs.items()})
        for op in OPERATORS:
            spec = get_operator(op)
            for variant in spec.variants:
                for d in spec.directions:
                    for padding in PADDINGS:
                        for kind, x in inputs.items():
                            rgb = kind.startswith("rgb")
                            for extra in LANE_OUTPUTS:
                                kw = dict(spec=spec, variant=variant, directions=d,
                                          padding=padding, block_h=32, block_w=64, rgb=rgb,
                                          **extra)
                                fits = fitting_depths(32, 64, spec, x.element_size(),
                                                      3 if rgb else 1, "out_nms" in extra)
                                results.append(k2_against(
                                    x, kw, K2_DEPTHS, fits,
                                    f"{shape} {op} {variant} {d} {padding} {kind} "
                                    f"{sorted(extra)}"))
    spec5 = get_operator("sobel5")
    full = {}
    for kind in ("f32", "u8"):
        x = frames(kind, (4, 2048, 2048), rng, dev)
        full[kind] = x
        for extra in (dict(with_max=True), dict(out_nms=True, with_max=True)):
            kw = dict(spec=spec5, variant="v2", directions=4, block_h=64, block_w=256, **extra)
            fits = fitting_depths(64, 256, spec5, x.element_size(), 1, "out_nms" in extra)
            results.append(k2_against(x, kw, PIPELINE_DEPTHS, fits,
                                      f"4x2048x2048 {kind} {sorted(extra)}"))
            print(f"  4x2048x2048 {kind} 64x256 {sorted(extra)}: depths that fit {fits}")
    torch.cuda.synchronize()
    cases, mismatches, raised = map(sum, zip(*results))
    tma = edge_pipelined_cuda.tma_launches - tma0
    cp = edge_pipelined_cuda.cp_async_launches - cp0
    print(f"K2 vs plain and K1: {cases} cases, {mismatches} mismatches; {raised} over-budget "
          f"depths raised; copy routes: {tma} TMA launches, {cp} cp.async launches "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"K2 differs from edge_plain/K1 in {mismatches} of {cases} cases")
    check(raised > 0, "no over-budget depth was tried")
    check(tma > 0 and cp > 0, f"phase 2d ran one copy route only ({tma} TMA, {cp} cp.async)")
    k2_footprints_agree()
    return full


def k2_footprints_agree():
    """``edge.pipelined_smem_bytes`` against the source's own
    ``pipelined_layout`` (``repro_pipelined_smem_bytes``) over tiles,
    radii, depths, input types, layouts and NMS, with plans too
    (``repro_pipelined_plan_smem_bytes``), and ``edge.pipelined_bands``
    against ``repro_pipelined_bands``."""
    import itertools

    from repro_torch.kernels.edge import (PIPELINE_DEPTHS, _lib, pipelined_bands,
                                          pipelined_smem_bytes, pre_plane_words)

    lib = _lib("edge_pipelined")
    tiles = ((1, 1), (8, 32), (32, 64), (29, 96), (64, 256), (128, 128), (300, 512), (16, 1000))
    cases = bad = 0
    for (bh, bw), r, d, nb, ch, nms in itertools.product(
            tiles, (1, 2, 3, 4), PIPELINE_DEPTHS, (1, 4), (1, 3), (False, True)):
        want = pipelined_smem_bytes(bh, bw, r, d, nb, ch, nms)
        got = lib.repro_pipelined_smem_bytes(bh, bw, r, d, nb, ch, int(nms))
        cases += 1
        bad += int(got != want)
    battery = plan_battery()
    for (bh, bw), name, d, nb, ch, nms in itertools.product(
            tiles, ("canny5", "blur_sobel5", "erode_abs_sobel3", "square_g3_scharr3_nms"),
            PIPELINE_DEPTHS, (1, 4), (1, 3), (False, True)):
        plan = battery[name]
        want = pipelined_smem_bytes(bh, bw, plan.gradient.radius, d, nb, ch, nms, plan=plan)
        got = lib.repro_pipelined_plan_smem_bytes(bh, bw, plan.linear_reach, d, nb, ch, int(nms),
                                                  pre_plane_words(bh, bw, plan, nms))
        cases += 1
        bad += int(got != want)
    for (bh, bw), nms, size in itertools.product(tiles + ((320, 32), (305, 32)), (False, True),
                                                 (3, 5, 7, 9)):
        cases += 1
        bad += int(lib.repro_pipelined_bands(bh, bw, int(nms), size)
                   != len(pipelined_bands(bh, bw, nms, size)))
    print(f"K2 footprint and bands, edge.py vs the source's pipelined_layout and "
          f"pipelined_bands: {cases} cases, {bad} differ")
    check(bad == 0, f"edge.py's K2 layout differs from csrc/edge_pipelined.cu in {bad} cases")


def phase_int_lane(rng, dev, full):
    """Phase 2e: K1 and K2 on the integer lane against the f32 plain lane."""
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import edge_cuda, edge_pipelined_cuda, edge_plain

    t0 = time.perf_counter()
    cases = mismatches = 0
    for shape in SIZES:
        x = frames("u8", (2,) + shape, rng, dev)
        for op in INT_OPERATORS:
            spec = get_operator(op)
            for variant in spec.variants:
                for d in spec.directions:
                    for padding in PADDINGS:
                        for extra in LANE_OUTPUTS:
                            kw = dict(spec=spec, variant=variant, directions=d, padding=padding,
                                      block_h=32, block_w=64, **extra)
                            want = edge_plain(x, **kw)
                            runs = [(0, inst) for inst in instances(spec, variant, d)]
                            for depth, inst in runs + [(k, "auto") for k in K2_DEPTHS]:
                                got = edge_cuda(x, precision="int", pipeline_depth=depth,
                                                instance=inst, **kw)
                                cases += 1
                                if not _same(got, want):
                                    mismatches += 1
                                    print(f"  MISMATCH int {shape} {op} {variant} {d} {padding} "
                                          f"depth={depth} {inst} {sorted(extra)}")
    spec5 = get_operator("sobel5")
    x = full["u8"]
    kw = dict(spec=spec5, variant="v2", directions=4, block_h=64, block_w=256, with_max=True)
    want = edge_plain(x, **kw)
    k1_int, k2_int = edge_cuda.int_launches, edge_pipelined_cuda.int_launches
    k1_const = edge_cuda.const_launches
    depths = [0] + fitting_depths(64, 256, spec5, 1, 1, False)
    for depth, inst in [(0, "runtime")] + [(d, "auto") for d in depths]:
        cases += 1
        if not _same(edge_cuda(x, precision="int", pipeline_depth=depth, instance=inst, **kw),
                     want):
            mismatches += 1
            print(f"  MISMATCH int 4x2048x2048 depth={depth} {inst}")
    check(edge_cuda.int_launches == k1_int + 2
          and edge_pipelined_cuda.int_launches == k2_int + len(depths) - 1
          and edge_cuda.const_launches == k1_const + 1,
          "the integer lane's launches were not counted as such")
    torch.cuda.synchronize()
    print(f"int lane (K1, K2) vs f32 plain lane: {cases} cases, {mismatches} mismatches "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches == 0, f"the integer lane differs from f32 in {mismatches} of {cases} cases")


def phase_plans_vs_plain(rng, dev, full):
    """Phase 2f: K1 and K2 with stencil plans against ``edge_plain(plan=)``
    (K2 also against K1), the integer lane of the integer plans, and the
    built-in plans at 4x2048x2048 on the FULL tile, where every ring depth
    over ``SMEM_MAX`` must raise."""
    from repro_torch.kernels.edge import (PIPELINE_DEPTHS, edge_cuda, edge_pipelined_cuda,
                                          edge_plain)

    t0 = time.perf_counter()
    battery = plan_battery()
    results = []  # (cases, mismatches, raised) of each k2_against
    k1_cases = k1_bad = 0
    k1_plan0, k2_plan0 = edge_cuda.plan_launches, edge_pipelined_cuda.plan_launches
    for shape in PLAN_SIZES:
        inputs = {k: frames(k, (2,) + shape, rng, dev) for k in KINDS}
        for name, plan in battery.items():
            spec = plan.gradient
            variant, d = spec.resolve_variant("auto"), spec.resolve_directions(0)
            lanes = LANE_OUTPUTS[2:] if plan.nms else LANE_OUTPUTS[:2]
            for padding in PADDINGS:
                for kind, x in inputs.items():
                    rgb = kind.startswith("rgb")
                    for extra in lanes:
                        for bh, bw in ((16, 32), (64, 256)):
                            kw = dict(spec=spec, plan=plan, variant=variant, directions=d,
                                      padding=padding, block_h=bh, block_w=bw, rgb=rgb, **extra)
                            label = f"{shape} {name} {padding} {kind} {bh}x{bw} {sorted(extra)}"
                            fits = fitting_depths(bh, bw, spec, x.element_size(), 3 if rgb else 1,
                                                  plan.nms, plan=plan)
                            want = edge_plain(x, **kw)
                            results.append(k2_against(x, kw, K2_DEPTHS, fits, label, want))
                            for inst in ("runtime",) if len(instances(spec, variant, d)) > 1 else ():
                                k1_cases += 1
                                if not _same(edge_cuda(x, instance=inst, **kw), want):
                                    k1_bad += 1
                                    print(f"  MISMATCH K1 {label} {inst}")
                            if name in INT_PLANS and kind == "u8":
                                for depth in [0] + [k for k in K2_DEPTHS if k in fits]:
                                    k1_cases += 1
                                    got = edge_cuda(x, precision="int", pipeline_depth=depth, **kw)
                                    if not _same(got, want):
                                        k1_bad += 1
                                        print(f"  MISMATCH int {label} depth={depth}")
    for kind, x in full.items():
        for name in ("canny5", "blur_sobel5"):
            plan = battery[name]
            spec = plan.gradient
            for extra in (LANE_OUTPUTS[2:] if plan.nms else LANE_OUTPUTS[:2]):
                kw = dict(spec=spec, plan=plan, variant="v2", directions=4, block_h=64,
                          block_w=256, **extra)
                fits = fitting_depths(64, 256, spec, x.element_size(), 1, plan.nms, plan=plan)
                results.append(k2_against(x, kw, PIPELINE_DEPTHS, fits,
                                          f"4x2048x2048 {kind} {name} {sorted(extra)}"))
                print(f"  4x2048x2048 {kind} {name} 64x256 {sorted(extra)}: K2 depths that fit "
                      f"{fits}")
    torch.cuda.synchronize()
    cases, mismatches, raised = map(sum, zip(*results))
    k1_plan = edge_cuda.plan_launches - k1_plan0
    k2_plan = edge_pipelined_cuda.plan_launches - k2_plan0
    print(f"plans (K1, K2) vs plain: {cases} K1/K2 cases and {k1_cases} run-time-instance and "
          f"integer-lane cases, {mismatches + k1_bad} mismatches; {raised} over-budget depths "
          f"raised; {k1_plan} K1 and {k2_plan} K2 launches ran pre-stages "
          f"({time.perf_counter() - t0:.1f}s)")
    check(mismatches + k1_bad == 0,
          f"plans differ from edge_plain in {mismatches + k1_bad} of {cases + k1_cases} cases")
    check(raised > 0, "no over-budget plan depth was tried")
    check(k1_plan > 0 and k2_plan > 0, "the plan launches were not counted")


def phase_plan_facade(full_inputs, dev):
    """Phase 3e, the stencil-plan slice's main path: ``edge_detect`` with a
    plan on the sobel-hd FULL config at 4x2048x2048; each call must be one
    K1 (or K2) launch with pre-stages and equal the torch lane. Returns the
    summed counts of these calls."""
    from repro_torch.api import EdgeConfig, edge_detect
    from repro_torch.configs import get_config
    from repro_torch.core.filters import make_plan
    from repro_torch.kernels.edge import (SMEM_MAX, _tile_threads, pipelined_smem_bytes,
                                          window_smem_bytes)

    t0 = time.perf_counter()
    for (plan, name), fields in PLAN_GOLDEN.items():
        arr = golden_inputs()[name]
        res = edge_detect(arr, EdgeConfig(plan=plan, with_max=True,
                                          hysteresis=plan == "canny5"))
        for field, want in fields.items():
            got = digest(getattr(res, field))
            check(got == want, f"{plan} {name} {field} digest {got} != JAX reference {want}")
    print("plan facade: small inputs equal the JAX reference's digests (canny5, blur_sobel5)")
    full = get_config("sobel-hd")
    dilate = make_plan("dilate3_sobel5_nms", ("dilate3", "sobel5", "nms"))
    calls = (
        ("canny5 + hysteresis", "u8", dict(plan="canny5", hysteresis=True), "k1"),
        ("canny5 + hysteresis", "f32", dict(plan="canny5", hysteresis=True), "k1"),
        ("blur_sobel5, normalized", "u8", dict(plan="blur_sobel5"), "k1"),
        ("blur_sobel5, normalized", "f32", dict(plan="blur_sobel5"), "k1"),
        ("dilate3 -> sobel5 -> nms, precision auto", "u8", dict(plan=dilate, hysteresis=True),
         "k1_int"),
        ("canny5 + hysteresis, pipeline_depth=2", "u8",
         dict(plan="canny5", hysteresis=True, pipeline_depth=2), "k2"),
    )
    total = dict.fromkeys(COUNTS, 0)
    for label, kind, kw, lane in calls:
        x = full_inputs[kind]
        cfg = full.edge_config(with_max=True, **kw)
        reset_counts()
        res = edge_detect(x, cfg)
        counts = read_counts()
        rc = cfg.resolved()
        k2 = lane == "k2"
        want = dict(k1=int(not k2), k1_plan=int(not k2), k1_int=int(lane == "k1_int"),
                    k2=int(k2), k2_plan=int(k2), k2_int=0)
        check(all(counts[k] == v for k, v in want.items()),
              f"edge_detect({label}) on {kind} launched {counts}, not one {lane} with pre-stages")
        ref = edge_detect(x, cfg.replace(backend="torch"))
        for f in ("magnitude", "peak", "thin", "edges"):
            a, b = getattr(res, f), getattr(ref, f)
            check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                  f"edge_detect({label}) on {kind}: {f} differs from the torch lane")
        check(bool(torch.isfinite(res.magnitude).all()), f"edge_detect({label}): non-finite")
        if k2:
            smem = pipelined_smem_bytes(rc.block_h, rc.block_w, 2, cfg.pipeline_depth,
                                        x.element_size(), 1, rc.nms, plan=rc.plan)
            where = f"K2 depth {cfg.pipeline_depth}"
        else:
            smem = window_smem_bytes(rc.block_h, rc.block_w, 2, rc.nms, plan=rc.plan)
            where = f"K1, {_tile_threads(rc.block_w, rc.nms)} threads"
        for k, v in counts.items():
            total[k] += v
        print(f"plan facade {label} on 4x{full.image_h}x{full.image_w} {kind}: {where}, "
              f"{smem} B of shared memory a CTA (limit {SMEM_MAX}); launches {counts}; equal "
              "to the torch lane")
    print(f"plan facade: {time.perf_counter() - t0:.1f}s")
    return total


# Phase 3f's meshes on eight logical devices of the one card, and its calls.
SHARD_MESHES = ("2x2x2", "1x4x2", "1x2x2", "8x1x1")
RESULT_FIELDS = ("magnitude", "components", "peak", "thin", "edges")


def logical_devices():
    """Eight logical devices on the one card, the counterpart of the
    reference tests' 8 forced host devices."""
    return [torch.device("cuda:0")] * 8


def same_result(a, b) -> bool:
    return all((getattr(a, f) is None) == (getattr(b, f) is None)
               and (getattr(a, f) is None or torch.equal(getattr(a, f), getattr(b, f)))
               for f in RESULT_FIELDS)


def shard_split_ms(x, cfg, mesh):
    """CUDA-event medians of the three steps of one sharded call: the
    exchange (extension, scatter, halos), the per-shard launches and the
    gather (crop, peaks, assembly), with the tile, lane and depth the facade
    resolves for this call."""
    from repro_torch.kernels import dispatch
    from repro_torch.sharding import halo

    rc = cfg.resolved()
    rgb = x.ndim == 4
    precision = dispatch.resolve_precision(rc.precision, "cuda", spec=rc.spec, rgb=rgb,
                                           input_dtype=x.dtype, plan=rc.plan)
    need_comps = rc.with_components or rc.with_orientation
    need_peak = rc.normalize or rc.with_max or rc.hysteresis
    compute = dispatch._shard_compute(rc, "cuda", rgb=rgb, need_comps=need_comps,
                                      need_raw=rc.nms and need_peak, block_h=rc.block_h,
                                      block_w=rc.block_w, precision=precision,
                                      depth=rc.pipeline_depth or 0)
    r = halo.exchange_radius(rc.spec, rc.nms, plan=rc.plan)
    parts = halo.exchange(x, mesh, radius=r, padding=rc.padding, rgb=rgb)

    def launches():
        return [[[compute(b) for b in row] for row in g] for g in parts.blocks]

    outs = launches()
    return (median_ms(lambda: halo.exchange(x, mesh, radius=r, padding=rc.padding, rgb=rgb),
                      reps=10, warm=2),
            median_ms(launches, reps=10, warm=2),
            median_ms(lambda: halo.gather(parts, outs, need_comps=need_comps,
                                          need_peak=need_peak), reps=10, warm=2),
            parts.blocks[0][0][0].shape)


def phase_sharded_facade(full_inputs, dev):
    """Phase 3f, the sharded facade: ``edge_detect(x, cfg, mesh=...)`` on the
    sobel-hd FULL config over meshes of eight logical devices on the card.
    Each call must equal the single-device call and the torch lane bit for
    bit and launch one K1 (or K2 at a depth) per shard; each is timed
    beside the single-device call, with the split between exchange,
    launches and gather. Returns the summed counts and the rows."""
    from repro_torch.api import ShardConfig, edge_detect
    from repro_torch.configs import get_config
    from repro_torch.sharding import halo

    t0 = time.perf_counter()
    full = get_config("sobel-hd")
    rgb = frames("rgb", (4, 1080, 1920), np.random.default_rng(30), dev)
    calls = (
        ("f32", full_inputs["f32"], dict(), "k1"),
        ("u8, auto -> integer lane", full_inputs["u8"], dict(), "k1_int"),
        ("RGB u8 1080x1920", rgb, dict(), "k1"),
        ("f32, nms + hysteresis", full_inputs["f32"], dict(nms=True, hysteresis=True), "k1"),
        ("u8, canny5 + hysteresis", full_inputs["u8"], dict(plan="canny5", hysteresis=True),
         "k1_plan"),
        ("f32, pipeline_depth=2", full_inputs["f32"], dict(pipeline_depth=2), "k2"),
    )
    total = dict.fromkeys(COUNTS, 0)
    rows = {}
    for label, x, kw, lane in calls:
        cfg = full.edge_config(with_max=True, **kw)
        single = edge_detect(x, cfg)
        plain = edge_detect(x, cfg.replace(backend="torch"))
        check(same_result(single, plain), f"sharded facade {label}: the single-device call "
              "differs from the torch lane")
        ms_single = median_ms(lambda: edge_detect(x, cfg), reps=10, warm=2)
        for spec in SHARD_MESHES:
            shard = ShardConfig.parse(spec)
            mesh = halo.mesh_from_config(shard, logical_devices())
            reset_counts()
            out = edge_detect(x, cfg.replace(shard=shard), mesh=mesh)
            torch.cuda.synchronize()
            counts = read_counts()
            kernel = "k2" if lane == "k2" else "k1"
            other = "k1" if lane == "k2" else "k2"
            check(counts[lane] == mesh.size and counts[kernel] == mesh.size
                  and counts[other] == 0 and counts["k3"] == 0,
                  f"sharded facade {label} on {spec}: launches {counts}, not one {lane} for "
                  f"each of {mesh.size} shards")
            check(same_result(out, single) and same_result(out, plain),
                  f"sharded facade {label} on {spec}: differs from the single-device call or "
                  "the torch lane")
            for k, v in counts.items():
                total[k] += v
            ms = median_ms(lambda: edge_detect(x, cfg, mesh=mesh), reps=10, warm=2)
            ex, la, ga, block = shard_split_ms(x, cfg, mesh)
            rows[f"{label} {spec}"] = dict(ms=ms, single_ms=ms_single, exchange_ms=ex,
                                           launches_ms=la, gather_ms=ga, shards=mesh.size,
                                           block=list(block), launches=counts[lane])
            if label == "f32" and spec == "2x2x2":
                # Where one sharded call's time goes on the device, and how
                # long the device waits for the host.
                busy, span, k1_us = device_profile(f"one {spec} sharded call ({label})",
                                                   lambda: edge_detect(x, cfg, mesh=mesh),
                                                   top=8, kernel="edge_kernel")
                rows[f"{label} {spec}"].update(device_busy_us=busy, span_us=span,
                                               k1_device_us=k1_us)
            print(f"sharded facade {label} on {spec} ({mesh.size} shards of "
                  f"{'x'.join(map(str, block))}): {counts[lane]} {lane} launches; equal to "
                  f"the single-device call and the torch lane; {ms:.4f} ms against "
                  f"{ms_single:.4f} ms single-device ({ms / ms_single:.2f}x); exchange "
                  f"{ex:.4f} ms, launches {la:.4f} ms, gather {ga:.4f} ms")
    if torch.cuda.device_count() > 1:
        devs = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
        mesh = halo.mesh_from_config(ShardConfig(0, 1, 2), devs)
        x = full_inputs["f32"]
        cfg = full.edge_config(with_max=True)
        check(same_result(edge_detect(x, cfg, mesh=mesh), edge_detect(x, cfg)),
              f"sharded facade over {len(devs)} distinct GPUs differs from one device")
        print(f"sharded facade over {len(devs)} distinct GPUs: equal to one device")
    else:
        print("the distinct-GPU path (cuda:0..N) was not run: torch.cuda.device_count() == 1")
    print(f"sharded facade: {time.perf_counter() - t0:.1f}s")
    return total, rows


def phase_chaos_server(dev):
    """Phase 4e: the image server over ``[cuda:0] * 8`` with ``--shard 2x2x2``
    under ``--chaos 'loss@3;fail@step:1x2;slow@d1:40'``, then
    ``--simulate-loss-at 3``, then ``--edges`` with the same loss. Each run
    must account for every request, replan at least once, launch K1 (counts
    set to 0 just before, read just after) and answer its last request as
    the torch lane does on the same frames."""
    from repro_torch.api import edge_detect
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import image_batch
    from repro_torch.launch import serve

    full = get_config("sobel-hd")
    base = ["--arch", "sobel-hd", "--slots", "4", "--requests", "8", "--shard", "2x2x2"]
    runs = (
        ("chaos", ["--chaos", "loss@3;fail@step:1x2;slow@d1:40"], {}),
        ("simulate-loss", ["--simulate-loss-at", "3"], {}),
        ("edges", ["--simulate-loss-at", "3", "--edges"], dict(nms=True, hysteresis=True)),
    )
    out = {}
    for label, extra, kw in runs:
        reset_counts()
        stats = serve.main(base + extra, devices=logical_devices())
        counts = read_counts()
        health = stats["health"]
        check(health.unaccounted == 0 and health.submitted == 8,
              f"the {label} server left requests unaccounted: {health.summary()}")
        check(health.replans >= 1, f"the {label} server never replanned: {health.summary()}")
        check(counts["k1"] >= 1, f"the {label} server did not launch K1: {counts}")
        last = torch.from_numpy(image_batch(full, 4, step=7)["images"]).to(dev)
        plain = edge_detect(last, full.edge_config(with_max=True, backend="torch", **kw))
        check(same_result(stats["result"], plain),
              f"the {label} server's last answer differs from the torch lane")
        out[label] = dict(launches=counts["k1"], mps=stats["mps"],
                          compute_p50_ms=stats["compute_p50_ms"],
                          transfer_p50_ms=stats["transfer_p50_ms"],
                          rewarm_ms=stats["rewarm_ms"], meshes=stats["meshes"],
                          retries=health.retries, replans=health.replans,
                          excluded=list(health.excluded))
        print(f"{label} server: {counts['k1']} K1 launches; MPS {stats['mps']:.1f}; compute "
              f"p50 {stats['compute_p50_ms']:.2f} ms; transfer p50 "
              f"{stats['transfer_p50_ms']:.2f} ms; re-warm "
              f"{', '.join(f'{v:.1f}' for v in stats['rewarm_ms'])} ms; meshes "
              f"{stats['meshes']}; {health.summary()}; last answer equal to the torch lane")
    return out


def phase_facade(rng, dev):
    """Phase 3: the facade on the card against the reference's digests and
    the torch lane."""
    from repro_torch.api import EdgeConfig, edge_detect
    from repro_torch.kernels.edge import edge_cuda

    for name, arr in golden_inputs().items():
        res = edge_detect(arr, EdgeConfig(with_max=True))
        for field in ("magnitude", "peak"):
            want = GOLDEN[name][field]
            got = digest(getattr(res, field))
            check(got == want, f"{name} {field} digest {got} != JAX reference {want}")
    print("facade: small inputs equal the JAX reference's digests")
    facade_inputs = {
        "1080p rgb u8 NHWC": frames("rgb", (4, 1080, 1920), rng, dev),
        "NTHW gray u8": frames("u8", (2, 3, 480, 640), rng, dev),
    }
    for label, x in facade_inputs.items():
        edge_cuda.launches = 0
        res = edge_detect(x)
        launches = edge_cuda.launches
        ref = edge_detect(x, EdgeConfig(backend="torch"))
        check(launches >= 1, f"facade on {label} did not launch K1")
        check(torch.equal(res.magnitude, ref.magnitude),
              f"facade on {label}: cuda and torch lanes differ")
        want_shape = x.shape[:-1] if res.layout.endswith("C") else x.shape
        check(res.magnitude.shape == want_shape, f"facade on {label}: shape {tuple(res.magnitude.shape)}")
        check(bool(torch.isfinite(res.magnitude).all()), f"facade on {label}: non-finite output")
        print(f"facade {label}: layout {res.layout}, K1 launches {launches}, equal to torch lane")


def phase_depth_facade(full_inputs, dev):
    """Phase 3c, this slice's main path: ``edge_detect`` on the sobel-hd
    FULL config at 4x2048x2048 with an explicit ring depth (each depth that
    fits, f32 and u8 frames) and, on u8, the default ``precision="auto"``.
    Counts are set to 0 just before each call and read just after. Returns
    the summed counts of these runs."""
    from repro_torch.api import edge_detect
    from repro_torch.configs import get_config
    from repro_torch.core.filters import get_operator

    t0 = time.perf_counter()
    full = get_config("sobel-hd")
    spec5 = get_operator("sobel5")
    total = dict.fromkeys(COUNTS, 0)
    runs = []
    for kind, x in full_inputs.items():
        for depth in fitting_depths(full.sobel_block_h, full.sobel_block_w, spec5,
                                    x.element_size(), 1, False):
            cfg = full.edge_config(pipeline_depth=depth, with_max=True)
            reset_counts()
            res = edge_detect(x, cfg)
            counts = read_counts()
            lane = "int" if kind == "u8" else "f32"
            check(counts["k2"] == 1 and counts["k1"] == 0,
                  f"edge_detect(pipeline_depth={depth}) on {kind} launched {counts}")
            check(counts["k2_int"] == (1 if lane == "int" else 0),
                  f"edge_detect(pipeline_depth={depth}) on {kind} ran the wrong lane: {counts}")
            ref = edge_detect(x, cfg.replace(backend="torch"))
            check(torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.peak, ref.peak),
                  f"edge_detect(pipeline_depth={depth}) on {kind} differs from the torch lane")
            check(bool(torch.isfinite(res.magnitude).all()), "non-finite facade output")
            for k, v in counts.items():
                total[k] += v
            runs.append(f"{kind}/d{depth}/{lane}")
    cfg = full.edge_config(with_max=True)
    reset_counts()
    res = edge_detect(full_inputs["u8"], cfg)
    counts = read_counts()
    check(counts["k1_int"] == 1 and counts["k2"] == 0,
          f"edge_detect on u8 gray with precision='auto' did not run K1's int lane: {counts}")
    ref = edge_detect(full_inputs["u8"], cfg.replace(backend="torch"))
    check(torch.equal(res.magnitude, ref.magnitude), "the auto int lane differs from torch")
    for k, v in counts.items():
        total[k] += v
    print(f"facade depth/lane at 4x{full.image_h}x{full.image_w} ({', '.join(runs)}, u8/auto "
          f"-> K1 int): every output equal to the torch lane; launches {total} "
          f"({time.perf_counter() - t0:.1f}s)")
    return total


def phase_tuned_facade(full_inputs, dev):
    """Phase 3d: autotune the image server's workload (4 f32 frames of
    2048x2048) on the card into this run's cache, then ``edge_detect`` with
    no tile must take the tuned tile and depth, unpinned and with the depth
    pinned to 2. Returns the summed counts of the two main-path calls and
    the sweep's rows."""
    from repro_torch.api import edge_detect
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch, tuning

    t0 = time.perf_counter()
    full = get_config("sobel-hd")
    x = full_inputs["f32"]
    h, w = full.image_h, full.image_w
    rows = {}
    best = {}
    for pinned in (None, 2):
        best[pinned] = tuning.autotune(h, w, backend="cuda", dtype="float32",
                                       shapes=TUNE_SHAPES, iters=3, batch=x.shape[0],
                                       pipeline_depth=pinned)
        # The rows autotune chose from are not returned; a second sweep of
        # the same candidates shows them (its order may differ by noise).
        rows[pinned] = tuning.sweep(h, w, backend="cuda", dtype="float32", shapes=TUNE_SHAPES,
                                    iters=3, batch=x.shape[0],
                                    depths=(0, 2) if pinned is None else (pinned,))
        print(f"autotune 4x{h}x{w} f32 (depth {'0 or 2' if pinned is None else pinned}): "
              f"winner {best[pinned]}; the candidates swept again:")
        for r in sorted(rows[pinned], key=lambda r: r["us"]):
            print(f"  {r['block_h']:4d}x{r['block_w']:<4d} depth {r['depth']}: {r['us']:9.1f} us "
                  f"(host clock, best of 3); smem {r['smem_bytes']} B, halo overhead "
                  f"{r['halo_overhead']:.3f}")
    total = dict.fromkeys(COUNTS, 0)
    for pinned in (None, 2):
        cfg = full.edge_config(block_h=None, block_w=None, pipeline_depth=pinned,
                               with_max=True)
        choice = dispatch.choose_block_shape(h, w, operator=cfg.operator, variant="v2",
                                             backend="cuda", pipeline_depth=pinned)
        check(choice == best[pinned] + ("tuned",),
              f"choose_block_shape gave {choice}, not the tuned {best[pinned]}")
        reset_counts()
        res = edge_detect(x, cfg)
        counts = read_counts()
        want_k2 = best[pinned][2] != 0
        check(counts["k2"] == int(want_k2) and counts["k1"] == int(not want_k2),
              f"the tuned call (depth {best[pinned][2]}) launched {counts}")
        ref = edge_detect(x, cfg.replace(backend="torch"))
        check(torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.peak, ref.peak),
              "the tuned call differs from the torch lane")
        for k, v in counts.items():
            total[k] += v
        print(f"tuned edge_detect (pipeline_depth={pinned}): {choice}, launches {counts}; "
              "equal to the torch lane")
    print(f"tuned facade: {time.perf_counter() - t0:.1f}s")
    return total, rows, best


def video(cfg, n_streams: int, step: int, motion: float, dev):
    """The stream server's frames of one step, stacked, on ``dev``."""
    from repro_torch.data.synthetic import video_frame

    return torch.from_numpy(np.stack([video_frame(cfg, stream=s, step=step, motion=motion)
                                      for s in range(n_streams)])).to(dev)


def phase_nms_facade(rng, dev):
    """Phase 3b: NMS + hysteresis through the facade, and the stream path
    with decay 0 against stateless calls, at full width."""
    from repro_torch.api import EdgeConfig, edge_detect, edge_detect_stream
    from repro_torch.configs import get_config
    from repro_torch.kernels.edge import edge_cuda, edge_stream_cuda

    t0 = time.perf_counter()
    x = frames("rgb", (2, 1080, 1920), rng, dev)
    cfg = EdgeConfig(hysteresis=True, with_max=True)
    edge_cuda.launches = 0
    res = edge_detect(x, cfg)
    check(edge_cuda.launches == 1, "edge_detect(hysteresis) did not launch K1 once")
    ref = edge_detect(x, cfg.replace(backend="torch"))
    for field in ("magnitude", "thin", "edges", "peak"):
        check(torch.equal(getattr(res, field), getattr(ref, field)),
              f"edge_detect(nms, hysteresis): cuda and torch lanes differ in {field}")
    full = get_config("sobel-hd")
    stream_cfg = full.edge_config(temporal=True, decay=0.0, with_max=True)
    stateless = full.edge_config(hysteresis=True, with_max=True)
    state = None
    edge_stream_cuda.launches = 0
    for t in range(8):
        f = video(full, 4, t, 2.0, dev)
        out, state = edge_detect_stream(f, stream_cfg, state)
        want = edge_detect(f, stateless)
        for field in ("magnitude", "edges", "peak"):
            check(torch.equal(getattr(out, field), getattr(want, field)),
                  f"stream step {t} with decay 0 differs from stateless edge_detect in {field}")
    check(edge_stream_cuda.launches == 8, "edge_detect_stream did not launch K3 each frame")
    print(f"facade nms: edge_detect(hysteresis) equals the torch lane; 8 frames of 4 "
          f"{full.image_h}x{full.image_w} streams with decay 0 equal 8 stateless calls "
          f"({time.perf_counter() - t0:.1f}s)")


def phase_server(dev):
    """Phase 4: the image server and its --edges mode."""
    from repro_torch.api import edge_detect
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels.edge import edge_cuda
    from repro_torch.launch import serve

    edge_cuda.launches = 0
    stats = serve.main(["--arch", "sobel-hd", "--slots", "4", "--requests", "8"])
    server_launches = edge_cuda.launches
    check(server_launches >= 1, "the server did not launch K1")
    out = stats["result"]
    full_cfg = get_config("sobel-hd")
    check(tuple(out.magnitude.shape) == (4, full_cfg.image_h, full_cfg.image_w),
          f"server shape {tuple(out.magnitude.shape)}")
    check(bool(torch.isfinite(out.magnitude).all()), "server output not finite")
    # mag * RN(255 / peak) rounds twice, so the peak pixel may land one ulp
    # above 255, as it does in the JAX reference.
    top = float(np.nextafter(np.float32(255.0), np.float32(np.inf)))
    check(float(out.magnitude.max()) <= top and float(out.magnitude.min()) >= 0.0,
          f"server output outside [0, {top}]")
    check(bool((out.peak > 0).all()), "server peak not positive")
    last = torch.from_numpy(image_batch(full_cfg, 4, step=stats["requests"] - 1)["images"]).to(dev)
    server_cfg = full_cfg.edge_config(with_max=True)
    plain = edge_detect(last, server_cfg.replace(backend="torch"))
    check(torch.equal(out.magnitude, plain.magnitude) and torch.equal(out.peak, plain.peak),
          "the server's last answer differs from the torch lane on the same frames")
    print(f"server: {server_launches} K1 launches; MPS {stats['mps']:.1f}; compute "
          f"p50 {stats['compute_p50_ms']:.2f} ms p95 {stats['compute_p95_ms']:.2f} ms; "
          f"transfer p50 {stats['transfer_p50_ms']:.2f} ms p95 {stats['transfer_p95_ms']:.2f} ms; "
          "last answer equal to the torch lane")

    # One more request of the server's config under the profiler: device
    # time by kernel, to show where a request's compute goes.
    device_profile("one request", lambda: edge_detect(last, server_cfg), top=6, again=10)

    edge_cuda.launches = 0
    edges = serve.main(["--arch", "sobel-hd", "--slots", "4", "--requests", "4", "--edges"])
    edges_launches = edge_cuda.launches
    check(edges_launches >= 1, "the --edges server did not launch K1")
    last = torch.from_numpy(image_batch(full_cfg, 4, step=3)["images"]).to(dev)
    plain = edge_detect(last, full_cfg.edge_config(with_max=True, nms=True, hysteresis=True,
                                                   backend="torch"))
    res = edges["result"]
    for field in ("magnitude", "thin", "edges", "peak"):
        check(torch.equal(getattr(res, field), getattr(plain, field)),
              f"the --edges server's last answer differs from the torch lane in {field}")
    check(0.0 < edges["edge_density"] < 0.5, f"edge density {edges['edge_density']}")
    print(f"--edges server: {edges_launches} K1 launches (NMS outputs); compute p50 "
          f"{edges['compute_p50_ms']:.2f} ms p95 {edges['compute_p95_ms']:.2f} ms; edge density "
          f"{edges['edge_density']:.4f}; last answer equal to the torch lane")
    return server_launches, edges_launches


def phase_stream_server(dev):
    """Phase 4b: the stream server at full width, three runs, each replayed
    through the torch lane frame by frame."""
    from repro_torch.api import edge_detect_stream
    from repro_torch.configs import get_config
    from repro_torch.core import nms
    from repro_torch.kernels.edge import edge_cuda, edge_stream_cuda
    from repro_torch.launch import serve

    full = get_config("sobel-hd")
    n_streams, n_frames = 4, 8
    runs = {}
    for label, motion, decay in (("motion", 2.0, 0.0), ("static", 0.0, 0.0),
                                 ("decay", 2.0, 0.9)):
        edge_cuda.launches = edge_stream_cuda.launches = 0
        stats = serve.main(["--arch", "sobel-hd", "--streams", str(n_streams), "--slots",
                            str(n_streams), "--requests", str(n_frames), "--motion", str(motion),
                            "--decay", str(decay), "--collect"])
        k3 = edge_stream_cuda.launches
        k1 = edge_cuda.launches
        health = stats["health"]
        check(not health.degraded and health.retries == 0,
              f"stream run {label}: degraded={health.degraded} retries={health.retries}")
        counts = health.counts
        check(counts["served"] + counts["retried"] + counts["degraded"] + counts["shed"]
              + counts["quarantined"] == health.submitted == n_streams * n_frames,
              f"stream run {label}: accounting {counts} vs submitted {health.submitted}")
        check(k3 >= 1, f"stream run {label} did not launch K3")
        cached = sum(st.cached_steps for st in stats["streams"].values())
        if label == "motion":
            check(stats["skip_rate"] > 0, "the motion run skipped no tile")
        if label == "static":
            check(k3 == 1 and cached == n_streams * (n_frames - 1),
                  f"the static run launched K3 {k3} times with {cached} cached steps")
        # Replay the same frames through the torch lane and hold every served
        # frame of every stream against it.
        cfg = stats["config"].replace(backend="torch")
        state, iters, replayed = None, [], {}
        for t in range(n_frames):
            f = video(full, n_streams, t, motion, dev)
            res, state = edge_detect_stream(f, cfg, state)
            iters.append(nms.hysteresis.iterations)
            for sid in range(n_streams):
                out = stats["streams"][sid].outputs[t]
                ok = (np.array_equal(out["magnitude"], res.magnitude[sid].cpu().numpy())
                      and np.array_equal(out["edges"], res.edges[sid].cpu().numpy())
                      and out["skipped"] == int(res.skipped[sid]))
                check(ok, f"stream run {label}: stream {sid} frame {t} differs from the torch lane")
            if t >= n_frames - 2:
                replayed[t] = (f, state)
        ps = stats["per_stream"]
        print(f"stream server {label} (motion {motion}, decay {decay}): K3 launches {k3}, "
              f"K1 launches {k1}, cached steps {cached}, skip rate {stats['skip_rate']:.4f}, "
              f"{stats['frames_per_s']:.1f} frames/s; every frame equal to the torch lane; "
              f"hysteresis dilation steps per frame {iters}")
        for sid, row in ps.items():
            print(f"  stream {sid}: compute p50 {row['compute_p50_ms']:.3f} ms p99 "
                  f"{row['compute_p99_ms']:.3f} ms; transfer p50 {row['transfer_p50_ms']:.3f} ms "
                  f"p99 {row['transfer_p99_ms']:.3f} ms; skip {row['skip_rate']:.4f}")
        print(f"  {health.summary()}")
        for st in stats["streams"].values():
            st.outputs.clear()
        runs[label] = dict(k3=k3, cfg=stats["config"], replayed=replayed, motion=motion)
    return runs


def phase_step_parts(run, dev):
    """Phase 4c: where one stream step of the motion run goes; returns the
    step's change mask."""
    from repro_torch.core import nms
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import video_frame
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.edge import edge_stream_cuda

    cfg = run["cfg"]
    full = get_config("sobel-hd")
    (_, (_, state)), (t_last, (x, _)) = sorted(run["replayed"].items())
    host = torch.from_numpy(np.stack([video_frame(full, stream=s, step=t_last, motion=run["motion"])
                                      for s in range(x.shape[0])]))
    xfer = []
    for _ in range(5):
        t0 = time.perf_counter()
        host.to(dev)
        torch.cuda.synchronize()
        xfer.append((time.perf_counter() - t0) * 1e3)
    changed, skipped = dispatch.stream_delta(x, state, cfg)
    mask = changed.to(torch.int32).contiguous()
    bh, bw = state.block
    kw = dict(spec=cfg.spec, variant=cfg.variant, directions=cfg.directions,
              padding=cfg.padding, block_h=bh, block_w=bw, out_nms=True)
    primary, bmax = edge_stream_cuda(x, state.primary, state.bmax, mask, **kw)
    peak = bmax.amax(dim=(-2, -1), keepdim=True)
    low, high = nms.resolve_thresholds(peak, cfg.low, cfg.high)
    parts = {
        "transfer (host clock, pageable)": statistics.median(xfer),
        "change test (stream_delta)": median_ms(lambda: dispatch.stream_delta(x, state, cfg),
                                                reps=10),
        "K3": median_ms(lambda: edge_stream_cuda(x, state.primary, state.bmax, mask, **kw),
                        reps=10),
        "hysteresis": median_ms(lambda: nms.hysteresis(primary, low, high), reps=5, warm=1),
        "epilogue (peak, hysteresis, normalize)": median_ms(
            lambda: dispatch._stream_epilogue(x, cfg, state, primary, bmax, skipped,
                                              batch_shape=(x.shape[0],), layout="NHW"),
            reps=5, warm=1),
        "whole step (edge_stream)": median_ms(
            lambda: dispatch.edge_stream(x, cfg, state), reps=5, warm=1),
    }
    iters = nms.hysteresis.iterations
    share = float(changed.float().mean())
    print(f"one stream step of the motion run (frame {t_last}, 4x{x.shape[1]}x{x.shape[2]} u8, "
          f"{100 * share:.2f}% of tiles changed; hysteresis {iters} dilation steps):")
    for name, ms in parts.items():
        print(f"  {ms:9.4f} ms  {name}")
    return mask


# Hysteresis fractions that give the synthetic frames weak chains: the
# textured background's thin maxima lie between 1% and 3% of the peak, so
# they link to the strong ridges over hundreds of dilation steps (the
# defaults, 10% and 20%, leave nothing weak but unlinked).
WEAK_LOW, WEAK_HIGH = 0.01, 0.03


def phase_linking(run, dev):
    """Phase 4d: one stream step of the motion run with weak chains to link,
    on the card and on the torch lane; times the linking loop."""
    from repro_torch.api import edge_detect_stream
    from repro_torch.core import nms
    from repro_torch.kernels.edge import edge_stream_cuda

    cfg = run["cfg"].replace(low=WEAK_LOW, high=WEAK_HIGH)
    (_, (_, state)), (t_last, (x, _)) = sorted(run["replayed"].items())
    launches = edge_stream_cuda.launches
    res, new_state = edge_detect_stream(x, cfg, state)
    check(edge_stream_cuda.launches > launches, "the linking step did not launch K3")
    steps = nms.hysteresis.iterations
    ref, ref_state = edge_detect_stream(x, cfg.replace(backend="torch"), state)
    check(nms.hysteresis.iterations == steps, "the torch lane linked in another number of steps")
    ok = (torch.equal(res.magnitude, ref.magnitude) and torch.equal(res.edges, ref.edges)
          and torch.equal(res.skipped, ref.skipped)
          and torch.equal(new_state.primary, ref_state.primary))
    check(ok, "the linking step differs from the torch lane")
    peak = new_state.bmax.amax(dim=(-2, -1), keepdim=True)
    low, high = nms.resolve_thresholds(peak, cfg.low, cfg.high)
    thin = new_state.primary
    weak, strong = int((thin > low).sum()), int(((thin > high) & (thin > low)).sum())
    hyst_ms = median_ms(lambda: nms.hysteresis(thin, low, high), reps=3, warm=1)
    step_ms = median_ms(lambda: edge_detect_stream(x, cfg, state), reps=3, warm=1)
    print(f"linking (frame {t_last} of the motion run, low {WEAK_LOW}, high {WEAK_HIGH}): "
          f"{weak} weak and {strong} strong pixels, {int(res.edges.sum())} edges; "
          f"{steps} dilation steps; equal to the torch lane")
    print(f"  {hyst_ms:9.4f} ms  hysteresis ({hyst_ms / steps:.4f} ms a dilation step)")
    print(f"  {step_ms:9.4f} ms  whole edge_detect_stream step")
    return dict(steps=steps, hysteresis_ms=hyst_ms, step_ms=step_ms, weak=weak, strong=strong)


# --- K4 (flash attention) and the LM server ---------------------------------

# Phase 6's cases, (B, H, S, T, D), (block_q, block_kv): the reference test's
# four shapes (tests/test_kernels.py), ragged lengths, the model's head
# dims, the server's prefill shapes (llama3.2-1b: 32 heads of 64, buckets
# 8-64) and a 2,048-token prompt. Each runs f32 and bf16, causal and not.
K4_CASES = (
    [((2, 3, 16, 16, 8), (4, 4)), ((1, 2, 32, 32, 16), (8, 16)), ((2, 2, 8, 24, 8), (8, 8)),
     ((1, 1, 64, 64, 4), (16, 32))]
    + [((1, 4, s, s, d), (s, s)) for s in (1, 7, 65, 129, 200) for d in (64, 128)]
    + [((1, 32, s, s, 64), (s, s)) for s in (8, 16, 32, 64)]
    + [((1, 32, 2048, 2048, 64), (128, 128))]
    # zamba2's shared block (32 heads of 80: the D <= 128 instance) at the
    # engine's buckets and the long prefills; whisper's encoder, decoder
    # self- and cross-attention (20 heads of 64; 4 prompts of 32 tokens
    # over the 1,500-frame window); pixtral's 1,024 patches + 32 tokens
    # (8 KV heads repeated to 32 of 128). The mesh trainer's shard (phase 17a:
    # llama3.2-1b's 8 x 128 batch on a 2x2 mesh, 4 rows and 16 of the 32
    # heads a position).
    + [((1, 32, s, s, 80), (s, s)) for s in (8, 16, 32, 64, 1000, 2048)]
    + [((4, 20, 1500, 1500, 64), (1500, 1500)), ((4, 20, 32, 1500, 64), (32, 1500)),
       ((4, 20, 32, 32, 64), (32, 32))]
    + [((4, 32, 1056, 1056, 128), (1056, 1056))]
    + [((4, 16, 128, 128, 64), (128, 128))]
)
K4_TOL = 2e-5            # f32: tests/test_kernels.py's atol and rtol
# minicpm3-4b's MLA prefill as K4 sees it: 40 heads, q and k of 64 nope + 32
# rope dims, v of 64 zero-padded to 96; the server's buckets and 2,048.
MLA_HEADS, MLA_QK, MLA_V = 40, 96, 64
MLA_K4_S = (8, 16, 32, 64, 2048)
# Logits of the f32 model, K4 lane against the plain lane on the card: the
# attention outputs differ by rounding (~1e-6), which 16 layers of f32
# products carry to the logits far below this.
LOGIT_TOL = 1e-3
LM_REQUESTS, LM_SLOTS, LM_NEW = 16, 4, 16     # the reference server's defaults
LM_ARGS = ["--arch", "llama3.2-1b", "--requests", "16", "--slots", "4", "--max-new", "16"]
# A moe model's lanes are compared layer by layer (``layer_local``): at
# random weights its gates amplify the lanes' last-bit differences from
# layer to layer, so two free-running lanes part as far as the plain lane
# parts from itself with its embeddings moved by one ulp
# (tools/moe_lane_divergence.py prints both, layer by layer).
# ATTN_TOL: the K4 lane's attention output against the plain lane's on the
# same input, relative to its largest value; a layout, head-mapping, mask
# or padding fault moves it by O(1), while the random weights' scores (of
# order 10^3 in phi3.5-moe) amplify the kernels' rounding to ~1e-4.
ATTN_TOL = 1e-3
# ROUTER_TOL: the lanes' router logits on the same input, relative to the
# plain lane's router-logit standard deviation at that layer.
ROUTER_TOL = 1e-3
# ROUTE_MARGIN: where the lanes' router logits differ by at most d, rounding
# can part their expert sets only where the plain lane's margin between its
# k-th and (k+1)-th logit is at most 2 d; a part at a larger margin is a
# fault. The bound is ROUTE_MARGIN x d, d measured at each layer.
ROUTE_MARGIN = 2.0


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``x`` (8 bits of mantissa)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


def attention_inputs(shape, dtype, dev, seed):
    b, h, s, t, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(n, generator=g, device=dev).to(dtype)
                 for n in ((b, h, s, d), (b, h, t, d), (b, h, t, d)))


def phase_k4_vs_plain(dev):
    """Phase 6: K4 against flash_attention_plain on the card. Returns the
    worst f32 error at (1, 32, 2048, 64) causal."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    cases = bad = 0
    worst_f32, worst_ulps, worst_bf16, main_err = 0.0, 0.0, 0.0, None
    for i, (shape, (bq, bkv)) in enumerate(K4_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attention_inputs(shape, dtype, dev, seed=i)
            for causal in (True, False):
                got = flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
                want = flash_attention_plain(q, k, v, causal=causal)
                diff = (got.float() - want.float()).abs()
                cases += 1
                if dtype == torch.float32:
                    ok = bool((diff <= K4_TOL + K4_TOL * want.abs()).all())
                    worst_f32 = max(worst_f32, float(diff.max()))
                    if shape == (1, 32, 2048, 2048, 64) and causal:
                        main_err = float(diff.max())
                else:
                    # Each side rounds an f32 result once: one bf16 ulp, plus
                    # the f32 tolerance where the output's ulp is below it.
                    ulps = diff / bf16_ulp(want)
                    ok = bool((diff <= bf16_ulp(want) + K4_TOL).all())
                    worst_ulps = max(worst_ulps, float(ulps.max()))
                    worst_bf16 = max(worst_bf16, float(diff.max()))
                if not (ok and bool(torch.isfinite(got).all())):
                    bad += 1
                    print(f"  MISMATCH K4 {shape} {dtype} causal={causal}: max abs err "
                          f"{float(diff.max())}")
    # MLA's prefill (minicpm3-4b: 40 heads, q and k of 64 + 32 dims, v of 64
    # zero-padded to 96 as models/attention.py pads it), causal f32: within
    # K4_TOL of the plain version on the padded v and on the 64-wide v, and
    # the 32 padded output columns exactly 0.
    mla_bad, worst_mla = 0, 0.0
    for s in MLA_K4_S:
        q, k, v = attention_inputs((1, MLA_HEADS, s, s, MLA_QK), torch.float32, dev, seed=s)
        v = v[..., :MLA_V]
        got = flash_attention(q, k, F.pad(v, (0, MLA_QK - MLA_V)), causal=True, block_q=s,
                              block_kv=s)
        pad_zero = torch.count_nonzero(got[..., MLA_V:]) == 0
        for want in (flash_attention_plain(q, k, F.pad(v, (0, MLA_QK - MLA_V)))[..., :MLA_V],
                     flash_attention_plain(q, k, v)):
            diff = (got[..., :MLA_V] - want).abs()
            worst_mla = max(worst_mla, float(diff.max()))
            if not (bool((diff <= K4_TOL + K4_TOL * want.abs()).all()) and pad_zero
                    and bool(torch.isfinite(got).all())):
                mla_bad += 1
                print(f"  MISMATCH K4 MLA (1, {MLA_HEADS}, {s}, {MLA_QK}) v {MLA_V}: max abs err "
                      f"{float(diff.max())}, padded columns zero: {bool(pad_zero)}")
    torch.cuda.synchronize()
    print(f"K4 vs plain: {cases} cases, {bad} outside tolerance; worst f32 abs err "
          f"{worst_f32:.3g} (tolerance {K4_TOL} abs + rel); worst bf16 abs err {worst_bf16:.3g}, "
          f"{worst_ulps:.3g} ulp of the output (tolerance 1 ulp + {K4_TOL}); MLA shapes "
          f"(1, {MLA_HEADS}, S, {MLA_QK}), S in {MLA_K4_S}, v {MLA_V} zero-padded: "
          f"{2 * len(MLA_K4_S)} comparisons, {mla_bad} outside tolerance, worst abs err "
          f"{worst_mla:.3g}, padded output columns exactly 0 in every case: {mla_bad == 0}")
    check(bad == 0, f"K4 differs from flash_attention_plain in {bad} of {cases} cases")
    check(mla_bad == 0, f"K4 with MLA's padded v differs in {mla_bad} comparisons")
    return main_err


def replay_prompts(vocab: int, n: int):
    """The LM server's prompts: repro_torch.launch.serve.serve_lm's rng."""
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(n):
        plen = int(rng.integers(2, 24))
        prompts.append(rng.integers(0, vocab, plen).tolist())
    return prompts


def padded_batch(ctx, dev, trash=None):
    """The engine's bucket-padded prefill batch of one context: tokens
    right-padded to their bucket, pad tokens' cache destinations at
    ``trash`` (default: the bucket length). Returns (batch, bucket)."""
    from repro_torch.launch.serve import LM_BUCKETS
    from repro_torch.serve.engine import _bucket

    b = _bucket(len(ctx), LM_BUCKETS)
    toks = torch.zeros((1, b), dtype=torch.int32, device=dev)
    toks[0, :len(ctx)] = torch.tensor(ctx)
    pos = torch.arange(b, dtype=torch.int32, device=dev)[None]
    trash = b if trash is None else trash
    return {"tokens": toks, "positions": pos,
            "cache_positions": torch.where(pos < len(ctx), pos, trash)}, b


def engine_batch(cfg, ctx, dev):
    """The engine's prefill batch of one context and the cache length it
    needs: bucket-padded with a trash slot (the attention families), or the
    context as it is (ssm and hybrid: bucket-length contexts only)."""
    if cfg.family in ("ssm", "hybrid"):
        return {"tokens": torch.tensor([ctx], dtype=torch.int32, device=dev)}, len(ctx) + 1
    batch, b = padded_batch(ctx, dev)
    return batch, b + 1


def k4_per_prefill(cfg) -> int:
    """K4 launches of one prefill: one a layer (dense, moe, vlm), one a
    shared-block application (hybrid), encoder + decoder self + cross
    (encdec)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def top2_gap(logits: torch.Tensor, token: int):
    """The gap between the two largest of ``logits`` and how far ``token``'s
    logit lies below the largest."""
    top2 = torch.topk(logits, 2).values
    return float(top2[0] - top2[1]), float(top2[0] - logits[token])


def ulp_params(params):
    """The weights with the embedding table moved by one ulp (x (1 + 2^-23)):
    the plain lane on them is the control that shows how far the model's
    own rounding carries a last-bit difference."""
    emb = params["embed"]["embedding"] * (1 + 2.0 ** -23)
    return dict(params, embed=dict(params["embed"], embedding=emb))


def ulp_moved(t: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``t`` with each entry moved one ulp up or down at random (``seed``):
    a last-bit change that a norm's scale invariance does not cancel, as
    it largely cancels ``ulp_params``' uniform scaling behind an RMSNorm."""
    g = torch.Generator(device=t.device).manual_seed(seed)
    up = torch.rand(t.shape, generator=g, device=t.device) < 0.5
    return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf).to(t.dtype))


def random_ulp_params(params):
    """The weights with each embedding entry moved one ulp at random
    (``ulp_moved``): phase 18's control."""
    emb = ulp_moved(params["embed"]["embedding"])
    return dict(params, embed=dict(params["embed"], embedding=emb))


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def layer_local(cfg, params, batch) -> dict:
    """A moe model's two lanes layer by layer, each block run on both lanes
    from the plain lane's hidden state (the prefill's attention and MoE;
    the cache is only written there): the K4 lane's attention output within
    ``ATTN_TOL`` of the plain lane's, router logits within ``ROUTER_TOL``
    (relative), expert sets apart only where the plain lane's margin
    between its k-th and (k+1)-th router logit is at most ``ROUTE_MARGIN``
    times the lanes' router-logit difference, and the last layer's logits
    (final norm and head on each lane's last block) within ``LOGIT_TOL``
    unless the last layer's experts parted. Returns the worst of each and the parts."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.layers import apply_norm, torch_dtype
    from repro_torch.models.moe import record_routing

    k = cfg.num_experts_per_tok
    x, pos = T._prepare_inputs(params, cfg, batch, torch_dtype(cfg.dtype))
    out = dict(attn_err=0.0, router_err=0.0, parts=0, last_parted=False,
               min_margin=float("inf"), logit_err=0.0)
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        xn = apply_norm(lp["ln1"], cfg, x)
        attn, y, logs = {}, {}, {}
        for backend in ("torch", "auto"):
            attn[backend], _ = apply_attention(lp["attn"], cfg, xn, pos, backend=backend)
            with record_routing() as logs[backend]:
                y[backend], _, _ = T._apply_attn_block(lp, cfg, x, pos, backend=backend)
        (lg_p, idx_p, _), (lg_k, idx_k, _) = logs["torch"][0], logs["auto"][0]
        d = float((lg_k - lg_p).abs().max())
        top = torch.topk(lg_p, k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        parted = (idx_p.sort(dim=-1).values != idx_k.sort(dim=-1).values).any(dim=-1)
        attn_err, router_err = max_rel(attn["auto"], attn["torch"]), d / float(lg_p.std())
        check(attn_err <= ATTN_TOL, f"layer {i}: K4's attention output differs from the plain "
                                    f"lane's by {attn_err:.3g} of its largest value > {ATTN_TOL}")
        check(router_err <= ROUTER_TOL, f"layer {i}: the lanes' router logits differ by "
                                        f"{router_err:.3g} of their deviation > {ROUTER_TOL}")
        check(not bool((parted & (margin > ROUTE_MARGIN * d)).any()),
              f"layer {i}: the lanes route apart where the plain lane's router margin exceeds "
              f"{ROUTE_MARGIN} x their router-logit difference {d:.3g}")
        out["attn_err"] = max(out["attn_err"], attn_err)
        out["router_err"] = max(out["router_err"], router_err)
        out["min_margin"] = min(out["min_margin"], float(margin.min()))
        out["parts"] += int(parted.sum())
        out["last_parted"] = bool(parted.any())
        x = y["torch"]
    logits = {b: T.unembed(params, cfg, apply_norm(params["final_norm"], cfg, y[b][:, -1:]))
              for b in y}
    check(bool(torch.isfinite(logits["auto"]).all()), "non-finite logits")
    out["logit_err"] = float((logits["auto"] - logits["torch"]).abs().max())
    check(out["last_parted"] or out["logit_err"] <= LOGIT_TOL,
          f"the last layer's logits differ by {out['logit_err']} > {LOGIT_TOL}")
    return out


def replay_logits(cfg, params, prompt, outputs, step, backend, dev):
    """Teacher-forced greedy decode of one request on one lane (batch 1):
    the logits at ``step`` after feeding ``outputs[:step]``. The context is
    prefilled as the engine does: bucket-padded with the pad tokens aimed at
    a trash slot, or, for an ssm or hybrid model, as it is."""
    from repro_torch.models import Model

    model = Model(cfg, backend=backend)
    n = len(prompt) - 1
    length = len(prompt) + step + 1              # the last position is the trash slot
    cache = model.init_cache(1, length, dtype=torch.float32, device=dev)
    if n and cfg.family in ("ssm", "hybrid"):
        model.prefill(params, {"tokens": torch.tensor([prompt[:-1]], device=dev)}, cache)
    elif n:
        model.prefill(params, padded_batch(prompt[:-1], dev, trash=length - 1)[0], cache)
    for j, tok in enumerate([prompt[-1]] + list(outputs[:step])):
        logits, cache = model.decode_step(params, cache, torch.tensor([[tok]], device=dev), n + j)
    return logits[0, 0]


def lane_replay(cfg, params, done, dev) -> dict:
    """The served requests (kernel lane) against the plain lane on the card,
    on the same weights. Every prompt's engine prefill (bucket-padded, or
    as it is for a hybrid model): a dense or hybrid model's logits within
    ``LOGIT_TOL`` on both lanes; a moe model's
    blocks by ``layer_local`` (prompts whose last layer routed apart are
    exempt from its logit check, and counted). Then the requests replayed
    through a plain-lane ``Engine``: greedy tokens equal except where the
    plain lane's top-2 gap is below ``LOGIT_TOL``; for a moe model, below
    ``LOGIT_TOL`` plus how far the plain lane's logits move there when its
    embeddings move by one ulp (``ulp_params``: the model's own rounding
    noise at that token)."""
    from repro_torch.launch.serve import LM_BUCKETS
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    moe = cfg.family == "moe"
    worst, local = 0.0, []
    for r in done:
        batch, length = engine_batch(cfg, r.prompt[:-1], dev)
        if moe:
            local.append(layer_local(cfg, params, batch))
            continue
        lane = {}
        for backend in ("auto", "torch"):
            cache = Model(cfg).init_cache(1, length, dtype=torch.float32, device=dev)
            lane[backend], _ = Model(cfg, backend=backend).prefill(params, batch, cache)
        check(bool(torch.isfinite(lane["auto"]).all()), "non-finite prefill logits")
        worst = max(worst, float((lane["auto"] - lane["torch"]).abs().max()))
    exempt = sum(lo["last_parted"] for lo in local)
    if moe:
        worst = max([lo["logit_err"] for lo in local if not lo["last_parted"]], default=0.0)
    check(worst <= LOGIT_TOL, f"prefill logits differ by {worst} > {LOGIT_TOL}")

    eng = Engine(cfg, params, max_batch=LM_SLOTS, max_len=256, prompt_buckets=LM_BUCKETS,
                 backend="torch")
    for r in done:
        eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=len(r.output)))
    before = read_counts()["k4"]
    plain = {r.uid: r.output for r in eng.run()}
    check(read_counts()["k4"] == before, "the plain replay launched K4")
    ties, noise = 0, 0.0
    for r in done:
        want = plain[r.uid]
        if r.output == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(r.output, want)) if a != b)
        lg = replay_logits(cfg, params, r.prompt, r.output, step, "torch", dev)
        gap, below = top2_gap(lg, r.output[step])
        tol = LOGIT_TOL
        if moe:
            lc = replay_logits(cfg, ulp_params(params), r.prompt, r.output, step, "torch", dev)
            tol += float((lc - lg).abs().max())
            noise = max(noise, tol - LOGIT_TOL)
        check(gap < tol and below < tol,
              f"request {r.uid} step {step}: token {r.output[step]} (plain {want[step]}) with "
              f"the plain lane's top-2 gap {gap} and the token {below} below its top "
              f"(tolerance {tol})")
        ties += 1
    n = len(done)
    out = dict(logit_err=worst, near_ties=ties)
    if moe:
        out.update(route_exempt=exempt, route_parts=sum(lo["parts"] for lo in local),
                   route_min_margin=min(lo["min_margin"] for lo in local),
                   attn_err=max(lo["attn_err"] for lo in local),
                   router_err=max(lo["router_err"] for lo in local), tie_noise=noise)
        print(f"  plain-lane replay on the card, layer by layer (each block on both lanes from "
              f"the plain lane's input): attention within {out['attn_err']:.3g} of its largest "
              f"value (tolerance {ATTN_TOL}), router logits within {out['router_err']:.3g} of "
              f"their deviation (tolerance {ROUTER_TOL}); experts parted at "
              f"{out['route_parts']} (token, layer) pairs, each at a margin within "
              f"{ROUTE_MARGIN} x the router-logit difference; least router margin "
              f"{out['route_min_margin']:.3g}; last-layer logits within {worst:.3g} (tolerance "
              f"{LOGIT_TOL}) in {n - exempt} of {n} prompts, {exempt} exempt (the last layer's "
              f"experts parted)")
    else:
        print(f"  plain-lane replay on the card: prefill logits within {worst:.3g} (tolerance "
              f"{LOGIT_TOL})")
    print(f"  tokens equal in {n - ties} of {n} requests, {ties} near ties (top-2 gap < "
          f"{LOGIT_TOL}{' + the one-ulp control' if moe else ''})")
    return out


def profile_engine(cfg, params, prompts, label: str) -> dict:
    """Four prompts admitted into a fresh engine (four prefills) and then
    one decode step of its four slots, each under the profiler: device time
    by kernel, K4's share of the prefills' and the decode step's idle
    share."""
    from repro_torch.launch.serve import LM_BUCKETS
    from repro_torch.serve import Engine, Request

    eng = Engine(cfg, params, max_batch=LM_SLOTS, max_len=256, prompt_buckets=LM_BUCKETS)
    for uid, prompt in enumerate(prompts[:LM_SLOTS]):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=LM_NEW))
    busy_p, _, k4_us = device_profile(f"four engine prefills (K4 lane), {label}", eng._admit,
                                      top=8, kernel="flash_kernel")
    eng._decode_once()
    busy, span, _ = device_profile(f"one engine decode step, 4 slots, {label}",
                                   eng._decode_once, top=8)
    return dict(k4_profile_us=k4_us, k4_share=k4_us / busy_p, decode_idle=1 - busy / span,
                decode_busy_us=busy)


def phase_lm_server(dev):
    """Phase 7, the dense slice's main path: the LM server at FULL
    llama3.2-1b width and depth, f32, through repro_torch.launch.serve;
    counts set to 0 just before and read just after. Then the same requests
    on the same weights through the plain lane on the card
    (``lane_replay``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    stats = serve.main(LM_ARGS)
    counts = read_counts()
    cfg = get_config("llama3.2-1b").replace(dtype="float32")
    check(counts["k4"] == cfg.num_layers * LM_REQUESTS and stats["k4_launches"] == counts["k4"],
          f"the LM server launched K4 {counts['k4']} times, not {cfg.num_layers} x "
          f"{LM_REQUESTS}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"), f"the LM server launched {counts}")
    done = sorted(stats["requests"], key=lambda r: r.uid)
    check(len(done) == LM_REQUESTS and all(len(r.output) == LM_NEW for r in done),
          "the LM server did not serve every request to --max-new")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output), "token out of range")
    print(f"LM server {cfg.name}: {stats['param_count']:,} params; {stats['tok_s']:.1f} tok/s "
          f"({stats['tokens']} tokens in {stats['seconds']:.3f} s); prefill p50 "
          f"{stats['prefill_p50_ms']:.3f} ms ({stats['prefills']}); decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms ({stats['decode_steps']}); K4 launches {counts['k4']}")
    prompts = replay_prompts(cfg.vocab_size, LM_REQUESTS)
    check([r.prompt for r in done] == prompts, "the server's prompts are not the replay's")
    lanes = lane_replay(cfg, stats["params"], done, dev)
    prof = profile_engine(cfg, stats["params"], prompts, cfg.name)
    return dict(stats, k4=counts["k4"], **lanes, **prof)


def long_prefill(cfg, params, dev) -> int:
    """``Model.prefill`` of one prompt of 2,048 random tokens and one of
    1,000 (``default_rng(7)``) on both lanes, counts set to 0 before each:
    the kernel lane launches K4 ``k4_per_prefill`` times (once a layer, or
    once a hybrid's shared-block application) and nothing else, the plain
    lane nothing; logits within ``LOGIT_TOL`` (a moe model: ``layer_local``,
    and the free-running lanes' difference printed beside the one-ulp
    control's). Prints each lane's seconds. Returns the K4 launches."""
    from repro_torch.models import Model

    rng = np.random.default_rng(7)
    launches = 0
    for n in (2048, 1000):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
        lane, secs = {}, {}
        for backend in ("auto", "torch"):
            cache = Model(cfg).init_cache(1, n, dtype=torch.float32, device=dev)
            reset_counts()
            t0 = time.perf_counter()
            lane[backend], _ = Model(cfg, backend=backend).prefill(params, {"tokens": tokens},
                                                                   cache)
            torch.cuda.synchronize()
            secs[backend] = time.perf_counter() - t0
            counts = read_counts()
            k4 = counts["k4"]
            check(k4 == (k4_per_prefill(cfg) if backend == "auto" else 0)
                  and all(counts[k] == 0 for k in COUNTS if k != "k4"),
                  f"prefill of {n} tokens ({backend}) launched {counts}")
            launches += k4
        err = float((lane["auto"] - lane["torch"]).abs().max())
        check(bool(torch.isfinite(lane["auto"]).all()), f"non-finite logits at {n} tokens")
        if cfg.family == "moe":
            cache = Model(cfg).init_cache(1, n, dtype=torch.float32, device=dev)
            ctrl, _ = Model(cfg, backend="torch").prefill(ulp_params(params), {"tokens": tokens},
                                                          cache)
            lo = layer_local(cfg, params, {"tokens": tokens})
            line = (f"layer by layer: attention within {lo['attn_err']:.3g} (tolerance "
                    f"{ATTN_TOL}), router logits within {lo['router_err']:.3g} (tolerance "
                    f"{ROUTER_TOL}), experts parted at {lo['parts']} (token, layer) pairs "
                    f"(least margin {lo['min_margin']:.3g}), last-layer logits within "
                    f"{lo['logit_err']:.3g} (tolerance {LOGIT_TOL}"
                    f"{', exempt: the last layer parted' if lo['last_parted'] else ''}); "
                    f"free-running lanes apart by {err:.3g}, the one-ulp control by "
                    f"{float((ctrl - lane['torch']).abs().max()):.3g}")
        else:
            check(err <= LOGIT_TOL, f"prefill of {n} tokens: logits differ by {err} > {LOGIT_TOL}")
            line = f"K4 lane within {err:.3g} of the plain lane (tolerance {LOGIT_TOL})"
        print(f"long prefill {cfg.name} ({cfg.num_layers} layers) {n} tokens: {line}; K4 "
              f"launches {k4_per_prefill(cfg)}; K4 lane {secs['auto']:.2f} s, plain lane "
              f"{secs['torch']:.2f} s")
    return launches


def phase_long_prefill(dev, params):
    """Phase 7b: ``long_prefill`` at FULL llama3.2-1b."""
    from repro_torch.configs import get_config

    return long_prefill(get_config("llama3.2-1b").replace(dtype="float32"), params, dev)


def flash_bound(shape, causal: bool, elt: int, dv: int = 0) -> dict:
    """K4's least time, in ms, the largest of three terms over the (query,
    key) pairs the mask keeps: the tensor cores' products, 2D + 2Dv flops a
    pair (q.k and p*v), for f32 inputs (``elt`` 4) three times over in the
    3xTF32 split at the dense TF32 rate, for bf16 inputs (``elt`` 2) once
    at the dense bf16 rate, what the function needs whatever K4 does with
    them; one exp a pair on the SFUs; q, k, v read once and the output
    written once at 3.35 TB/s. ``dv`` is v's width (default D; MLA's 64
    beside D = 96 counts the unpadded work). ``simt_ms`` is the bound of
    the SIMT kernel K4 was before (2D FMAs and 4 other f32 operations a
    pair at 33.5 T instructions/s), printed beside it."""
    b, h, s, t, d = shape
    dv = dv or d
    pairs = b * h * (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
    flops = 2 * (d + dv) * pairs
    terms = {"tensor_ms": (3 * flops / TF32_FLOPS_PER_S if elt == 4
                           else flops / BF16_FLOPS_PER_S) * 1e3,
             "exp_ms": pairs / SFU_PER_S * 1e3,
             "bytes_ms": b * h * (s * (d + dv) + t * (d + dv)) * elt / HBM_BYTES_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return dict(terms, bound_ms=terms[top], bound_by="bytes" if top == "bytes_ms" else "operations",
                simt_ms=pairs * (d + dv + 4) / F32_OPS_PER_S * 1e3, pairs=pairs)


def phase_k4_timing(dev, lm, long_launches, main_err, paths):
    """Phase 5 (K4): CUDA-event medians of K4, its plain version and
    F.scaled_dot_product_attention (the yardstick; the port never calls
    it), f32, causal at (1, 32, 2048, 64), the server's prefill shapes,
    MLA's (1, 40, 2048, 96) with v of 64 (K4 on v zero-padded to 96, SDPA
    on the 64-wide v), zamba2's shared block (1, 32, 2048, 80) and
    pixtral's (1, 32, 1056, 128); non-causal at whisper's encoder (1, 20,
    1500, 64). ``paths`` holds the other LM paths' K4 launches and server
    numbers (phases 11-15)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for s, h, d, dv, causal in ((2048, 32, 64, 64, True), (8, 32, 64, 64, True),
                                (16, 32, 64, 64, True), (32, 32, 64, 64, True),
                                (64, 32, 64, 64, True), (2048, MLA_HEADS, MLA_QK, MLA_V, True),
                                (2048, 32, 80, 80, True), (1500, 20, 64, 64, False),
                                (1056, 32, 128, 128, True)):
        shape = (1, h, s, s, d)
        q, k, v = attention_inputs(shape, torch.float32, dev, seed=s)
        v = v[..., :dv]
        vk = F.pad(v, (0, d - dv))       # what K4 takes: v of k's width
        got = flash_attention(q, k, vk, causal=causal, block_q=s, block_kv=s)[..., :dv]
        want = flash_attention_plain(q, k, v, causal=causal)
        fb = flash_bound(shape, causal, 4, dv)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        kern = lambda: flash_attention(q, k, vk, causal=causal, block_q=s,  # noqa: E731
                                       block_kv=s)
        # In turns (library, kernel, kernel, library), each a median of 20.
        lib1, ms1, ms2, lib2 = median_ms(sdpa), median_ms(kern), median_ms(kern), median_ms(sdpa)
        row = dict(ms=statistics.median([ms1, ms2]), ms_runs=[ms1, ms2],
                   plain_ms=median_ms(lambda: flash_attention_plain(q, k, v, causal=causal)),
                   library_ms=statistics.median([lib1, lib2]), library_ms_runs=[lib1, lib2],
                   max_abs_err=float((got - want).abs().max()), shape=list(shape), dv=dv,
                   causal=causal, **fb)
        label = f"1x{h}x{s}x{d}" + (f"_v{dv}" if dv != d else "") + ("" if causal else "_full")
        rows[label] = row
        verdict = "faster" if row["ms"] < row["library_ms"] else "slower"
        print(f"K4 at (1, {h}, {s}, {d}){f' v {dv} padded to {d}' if dv != d else ''} "
              f"{'causal' if causal else 'non-causal'} f32: "
              f"{ms1:.4f} / {ms2:.4f} ms; scaled_dot_product_attention {lib1:.4f} / {lib2:.4f} "
              f"ms (K4 {verdict}, {row['ms'] / row['library_ms']:.3f}x); plain "
              f"{row['plain_ms']:.4f} ms; bound {fb['bound_ms']:.4f} ms by {fb['bound_by']} "
              f"({fb['pairs']} pairs: 3xTF32 tensor {fb['tensor_ms']:.4f} ms, SFU exp "
              f"{fb['exp_ms']:.4f} ms, bytes {fb['bytes_ms']:.4f} ms; the old SIMT bound "
              f"{fb['simt_ms']:.4f} ms)")
    main = rows["1x32x2048x64"]
    by_path = {"llama3.2-1b server": lm["k4"], "llama3.2-1b long prefills": long_launches,
               **paths["launches"]}
    server_keys = ("tok_s", "prefill_p50_ms", "decode_p50_ms", "tokens", "prefills",
                   "decode_steps", "param_count", "logit_err", "near_ties", "decode_idle",
                   "decode_busy_us", "k4_share", "k4_profile_us", "plain_prefill_ms",
                   "attn_err", "cross_err", "free_logit_err", "control_logit_err",
                   "decode_logit_err", "decode_control_err", "step_p50_ms", "step_ms",
                   "peak_gb", "step_idle", "loss", "grad_norm", "phase_seconds", "lanes",
                   "functions", "restart", "k4_train", "k4_per_step", "mesh", "reshard",
                   "f32", "pod", "single_step_p50_ms", "single_tok_s", "single_peak_gb",
                   "single_step_idle", "k4_device_us", "step_busy_us")
    return {
        "name": "K4 flash_attention (online-softmax attention)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:40",
        "launches": sum(by_path.values()),
        "max_abs_err": main_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shapes": rows,
        "launches_by_path": by_path,
        "launches_long_prefill": long_launches,
        "server": {k: lm[k] for k in server_keys if k in lm},
        **{name: {k: v for k, v in st.items() if k in server_keys or k.startswith("route")}
           for name, st in paths["servers"].items()},
        **paths["family_mesh"],
    }


# --- K5 (selective scan) and the ssm server -----------------------------------

# Phase 8's cases, (B, L, d_inner, N), (chunk, block_d): the reference test's
# shape and blocks (tests/test_kernels.py), ragged d_inner x N x L, the ssm
# server's prefill shapes (falcon-mamba-7b: d_inner 8192, N 16, buckets
# 8-64) and a 2,048-token prompt at the model's chunk (_pick_chunk(2048, 16)).
# Each runs f32 and bf16.
K5_CASES = (
    [((2, 32, 16, 4), blocks) for blocks in ((8, 8), (16, 4), (32, 16))]
    + [((2, l, di, n), (l, di)) for di in (24, 200) for n in (1, 4, 16) for l in (1, 7, 2048)]
    + [((2, l, 200, n), (l, 200)) for n in (33, 64) for l in (7, 2049)]
    + [((1, l, 8192, 16), (l, 8192)) for l in (8, 16, 32, 64)]
    + [((1, 2048, 8192, 16), (16, 8192))]
)
K5_TOL = 3e-5            # f32: tests/test_kernels.py's atol and rtol
# The cache's final state and conv tail, K5 lane against the plain lane at
# FULL falcon-mamba-7b, abs + rel: rounding differences of the scan's y
# (~1e-7) carried through up to 63 earlier layers of f32 products.
STATE_TOL = 1e-3
SSM_ARCH = "falcon-mamba-7b"
SSM_BUCKETS = (8, 16, 32, 64)
SSM_REQUESTS, SSM_SLOTS, SSM_NEW = 16, 4, 16
SSM_PARAMS = 7_272_665_088       # the reference's Model.param_count() at FULL
SFU_PER_S = 16 * 132 * 1.98e9    # exp: 16 special-function results a clock per SM, 132 SMs


def scan_inputs(shape, dtype, dev, seed):
    """The reference test's distributions: x, B, C ~ N(0, 1), dt = |N(0, 0.1)|,
    A = -|N(1, 0.3)| (f32)."""
    bsz, l, di, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(bsz, l, di, generator=g, device=dev)
    dt = (torch.randn(bsz, l, di, generator=g, device=dev) * 0.1).abs()
    bm = torch.randn(bsz, l, n, generator=g, device=dev)
    cm = torch.randn(bsz, l, n, generator=g, device=dev)
    a = -(1 + 0.3 * torch.randn(di, n, generator=g, device=dev)).abs()
    return [t.to(dtype) for t in (x, dt, bm, cm)] + [a]


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    return bool(((got.float() - want.float()).abs() <= tol + tol * want.float().abs()).all())


def phase_k5_vs_plain(dev):
    """Phase 8: K5 against selective_scan_plain on the card, y and the final
    state. Returns the worst f32 error of y at (1, 2048, 8192, 16)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    cases = bad = equal = 0
    async0 = selective_scan.async_launches
    worst_f32, worst_h, worst_ulps, worst_bf16, main_err = 0.0, 0.0, 0.0, 0.0, None
    for i, (shape, (chunk, block_d)) in enumerate(K5_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(shape, dtype, dev, seed=i)
            y, h = selective_scan(*args, chunk=chunk, block_d=block_d)
            wy, wh = selective_scan_plain(*args)
            dy = (y.float() - wy.float()).abs()
            worst_h = max(worst_h, float((h - wh).abs().max()))
            equal += int(torch.equal(y, wy) and torch.equal(h, wh))
            ok = within(h, wh, K5_TOL) and y.dtype == dtype and h.shape == wh.shape
            cases += 1
            if dtype == torch.float32:
                ok = ok and within(y, wy, K5_TOL)
                worst_f32 = max(worst_f32, float(dy.max()))
                if shape == (1, 2048, 8192, 16):
                    main_err = float(dy.max())
            else:
                # Each side rounds an f32 y once: one bf16 ulp, plus the f32
                # tolerance where the output's ulp is below it.
                ulp = bf16_ulp(wy)
                ok = ok and bool((dy <= ulp + K5_TOL).all())
                worst_ulps = max(worst_ulps, float((dy / ulp).max()))
                worst_bf16 = max(worst_bf16, float(dy.max()))
            if not (ok and bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())):
                bad += 1
                print(f"  MISMATCH K5 {shape} {dtype} blocks ({chunk}, {block_d}): max abs err "
                      f"y {float(dy.max())}, h {float((h - wh).abs().max())}")
    torch.cuda.synchronize()
    print(f"K5 vs plain: {cases} cases, {bad} outside tolerance, {equal} of them bit-equal "
          f"(y and the final state); worst f32 abs err of y "
          f"{worst_f32:.3g} (tolerance {K5_TOL} abs + rel); of the final state {worst_h:.3g}; "
          f"worst bf16 abs err {worst_bf16:.3g}, {worst_ulps:.3g} ulp of the output "
          f"(tolerance 1 ulp + {K5_TOL}); {selective_scan.async_launches - async0} of the "
          f"launches copied by cp.async")
    check(bad == 0, f"K5 differs from selective_scan_plain in {bad} of {cases} cases")
    return main_err


def ssm_prompts(vocab: int, n: int):
    """Phase 9's prompts: a context of a bucket's length (drawn by
    default_rng(0)), tokens uniform in the vocab, plus one last token."""
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(n):
        ctx = int(rng.choice(SSM_BUCKETS))
        prompts.append(rng.integers(0, vocab, ctx + 1).tolist())
    return prompts


def phase_ssm_server(dev):
    """Phase 9, the ssm slice's main path: the port's server refuses the
    reference server's prompts for falcon-mamba-7b, as the reference's does;
    then the Engine serves FULL falcon-mamba-7b (f32) on bucket-length
    prompts, counts set to 0 just before and read just after, and a replay
    on the plain lane on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    refusal = None
    try:
        serve.main(["--arch", SSM_ARCH, "--requests", str(SSM_REQUESTS), "--slots",
                    str(SSM_SLOTS), "--max-new", str(SSM_NEW)])
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and refusal.startswith("ssm engine needs bucket-length prompts; "
                                                     "got "),
          f"the port's server did not refuse the reference's prompts for {SSM_ARCH}: {refusal}")
    print(f"ssm server refuses the reference server's prompts: {refusal}")
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(SSM_ARCH).replace(dtype="float32")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"{cfg.name} FULL: {n_params:,} params drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f} GB "
          f"allocated")
    check(n_params == SSM_PARAMS, f"{cfg.name} has {n_params:,} params, not {SSM_PARAMS:,}")
    prompts = ssm_prompts(cfg.vocab_size, SSM_REQUESTS)
    eng = Engine(cfg, params, max_batch=SSM_SLOTS, max_len=256, prompt_buckets=SSM_BUCKETS)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=SSM_NEW))
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["k5"] == cfg.num_layers * SSM_REQUESTS,
          f"the ssm engine launched K5 {counts['k5']} times, not {cfg.num_layers} x "
          f"{SSM_REQUESTS}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k5"), f"the ssm engine launched {counts}")
    done = sorted(done, key=lambda r: r.uid)
    check(len(done) == SSM_REQUESTS and all(len(r.output) == SSM_NEW for r in done),
          "the ssm engine did not serve every request to its max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output), "token out of range")
    check([r.prompt for r in done] == prompts, "the engine's prompts are not the replay's")
    toks = sum(len(r.output) for r in done)
    stats = dict(tokens=toks, seconds=wall, tok_s=toks / wall, prefills=len(eng.prefill_ms),
                 decode_steps=len(eng.decode_ms),
                 prefill_p50_ms=statistics.median(eng.prefill_ms),
                 decode_p50_ms=statistics.median(eng.decode_ms), param_count=n_params)
    print(f"ssm engine {cfg.name}: {toks / wall:.1f} tok/s ({toks} tokens in {wall:.3f} s); "
          f"prefill p50 {stats['prefill_p50_ms']:.3f} ms ({stats['prefills']}, contexts of "
          f"{sorted(set(len(p) - 1 for p in prompts))} tokens); decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms ({stats['decode_steps']}); K5 launches "
          f"{counts['k5']}")

    # Every prompt's prefill on both lanes.
    worst = 0.0
    for prompt in prompts:
        tokens = torch.tensor([prompt[:-1]], dtype=torch.int32, device=dev)
        lane = {}
        for backend in ("auto", "torch"):
            cache = model.init_cache(1, 0, dtype=torch.float32, device=dev)
            lane[backend], _ = Model(cfg, backend=backend).prefill(params, {"tokens": tokens},
                                                                   cache)
        check(bool(torch.isfinite(lane["auto"]).all()), "non-finite prefill logits")
        worst = max(worst, float((lane["auto"] - lane["torch"]).abs().max()))
    check(worst <= LOGIT_TOL, f"ssm prefill logits differ by {worst} > {LOGIT_TOL}")

    eng = Engine(cfg, params, max_batch=SSM_SLOTS, max_len=256, prompt_buckets=SSM_BUCKETS,
                 backend="torch")
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=SSM_NEW))
    before = read_counts()["k5"]
    plain = {r.uid: r.output for r in eng.run()}
    check(read_counts()["k5"] == before, "the plain replay launched K5")
    ties = 0
    for r in done:
        want = plain[r.uid]
        if r.output == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(r.output, want)) if a != b)
        gap, below = top2_gap(replay_logits(cfg, params, r.prompt, r.output, step, "torch", dev),
                              r.output[step])
        check(gap < LOGIT_TOL and below < LOGIT_TOL,
              f"request {r.uid} step {step}: token {r.output[step]} (plain {want[step]}) with "
              f"the plain lane's top-2 gap {gap} and the token {below} below its top")
        ties += 1
    print(f"  plain-lane replay on the card: prefill logits within {worst:.3g} (tolerance "
          f"{LOGIT_TOL}); tokens equal in {SSM_REQUESTS - ties} of {SSM_REQUESTS} requests, "
          f"{ties} near ties (top-2 gap < {LOGIT_TOL})")

    # Where a prefill and a decode step go: four prompts admitted into a
    # fresh engine (four prefills), then one decode step of its four slots.
    eng = Engine(cfg, params, max_batch=SSM_SLOTS, max_len=256, prompt_buckets=SSM_BUCKETS)
    for uid, prompt in enumerate(prompts[:SSM_SLOTS]):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=SSM_NEW))
    _, _, k5_us = device_profile("four ssm engine prefills (K5 lane)", eng._admit, top=8,
                                 kernel="selective_scan_kernel")
    eng._decode_once()
    device_profile("one ssm engine decode step, 4 slots", eng._decode_once, top=8)
    return dict(stats, k5=counts["k5"], logit_err=worst, near_ties=ties, k5_profile_us=k5_us,
                params=params)


def phase_ssm_long_prefill(dev, params):
    """Phase 9b: Model.prefill at FULL falcon-mamba-7b on one prompt of
    2,048 tokens and one of 1,000, K5 lane against the plain lane: logits,
    and the cache's state and conv tail. Then 9c, the bf16 scan elements
    (``ssm_scan_dtype="bfloat16"``): the 2,048-token prefill once more on
    the K5 lane (K5's bf16 mode once a layer, counts set to 0 just before)
    beside the f32 one, and a 128-token prefill on both lanes, held within
    ``LOGIT_TOL`` (cache within ``STATE_TOL``). Returns the K5 launches of
    9b and of 9c's K5 lane."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.ssm import _pick_chunk

    cfg = get_config(SSM_ARCH).replace(dtype="float32")
    rng = np.random.default_rng(7)
    launches = 0
    for n in (2048, 1000):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
        lane, caches, secs = {}, {}, {}
        for backend in ("auto", "torch"):
            cache = Model(cfg).init_cache(1, 0, dtype=torch.float32, device=dev)
            reset_counts()
            t0 = time.perf_counter()
            lane[backend], caches[backend] = Model(cfg, backend=backend).prefill(
                params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            secs[backend] = time.perf_counter() - t0
            k5 = read_counts()["k5"]
            check(k5 == (cfg.num_layers if backend == "auto" else 0),
                  f"prefill of {n} tokens ({backend}) launched K5 {k5} times")
            launches += k5
        if n == 2048:
            f32_logits = lane["auto"]
        err = float((lane["auto"] - lane["torch"]).abs().max())
        check(bool(torch.isfinite(lane["auto"]).all()), f"non-finite logits at {n} tokens")
        check(err <= LOGIT_TOL, f"prefill of {n} tokens: logits differ by {err} > {LOGIT_TOL}")
        state_err = {}
        for name in ("h", "conv"):
            got, want = caches["auto"]["layers"][name], caches["torch"]["layers"][name]
            state_err[name] = float((got - want).abs().max())
            check(within(got, want, STATE_TOL),
                  f"prefill of {n} tokens: cache {name} differs by {state_err[name]} (tolerance "
                  f"{STATE_TOL} abs + rel)")
        print(f"ssm long prefill {n} tokens (chunk {_pick_chunk(n, cfg.ssm_chunk)}), all "
              f"{cfg.num_layers} layers: K5 lane within {err:.3g} of the plain lane (tolerance "
              f"{LOGIT_TOL}); cache h within {state_err['h']:.3g}, conv within "
              f"{state_err['conv']:.3g} (tolerance {STATE_TOL} abs + rel); K5 launches "
              f"{cfg.num_layers}; K5 lane {secs['auto']:.2f} s, plain lane {secs['torch']:.2f} s")
    return launches, ssm_bf16_prefill(dev, params, cfg, f32_logits)


def ssm_bf16_prefill(dev, params, cfg, f32_logits) -> int:
    """Phase 9c (see :func:`phase_ssm_long_prefill`). Returns the K5
    launches of the 2,048-token K5-lane prefill."""
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import Model

    cfg = cfg.replace(ssm_scan_dtype="bfloat16")
    rng = np.random.default_rng(7)               # 9b's first prompt
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2048)).astype(np.int32)).to(dev)
    cache = Model(cfg).init_cache(1, 0, dtype=torch.float32, device=dev)
    reset_counts()
    bf16_before = selective_scan.bf16_launches
    t0 = time.perf_counter()
    logits, _ = Model(cfg).prefill(params, {"tokens": tokens}, cache)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k5, k5_bf16 = read_counts()["k5"], selective_scan.bf16_launches - bf16_before
    check(k5 == k5_bf16 == cfg.num_layers,
          f"the bf16-element prefill launched K5 {k5} times, {k5_bf16} in the bf16 mode")
    check(bool(torch.isfinite(logits).all()), "non-finite logits of the bf16-element prefill")
    from_f32 = float((logits - f32_logits).abs().max())
    short = tokens[:, :128]
    lane, caches = {}, {}
    for backend in ("auto", "torch"):
        c = Model(cfg).init_cache(1, 0, dtype=torch.float32, device=dev)
        lane[backend], caches[backend] = Model(cfg, backend=backend).prefill(
            params, {"tokens": short}, c)
    err = float((lane["auto"] - lane["torch"]).abs().max())
    equal = torch.equal(lane["auto"], lane["torch"])
    check(err <= LOGIT_TOL, f"bf16-element prefill of 128 tokens: lanes differ by {err}")
    for name in ("h", "conv"):
        check(within(caches["auto"]["layers"][name], caches["torch"]["layers"][name], STATE_TOL),
              f"bf16-element prefill of 128 tokens: cache {name} differs between the lanes")
    print(f"phase 9c: {cfg.name} FULL prefill of 2048 tokens on bf16 scan elements (chunk "
          f"{cfg.ssm_chunk}): K5 {k5} launches, all in the bf16 mode, {secs:.2f} s; logits "
          f"{from_f32:.3g} from the f32-element prefill's; 128 tokens on both lanes: logits "
          f"{'bit-equal' if equal else f'within {err:.3g}'} (tolerance {LOGIT_TOL})")
    return k5


def launch_device_us(fn, kernel: str, launches: int = 50) -> float:
    """Mean device microseconds a launch of the kernels whose name contains
    ``kernel``, over ``launches`` calls of ``fn`` under the profiler (no
    host time between launches counts), averaged over the launches the
    profiler kept (it may drop some of a long run of short kernels). On
    the H100 a short window can come back with none of its device records
    (seen at 50 launches of a 3 us kernel); such a window is run again with
    ten times the launches, twice at most, and says so."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in evs)
        if count or attempt == 2:
            break
        print(f"  the profiler kept none of {launches} {kernel} launches; again with "
              f"{10 * launches}")
        launches *= 10
    check(0 < count <= launches, f"the profiler saw {count} {kernel} launches of {launches}")
    return sum(e.self_device_time_total for e in evs) / count


def scan_bound(shape, elt: int):
    """K5's least time: x, dt and y (``elt`` bytes), B and C (``elt``), A
    and the final state (f32) moved once at 3.35 TB/s; about 6 f32
    operations a (t, d, n) (dt*A, h*da, dt*x, *B, +, h*C) at 33.5 T/s; one
    exp a (t, d, n) on the SFUs at 16 a clock per SM (4.18 T/s)."""
    bsz, l, di, n = shape
    elems = bsz * l * di * n
    t_bytes = ((3 * bsz * l * di + 2 * bsz * l * n) * elt + (di * n + bsz * di * n) * 4
               ) / HBM_BYTES_PER_S
    t_ops = 6 * elems / F32_OPS_PER_S
    t_sfu = elems / SFU_PER_S
    worst = max(t_bytes, t_ops, t_sfu)
    return (worst * 1e3, "bytes" if worst == t_bytes else "operations", t_bytes * 1e3,
            t_ops * 1e3, t_sfu * 1e3)


def k5_bf16_timing(dev, f32_row: dict) -> dict:
    """K5's bf16-element mode at (1, 2048, 8192, 16), chunks of 16 steps:
    CUDA-event medians in turns with the f32 mode (f32, bf16, bf16, f32),
    device us a launch under the profiler, the plain version's bf16 mode
    (3 runs: its 2,048-step Python loop), and ``scan_bound`` (the same
    work: the elements never leave registers)."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    shape = K5_BF16_TIMING_SHAPE
    l, di = shape[1], shape[2]
    args = scan_inputs(shape, torch.float32, dev, seed=l)
    kw = dict(chunk=K5_BF16_CHUNK, block_d=di, scan_dtype="bfloat16")
    bf = lambda: selective_scan(*args, **kw)                  # noqa: E731
    f32 = lambda: selective_scan(*args, chunk=l, block_d=di)  # noqa: E731
    f1, b1, b2, f2 = median_ms(f32), median_ms(bf), median_ms(bf), median_ms(f32)
    y, h = bf()
    wy, wh = selective_scan_plain(*args, scan_dtype="bfloat16", chunk=K5_BF16_CHUNK)
    equal = torch.equal(y, wy) and torch.equal(h, wh)
    check(equal, f"K5's bf16 elements at {shape} differ from the plain version's")
    plain_ms = median_ms(lambda: selective_scan_plain(*args, scan_dtype="bfloat16",
                                                      chunk=K5_BF16_CHUNK), reps=3, warm=1)
    b_ms, b_by = f32_row["bound_ms"], f32_row["bound_by"]
    row = dict(ms=statistics.median([b1, b2]), ms_runs=[b1, b2], f32_ms_runs=[f1, f2],
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bit_equal=equal,
               chunk=K5_BF16_CHUNK, device_us=launch_device_us(bf, "selective_scan"),
               max_abs_err=float((y.float() - wy.float()).abs().max()))
    print(f"K5 at {shape} on bf16 elements (chunk {K5_BF16_CHUNK}): {b1:.4f} / {b2:.4f} ms in "
          f"turns with the f32 mode's {f1:.4f} / {f2:.4f} ms; {row['device_us']:.2f} us a launch "
          f"of device time; plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms by {b_by}; y and the "
          f"final state bit-equal to the plain version's")
    return row


def phase_k5_timing(dev, ssm, long_launches, main_err, training, bf16_launches):
    """Phase 5 (K5): CUDA-event medians of K5 and its plain version, f32, at
    (1, 2048, 8192, 16), the ssm server's prefill shapes and phase 18's
    training shard (4, 128, 4096, 16), and the bf16-element mode
    (:func:`k5_bf16_timing`; ``bf16_launches``: phase 9c's). No PyTorch call
    computes a selective scan: no library yardstick. ``training`` holds
    phase 18's falcon-mamba-7b mesh training numbers by path."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain

    rows = {}
    for shape in [(1, l, 8192, 16) for l in (2048, 8, 16, 32, 64)] + [(4, 128, 4096, 16)]:
        l, di = shape[1], shape[2]
        args = scan_inputs(shape, torch.float32, dev, seed=l)
        y, _ = selective_scan(*args, chunk=l, block_d=di)
        wy, _ = selective_scan_plain(*args)
        b_ms, b_by, t_bytes, t_ops, t_sfu = scan_bound(shape, 4)
        row = dict(ms=median_ms(lambda: selective_scan(*args, chunk=l, block_d=di)),
                   plain_ms=median_ms(lambda: selective_scan_plain(*args)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes,
                   ops_ms=t_ops, sfu_ms=t_sfu, max_abs_err=float((y - wy).abs().max()),
                   shape=list(shape))
        row["device_us"] = launch_device_us(
            lambda: selective_scan(*args, chunk=l, block_d=di), "selective_scan")
        rows["x".join(map(str, shape))] = row
        print(f"K5 at {shape} f32: {row['ms']:.4f} ms on CUDA events, "
              f"{row['device_us']:.2f} us a launch of device time (profiler, 50 launches); plain "
              f"{row['plain_ms']:.4f} ms; bound {b_ms:.4f} ms by {b_by} (bytes {t_bytes:.4f} ms, "
              f"f32 ops {t_ops:.4f} ms, SFU exp {t_sfu:.4f} ms); no library call")
    main = rows["1x2048x8192x16"]
    bf16 = k5_bf16_timing(dev, main)
    bf16["launches"] = bf16_launches
    by_path = {"falcon-mamba-7b engine": ssm["k5"],
               "falcon-mamba-7b bf16-element prefill": bf16_launches,
               **{name: st["launches"] for name, st in training.items()}}
    return {
        "name": "K5 selective_scan (Mamba-1 forward scan)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:39",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": main_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "shapes": rows,
        "launches_long_prefill": long_launches,
        "bf16_elements": bf16,
        "server": {k: ssm[k] for k in ("tok_s", "prefill_p50_ms", "decode_p50_ms", "tokens",
                                       "prefills", "decode_steps", "param_count", "logit_err",
                                       "near_ties", "k5_profile_us")},
        **training,
    }


# --- The moe family and MLA on K4 (phases 11-12) -------------------------------

MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 24    # of 48: the whole is 122.1 GB in f32
PHI_ARCH, PHI_LAYERS = "phi3.5-moe-42b-a6.6b", 8  # of 32: the whole is 167.5 GB in f32
MLA_ARCH = "minicpm3-4b"                          # whole: 17.0 GB in f32
# Model.param_count() at those depths, as the reference counts them.
CUT_PARAMS = {MOE_ARCH: 15_577_227_264, PHI_ARCH: 10_665_205_760, MLA_ARCH: 4_261_902_848}
MLA_ARGS = ["--arch", MLA_ARCH, "--requests", "16", "--slots", "4", "--max-new", "16"]


def draw(arch: str, layers: int, dev):
    """FULL-width ``arch`` at ``layers`` layers (``None``: its whole depth)
    in f32, its weights drawn on the card from seed 0. Returns (cfg,
    params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    full = get_config(arch)
    cfg = full.replace(num_layers=layers or full.num_layers, dtype="float32")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count()
    want = CUT_PARAMS[arch] if layers else FULL_PARAMS[arch]
    print(f"{cfg.name} FULL width, {cfg.num_layers} of {full.num_layers} layers: "
          f"{n_params:,} params ({4 * n_params / 1e9:.1f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f} GB "
          f"allocated")
    check(n_params == want, f"{cfg.name} has {n_params:,} params, not {want:,}")
    return cfg, params


def free_weights():
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_server(dev):
    """Phase 11, the moe slice's main path: ``Engine`` on qwen3-moe-30b-a3b
    at FULL width and 24 of its 48 layers, f32, 4 slots, the reference
    server's 16 prompts (buckets 8-64, 16 new tokens), counts set to 0 just
    before and read just after: K4 must launch 24 layers x 16 prefills =
    384 times and nothing else may launch. Then ``lane_replay`` on the same
    weights and the profiled decode step."""
    from repro_torch.launch.serve import LM_BUCKETS
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = draw(MOE_ARCH, MOE_LAYERS, dev)
    prompts = replay_prompts(cfg.vocab_size, LM_REQUESTS)
    eng = Engine(cfg, params, max_batch=LM_SLOTS, max_len=256, prompt_buckets=LM_BUCKETS)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=LM_NEW))
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["k4"] == cfg.num_layers * LM_REQUESTS,
          f"the moe engine launched K4 {counts['k4']} times, not {cfg.num_layers} x "
          f"{LM_REQUESTS}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"), f"the moe engine launched {counts}")
    done = sorted(done, key=lambda r: r.uid)
    check(len(done) == LM_REQUESTS and all(len(r.output) == LM_NEW for r in done),
          "the moe engine did not serve every request to its max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output), "token out of range")
    check([r.prompt for r in done] == prompts, "the engine's prompts are not the replay's")
    toks = sum(len(r.output) for r in done)
    stats = dict(tokens=toks, seconds=wall, tok_s=toks / wall, prefills=len(eng.prefill_ms),
                 decode_steps=len(eng.decode_ms),
                 prefill_p50_ms=statistics.median(eng.prefill_ms),
                 decode_p50_ms=statistics.median(eng.decode_ms),
                 param_count=CUT_PARAMS[MOE_ARCH], k4=counts["k4"])
    print(f"moe engine {cfg.name} ({cfg.num_layers} layers): {stats['tok_s']:.1f} tok/s ({toks} "
          f"tokens in {wall:.3f} s); prefill p50 {stats['prefill_p50_ms']:.3f} ms "
          f"({stats['prefills']}); decode step p50 {stats['decode_p50_ms']:.3f} ms "
          f"({stats['decode_steps']}); K4 launches {counts['k4']}")
    del eng
    stats.update(lane_replay(cfg, params, done, dev))
    stats.update(profile_engine(cfg, params, prompts, cfg.name))
    return stats, cfg, params


def phase_moe_long_prefill(dev, cfg, params):
    """Phase 11b: ``long_prefill`` on phase 11's qwen3-moe weights (one
    routing group of 2,048 and of 1,000 tokens)."""
    return long_prefill(cfg, params, dev)


def phase_phi_prefill(dev):
    """Phase 11c: ``long_prefill`` at FULL phi3.5-moe-42b-a6.6b width and 8
    of its 32 layers (top-2 of 16 experts, layernorm)."""
    cfg, params = draw(PHI_ARCH, PHI_LAYERS, dev)
    return long_prefill(cfg, params, dev)


def phase_mla_server(dev):
    """Phase 12, the MLA slice's main path: the LM server with ``--arch
    minicpm3-4b`` at FULL width and depth, f32, counts set to 0 just before
    and read just after: K4 must launch 62 layers x 16 prefills = 992 times
    (q and k of 96 dims, v zero-padded from 64) and nothing else may
    launch. Then ``lane_replay``, the profiled decode step and
    ``long_prefill`` on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    stats = serve.main(MLA_ARGS)
    counts = read_counts()
    cfg = get_config(MLA_ARCH).replace(dtype="float32")
    params = stats.pop("params")
    check(stats["param_count"] == CUT_PARAMS[MLA_ARCH], f"{cfg.name} has "
                                                        f"{stats['param_count']:,} params")
    check(counts["k4"] == cfg.num_layers * LM_REQUESTS and stats["k4_launches"] == counts["k4"],
          f"the MLA server launched K4 {counts['k4']} times, not {cfg.num_layers} x "
          f"{LM_REQUESTS}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"), f"the MLA server launched {counts}")
    done = sorted(stats.pop("requests"), key=lambda r: r.uid)
    check(len(done) == LM_REQUESTS and all(len(r.output) == LM_NEW for r in done),
          "the MLA server did not serve every request to --max-new")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output), "token out of range")
    prompts = replay_prompts(cfg.vocab_size, LM_REQUESTS)
    check([r.prompt for r in done] == prompts, "the server's prompts are not the replay's")
    print(f"MLA server {cfg.name}: {stats['param_count']:,} params; {stats['tok_s']:.1f} tok/s "
          f"({stats['tokens']} tokens in {stats['seconds']:.3f} s); prefill p50 "
          f"{stats['prefill_p50_ms']:.3f} ms ({stats['prefills']}); decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms ({stats['decode_steps']}); K4 launches {counts['k4']}")
    stats.update(lane_replay(cfg, params, done, dev), k4=counts["k4"])
    stats.update(profile_engine(cfg, params, prompts, cfg.name))
    stats["long_launches"] = long_prefill(cfg, params, dev)
    return stats


# --- The hybrid, encdec and vlm families on K4 (phases 13-15) -----------------

HYBRID_ARCH = "zamba2-2.7b"          # 9.7 GB in f32, whole
ENCDEC_ARCH = "whisper-large-v3"     # 6.4 GB in f32, whole
VLM_ARCH = "pixtral-12b"             # 49.0 GB in f32, whole
# Model.param_count() at FULL width and depth, as the reference counts them.
FULL_PARAMS = {HYBRID_ARCH: 2_422_670_240, ENCDEC_ARCH: 1_601_198_080,
               VLM_ARCH: 12_247_782_400}
FRONTEND_BATCH = 4                   # prompts in one Model.prefill (whisper, pixtral)
FRONTEND_TEXT = 32                   # decoder / text tokens of each prompt
FRONTEND_PREFILLS = 3                # K4-lane prefills timed (their p50 is printed)


def phase_hybrid_server(dev):
    """Phase 13, zamba2-2.7b at FULL width and depth, f32: the ``Engine``
    at 4 slots on 16 bucket-length prompts (``ssm_prompts``), 16 new tokens
    each, counts set to 0 just before and read just after: K4 must launch
    9 shared-block applications x 16 prefills = 144 times and nothing else
    may launch. Then ``lane_replay``, ``profile_engine`` and
    ``long_prefill`` (9 K4 launches a prompt) on the same weights."""
    from repro_torch.serve import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = draw(HYBRID_ARCH, None, dev)
    prompts = ssm_prompts(cfg.vocab_size, LM_REQUESTS)
    eng = Engine(cfg, params, max_batch=LM_SLOTS, max_len=256, prompt_buckets=SSM_BUCKETS)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=LM_NEW))
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = k4_per_prefill(cfg) * LM_REQUESTS
    check(counts["k4"] == want, f"the hybrid engine launched K4 {counts['k4']} times, not "
                                f"{k4_per_prefill(cfg)} x {LM_REQUESTS} = {want}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"),
          f"the hybrid engine launched {counts}")
    done = sorted(done, key=lambda r: r.uid)
    check(len(done) == LM_REQUESTS and all(len(r.output) == LM_NEW for r in done),
          "the hybrid engine did not serve every request to its max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output), "token out of range")
    check([r.prompt for r in done] == prompts, "the engine's prompts are not the replay's")
    toks = sum(len(r.output) for r in done)
    stats = dict(tokens=toks, seconds=wall, tok_s=toks / wall, prefills=len(eng.prefill_ms),
                 decode_steps=len(eng.decode_ms),
                 prefill_p50_ms=statistics.median(eng.prefill_ms),
                 decode_p50_ms=statistics.median(eng.decode_ms),
                 param_count=FULL_PARAMS[HYBRID_ARCH], k4=counts["k4"])
    print(f"hybrid engine {cfg.name}: {stats['tok_s']:.1f} tok/s ({toks} tokens in {wall:.3f} s); "
          f"prefill p50 {stats['prefill_p50_ms']:.3f} ms ({stats['prefills']}, contexts of "
          f"{sorted(set(len(p) - 1 for p in prompts))} tokens); decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms ({stats['decode_steps']}); K4 launches "
          f"{counts['k4']}")
    del eng
    stats.update(lane_replay(cfg, params, done, dev))
    stats.update(profile_engine(cfg, params, prompts, cfg.name))
    stats["long_launches"] = long_prefill(cfg, params, dev)
    return stats


def frontend_batch(cfg, dev) -> dict:
    """``data.synthetic.lm_batch`` (seed 0) of ``FRONTEND_BATCH`` prompts on
    the card: whisper's whole 30 s window of 1,500 frames (``enc_embeds``,
    drawn at seq_len = encoder_len) with the first ``FRONTEND_TEXT`` tokens
    of its stream as the decoder prompt; pixtral's 1,024 patches
    (``patch_embeds``) before ``FRONTEND_TEXT`` text tokens."""
    from repro_torch.data.synthetic import lm_batch

    if cfg.family == "encdec":
        b = lm_batch(cfg, FRONTEND_BATCH, cfg.encoder_len, seed=0)
        b = {"tokens": b["tokens"][:, :FRONTEND_TEXT], "enc_embeds": b["enc_embeds"]}
    else:
        b = lm_batch(cfg, FRONTEND_BATCH, cfg.num_patches + FRONTEND_TEXT, seed=0)
        b = {"tokens": b["tokens"], "patch_embeds": b["patch_embeds"]}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}


def ulp_batch(batch: dict) -> dict:
    """``batch`` with its frontend embeddings (``enc_embeds``,
    ``patch_embeds``) moved by one ulp (x (1 + 2^-23)), for the control
    lane beside ``ulp_params``."""
    return {k: v * (1 + 2.0 ** -23) if k.endswith("_embeds") else v for k, v in batch.items()}


def frontend_layer_local(cfg, params, batch) -> dict:
    """An encdec or vlm model's two lanes block by block, each block run on
    both lanes from the plain lane's hidden state (as ``layer_local`` does
    for a moe model): every self-attention output (the encoder's
    non-causal) and every cross-attention output (from the plain lane's
    encoder output and state) of the K4 lane within ``ATTN_TOL`` of the
    plain lane's, relative to its largest value, and the last layer's
    logits (final norm and head on each lane's last block, last position)
    within ``LOGIT_TOL``. Returns the worst of each."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import apply_attention, apply_cross_attention, cross_kv
    from repro_torch.models.layers import apply_norm, torch_dtype

    dtype = torch_dtype(cfg.dtype)
    out = dict(attn_err=0.0, cross_err=0.0, logit_err=0.0)
    lanes = ("auto", "torch")

    def self_attention(lp, x, pos, causal):
        xn = apply_norm(lp["ln1"], cfg, x)
        h = {bk: apply_attention(lp["attn"], cfg, xn, pos, causal=causal, backend=bk)[0]
             for bk in lanes}
        out["attn_err"] = max(out["attn_err"], max_rel(h["auto"], h["torch"]))
        return h["torch"]

    enc_out = None
    if cfg.family == "encdec":
        x0 = batch["enc_embeds"].to(dtype)
        b, t = x0.shape[0], x0.shape[1]
        pos = torch.arange(t, dtype=torch.int32, device=x0.device)[None].expand(b, t)
        x = x0 + T._sinusoid(pos, cfg.d_model).to(dtype)
        for i in range(cfg.encoder_layers):
            lp = T._layer(params["encoder"]["layers"], i)
            self_attention(lp, x, pos, False)
            x, _, _ = T._apply_attn_block(lp, cfg, x, pos, causal=False, backend="torch")
        enc_out = apply_norm(params["encoder"]["final_norm"], cfg, x)
    x, positions = T._prepare_inputs(params, cfg, batch, dtype)
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        h = self_attention(lp, x, positions, True)
        enc_kv = None
        if enc_out is not None:
            enc_kv = cross_kv(lp["cross"], cfg, enc_out)
            xc = apply_norm(lp["ln_x"], cfg, x + h)
            c = {bk: apply_cross_attention(lp["cross"], cfg, xc, *enc_kv, backend=bk)
                 for bk in lanes}
            out["cross_err"] = max(out["cross_err"], max_rel(c["auto"], c["torch"]))
        y = {bk: T._apply_attn_block(lp, cfg, x, positions, causal=True, enc_kv=enc_kv,
                                     backend=bk)[0] for bk in lanes}
        x = y["torch"]
    logits = {bk: T.unembed(params, cfg, apply_norm(params["final_norm"], cfg, y[bk][:, -1:]))
              for bk in lanes}
    out["logit_err"] = float((logits["auto"] - logits["torch"]).abs().max())
    check(out["attn_err"] <= ATTN_TOL and out["cross_err"] <= ATTN_TOL,
          f"{cfg.name}: K4's attention differs from the plain lane's by {out['attn_err']:.3g} "
          f"(cross {out['cross_err']:.3g}) of its largest value > {ATTN_TOL}")
    check(out["logit_err"] <= LOGIT_TOL,
          f"{cfg.name}: the last layer's logits differ by {out['logit_err']} > {LOGIT_TOL}")
    return out


def frontend_serve(arch: str, dev) -> dict:
    """Phases 14 (whisper-large-v3) and 15 (pixtral-12b), FULL width and
    depth in f32, weights drawn on the card from seed 0: ``Model.prefill``
    of ``frontend_batch``'s 4 prompts, then ``LM_NEW`` greedy
    ``decode_step``s (the reference's servers refuse these families, so
    the model is driven as tests/test_decode_consistency.py drives it).
    The K4 lane prefills ``FRONTEND_PREFILLS`` times, counts set to 0 just
    before each and read just after: ``k4_per_prefill`` launches each
    (whisper 32 encoder + 32 decoder self + 32 cross = 96; pixtral 40), and
    none during the decode. Then the plain lane on the same weights, and
    the control: the plain lane with the token embeddings and the
    frontend embeddings moved by one ulp (``ulp_params``, ``ulp_batch``),
    teacher-forced on the plain lane's tokens, which shows how far the
    model's own rounding carries a last-bit difference at each step. Held:
    the blocks layer by layer (``frontend_layer_local``: attention within
    ``ATTN_TOL``, last-layer logits within ``LOGIT_TOL``); and, where the
    control stays within ``LOGIT_TOL`` at every step, end to end: the
    free-running prefill logits, and the decode logits while both lanes'
    tokens agree, within ``LOGIT_TOL``, greedy tokens equal except where
    the plain lane's top-2 gap is below it (the ties are counted). Where
    the control parts past it (at random weights: the stacked specs'
    ``fan_in`` init divides by the layer count, so the attention scores are
    sharp and a last-bit difference grows from layer to layer;
    ``tools/encdec_lane_divergence.py`` prints it), the free-running
    numbers are printed beside the control's. Then one prefill and one
    decode step under the profiler. Frees the weights."""
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = draw(arch, None, dev)
    batch = frontend_batch(cfg, dev)
    b, s = batch["tokens"].shape
    off = cfg.num_patches if cfg.family == "vlm" else 0
    length = off + s + LM_NEW + 1
    lanes = {}
    for lane in ("auto", "torch", "control"):
        backend = "auto" if lane == "auto" else "torch"
        w, bt = (ulp_params(params), ulp_batch(batch)) if lane == "control" else (params, batch)
        model = Model(cfg, backend=backend)
        pre_ms = []
        for _ in range(FRONTEND_PREFILLS if lane == "auto" else 1):
            cache = model.init_cache(b, length, dtype=torch.float32, device=dev)
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = model.prefill(w, bt, cache)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            check(counts["k4"] == (k4_per_prefill(cfg) if lane == "auto" else 0)
                  and all(counts[k] == 0 for k in COUNTS if k != "k4"),
                  f"{cfg.name} prefill ({lane}) launched {counts}")
        check(bool(torch.isfinite(logits).all()) and logits.shape == (b, 1, cfg.vocab_size),
              f"{cfg.name} prefill logits: shape {tuple(logits.shape)} or not finite")
        tok = logits[:, -1].argmax(-1)
        toks, step_logits, dec_ms = [tok], [logits[:, -1]], []
        reset_counts()
        for i in range(LM_NEW):
            if lane == "control":       # teacher-forced on the plain lane's tokens
                tok = lanes["torch"]["toks"][:, i].to(dev)
            t0 = time.perf_counter()
            step, cache = model.decode_step(w, cache, tok[:, None], off + s + i)
            tok = step[:, -1].argmax(-1)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok)
            step_logits.append(step[:, -1])
        counts = read_counts()
        check(all(v == 0 for v in counts.values()), f"{cfg.name} decode launched {counts}")
        lanes[lane] = dict(pre_ms=pre_ms, dec_ms=dec_ms, toks=torch.stack(toks, 1).cpu(),
                           logits=torch.stack(step_logits, 1))
        del cache, w, bt
    k4, plain, ctrl = lanes["auto"], lanes["torch"], lanes["control"]
    noise = (ctrl["logits"] - plain["logits"]).abs().amax(-1)         # (b, steps)
    diff = (k4["logits"] - plain["logits"]).abs().amax(-1)
    # Where a last-bit change of the inputs moves the logits past LOGIT_TOL,
    # the model's own rounding decides the free-running logits and tokens,
    # and only the layer-by-layer comparison can hold the kernel.
    end_to_end = float(noise.max()) <= LOGIT_TOL
    parted, dec_err, dec_noise = [], 0.0, float(noise[:, 1:].max())
    for row in range(b):
        got, want = k4["toks"][row].tolist(), plain["toks"][row].tolist()
        agree = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), len(got))
        # step j's logits were computed on the same history as long as j <= agree
        for j in range(min(agree + 1, len(got))):
            check(not end_to_end or float(diff[row, j]) <= LOGIT_TOL,
                  f"{cfg.name} prompt {row} step {j}: logits differ by {float(diff[row, j])} > "
                  f"{LOGIT_TOL}")
            if j:
                dec_err = max(dec_err, float(diff[row, j]))
        if agree < len(got):
            gap, below = top2_gap(plain["logits"][row, agree], got[agree])
            check(not end_to_end or (gap < LOGIT_TOL and below < LOGIT_TOL),
                  f"{cfg.name} prompt {row} token {agree}: {got[agree]} (plain {want[agree]}) "
                  f"with the plain lane's top-2 gap {gap} and the token {below} below its top")
            parted.append(agree)
    ties = len(parted) if end_to_end else 0          # near ties, held above
    pre_err, pre_noise = float(diff[:, 0].max()), float(noise[:, 0].max())
    local = frontend_layer_local(cfg, params, batch)
    n_tok = b * (LM_NEW + 1)
    wall_ms = k4["pre_ms"][-1] + sum(k4["dec_ms"])
    stats = dict(tokens=n_tok, seconds=wall_ms / 1e3, tok_s=n_tok / (wall_ms / 1e3),
                 prefills=len(k4["pre_ms"]), decode_steps=len(k4["dec_ms"]),
                 prefill_p50_ms=statistics.median(k4["pre_ms"]),
                 decode_p50_ms=statistics.median(k4["dec_ms"]),
                 plain_prefill_ms=plain["pre_ms"][0], param_count=FULL_PARAMS[arch],
                 k4=k4_per_prefill(cfg) * len(k4["pre_ms"]), logit_err=local["logit_err"],
                 attn_err=local["attn_err"], cross_err=local["cross_err"],
                 free_logit_err=pre_err, control_logit_err=pre_noise,
                 decode_logit_err=dec_err, decode_control_err=dec_noise, near_ties=ties,
                 parted_at=parted, end_to_end=end_to_end)
    shape = (f"{b} x ({cfg.num_patches} patches + {s} tokens)" if off else
             f"{b} x {s} tokens over {batch['enc_embeds'].shape[1]} frames")
    print(f"{cfg.name} ({cfg.family}): prefill of {shape}: p50 {stats['prefill_p50_ms']:.3f} "
          f"ms ({stats['prefills']}: {', '.join(f'{t:.1f}' for t in k4['pre_ms'])}; plain "
          f"lane {stats['plain_prefill_ms']:.1f} ms); decode step p50 "
          f"{stats['decode_p50_ms']:.3f} ms ({stats['decode_steps']}); {stats['tok_s']:.1f} "
          f"tok/s ({n_tok} greedy tokens in {wall_ms / 1e3:.3f} s); K4 launches "
          f"{k4_per_prefill(cfg)} a prefill, 0 in the decode")
    print(f"  layer by layer (each block on both lanes from the plain lane's input): "
          f"attention within {local['attn_err']:.3g} of its largest value, cross-attention "
          f"within {local['cross_err']:.3g} (tolerance {ATTN_TOL}); last-layer logits within "
          f"{local['logit_err']:.3g} (tolerance {LOGIT_TOL})")
    if end_to_end:
        held = (f"held end to end: tokens equal in {b - ties} of {b} prompts, {ties} near "
                f"ties (top-2 gap < {LOGIT_TOL})")
    else:
        held = (f"not held end to end (the one-ulp control parts past {LOGIT_TOL}): the "
                f"lanes' tokens part in {len(parted)} of {b} prompts, at steps {parted}")
    print(f"  free-running on the card: prefill logits within {pre_err:.3g}, decode logits "
          f"within {dec_err:.3g} while the tokens agree; the one-ulp control (plain lane, "
          f"teacher-forced) within {pre_noise:.3g} and {dec_noise:.3g}; {held}")
    del lanes
    model = Model(cfg)
    cache = model.init_cache(b, length, dtype=torch.float32, device=dev)
    busy_p, _, k4_us = device_profile(f"one prefill (K4 lane), {cfg.name}",
                                      lambda: model.prefill(params, batch, cache), top=8,
                                      kernel="flash_kernel")
    tok = batch["tokens"][:, -1:]
    busy, span, _ = device_profile(f"one decode step, {b} prompts, {cfg.name}",
                                   lambda: model.decode_step(params, cache, tok, off + s), top=8)
    stats.update(k4_profile_us=k4_us, k4_share=k4_us / busy_p, decode_idle=1 - busy / span,
                 decode_busy_us=busy)
    del params, cache
    free_weights()
    return stats


def phase_timing(full, dev, motion_mask, server_launches, edges_launches, k3_launches,
                 full_inputs, main_counts, tuned):
    """Phase 5: K1, K1 out_nms, K2 (each fitting depth), the integer lane
    of K1 and K2, and K3 beside their plain versions and bounds."""
    from repro_torch.configs import get_config
    from repro_torch.core.filters import get_operator
    from repro_torch.kernels.edge import (edge_cuda, edge_plain, edge_stream_cuda,
                                          edge_stream_plain, tma_route)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec5 = get_operator("sobel5")
    bank = torch.from_numpy(spec5.bank(4)).to(dev)[:, None]

    def conv_components(x, rgb):
        gray = (x.float() if not rgb else
                (x[..., 0].float() * 0.299 + x[..., 1].float() * 0.587) + x[..., 2].float() * 0.114)
        xp = F.pad(gray[:, None], (2, 2, 2, 2), mode="reflect")
        return F.conv2d(xp, bank)

    timings = {}
    for label, (x, kw, err) in full.items():
        rgb = kw["rgb"]
        n_px = x.shape[0] * x.shape[1] * x.shape[2]
        gh, gw = -(-x.shape[1] // kw["block_h"]), -(-x.shape[2] // kw["block_w"])
        ms = median_ms(lambda: edge_cuda(x, **kw))
        ms_runtime = median_ms(lambda: edge_cuda(x, instance="runtime", **kw))
        ms_default = median_ms(lambda: edge_cuda(x, **dict(kw, block_h=32, block_w=128)))
        plain_ms = median_ms(lambda: edge_plain(x, **kw), reps=5, warm=1)
        library_ms = median_ms(lambda: conv_components(x, rgb))
        ops = kernel_ops_per_pixel(spec5, "v2", 4, rgb)
        in_bytes = 3 if rgb else x.element_size()
        b_ms, b_by, t_bytes, t_ops = bound(n_px, in_bytes, n_px * 4 + x.shape[0] * gh * gw * 4, ops)
        timings[label] = dict(ms=ms, ms_runtime=ms_runtime, ms_block_32x128=ms_default,
                              plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
                              ops_per_px=ops, library_ms=library_ms, max_abs_err=err,
                              shape=list(x.shape))
        print(f"K1 at {label} {tuple(x.shape)} block 64x256: {ms:.4f} ms compile-time taps, "
              f"{ms_runtime:.4f} ms run-time taps (32x128: {ms_default:.4f} ms); plain "
              f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"(bytes {t_bytes:.4f} ms, {ops} ops/px {t_ops:.4f} ms); "
              f"cuDNN conv2d of the 4-direction bank (components only) {library_ms:.4f} ms")

    # K2 at every depth that fits, and the integer lane of K1 and K2, at the
    # FULL config's shape: 4 x 2048 x 2048, 64 x 256 tiles, f32 and u8.
    int_rate = int32_ops_per_s()
    print(f"INT32 rate: 64 lanes x {torch.cuda.get_device_properties(0).multi_processor_count} "
          f"SMs x max SM clock = {int_rate / 1e12:.2f} T ops/s (f32 without FMA: "
          f"{F32_OPS_PER_S / 1e12:.2f} T ops/s)")
    k2_rows, int_rows = {}, {}
    for kind, x in full_inputs.items():
        n, h, w = x.shape
        n_px = n * h * w
        kw = dict(spec=spec5, variant="v2", directions=4, block_h=64, block_w=256,
                  with_max=True)
        out_bytes = n_px * 4 + n * (-(-h // 64)) * (-(-w // 256)) * 4
        ops = kernel_ops_per_pixel(spec5, "v2", 4, False)
        b_ms, b_by, t_bytes, t_ops = bound(n_px, x.element_size(), out_bytes, ops)
        want = edge_plain(x, **kw)
        plain_ms = median_ms(lambda: edge_plain(x, **kw), reps=5, warm=1)
        library_ms = median_ms(lambda: conv_components(x, False))
        k1_ms = median_ms(lambda: edge_cuda(x, **kw))
        k1_runtime_ms = median_ms(lambda: edge_cuda(x, instance="runtime", **kw))
        route = "TMA" if tma_route(x, w, False) else "cp.async"
        for depth in fitting_depths(64, 256, spec5, x.element_size(), 1, False):
            got = edge_cuda(x, pipeline_depth=depth, **kw)
            check(_same(got, want), f"K2 {kind} depth {depth} differs at the timing shape")
            # In turns with K1 on the same frames: K1, K2, K2, K1.
            turns = [median_ms(lambda: edge_cuda(x, pipeline_depth=dd, **kw))
                     for dd in (0, depth, depth, 0)]
            row = dict(ms=turns[1], k2_ms_turns=turns[1:3], k1_ms_turns=[turns[0], turns[3]],
                       k1_ms=turns[0], route=route, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
                       ops_per_px=ops, library_ms=library_ms,
                       max_abs_err=float((got[0] - want[0]).abs().max()), shape=[n, h, w])
            k2_rows[f"{kind} depth {depth}"] = row
            print(f"K2 at 4x{h}x{w} {kind} block 64x256 depth {depth} ({route}): "
                  f"{turns[1]:.4f} / {turns[2]:.4f} ms in turns with K1 {turns[0]:.4f} / "
                  f"{turns[3]:.4f} ms; plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by}; "
                  f"cuDNN conv2d {library_ms:.4f} ms")
        if kind == "f32":
            # The tuned facade's choice for this workload (phase 3d).
            bh, bw, depth = tuned
            tkw = dict(kw, block_h=bh, block_w=bw)
            got = edge_cuda(x, pipeline_depth=depth, **tkw)
            check(_same(got, edge_plain(x, **tkw)), f"the tuned {tuned} differs at the timing shape")
            tb_ms, tb_by, _tb, _to = bound(
                n_px, x.element_size(), n_px * 4 + n * (-(-h // bh)) * (-(-w // bw)) * 4, ops)
            row = dict(ms=median_ms(lambda: edge_cuda(x, pipeline_depth=depth, **tkw)),
                       k1_ms=median_ms(lambda: edge_cuda(x, **tkw)), plain_ms=plain_ms,
                       bound_ms=tb_ms, bound_by=tb_by, library_ms=library_ms,
                       max_abs_err=float((got[0] - want[0]).abs().max()),
                       block=[bh, bw], shape=[n, h, w])
            k2_rows[f"f32 tuned {bh}x{bw} depth {depth}"] = row
            print(f"tuned choice {bh}x{bw} depth {depth} at 4x{h}x{w} f32: {row['ms']:.4f} ms "
                  f"(K1 at that tile {row['k1_ms']:.4f} ms); bound {row['bound_ms']:.4f} ms")
            continue
        ib_ms, ib_by, it_bytes, it_ops, int_px = int_lane_bound(
            n_px, 1, out_bytes, spec5, "v2", 4, int_rate)
        for depth in [0] + fitting_depths(64, 256, spec5, 1, 1, False):
            got = edge_cuda(x, precision="int", pipeline_depth=depth, **kw)
            check(_same(got, want), f"int lane depth {depth} differs at the timing shape")
            row = dict(ms=median_ms(lambda: edge_cuda(x, precision="int", pipeline_depth=depth,
                                                      **kw)),
                       f32_lane_ms=(k1_ms if depth == 0 else k2_rows[f"u8 depth {depth}"]["ms"]),
                       plain_ms=plain_ms, bound_ms=ib_ms, bound_by=ib_by, bytes_ms=it_bytes,
                       ops_ms=it_ops, int_ops_per_px=int_px, int32_ops_per_s=int_rate,
                       library_ms=library_ms, max_abs_err=float((got[0] - want[0]).abs().max()),
                       shape=[n, h, w])
            if depth:
                # In turns with K1's integer lane: K1, K2, K2, K1.
                turns = [median_ms(lambda: edge_cuda(x, precision="int", pipeline_depth=dd, **kw))
                         for dd in (0, depth, depth, 0)]
                row.update(ms=turns[1], k2_ms_turns=turns[1:3],
                           k1_int_ms_turns=[turns[0], turns[3]])
                print(f"int lane K2 depth {depth} in turns with K1's: {turns[1]:.4f} / "
                      f"{turns[2]:.4f} ms against {turns[0]:.4f} / {turns[3]:.4f} ms")
            if depth == 0:
                row.update(ms_runtime=median_ms(lambda: edge_cuda(x, precision="int",
                                                                  instance="runtime", **kw)),
                           f32_lane_ms_runtime=k1_runtime_ms,
                           f32_lane_ms_again=median_ms(lambda: edge_cuda(x, **kw)))
                print(f"K1 at 4x{h}x{w} u8: integer lane {row['ms']:.4f} ms, f32 lane "
                      f"{row['f32_lane_ms']:.4f} / {row['f32_lane_ms_again']:.4f} ms (compile-time "
                      f"taps; integer/f32 {row['ms'] / row['f32_lane_ms_again']:.3f}); run-time "
                      f"taps: integer {row['ms_runtime']:.4f} ms, f32 {k1_runtime_ms:.4f} ms")
            int_rows[f"{'K1' if depth == 0 else 'K2'} depth {depth}"] = row
            print(f"int lane {'K1' if depth == 0 else 'K2'} depth {depth} at 4x{h}x{w} u8: "
                  f"{row['ms']:.4f} ms (f32 lane {row['f32_lane_ms']:.4f} ms); bound "
                  f"{ib_ms:.4f} ms by {ib_by} ({int_px} int ops/px {it_ops:.4f} ms, bytes "
                  f"{it_bytes:.4f} ms)")
    del want, got

    # The stream server's shape: 4 x 2048 x 2048 u8, 64 x 256 tiles, NMS on.
    cfg = get_config("sobel-hd")
    rng = np.random.default_rng(5)
    n, h, w = motion_mask.shape[0], cfg.image_h, cfg.image_w
    bh, bw = cfg.sobel_block_h, cfg.sobel_block_w
    x = video(cfg, n, 3, 2.0, dev)
    n_px = n * h * w
    kw = dict(spec=spec5, variant="v2", directions=4, padding="reflect", block_h=bh,
              block_w=bw, out_nms=True)
    gh, gw = -(-h // bh), -(-w // bw)
    nms_ops = nms_lane_ops(spec5, "v2", 4, False, np.ones((n, gh, gw), bool), h, w, bh, bw) / n_px
    a, am = edge_cuda(x, with_max=True, **kw)
    b, bm = edge_plain(x, with_max=True, **kw)
    check(torch.equal(a, b) and torch.equal(am, bm), "K1 out_nms at the stream shape differs")
    nms_err = float((a - b).abs().max())
    b_ms, b_by, t_bytes, t_ops = bound(n_px, 1, n_px * 4 + n * gh * gw * 4, nms_ops)
    k1_nms = dict(ms=median_ms(lambda: edge_cuda(x, with_max=True, **kw)),
                  ms_runtime=median_ms(lambda: edge_cuda(x, with_max=True, instance="runtime",
                                                         **kw)),
                  plain_ms=median_ms(lambda: edge_plain(x, with_max=True, **kw), reps=5, warm=1),
                  bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
                  ops_per_px=nms_ops, max_abs_err=nms_err, shape=[n, h, w], library_ms=None,
                  launches_edges_server=edges_launches)
    print(f"K1 out_nms at 4x{h}x{w} u8 block {bh}x{bw}: {k1_nms['ms']:.4f} ms compile-time "
          f"taps, {k1_nms['ms_runtime']:.4f} ms run-time taps; plain "
          f"{k1_nms['plain_ms']:.3f} ms; bound {b_ms:.4f} ms by {b_by} (bytes {t_bytes:.4f} ms, "
          f"{nms_ops:.1f} ops/px {t_ops:.4f} ms); library: none")

    prev = b.contiguous()
    prev_max = bm.contiguous()
    x_next = video(cfg, n, 4, 2.0, dev)
    k3 = {}
    for share_label, mask in (("0%", torch.zeros_like(motion_mask)),
                              ("motion", motion_mask),
                              ("100%", torch.ones_like(motion_mask))):
        ka = edge_stream_cuda(x_next, prev, prev_max, mask, **kw)
        kb = edge_stream_plain(x_next, prev, prev_max, mask, **kw)
        check(_same(ka, kb), f"K3 at {share_label} differs from its plain version")
        err = float((ka[0] - kb[0]).abs().max())
        m = mask.cpu().numpy()
        b_ms, b_by, t_bytes, t_ops, share = stream_bound(
            m, h, w, bh, bw, 1, nms_lane_ops(spec5, "v2", 4, False, m, h, w, bh, bw))

        def k3_call(mask=mask):
            return edge_stream_cuda(x_next, prev, prev_max, mask, **kw)

        row = dict(ms=median_ms(k3_call),
                   device_us=launch_device_us(k3_call, "stream_kernel"),
                   ms_runtime=median_ms(lambda: edge_stream_cuda(x_next, prev, prev_max, mask,
                                                                 instance="runtime", **kw)),
                   plain_ms=median_ms(lambda: edge_stream_plain(x_next, prev, prev_max, mask, **kw),
                                      reps=5, warm=1),
                   bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes, ops_ms=t_ops,
                   changed_share=share, max_abs_err=err, library_ms=None)
        if share_label == "100%":
            # Every tile walked: in turns with K1's NMS lane on the same frames.
            def k1_call():
                return edge_cuda(x_next, with_max=True, **kw)

            turns = [median_ms(f) for f in (k1_call, k3_call, k3_call, k1_call)]
            row.update(k3_ms_turns=turns[1:3], k1_nms_ms_turns=[turns[0], turns[3]],
                       k1_nms_device_us=launch_device_us(k1_call, "edge_kernel"))
            print(f"K3 at 100% in turns with K1's NMS lane on the same frames: {turns[1]:.4f} / "
                  f"{turns[2]:.4f} ms against {turns[0]:.4f} / {turns[3]:.4f} ms; device "
                  f"{row['device_us']:.1f} us against {row['k1_nms_device_us']:.1f} us a launch")
        k3[share_label] = row
        print(f"K3 at 4x{h}x{w} u8 block {bh}x{bw}, {100 * share:.2f}% of pixels in changed "
              f"tiles ({share_label}): {row['ms']:.4f} ms on CUDA events, {row['device_us']:.1f} "
              f"us a launch of device time (profiler; run-time taps {row['ms_runtime']:.4f} "
              f"ms); plain {row['plain_ms']:.3f} ms; bound "
              f"{b_ms:.4f} ms by {b_by} (bytes {t_bytes:.4f} ms, ops {t_ops:.4f} ms); "
              "library: none")

    main_t = timings["2048x2048 f32"]
    k3_main = k3["motion"]
    return [{
        "name": "K1 edge (fused Sobel megakernel)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge.cu",
        "replaces": "src/repro/kernels/edge.py:245",
        "launches": server_launches,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shapes": timings,
        "out_nms": k1_nms,
        "int_lane": int_rows["K1 depth 0"],
        "launches_depth_facade": main_counts["k1"],
    }, {
        "name": "K2 edge_pipelined (prefetching megakernel: K1's walk fed by a ring)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_pipelined.cu",
        "replaces": "src/repro/kernels/edge.py:274",
        "launches": main_counts["k2"],
        "max_abs_err": k2_rows["f32 depth 2"]["max_abs_err"],
        "ms": k2_rows["f32 depth 2"]["ms"],
        "plain_ms": k2_rows["f32 depth 2"]["plain_ms"],
        "bound_ms": k2_rows["f32 depth 2"]["bound_ms"],
        "bound_by": k2_rows["f32 depth 2"]["bound_by"],
        "library_ms": k2_rows["f32 depth 2"]["library_ms"],
        "depths": k2_rows,
        "int_lane": {k: v for k, v in int_rows.items() if k != "K1 depth 0"},
        "int_launches": main_counts["k2_int"],
    }, {
        "name": "K3 edge_stream (persistent delta-skip kernel)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_stream.cu",
        "replaces": "src/repro/kernels/edge.py:359",
        "launches": k3_launches,
        "max_abs_err": k3_main["max_abs_err"],
        "ms": k3_main["ms"],
        "plain_ms": k3_main["plain_ms"],
        "bound_ms": k3_main["bound_ms"],
        "bound_by": k3_main["bound_by"],
        "library_ms": None,
        "shares": k3,
    }]


def composed_bank(plan) -> np.ndarray:
    """The (D, K, K) correlation bank of a plan of one linear pre-stage and a
    gradient: each direction's taps convolved with the pre-stage's (K = 9 for
    blur_sobel5), the taps one conv2d needs to compute the same components."""
    g = plan.pre_stages[0].operator.bank(1)[0].astype(np.float64)
    bank = plan.gradient.bank(4).astype(np.float64)
    kg, kd = g.shape[0], bank.shape[-1]
    out = np.zeros((bank.shape[0], kg + kd - 1, kg + kd - 1))
    for i in range(kd):
        for j in range(kd):
            out[:, i:i + kg, j:j + kg] += bank[:, i:i + 1, j:j + 1] * g
    return out.astype(np.float32)


def phase_plan_timing(full_inputs, dev, plan_counts):
    """Phase 5, the plan lanes: ``canny5`` (thin map and maxima) and
    ``blur_sobel5`` (magnitude and maxima) on K1 and ``canny5`` on K2 at the
    depths that fit, at 4x2048x2048 u8 and f32 on the 64x256 tile, each in
    turns with K1's NMS lane on the same frames (nms, plan, plan, nms),
    beside the plain version and the bound; one cuDNN conv2d of the composed
    9x9 bank as ``blur_sobel5``'s yardstick. Returns K1's and K2's rows."""
    from repro_torch.core.filters import get_operator, get_plan
    from repro_torch.kernels.edge import edge_cuda, edge_plain

    torch.backends.cudnn.allow_tf32 = False
    spec5 = get_operator("sobel5")
    canny, blur = get_plan("canny5"), get_plan("blur_sobel5")
    bank9 = torch.from_numpy(composed_bank(blur)).to(dev)[:, None]
    base = dict(spec=spec5, variant="v2", directions=4, block_h=64, block_w=256, with_max=True)
    k1_rows, k2_rows = {}, {}
    for kind, x in full_inputs.items():
        n, h, w = x.shape
        n_px = n * h * w
        gh, gw = -(-h // 64), -(-w // 256)
        out_bytes = n_px * 4 + n * gh * gw * 4
        ones = np.ones((n, gh, gw), bool)

        def nms_lane():
            return edge_cuda(x, out_nms=True, **base)

        calls = {"canny5": dict(plan=canny, out_nms=True), "blur_sobel5": dict(plan=blur)}
        for name, pkw in calls.items():
            plan = pkw["plan"]
            if plan.nms:
                ops = nms_lane_ops(spec5, "v2", 4, False, ones, h, w, 64, 256)
            else:
                ops = kernel_ops_per_pixel(spec5, "v2", 4, False) * n_px
            ops += plan_pre_ops(plan, n, h, w, plan.nms)
            b_ms, b_by, t_bytes, t_ops = bound(n_px, x.element_size(), out_bytes, ops / n_px)
            want = edge_plain(x, **base, **pkw)
            plain_ms = median_ms(lambda: edge_plain(x, **base, **pkw), reps=5, warm=1)
            library_ms = None
            if name == "blur_sobel5":
                def conv9():
                    xp = F.pad(x.float()[:, None], (4, 4, 4, 4), mode="reflect")
                    return F.conv2d(xp, bank9)
                library_ms = median_ms(conv9)
            for depth in [0] + fitting_depths(64, 256, spec5, x.element_size(), 1, plan.nms,
                                              plan=plan):
                if depth and name != "canny5":
                    continue

                def call(depth=depth):
                    return edge_cuda(x, pipeline_depth=depth, **base, **pkw)

                got = call()
                check(_same(got, want), f"{name} {kind} depth {depth} differs at the timing shape")
                turns = [median_ms(f) for f in (nms_lane, call, call, nms_lane)]
                row = dict(ms=turns[1], ms_turns=turns[1:3], k1_nms_ms_turns=[turns[0], turns[3]],
                           device_us=launch_device_us(
                               call, "pipelined_kernel" if depth else "edge_kernel"),
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes_ms=t_bytes,
                           ops_ms=t_ops, ops_per_px=ops / n_px, library_ms=library_ms,
                           max_abs_err=float((got[0] - want[0]).abs().max()), shape=[n, h, w])
                where = f"K2 depth {depth}" if depth else "K1"
                (k2_rows if depth else k1_rows)[f"{name} {kind}" + (f" depth {depth}" if depth
                                                                    else "")] = row
                print(f"{name} on {where} at 4x{h}x{w} {kind} block 64x256: {turns[1]:.4f} / "
                      f"{turns[2]:.4f} ms in turns with K1's NMS lane {turns[0]:.4f} / "
                      f"{turns[3]:.4f} ms; {row['device_us']:.1f} us a launch of device time; "
                      f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms by {b_by} (bytes "
                      f"{t_bytes:.4f} ms, {ops / n_px:.2f} ops/px {t_ops:.4f} ms); library "
                      + (f"cuDNN conv2d of the composed 9x9 bank {library_ms:.4f} ms"
                         if library_ms is not None else "none"))
    return dict(plans=k1_rows, launches_plan_facade=plan_counts["k1_plan"]), dict(
        plans=k2_rows, launches_plan_facade=plan_counts["k2_plan"])


# --- Training (phase 16) ----------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
TRAIN_PARAMS = 1_498_482_688     # the reference's Model.param_count() at FULL
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 128    # the reference launcher's batch and seq
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ)]
# Phase 16a: K4's Function at llama's training shape (B, H, S, T, D), causal,
# at the mesh trainer's shard of it (phase 17a: 4 of the 8 rows and 16 of
# the 32 heads a position), and at a non-causal one (whisper's
# cross-attention over its 1,500 frames).
# Phase 18's shards (4 of the 8 rows a position): minicpm3-4b's 20 of 40
# MLA heads, q and k of 96 and v of 64 (zero-padded to 96 for K4, the
# gradient taken through the pad), and qwen3-moe's 16 of 32 heads of 128.
# (B, H, S, T, D), causal, dtype, v's width (0: D).
K4_GRAD_CASES = (((8, 32, 128, 128, 64), True, torch.float32, 0),
                 ((8, 32, 128, 128, 64), True, torch.bfloat16, 0),
                 ((4, 16, 128, 128, 64), True, torch.float32, 0),
                 ((4, 16, 128, 128, 64), True, torch.bfloat16, 0),
                 ((2, 20, 64, 1500, 64), False, torch.float32, 0),
                 ((4, 20, 128, 128, 96), True, torch.float32, 64),
                 ((4, 20, 128, 128, 96), True, torch.bfloat16, 64),
                 ((4, 16, 128, 128, 128), True, torch.bfloat16, 0),
                 ((4, 16, 128, 128, 80), True, torch.bfloat16, 0),
                 ((4, 10, 128, 128, 64), False, torch.bfloat16, 0),
                 ((4, 10, 128, 128, 64), True, torch.bfloat16, 0),
                 ((4, 16, 1152, 1152, 128), True, torch.bfloat16, 0))
# K5's Function at a small shape, at phase 18's shard of falcon-mamba-7b
# (4 of the 8 rows, 4,096 of the 8,192 channels a position) and at one
# device's (8, 128, 8192, 16), f32 as the model scans.
K5_GRAD_SHAPES = ((1, 128, 512, 16), (4, 128, 4096, 16), (8, 128, 8192, 16))
K5_BF16_CHUNK = 16       # falcon-mamba-7b's ssm_chunk: where the bf16 mode takes its f32 carry
K5_BF16_TIMING_SHAPE = (1, 2048, 8192, 16)      # phase 5: K5's bf16 mode beside its f32 mode
# The Functions' gradients against plain autograd on the same inputs: their
# backward recomputes the plain version, so they differ only in the order
# cuBLAS takes the recompute's products (bit-equal when it takes the same):
# within 1e-5 of each gradient's largest value.
FN_GRAD_REL = 1e-5
# Phase 16c, one f32 step at FULL width on both lanes from the same weights:
# the loss within 1e-4, each leaf's gradient within 1e-3 of its largest
# value. A leaf may part further only where the one-ulp control parts it
# past 1e-3 too (the model's own rounding: random weights make attention
# sharp); the lanes are then held block by block (``train_layer_local``):
# each block's attention output, and its gradients for its weights and
# its input, within TRAIN_GRAD_TOL of the plain lane's largest value.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_CKPT = ROOT / "build" / "chip_smoke" / "train_ckpt"


def phase_train_functions(dev) -> dict:
    """Phase 16a: ``k4_attention`` and ``k5_scan`` (the autograd Functions)
    against the plain versions under autograd on the card, and a bare
    ``backend="cuda"`` call under grad raising. Launches made here are
    comparisons: they count toward no path."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     k4_attention)
    from repro_torch.kernels.selective_scan import k5_scan, selective_scan, selective_scan_plain

    def grad_err(got, want):
        return max(float((a.float() - w.float()).abs().max() / w.float().abs().max().clamp_min(
            1e-30)) for a, w in zip(got, want))

    out = {}
    for shape, causal, dtype, dv in K4_GRAD_CASES:
        b, h, s, t, d = shape
        dv = dv or d
        q, k, v = attention_inputs(shape, dtype, dev, seed=t)
        q, k, v = q.requires_grad_(), k.requires_grad_(), v[..., :dv].detach().requires_grad_()
        go = torch.randn((b, h, s, dv), device=dev, generator=torch.Generator(
            device=dev).manual_seed(s)).to(dtype)
        before = flash_attention.launches
        # v zero-padded to k's width, as attention._k4_attention_narrow_v does
        o = k4_attention(q, k, F.pad(v, (0, d - dv)), causal=causal, block_q=s,
                         block_kv=t)[..., :dv]
        got = torch.autograd.grad(o, (q, k, v), go)
        torch.cuda.synchronize()
        check(flash_attention.launches == before + 1, "k4_attention did not launch K4 once")
        plain = flash_attention_plain(q, k, v, causal=causal)
        want = torch.autograd.grad(plain, (q, k, v), go)
        diff = (o.detach().float() - plain.detach().float()).abs()
        fwd = float(diff.max())
        bound = K4_TOL + (bf16_ulp(plain.detach()) if dtype == torch.bfloat16 else 0.0)
        check(bool((diff <= bound).all()),
              f"K4's forward at {shape} v {dv} {dtype} differs from the plain version by {fwd}")
        err = grad_err(got, want)
        equal = all(torch.equal(a, w) for a, w in zip(got, want))
        check(err <= FN_GRAD_REL, f"K4Attention's q/k/v gradients at {shape} v {dv} {dtype} "
                                  f"differ from plain autograd's by {err:.3g} of their largest "
                                  f"> {FN_GRAD_REL}")
        label = f"{'x'.join(map(str, shape))}{f' v {dv}' if dv != d else ''} " + (
            "causal " if causal else "non-causal ") + (
            "bf16" if dtype == torch.bfloat16 else "f32")
        out[label] = dict(forward_err=fwd, grad_rel_err=err, grads_bit_equal=equal)
        print(f"phase 16a K4Attention {label}: forward within {fwd:.3g}, q/k/v gradients within "
              f"{err:.3g} of their largest ({'bit-equal' if equal else 'not bit-equal'})")
    for shape in K5_GRAD_SHAPES:
        args = [x.requires_grad_() for x in scan_inputs(shape, torch.float32, dev, seed=5)]
        bsz, l, di, n = shape
        g = torch.Generator(device=dev).manual_seed(6)
        gy, gh = torch.randn((bsz, l, di), device=dev, generator=g), torch.randn(
            (bsz, di, n), device=dev, generator=g)
        before = selective_scan.launches
        y, hl = k5_scan(*args, chunk=l, block_d=di)
        got = torch.autograd.grad((y, hl), args, (gy, gh))
        torch.cuda.synchronize()
        check(selective_scan.launches == before + 1, "k5_scan did not launch K5 once")
        wy, wh = selective_scan_plain(*args)
        fwd_ok = within(y.detach(), wy.detach(), K5_TOL) and within(hl.detach(), wh.detach(),
                                                                    K5_TOL)
        fwd = float((y.detach() - wy.detach()).abs().max())
        check(fwd_ok, f"K5's forward at {shape} differs from the plain version by {fwd} "
                      f"(tolerance {K5_TOL} abs + rel)")
        want = torch.autograd.grad((wy, wh), args, (gy, gh))
        err = grad_err(got, want)
        check(err <= FN_GRAD_REL, f"K5Scan's gradients at {shape} differ from plain autograd's "
                                  f"by {err:.3g}")
        out["k5 " + "x".join(map(str, shape))] = dict(forward_err=fwd, grad_rel_err=err)
        print(f"phase 16a K5Scan {shape}: forward within {fwd:.3g}, x/dt/B/C/A gradients within "
              f"{err:.3g} of their largest")
        del args, got, want, wy, wh, y, hl
    out["k5_bf16"] = k5_bf16_elements(dev)
    args = [x.requires_grad_() for x in scan_inputs(K5_GRAD_SHAPES[0], torch.float32, dev,
                                                    seed=5)]
    l, di = K5_GRAD_SHAPES[0][1:3]
    refused = []
    q = attention_inputs((1, 2, 16, 16, 64), torch.float32, dev, seed=1)[0].requires_grad_()
    for name, call in (("flash_attention", lambda: flash_attention(q, q, q, backend="cuda")),
                       ("selective_scan", lambda: selective_scan(*args, chunk=l, block_d=di,
                                                                 backend="cuda"))):
        try:
            call()
        except RuntimeError as err:
            refused.append(name if "under autograd" in str(err) else f"{name}: {err}")
    check(refused == ["flash_attention", "selective_scan"],
          f"a bare backend='cuda' call under grad did not raise: {refused}")
    print("phase 16a: flash_attention and selective_scan on the kernel raise under autograd")
    return out


def k5_bf16_elements(dev) -> dict:
    """Phase 16a, K5's bf16-element mode (``scan_dtype="bfloat16"``, the
    model's ``ssm_scan_dtype``, chunks of falcon-mamba's 16 steps) at
    ``K5_GRAD_SHAPES`` on f32 inputs, as the model scans: y and the final
    state bit-equal (``torch.equal``) to ``selective_scan_plain``'s bf16
    mode, one launch each counted in ``selective_scan.bf16_launches``; and
    ``k5_scan``'s gradients in that mode against plain autograd through the
    bf16 plain scan at the first shape (within ``FN_GRAD_REL``). Launches
    made here are comparisons: they count toward no path."""
    from repro_torch.kernels.selective_scan import k5_scan, selective_scan, selective_scan_plain

    out = {}
    for shape in K5_GRAD_SHAPES:
        args = scan_inputs(shape, torch.float32, dev, seed=7)
        l, di = shape[1], shape[2]
        before = selective_scan.bf16_launches
        y, h = selective_scan(*args, chunk=K5_BF16_CHUNK, block_d=di, scan_dtype="bfloat16")
        wy, wh = selective_scan_plain(*args, scan_dtype="bfloat16", chunk=K5_BF16_CHUNK)
        torch.cuda.synchronize()
        check(selective_scan.bf16_launches == before + 1, "K5's bf16 mode did not launch once")
        equal = torch.equal(y, wy) and torch.equal(h, wh)
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        f32y, _ = selective_scan(*args, chunk=l, block_d=di)
        check(equal, f"K5's bf16 elements at {shape} differ from the plain version's by {err}")
        rounds = float((y - f32y).abs().max())
        out["x".join(map(str, shape))] = dict(bit_equal=equal, max_abs_err=err,
                                              from_f32_mode=rounds)
        print(f"phase 16a K5 bf16 elements {shape} chunk {K5_BF16_CHUNK}: y and final state "
              f"bit-equal to the plain version's bf16 mode; y {rounds:.3g} from the f32 mode's")
        del args, y, h, wy, wh, f32y
    shape = K5_GRAD_SHAPES[0]
    args = [x.requires_grad_() for x in scan_inputs(shape, torch.float32, dev, seed=8)]
    g = torch.Generator(device=dev).manual_seed(9)
    gy = torch.randn(shape[:3], device=dev, generator=g)
    gh = torch.randn((shape[0], shape[2], shape[3]), device=dev, generator=g)
    y, h = k5_scan(*args, chunk=K5_BF16_CHUNK, block_d=shape[2], scan_dtype="bfloat16")
    got = torch.autograd.grad((y, h), args, (gy, gh))
    wy, wh = selective_scan_plain(*args, scan_dtype="bfloat16", chunk=K5_BF16_CHUNK)
    want = torch.autograd.grad((wy, wh), args, (gy, gh))
    err = max(float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
              for a, w in zip(got, want))
    check(err <= FN_GRAD_REL, f"K5Scan's bf16-element gradients differ from plain autograd's by "
                              f"{err:.3g}")
    out["grad_rel_err"] = err
    print(f"phase 16a K5Scan bf16 elements {shape}: x/dt/B/C/A gradients within {err:.3g} of "
          f"their largest")
    return out


def redraw_leaf(model, path: str, dev) -> torch.Tensor:
    """The initial value of one parameter, drawn again (``init_tree`` seeds
    each leaf by its path alone)."""
    from repro_torch.models.layers import init_tree

    keys = path.split("/")
    tree = model.param_specs()
    for key in keys:
        tree = tree[key]
    for key in reversed(keys):
        tree = {key: tree}
    leaf = init_tree(tree, 0, device=dev)
    for key in keys:
        leaf = leaf[key]
    return leaf


def phase_train(dev) -> dict:
    """Phase 16b, the training slice's main path: ``repro_torch.launch.
    train.main`` on llama3.2-1b at FULL width and depth (1,498,482,688
    parameters; f32 master weights and AdamW moments, the forward in bf16
    through ``cast_params``), the reference launcher's batch 8 x 128 tokens,
    ``TRAIN_STEPS`` steps, counts set to 0 just before and read just after:
    K4 exactly 16 layers x 1 microbatch x ``forward_runs`` (2: remat's
    recompute) a step and nothing else, no
    ``dot_attention`` (the plain lane) call; every loss and grad norm
    finite, the grad norm > 0, lr 0 at step 0 (``warmup_cosine``), every
    parameter moved from its initial value. Prints the step p50 (host clock,
    each step ended by reading its loss), tokens/s, the peak of
    ``max_memory_allocated`` and one step under the profiler (device idle
    share, K4's share)."""
    from repro_torch.data.loader import DataLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attn_mod
    from repro_torch.tree import leaves_with_path

    plain_calls = []
    real_dot = attn_mod.dot_attention

    def counted_dot(*a, **kw):
        plain_calls.append(1)
        return real_dot(*a, **kw)

    free_weights()
    torch.cuda.reset_peak_memory_stats()
    attn_mod.dot_attention = counted_dot
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = launch_train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        attn_mod.dot_attention = real_dot
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist, trainer = out["history"], out["trainer"]
    cfg = trainer.cfg
    check(out["param_count"] == TRAIN_PARAMS, f"{cfg.name} has {out['param_count']:,} params")
    want = cfg.num_layers * trainer.tc.microbatches * TRAIN_STEPS * forward_runs(cfg)
    check(counts["k4"] == want, f"training launched K4 {counts['k4']} times, not {want}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"), f"training launched {counts}")
    check(not plain_calls, f"training called the plain attention {len(plain_calls)} times")
    check(hist["step"] == list(range(1, TRAIN_STEPS + 1)), f"steps logged {hist['step']}")
    check(all(np.isfinite(hist["loss"])) and all(np.isfinite(hist["grad_norm"])),
          f"non-finite loss or grad norm: {hist['loss']}, {hist['grad_norm']}")
    check(min(hist["grad_norm"]) > 0, f"a zero grad norm: {hist['grad_norm']}")
    check(hist["lr"][0] == 0.0 and hist["lr"][1] > 0, f"lr {hist['lr'][:2]}")
    unmoved = [path for path, leaf in leaves_with_path(trainer.state.params)
               if torch.equal(leaf, redraw_leaf(trainer.model, "/".join(path), dev))]
    check(not unmoved, f"parameters unchanged after {TRAIN_STEPS} steps: {unmoved}")
    step_ms = [1e3 * s for s in trainer.monitor.history[1:]]      # the first step warms up
    p50 = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    loader = DataLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device=dev)
    batch = next(loader)
    loader.close()
    state = trainer.state

    def one_step():
        new_state, metrics = trainer.step_fn(state, batch)
        float(metrics["loss"])

    busy_us, span_us, k4_us = device_profile("one training step", one_step, top=12,
                                             kernel="flash_kernel")
    k4_row = k4_training_shape(dev, (TRAIN_BATCH, cfg.num_heads, TRAIN_SEQ, TRAIN_SEQ,
                                     cfg.head_dim))
    k4_row["device_us"] = k4_us / (cfg.num_layers * trainer.tc.microbatches * forward_runs(cfg))
    stats = dict(k4=counts["k4"], steps=TRAIN_STEPS, loss=hist["loss"],
                 grad_norm=hist["grad_norm"], lr=hist["lr"], step_ms=step_ms, step_p50_ms=p50,
                 tok_s=tokens / (p50 / 1e3), peak_gb=peak_gb, seconds=seconds,
                 step_idle=1 - busy_us / span_us, step_busy_us=busy_us,
                 k4_share=k4_us / busy_us, param_count=out["param_count"], k4_train=k4_row)
    print(f"phase 16b: {cfg.name} FULL ({out['param_count']:,} params) trained {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in {seconds:.1f} s: loss "
          f"{hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, grad norm "
          f"{min(hist['grad_norm']):.4g}-{max(hist['grad_norm']):.4g}; step p50 {p50:.2f} ms "
          f"({', '.join(f'{m:.1f}' for m in step_ms)}), {stats['tok_s']:.0f} tok/s; K4 "
          f"{counts['k4']} launches ({counts['k4'] // TRAIN_STEPS} a step), plain attention "
          f"calls 0; max_memory_allocated {peak_gb:.2f} GB; one step's device idle "
          f"{100 * stats['step_idle']:.1f}%, K4 {100 * stats['k4_share']:.2f}% of its device "
          f"time ({k4_row['device_us']:.1f} us a launch)")
    del out, trainer, state, batch
    free_weights()
    return stats


def k4_training_shape(dev, shape, dv: int = 0, causal: bool = True) -> dict:
    """K4 at a training step's attention shape (B, H, S, T, D), bf16,
    causal or not, v of ``dv`` (0: D; K4 takes it zero-padded to D, as the MLA
    model pads it): CUDA-event medians in turns with
    F.scaled_dot_product_attention (the yardstick, on the unpadded v; the
    port never calls it), the plain version, and ``flash_bound``."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    b, h, s, t, d = shape
    dv = dv or d
    q, k, v = attention_inputs(shape, torch.bfloat16, dev, seed=s)
    v = v[..., :dv]
    vk = F.pad(v, (0, d - dv))
    with torch.no_grad():
        kern = lambda: flash_attention(q, k, vk, causal=causal, block_q=s,  # noqa: E731
                                       block_kv=t)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        lib1, ms1, ms2, lib2 = median_ms(sdpa), median_ms(kern), median_ms(kern), median_ms(sdpa)
        plain_ms = median_ms(lambda: flash_attention_plain(q, k, v, causal=causal))
    fb = flash_bound(shape, causal, 2, dv)
    row = dict(ms=statistics.median([ms1, ms2]), ms_runs=[ms1, ms2], plain_ms=plain_ms,
               library_ms=statistics.median([lib1, lib2]), library_ms_runs=[lib1, lib2],
               shape=list(shape), dv=dv, dtype="bfloat16", causal=causal, **fb)
    print(f"K4 at the training shape {shape}{f' v {dv} padded to {d}' if dv != d else ''} "
          f"{'causal' if causal else 'non-causal'} bf16: {ms1:.4f} / {ms2:.4f} ms; "
          f"scaled_dot_product_attention {lib1:.4f} / "
          f"{lib2:.4f} ms; plain {plain_ms:.4f} ms; bound {fb['bound_ms']:.4f} ms by "
          f"{fb['bound_by']}")
    return row


def lane_grads(cfg, params, batch, backend):
    """(per-leaf gradients, loss) of one step of ``cfg``'s ``loss_fn`` on
    ``backend``."""
    from repro_torch.models import Model
    from repro_torch.tree import leaves, unflatten

    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, _ = Model(cfg, backend=backend).loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    return grads, float(loss.detach())


def train_layer_local(cfg, params, batch) -> dict:
    """A dense model's two lanes under autograd, block by block: each block
    run on both lanes from the plain lane's hidden state and differentiated
    against one cotangent drawn on the card (seed 0, a new one a block).
    Held: the K4 lane's attention output, and its gradients for each of the
    block's weights and for the block's input, within ``TRAIN_GRAD_TOL`` of
    the plain lane's largest value. Returns the worst of each."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.layers import apply_norm, torch_dtype
    from repro_torch.tree import leaves, leaves_with_path, unflatten

    x, pos = T._prepare_inputs(params, cfg, batch, torch_dtype(cfg.dtype))
    x = x.detach()
    gen = torch.Generator(device=x.device).manual_seed(0)
    out = dict(attn_err=0.0, grad_err=0.0, grad_leaf="")
    for i in range(cfg.num_layers):
        lp = T._layer(params["layers"], i)
        names = ["/".join(p) for p, _ in leaves_with_path(lp)] + ["input"]
        cot = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        attn, grads, y = {}, {}, {}
        for backend in ("torch", "auto"):
            flat = [t.detach().requires_grad_(True) for t in leaves(lp) + [x]]
            lpb, xin = unflatten(lp, flat[:-1]), flat[-1]
            with torch.no_grad():
                attn[backend], _ = apply_attention(lpb["attn"], cfg, apply_norm(lpb["ln1"], cfg, xin),
                                                   pos, backend=backend)
            y[backend], _, _ = T._apply_attn_block(lpb, cfg, xin, pos, backend=backend)
            grads[backend] = torch.autograd.grad((y[backend] * cot).sum(), flat)
        attn_err = max_rel(attn["auto"], attn["torch"])
        check(attn_err <= TRAIN_GRAD_TOL, f"layer {i}: K4's attention output differs from the "
                                          f"plain lane's by {attn_err:.3g} > {TRAIN_GRAD_TOL}")
        out["attn_err"] = max(out["attn_err"], attn_err)
        for name, got, want in zip(names, grads["auto"], grads["torch"]):
            err = max_rel(got, want)
            check(err <= TRAIN_GRAD_TOL, f"layer {i} {name}: the lanes' block gradients differ "
                                         f"by {err:.3g} of its largest > {TRAIN_GRAD_TOL}")
            if err >= out["grad_err"]:
                out["grad_err"], out["grad_leaf"] = err, f"{i}/{name}"
        x = y["torch"].detach()
    return out


def phase_train_lanes(dev) -> dict:
    """Phase 16c: one f32 step's loss and gradients at FULL width on the K4
    lane (its backward: the plain version recomputed) and on the plain lane
    (``dot_attention``), from the same weights drawn on the card (seed 0)
    and the same batch; the plain lane with the embeddings moved by one ulp
    (``ulp_params``) is the control. Held: the loss within
    ``TRAIN_LOSS_TOL``; each leaf's gradient within ``TRAIN_GRAD_TOL`` of
    its largest value, or, for a leaf that the control parts past
    ``TRAIN_GRAD_TOL`` too (the model's own rounding), by the blocks
    (``train_layer_local``), which run in every call."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.tree import leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).replace(dtype="float32")
    params = Model(cfg).init(0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).items()}
    reset_counts()
    k4_grads, k4_loss = lane_grads(cfg, params, batch, "auto")
    runs = forward_runs(cfg)
    check(read_counts()["k4"] == cfg.num_layers * runs,
          f"the K4 lane's step did not launch K4 {runs} times a layer")
    plain_grads, plain_loss = lane_grads(cfg, params, batch, "torch")
    check(read_counts()["k4"] == cfg.num_layers * runs, "the plain lane's step launched K4")

    def rel(a, b):
        return [max_rel(x, y) for x, y in zip(a, b)]

    lanes = rel(k4_grads, plain_grads)
    paths = ["/".join(p) for p, _ in leaves_with_path(params)]
    del k4_grads
    ctrl_grads, ctrl_loss = lane_grads(cfg, ulp_params(params), batch, "torch")
    control = rel(ctrl_grads, plain_grads)
    del ctrl_grads, plain_grads
    loss_err = abs(k4_loss - plain_loss)
    check(np.isfinite(k4_loss) and loss_err <= TRAIN_LOSS_TOL,
          f"the f32 step's loss differs between the lanes by {loss_err} > {TRAIN_LOSS_TOL}")
    by_blocks = [p for p, err, ctl in zip(paths, lanes, control) if err > TRAIN_GRAD_TOL]
    for path, err, ctl in zip(paths, lanes, control):
        check(err <= TRAIN_GRAD_TOL or ctl > TRAIN_GRAD_TOL,
              f"{path}: the lanes' gradients differ by {err:.3g} of its largest, where the "
              f"one-ulp control parts them by {ctl:.3g}; > {TRAIN_GRAD_TOL}")
    local = train_layer_local(cfg, params, batch)
    del params
    worst = max(range(len(paths)), key=lambda i: lanes[i])
    stats = dict(loss=k4_loss, loss_err=loss_err, control_loss_err=abs(ctrl_loss - plain_loss),
                 grad_err=lanes[worst], grad_err_leaf=paths[worst], control_grad_err=max(control),
                 held_by_blocks=by_blocks, block_attn_err=local["attn_err"],
                 block_grad_err=local["grad_err"], block_grad_leaf=local["grad_leaf"])
    print(f"phase 16c: one f32 step of {cfg.name} FULL, K4 lane against the plain lane: loss "
          f"{k4_loss:.6f}, within {loss_err:.3g} (control {stats['control_loss_err']:.3g}); "
          f"gradients within {lanes[worst]:.3g} of their largest ({paths[worst]}; control "
          f"up to {max(control):.3g}); {len(by_blocks)} leaves held by the blocks; block by "
          f"block: attention outputs within {local['attn_err']:.3g}, gradients within "
          f"{local['grad_err']:.3g} ({local['grad_leaf']})")
    free_weights()
    return stats


def phase_train_restart(dev) -> dict:
    """Phase 16d: the reference's ``test_train_restart_after_injected_failure``
    (``tests/test_checkpoint_fault.py``) at SMOKE size on the card: 14 steps,
    a checkpoint every 5 (keep 2) under ``build/``, three failures at step 8
    that outlast one retry, so the trainer restores step 5's checkpoint and
    replays. Held: at least one restart, finite losses, the last loss
    within 0.5 of the first, ``latest_step() == 14``, and step 14's
    checkpoint restored to the card equal to the final state bit for bit."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.loader import DataLoader
    from repro_torch.runtime import FaultPolicy, StepFailure
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, leaves_with_path

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    cfg = get_config(TRAIN_ARCH, smoke=True)
    tc = TrainConfig(batch=4, seq_len=16, steps=14, peak_lr=5e-3, warmup_steps=2,
                     checkpoint_every=5, log_every=2)
    trainer = Trainer(cfg, tc, device=dev)
    mgr = CheckpointManager(str(TRAIN_CKPT), keep=2)
    fails = {"n": 0}

    def inject(step):
        if step == 8 and fails["n"] < 3:
            fails["n"] += 1
            raise StepFailure("injected")

    reset_counts()
    hist = trainer.fit(DataLoader(cfg, tc.batch, tc.seq_len, seed=0, device=dev), manager=mgr,
                       fail_injector=inject,
                       policy=FaultPolicy(max_retries_per_step=1, max_total_failures=8))
    k4 = read_counts()["k4"]
    check(hist["restarts"] >= 1, "no checkpoint-restart after the injected failures")
    check(bool(np.isfinite(hist["loss"]).all()) and hist["loss"][-1] < hist["loss"][0] + 0.5,
          f"losses {hist['loss']}")
    check(mgr.latest_step() == 14, f"latest checkpoint {mgr.latest_step()}, not 14")
    restored, meta = mgr.restore(trainer.abstract_state(), device=dev)
    same = [torch.equal(a, b) for a, b in zip(leaves(restored), leaves(trainer.state))]
    check(all(same) and len(same) == len(leaves_with_path(trainer.state)),
          "step 14's checkpoint does not restore to the final state bit for bit")
    check(meta["meta"]["loader_state"] == {"step": 14, "seed": 0}, f"loader state {meta}")
    print(f"phase 16d: {cfg.name} on the card, 14 steps with 3 injected failures at step 8: "
          f"restarts={hist['restarts']}, checkpoints {mgr.all_steps()}, loss "
          f"{hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, K4 {k4} launches; step 14 "
          f"restored bit-equal ({len(same)} leaves)")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return dict(restarts=hist["restarts"], k4=k4, loss=hist["loss"])


REMAT_POLICIES = ("none", "minimal", "dots")
REMAT_STEPS = 4          # timed steps a policy, after one that warms up


def phase_remat(dev, control: float) -> dict:
    """Phase 16e: FULL llama3.2-1b (bf16 forward over f32 master weights,
    the launcher's 8 x 128 batch, seed-0 weights drawn on the card) under
    each remat policy from the same state and batch: ``remat=False``
    (``none``), ``minimal`` and ``dots`` (llama3.2-1b's own). For each: one
    forward under ``remat.measure_keep`` (the bytes its operations made
    that are alive when it returns: what the step keeps for the backward,
    the bf16 weights among them) beside ``memory_allocated``'s growth over
    it; the backward, K4 counted on either side (the forward once a layer;
    the backward once a layer more under remat, its recompute); then
    ``REMAT_STEPS`` timed ``step_fn`` calls (host clock, each ended by
    reading its loss) and the peak of ``max_memory_allocated`` over them.
    Held: the kept bytes ordered ``minimal`` < ``dots`` < ``none``; each
    policy's gradients equal ``none``'s bit for bit, or each leaf within
    ``control``, phase 16c's one-ulp control (printed: which held). The
    peak is printed, not held to an order: the functional AdamW update, not
    the activations, may set it."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import remat
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, unflatten

    free_weights()
    base = get_config(TRAIN_ARCH)
    tc = TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(base, TRAIN_BATCH, TRAIN_SEQ, seed=0).items()}
    state = Trainer(base, tc, device=dev).init_state()
    rows, want = {}, None
    for pol in REMAT_POLICIES:
        cfg = base.replace(remat=False) if pol == "none" else base.replace(remat_policy=pol)
        tr = Trainer(cfg, tc, device=dev)
        flat = [p.detach().requires_grad_(True) for p in leaves(state.params)]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reset_counts()
        (loss, _), kept = remat.measure_keep(tr.model.loss_fn, unflatten(state.params, flat),
                                             batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        k4_fwd = read_counts()["k4"]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        torch.cuda.synchronize()
        k4_bwd = read_counts()["k4"] - k4_fwd
        check(k4_fwd == cfg.num_layers and k4_bwd == cfg.num_layers * (forward_runs(cfg) - 1),
              f"{pol}: K4 {k4_fwd} in the forward and {k4_bwd} in the backward")
        grads = [g.cpu() for g in grads]
        del loss, flat
        if want is None:
            want, equal, worst = grads, True, 0.0
        else:
            equal = all(torch.equal(g, w) for g, w in zip(grads, want))
            worst = max(max_rel(g, w) for g, w in zip(grads, want))
            check(equal or worst <= control,
                  f"{pol}: gradients differ from remat=False's by {worst:.3g} of a leaf's "
                  f"largest, past phase 16c's one-ulp control {control:.3g}")
        del grads
        free_weights()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(REMAT_STEPS + 1):
            t0 = time.perf_counter()
            new_state, metrics = tr.step_fn(state, batch)
            float(metrics["loss"])
            step_ms.append(1e3 * (time.perf_counter() - t0))
            del new_state, metrics
        peak = torch.cuda.max_memory_allocated()
        rows[pol] = dict(kept_bytes=kept, held_bytes=held, peak_bytes=peak,
                         step_ms=step_ms[1:], step_p50_ms=statistics.median(step_ms[1:]),
                         k4_forward=k4_fwd, k4_backward=k4_bwd, grads_bit_equal=equal,
                         grad_rel_err=worst)
        print(f"phase 16e {cfg.name} FULL remat {pol}: kept {kept:,} B for the backward "
              f"(memory_allocated grew {held:,} B over the forward); step p50 "
              f"{rows[pol]['step_p50_ms']:.2f} ms ({', '.join(f'{m:.1f}' for m in step_ms[1:])}); "
              f"peak {peak / 1e9:.2f} GB; K4 {k4_fwd} forward + {k4_bwd} backward; gradients "
              + ("(the reference)" if pol == "none" else "bit-equal to remat=False's" if equal
                 else f"within {worst:.3g} of remat=False's (control {control:.3g})"))
    kept = [rows[p]["kept_bytes"] for p in ("minimal", "dots", "none")]
    check(kept[0] < kept[1] < kept[2], f"kept bytes not ordered minimal < dots < none: {kept}")
    del state, batch, want
    free_weights()
    return dict(rows, control=control)


def phase_training(dev) -> dict:
    """Phase 16: 16a-16e. Returns the main path's numbers (16b) with the
    others' beside them."""
    t0 = time.perf_counter()
    functions = timed("16a K4/K5 Functions", phase_train_functions, dev)
    train = timed("16b training", phase_train, dev)
    lanes = timed("16c f32 step on both lanes", phase_train_lanes, dev)
    restart = timed("16d restart from a checkpoint", phase_train_restart, dev)
    policies = timed("16e remat policies", phase_remat, dev, lanes["control_grad_err"])
    seconds = time.perf_counter() - t0
    print(f"[phase 16: {seconds:.1f}s]")
    return dict(train, functions=functions, lanes=lanes, restart=restart, remat=policies,
                phase_seconds=seconds)


# --- Training on a mesh (phase 17) ------------------------------------------

MESH_STEPS, MESH_DEVICES = 6, 4                    # a 2x2 (data, model) mesh on one card
MESH_ARGS = ["--arch", TRAIN_ARCH, "--steps", str(MESH_STEPS), "--batch", str(TRAIN_BATCH),
             "--seq", str(TRAIN_SEQ), "--model-parallel", "2"]
POD_ARGS = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "4", "--batch", "8", "--seq", "32",
            "--model-parallel", "2", "--pods", "2"]
# Phase 17c, one f32 step at FULL width, mesh against one device: the loss
# within 1e-4 relative; each leaf's gathered gradient within 1e-3 of its
# largest value, or a leaf the one-ulp control parts past 1e-3 too (tensor
# parallelism reorders f32 sums as a last-bit change would; phase 16c's
# rule), and then by at most MESH_ESCAPE times the control's error: the
# mesh reorders every sum, not one input's last bit, so it parts further
# (at most 8.4 x the control on the H100, embed/embedding), but a fault
# that is no rounding parts past any such multiple.
MESH_LOSS_RTOL, MESH_GRAD_TOL, MESH_ESCAPE = 1e-4, 1e-3, 16.0


def phase_mesh_train(dev, single: dict) -> dict:
    """Phase 17a, the mesh slice's main path (see the module docstring);
    ``single`` holds phase 16b's numbers from this run. Returns the mesh
    trainer with its numbers (17b reshards its state)."""
    from repro_torch.data.loader import DataLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as attn_mod
    from repro_torch.sharding.placed import Placed, gather
    from repro_torch.tree import leaves_with_path

    plain_calls = []
    real_dot = attn_mod.dot_attention

    def counted_dot(*a, **kw):
        plain_calls.append(1)
        return real_dot(*a, **kw)

    free_weights()
    torch.cuda.reset_peak_memory_stats()
    attn_mod.dot_attention = counted_dot
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = launch_train.main(MESH_ARGS, devices=[dev] * MESH_DEVICES)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        attn_mod.dot_attention = real_dot
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist, trainer, mesh = out["history"], out["trainer"], out["mesh"]
    cfg = trainer.cfg
    check(mesh.shape == {"data": 2, "model": 2} and trainer.mesh is mesh,
          f"the launcher built mesh {mesh.shape} (trainer mesh {trainer.mesh})")
    check(out["param_count"] == TRAIN_PARAMS, f"{cfg.name} has {out['param_count']:,} params")
    per_step = cfg.num_layers * mesh.size * trainer.tc.microbatches * forward_runs(cfg)
    check(counts["k4"] == per_step * MESH_STEPS,
          f"mesh training launched K4 {counts['k4']} times, not {per_step * MESH_STEPS}")
    check(all(counts[k] == 0 for k in COUNTS if k != "k4"), f"mesh training launched {counts}")
    check(not plain_calls, f"mesh training called the plain attention {len(plain_calls)} times")
    check(hist["step"] == list(range(1, MESH_STEPS + 1)), f"steps logged {hist['step']}")
    check(all(np.isfinite(hist["loss"])) and all(np.isfinite(hist["grad_norm"]))
          and min(hist["grad_norm"]) > 0, f"losses {hist['loss']}, grad norms {hist['grad_norm']}")
    check(hist["lr"][0] == 0.0 and hist["lr"][1] > 0, f"lr {hist['lr'][:2]}")
    unmoved, wrong = [], []
    for path, leaf in leaves_with_path(trainer.state.params):
        name = "/".join(path)
        check(isinstance(leaf, Placed), f"{name} is not placed on the mesh")
        wrong += [name for pos, t in leaf.shards.items() if t.device != mesh.device(pos)]
        if torch.equal(gather(leaf), redraw_leaf(trainer.model, name, dev)):
            unmoved.append(name)
    check(not unmoved, f"parameters unchanged after {MESH_STEPS} steps: {unmoved}")
    check(not wrong, f"shards off their positions' devices: {wrong}")
    step_ms = [1e3 * t for t in trainer.monitor.history[1:]]      # the first step warms up
    p50 = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    loader = DataLoader(cfg, TRAIN_BATCH, TRAIN_SEQ, mesh=mesh, seed=0)
    batch = next(loader)
    loader.close()
    state = trainer.state

    def one_step():
        new_state, metrics = trainer.step_fn(state, batch)
        float(metrics["loss"])

    busy_us, span_us, k4_us = device_profile("one mesh training step", one_step, top=12,
                                             kernel="flash_kernel")
    stats = dict(k4=counts["k4"], k4_per_step=counts["k4"] // MESH_STEPS, steps=MESH_STEPS,
                 mesh=mesh.shape, loss=hist["loss"], grad_norm=hist["grad_norm"],
                 step_ms=step_ms, step_p50_ms=p50, tok_s=tokens / (p50 / 1e3),
                 peak_gb=peak_gb, seconds=seconds, step_idle=1 - busy_us / span_us,
                 step_busy_us=busy_us, k4_share=k4_us / busy_us,
                 k4_device_us=k4_us / per_step, single_step_p50_ms=single["step_p50_ms"],
                 single_tok_s=single["tok_s"], single_peak_gb=single["peak_gb"],
                 single_step_idle=single["step_idle"], single_busy_us=single["step_busy_us"])
    print(f"phase 17a: {cfg.name} FULL on a {mesh.shape} mesh of {MESH_DEVICES} x {dev} "
          f"trained {MESH_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in {seconds:.1f} s: "
          f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}; step p50 {p50:.2f} ms "
          f"({', '.join(f'{m:.1f}' for m in step_ms)}), {stats['tok_s']:.0f} tok/s; K4 "
          f"{counts['k4']} launches ({stats['k4_per_step']} a step), plain attention calls 0; "
          f"max_memory_allocated {peak_gb:.2f} GB; one step's device time {busy_us / 1e3:.1f} "
          f"ms, idle {100 * stats['step_idle']:.1f}%, K4 {100 * stats['k4_share']:.2f}% "
          f"({stats['k4_device_us']:.1f} us a launch). Phase 16b on one device: step p50 "
          f"{single['step_p50_ms']:.2f} ms ({p50 / single['step_p50_ms']:.2f}x), "
          f"{single['tok_s']:.0f} tok/s, {single['peak_gb']:.2f} GB, device time "
          f"{single['step_busy_us'] / 1e3:.1f} ms, idle {100 * single['step_idle']:.1f}%")
    del batch, state
    return stats, trainer


def phase_mesh_reshard(dev, trainer) -> dict:
    """Phase 17b: the trained 2x2 state resharded onto a 1x2 mesh of the
    same card (``runtime.elastic.reshard``, its logical axes, train rules):
    every leaf gathered from the new mesh equal bit for bit to the old,
    every new shard on its position's device."""
    from repro_torch.runtime.elastic import make_mesh, reshard
    from repro_torch.sharding.placed import Placed, gather
    from repro_torch.tree import leaves, leaves_with_path

    small = make_mesh([dev] * 2, model_parallel=2)
    t0 = time.perf_counter()
    new = reshard(trainer.state, trainer.state_axes(), small, trainer.abstract_state(),
                  rules="train")
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    differ = []
    for (path, a), b in zip(leaves_with_path(new), leaves(trainer.state)):
        if isinstance(a, Placed):
            check(a.mesh is small and all(t.device == small.device(p) for p, t in
                                          a.shards.items()), f"{path} is not on the 1x2 mesh")
        if not torch.equal(gather(a), gather(b)):
            differ.append("/".join(path))
    check(not differ, f"leaves changed by the reshard to 1x2: {differ}")
    n = len(leaves(new))
    print(f"phase 17b: reshard {trainer.mesh.shape} -> {small.shape}: {n} leaves bit-equal, "
          f"{ms:.1f} ms")
    del new
    return dict(leaves=n, ms=ms, bit_equal=True)


def mesh_layer_local(cfg, params, batch, trainer, control: bool = False) -> dict:
    """The mesh's parts against one device's, part by part (phase 16c's
    ``train_layer_local`` for the mesh): the embedding, each block and the
    head, each run once on one device and once on ``trainer``'s mesh from
    the same input, and differentiated against cotangents drawn on the card
    (seed 0, new ones a part). The embedding (``transformer.mesh_embed``:
    the table FSDP-gathered over ``data``, its ``d_model`` columns
    all-gathered over ``model``) takes a cotangent of its own at each
    position, and one device the sum of its ``model`` group's; each block
    (``transformer.mesh_block`` on the FSDP-gathered weights of that layer,
    K4 on each position's heads, the all-reduces over ``model``) and the
    head (``transformer.mesh_unembed``: the final norm and the
    vocab-parallel logits, gathered over ``model``) start from one device's
    f32 hidden state. Held: each part's output, its weights' gradients
    (reduce-scattered and replica-summed onto their shards, then gathered)
    and its input's gradient (summed over the ``model`` copies) within
    ``TRAIN_GRAD_TOL`` of one device's largest value. With ``control``
    (phases 18-19), each block also runs on one device from its input
    moved by one ulp (``ulp_moved``), and a block's gradient may part past
    ``TRAIN_GRAD_TOL`` by at most ``MESH_ESCAPE`` times that control's
    (phase 18's rule, ``FAMILY_F64_TOL``'s comment); its output is held
    within ``TRAIN_GRAD_TOL`` all the same. The blocks run in
    ``transformer.block_plan``'s order (``block_plan``).
    Returns the worst of each, and the embedding's and the head's on
    their own."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import torch_dtype
    from repro_torch.sharding.placed import Placed, gather, place, reduce_replicas
    from repro_torch.sharding.rules import PartitionSpec
    from repro_torch.tree import leaves, leaves_with_path, tree_map, unflatten

    mesh = trainer.mesh
    specs = trainer.state_shardings().params
    dtype = torch_dtype(cfg.dtype)
    tokens = place(batch["tokens"], trainer_batch_sharding(trainer, batch))
    mi = mesh.axis_names.index("model")
    active = T._active_positions(mesh, tokens)
    heads = [p for p in active if p[mi] == 0]
    rows = {p: tokens.bounds(p)[0] for p in active}
    gen = torch.Generator(device=tokens.local(active[0]).device).manual_seed(0)
    out = dict(out_err=0.0, grad_err=0.0, grad_leaf="")

    def on_mesh(tree, sh):
        """``tree``'s leaves placed by ``sh``, each shard a leaf of the graph."""
        return tree_map(lambda t, s: place(t.detach(), s).map(lambda u: u.requires_grad_(True)),
                        tree, sh)

    def mesh_grads(placed, loss, inputs):
        """The placed leaves' gradients, replica-summed and gathered, and the inputs'."""
        shards = [t for leaf in leaves(placed) for t in leaf.shards.values()]
        got = iter(torch.autograd.grad(loss, shards + inputs, allow_unused=True))
        grads = []
        for leaf in leaves(placed):
            g = {p: (lambda t, s: torch.zeros_like(s) if t is None else t)(next(got), s)
                 for p, s in leaf.shards.items()}
            grads.append(gather(reduce_replicas(Placed(leaf.mesh, leaf.spec, leaf.shape, g))))
        return grads, list(got)

    def hold(part, y_mesh, y, names, got, want, ctl=None, ctl_out=0.0):
        err = max_rel(y_mesh.detach(), y.detach())
        check(err <= TRAIN_GRAD_TOL, f"{part}: the mesh's output differs from one device's "
                                     f"by {err:.3g} > {TRAIN_GRAD_TOL}")
        out["out_err"] = max(out["out_err"], err)
        errs = [max_rel(g, w) for g, w in zip(got, want)]
        ctls = [max_rel(c, w) for c, w in zip(ctl, want)] if ctl else [0.0] * len(errs)
        out[part] = dict(out_err=err, grad_err=max(errs), control_err=max(ctls),
                         control_out_err=ctl_out)
        for name, err, c in zip(names, errs, ctls):
            check(err <= TRAIN_GRAD_TOL or bool(ctl) and err <= MESH_ESCAPE * c,
                  f"{part} {name}: the mesh's gradient differs from one device's by {err:.3g} "
                  f"> {TRAIN_GRAD_TOL}" + (f", where the one-ulp control parts them by {c:.3g}"
                                           if ctl else ""))
            if err >= out["grad_err"]:
                out["grad_err"], out["grad_leaf"] = err, f"{part}/{name}"
            if err > TRAIN_GRAD_TOL:
                out.setdefault("past_tol", []).append(f"{part}/{name}: {err:.3g}, control {c:.3g}")

    def row_sum(per_pos, like):
        """Per-position tensors summed into one device's rows."""
        whole = torch.zeros_like(like)
        for p, t in per_pos.items():
            if t is not None:
                whole[rows[p][0]:rows[p][1]] += t
        return whole

    # The embedding, from the tokens (a VLM's patches prepended, an encdec
    # model's sinusoid added).
    emb = {"embed": {"embedding": params["embed"]["embedding"]}}
    table = emb["embed"]["embedding"].detach().requires_grad_(True)
    x = T._prepare_inputs({"embed": {"embedding": table}}, cfg, batch, dtype)[0]
    placed = on_mesh(emb, {"embed": {"embedding": specs["embed"]["embedding"]}})
    patches = (place_batch_key(trainer, batch, "patch_embeds") if "patch_embeds" in batch
               else None)
    xs = T.mesh_embed(T._position_weights(placed, mesh, dtype, active), placed, cfg, tokens,
                      mesh, dtype, patch_embeds=patches)
    cots = {p: torch.randn(xs[p].shape, generator=gen, device=xs[p].device, dtype=xs[p].dtype)
            for p in active}
    want = torch.autograd.grad((x * row_sum(cots, x)).sum(), [table])
    got, _ = mesh_grads(placed, sum((xs[p] * cots[p]).sum() for p in active), [])
    hold("embed", torch.cat([xs[p] for p in heads]), x, ["embedding"], got, want)
    del emb, table, placed, xs, cots, got, want

    # Each block, from one device's hidden state (an encoder's from the
    # frames, an encdec decoder's with one device's encoder output).
    x, pos = T._prepare_inputs(params, cfg, batch, dtype)
    x = x.detach()
    if pos is None:                                   # an ssm model takes no positions
        pos = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    stream = {"dec": (x, pos)}
    if cfg.family == "encdec":
        frames = batch["enc_embeds"]
        enc_pos = torch.arange(frames.shape[1], dtype=torch.int32, device=x.device)[None].expand(
            frames.shape[0], frames.shape[1])
        stream["enc"] = ((frames.to(dtype) + T._sinusoid(enc_pos, cfg.d_model).to(dtype)).detach(),
                         enc_pos)
    enc_out = None
    for i, (part, lp, lp_specs, blk) in enumerate(block_plan(cfg, params, specs)):
        x, pos = stream[blk.stream]
        if blk.stream == "dec" and "enc" in stream and enc_out is None:
            enc_out = T.apply_norm(params["encoder"]["final_norm"], cfg, stream["enc"][0]).detach()
        enc = enc_out if "cross" in lp else None
        causal = blk.causal
        names = ["/".join(p) for p, _ in leaves_with_path(lp)] + ["input"] + (
            ["encoder output"] if enc is not None else [])
        n_w = len(leaves(lp))
        cot = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        flat = [t.detach().requires_grad_(True) for t in leaves(lp) + [x] + (
            [enc] if enc is not None else [])]
        y, aux = one_block(unflatten(lp, flat[:n_w]), cfg, flat[n_w], pos, causal,
                           flat[n_w + 1] if enc is not None else None)
        want = torch.autograd.grad((y * cot).sum() + sum(aux.values(), torch.zeros(
            (), device=y.device)), flat)
        ctl, ctl_out = None, 0.0
        if control:
            cflat = [t.detach().requires_grad_(True) for t in leaves(lp)] + [
                ulp_moved(x, seed=i).requires_grad_(True)] + (
                [enc.detach().requires_grad_(True)] if enc is not None else [])
            yc, auxc = one_block(unflatten(lp, cflat[:n_w]), cfg, cflat[n_w], pos, causal,
                                 cflat[n_w + 1] if enc is not None else None)
            ctl_out = max_rel(yc.detach(), y.detach())
            ctl = torch.autograd.grad((yc * cot).sum() + sum(auxc.values(), torch.zeros(
                (), device=yc.device)), cflat)
            del yc, auxc, cflat
        placed = on_mesh(lp, lp_specs)
        w = T._position_weights(placed, mesh, dtype, active)
        xs = {p: x[a:b].clone().requires_grad_(True) for p, (a, b) in rows.items()}
        encs = None if enc is None else {p: enc[a:b].clone().requires_grad_(True)
                                         for p, (a, b) in rows.items()}
        ys, aux_m = T.mesh_block(w, cfg, xs, {p: pos[a:b] for p, (a, b) in rows.items()}, mesh,
                                 causal=causal, enc=encs)
        check(set(aux_m) == set(aux), f"{part}: the mesh's aux losses {sorted(aux_m)}, one "
                                      f"device's {sorted(aux)}")
        for name in aux:
            err = abs(float(aux_m[name].detach()) - float(aux[name].detach())) / abs(
                float(aux[name].detach()))
            check(err <= TRAIN_GRAD_TOL, f"{part}: the mesh's {name} differs from one "
                                         f"device's by {err:.3g} > {TRAIN_GRAD_TOL}")
            out["aux_err"] = max(out.get("aux_err", 0.0), err)
        loss = sum((ys[p] * cot[rows[p][0]:rows[p][1]]).sum() for p in heads) + sum(
            (v.to(ys[heads[0]].device) for v in aux_m.values()),
            torch.zeros((), device=ys[heads[0]].device))
        inputs = [xs[p] for p in active] + ([encs[p] for p in active] if encs else [])
        grads, dxs = mesh_grads(placed, loss, inputs)
        in_grads = [row_sum(dict(zip(active, dxs[:len(active)])), x)] + (
            [row_sum(dict(zip(active, dxs[len(active):])), enc)] if encs else [])
        hold(part, torch.cat([ys[p] for p in heads]), y, names, grads + in_grads, want, ctl,
             ctl_out)
        stream[blk.stream] = (y.detach(), pos)
    x = stream["dec"][0]

    # The head, from the last block's output.
    head = {"embed": {"lm_head": params["embed"]["lm_head"]}, "final_norm": params["final_norm"]}
    names = ["/".join(p) for p, _ in leaves_with_path(head)] + ["input"]
    flat = [t.detach().requires_grad_(True) for t in leaves(head) + [x]]
    one = unflatten(head, flat[:-1])
    logits = T.unembed(one, cfg, T.apply_norm(one["final_norm"], cfg, flat[-1]))
    cot = torch.randn(logits.shape, generator=gen, device=logits.device, dtype=logits.dtype)
    want = torch.autograd.grad((logits * cot).sum(), flat)
    placed = on_mesh(head, {"embed": {"lm_head": specs["embed"]["lm_head"]},
                            "final_norm": specs["final_norm"]})
    xs = {p: x[a:b].clone().requires_grad_(True) for p, (a, b) in rows.items()}
    ls = T.mesh_unembed(T._position_weights(placed, mesh, dtype, active), placed, cfg, xs, mesh)
    loss = sum((ls[p] * cot[rows[p][0]:rows[p][1]]).sum() for p in ls)
    grads, dxs = mesh_grads(placed, loss, [xs[p] for p in active])
    hold("head", torch.cat([ls[p] for p in ls]), logits, names,
         grads + [row_sum(dict(zip(active, dxs)), x)], want)
    return out


def one_block(lp, cfg, x, pos, causal: bool = True, enc_out=None):
    """One device's block (``_apply_mamba_block`` or ``_apply_attn_block``,
    non-causal for an encoder's, with cross-attention over ``enc_out``
    for an encdec decoder's): (its output, its aux losses, ``{}`` but for
    the moe family)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import cross_kv

    if "mamba" in lp:
        return T._apply_mamba_block(lp, cfg, x)[0], {}
    enc_kv = None if enc_out is None else cross_kv(lp["cross"], cfg, enc_out)
    y, _, aux = T._apply_attn_block(lp, cfg, x, pos, causal=causal, enc_kv=enc_kv)
    return y, aux


def block_plan(cfg, params, specs) -> list:
    """Every block of one forward in ``transformer.block_plan``'s order:
    (label, its weights on one device, their train-rule shardings, its
    ``transformer.Block``)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.rules import PartitionSpec
    from repro_torch.tree import tree_map

    def layer_specs(sh):
        return tree_map(lambda x: type(x)(x.mesh, PartitionSpec(*tuple(x.spec)[1:])), sh)

    plan, shared = [], 0
    for blk in T.block_plan(cfg):
        if blk.layer == "shared":
            plan.append((f"shared {shared}", params["shared"], specs["shared"], blk))
            shared += 1
            continue
        tree, sh = (params["encoder"], specs["encoder"]) if blk.stream == "enc" else (params, specs)
        label = "encoder" if blk.stream == "enc" else "layer"
        plan.append((f"{label} {blk.layer}", T._layer(tree["layers"], blk.layer),
                     layer_specs(sh["layers"]), blk))
    return plan


def place_batch_key(trainer, batch, key):
    """``batch[key]`` placed on ``trainer``'s mesh by the ``batch`` rule."""
    from repro_torch.data.loader import batch_shardings
    from repro_torch.sharding.placed import place

    return place(batch[key], batch_shardings({key: batch[key]}, trainer.mesh)[key])


def trainer_batch_sharding(trainer, batch):
    """The ``batch`` rule's placement of the tokens on ``trainer``'s mesh."""
    from repro_torch.data.loader import batch_shardings

    return batch_shardings({"tokens": batch["tokens"]}, trainer.mesh)["tokens"]


def phase_mesh_f32_step(dev) -> dict:
    """Phase 17c: one f32 step's loss and gradients at FULL width on the
    2x2 mesh (K4 on every position) and on one device (K4), from the same
    weights drawn on the card (seed 0) and the same batch; the one-device
    step with the embeddings moved by one ulp (``ulp_params``) is the
    control. Held: the loss within ``MESH_LOSS_RTOL``; K4 16 x 4 launches;
    each leaf's gathered gradient within ``MESH_GRAD_TOL`` of its largest
    value, or, as in phase 16c, a leaf that the control parts past
    ``MESH_GRAD_TOL`` too, by at most ``MESH_ESCAPE`` times the control's
    error; and the embedding, every block and the head each on its own
    (:func:`mesh_layer_local`)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).replace(dtype="float32")
    tc = TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    params = Model(cfg).init(0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).items()}
    single = Trainer(cfg, tc, device=dev)
    want, want_m = single.grads_of(params, batch)
    mesh = make_mesh([dev] * MESH_DEVICES, model_parallel=2)
    trainer = Trainer(cfg, tc, mesh=mesh)
    placed = tree_map(place, params, trainer.state_shardings().params)
    reset_counts()
    got, got_m = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
    k4 = read_counts()["k4"]
    check(k4 == cfg.num_layers * mesh.size * forward_runs(cfg),
          f"the mesh's f32 step launched K4 {k4} times")
    del placed
    paths = ["/".join(p) for p, _ in leaves_with_path(params)]
    errs = [max_rel(gather(g), w) for g, w in zip(leaves(got), leaves(want))]
    del got
    ctrl, _ = single.grads_of(ulp_params(params), batch)
    control = [max_rel(c, w) for c, w in zip(leaves(ctrl), leaves(want))]
    del ctrl, want
    local = mesh_layer_local(cfg, params, batch, trainer)
    del params
    loss, ref = float(got_m["loss"]), float(want_m["loss"])
    loss_err = abs(loss - ref) / abs(ref)
    check(np.isfinite(loss) and loss_err <= MESH_LOSS_RTOL,
          f"the mesh's f32 loss {loss} differs from one device's {ref} by {loss_err:.3g}")
    for path, err, ctl in zip(paths, errs, control):
        check(err <= MESH_GRAD_TOL or MESH_GRAD_TOL < ctl and err <= MESH_ESCAPE * ctl,
              f"{path}: the mesh's gradient differs from one device's by {err:.3g} of its "
              f"largest, where the one-ulp control parts them by {ctl:.3g}; > {MESH_GRAD_TOL}, "
              f"or > {MESH_ESCAPE} x the control")
    worst = max(range(len(paths)), key=lambda i: errs[i])
    past = [i for i, e in enumerate(errs) if e > MESH_GRAD_TOL]
    ratio = max([errs[i] / control[i] for i in past], default=0.0)
    past = [paths[i] for i in past]
    print(f"phase 17c: one f32 step of {cfg.name} FULL on a {mesh.shape} mesh against one "
          f"device: loss {loss:.6f}, within {loss_err:.3g} relative; K4 {k4} launches; "
          f"gradients within {errs[worst]:.3g} of their largest ({paths[worst]}); the one-ulp "
          f"control parts them by up to {max(control):.3g}; {len(past)} leaves past "
          f"{MESH_GRAD_TOL}, each one the control parts past it too, by at most {ratio:.3g} x "
          f"the control: {past}; the embedding, each block and the head on their own: "
          f"outputs within {local['out_err']:.3g}, gradients within "
          f"{local['grad_err']:.3g} ({local['grad_leaf']}); the embedding's output within "
          f"{local['embed']['out_err']:.3g}, gradient within {local['embed']['grad_err']:.3g}; "
          f"the head's logits within {local['head']['out_err']:.3g}, gradients within "
          f"{local['head']['grad_err']:.3g}")
    free_weights()
    return dict(loss=loss, loss_rel_err=loss_err, grad_err=errs[worst],
                grad_err_leaf=paths[worst], control_grad_err=max(control), past_tol=past,
                past_control_ratio=ratio,
                grad_errs=dict(zip(paths, errs)), control_errs=dict(zip(paths, control)),
                block_out_err=local["out_err"], block_grad_err=local["grad_err"],
                block_grad_leaf=local["grad_leaf"], embed_local=local["embed"],
                head_local=local["head"])


def phase_mesh_pod(dev) -> dict:
    """Phase 17d: SMOKE on a (pod, data, model) = (2, 2, 2) mesh of 8 x the
    card through the launcher: the batch split over (pod, data), the
    weights replicated over pod (their gradients all-reduced over it), K4
    2 layers x 8 positions x 2 (remat's recompute) a step."""
    from repro_torch.launch import train as launch_train

    reset_counts()
    out = launch_train.main(POD_ARGS, devices=[dev] * 8)
    torch.cuda.synchronize()
    k4 = read_counts()["k4"]
    hist, mesh, cfg = out["history"], out["mesh"], out["trainer"].cfg
    check(mesh.shape == {"pod": 2, "data": 2, "model": 2}, f"pod mesh {mesh.shape}")
    check(k4 == cfg.num_layers * mesh.size * len(hist["step"]) * forward_runs(cfg),
          f"pod run K4 {k4}")
    check(bool(np.isfinite(hist["loss"]).all()) and hist["loss"][-1] < hist["loss"][0] + 0.5,
          f"pod run losses {hist['loss']}")
    print(f"phase 17d: {cfg.name} on a {mesh.shape} mesh of 8 x {dev}: {len(hist['step'])} "
          f"steps, loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}, K4 {k4} launches")
    return dict(k4=k4, loss=hist["loss"], mesh=mesh.shape)


def phase_mesh_training(dev, single: dict) -> dict:
    """Phase 17: 17a-17d. Returns the main path's numbers (17a) with the
    others' beside them."""
    t0 = time.perf_counter()
    stats, trainer = timed("17a mesh training", phase_mesh_train, dev, single)
    reshard = timed("17b reshard to 1x2", phase_mesh_reshard, dev, trainer)
    planned = timed("20b planned bytes against the held shards", phase_planned_bytes, trainer)
    del trainer
    free_weights()
    f32 = timed("17c f32 step, mesh against one device", phase_mesh_f32_step, dev)
    pod = timed("17d pod mesh", phase_mesh_pod, dev)
    seconds = time.perf_counter() - t0
    print(f"[phase 17: {seconds:.1f}s]")
    return dict(stats, reshard=reshard, f32=f32, pod=pod, planned=planned,
                phase_seconds=seconds)


# --- Every family but the dense one on a mesh (phases 18 and 19) -------------

# Each at FULL width from its configs/<arch>.py on a 2x2 mesh of one card,
# cut in depth only because the card holds all four positions' state (~30.5
# B a parameter with the bf16 copies and AdamW): (arch, layers, tokens a
# row, the f32 check's layers, the f64 step's layers, its rows, phase).
# Phase 18's f64 step takes 1 layer: 2 do not fit the card with qwen3-moe's
# experts gathered at every position. zamba2's depths stay multiples of
# attn_every = 6 (the f32 check's one group runs the shared block);
# whisper's encoder is cut with its decoder; pixtral's rows hold its 1,024
# patches and the launcher's 128 text tokens, and its one layer and 2-row
# f64 step leave room for the 131,072-wide vocab's logits. falcon-mamba-7b
# (8 layers before) and minicpm3-4b (16 before) are cut to 4 and 8 to keep
# chip_smoke.py under 1,100 s after the card check on a slow host (1,108.3
# s seen with them). The ssm family's shards launch K5, the others' K4.
FAMILY_MESH = ((SSM_ARCH, 4, TRAIN_SEQ, 2, 1, TRAIN_BATCH, "18"),
               (MLA_ARCH, 8, TRAIN_SEQ, 2, 1, TRAIN_BATCH, "18"),
               (MOE_ARCH, 2, TRAIN_SEQ, 2, 1, TRAIN_BATCH, "18"),
               (HYBRID_ARCH, 12, TRAIN_SEQ, 6, 6, TRAIN_BATCH, "19"),
               (ENCDEC_ARCH, 8, TRAIN_SEQ, 2, 2, TRAIN_BATCH, "19"),
               (VLM_ARCH, 1, 1024 + TRAIN_SEQ, 1, 1, 2, "19"))
# Model.param_count() at the main path's depths.
FAMILY_MESH_PARAMS = {SSM_ARCH: 953_929_728, MLA_ARCH: 877_455_872,
                      MOE_ARCH: 1_868_573_184, HYBRID_ARCH: 747_364_160,
                      ENCDEC_ARCH: 499_886_080, VLM_ARCH: 1_614_822_400}
FAMILY_STEPS = 4
# Phase 18's f32 rule: a leaf's gradient within MESH_GRAD_TOL of its
# largest value, or within MESH_ESCAPE times the one-ulp control's
# (``random_ulp_params``; for a block, its input moved so) on that leaf.
# The mesh reorders every sum where the control moves one input's last
# bits, so it parts 2-4x further (1.0-1.55e-3 against controls of
# 4.2-8e-4 on the H100: qwen3-moe's attention and experts, falcon's
# d_skip and layer 0's block); that it is rounding shows in f64, where
# the mesh's arithmetic (the plain lane: the kernels take f32 and bf16;
# every f32 part in f64 too, ``f64_throughout``) stays within
# FAMILY_F64_TOL of one device's: 3.1e-7 seen with the model's f32 parts
# (norm statistics, RoPE) left to round. A fault parts both far past
# these (tools/mesh_family_divergence.py prints every row).
FAMILY_F64_TOL = 1e-5
# At the init's weights a few layers at FULL width are chaotic in f32
# (``fan_in_params`` says why): whisper's one-ulp control moves its
# gradients by their whole size, and a 1% fault in half of pixtral's
# attention heads parts its gradients no further than the control, so the
# rule above cannot fail there. The f32 step is held again at fan-in
# weights, where the control must part every leaf by less than this (up to
# 1.41e-5 seen on the H100), so no leaf may part by more than 16x it; the
# same fault parts them 1,300-29,000x the control there. Not for the moe
# family: its top-k routing is discontinuous, and at fan-in weights the
# mesh's rounding routes one of 16,384 (token, slot) pairs of qwen3-moe to
# another expert (its k-th logit gap 1.55e-6), which moves the gradients by
# 0.089; its f64 step (every route the same) and the routing check hold it.
# tools/mesh_check_sensitivity.py prints both.
FAN_IN_CONTROL_MAX = 1e-3
BLOCKS = ("layer ", "encoder ", "shared ")         # mesh_layer_local's block parts


def cut_config(arch: str, layers: int, **kw):
    """``arch``'s FULL config at ``layers`` layers (an encdec model's
    encoder too): the widths stay."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cut = dict(num_layers=layers, **kw)
    if cfg.family == "encdec":
        cut["encoder_layers"] = layers
    return cfg.replace(**cut)


def launches_a_position(cfg) -> int:
    """K4 or K5 launches of one position in one forward on the mesh: one
    a block of ``transformer.block_plan``, but none for the hybrid's
    Mamba-2 layers (PyTorch ops) and two for an encdec decoder's
    (self-attention and cross-attention)."""
    from repro_torch.models.transformer import block_plan

    return sum(0 if cfg.family == "hybrid" and b.layer != "shared"
               else 2 if cfg.family == "encdec" and b.stream == "dec" else 1
               for b in block_plan(cfg))


def forward_runs(cfg) -> int:
    """How often a training step runs each remat unit's forward (its K4 and
    K5 launches among it): twice where ``cfg`` rematerialises (the
    backward's recompute, ``models/remat.py``), else once."""
    from repro_torch.models import remat

    return remat.forward_runs(cfg)


def mesh_kernel(cfg) -> str:
    """The kernel a family's shards launch on the mesh: K5 for the ssm
    family's Mamba-1 scan, K4 for every other's attention."""
    return "k5" if cfg.family == "ssm" else "k4"


def fan_in_params(cfg, params):
    """``params`` with each leaf of the ``fan_in`` init scaled to the
    standard deviation 1/sqrt(its inputs): its first axis past the layer
    and expert axes (d_model, mlp, ssm_inner, a latent's rank), or heads x
    head_dim for an output projection. The init divides a stacked leaf by
    sqrt(its layer count), as the reference's does, so at a few layers
    and FULL width each product multiplies its input's size by up to
    ~sqrt(d_model): pixtral's one block turns inputs of 0.1 into outputs
    of 2.4e6, one device's own f32 output parts 2.1e-3 from f64, and a
    one-ulp change of whisper's inputs moves its gradients by their whole
    size. At these weights rounding stays small and a wrong gradient
    shows."""
    from repro_torch.models import Model
    from repro_torch.models.layers import map_specs
    from repro_torch.tree import tree_map

    def factor(_path, spec):
        if spec.init != "fan_in":
            return 1.0
        shape, axes = spec.shape, spec.axes
        drawn = max(1, shape[0])
        while axes[0] in ("layers", "experts"):
            shape, axes = shape[1:], axes[1:]
        return (drawn / (shape[0] * (shape[1] if axes[0] == "heads" else 1))) ** 0.5

    factors = map_specs(factor, Model(cfg).param_specs())
    return tree_map(lambda t, f: t if f == 1.0 else t * f, params, factors)


def ulp_frontends(batch: dict) -> dict:
    """The batch with its frontend inputs (an encdec model's frames, a
    VLM's patches) moved one ulp at random: the encoder sees no token
    embedding, so its part of the one-ulp control moves the frames."""
    return {k: ulp_moved(v, seed=1) if k in ("enc_embeds", "patch_embeds") else v
            for k, v in batch.items()}


def phase_family_mesh_train(dev, arch: str, layers: int, seq: int, phase: str) -> dict:
    """Phases 18 and 19, one family's main path: ``arch`` at FULL width and
    ``layers`` layers on a 2x2 mesh of ``[dev] * 4``, ``seq`` tokens a row,
    the ``Trainer`` and ``DataLoader`` that ``launch.train`` builds, ``fit``
    for ``FAMILY_STEPS`` steps, counts set to 0 just before and read just
    after: its kernel (``mesh_kernel``) exactly ``launches_a_position`` x 4
    positions x ``forward_runs`` a step and no other kernel, no plain attention
    (``dot_attention``) or plain scan (``ssm.selective_scan``) call; losses
    and grad norms finite, every parameter moved, every shard on its position's device; one more step under the
    profiler (its metrics: a moe model's ``moe_aux`` and ``moe_z``, finite).
    Prints the step p50, tok/s, ``max_memory_allocated`` and the profiled
    step's device idle share and the kernel's share."""
    from repro_torch.configs import get_config
    from repro_torch.data.loader import DataLoader
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import Placed, gather
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves_with_path

    plain_calls = []
    real = (attn_mod.dot_attention, ssm_mod.selective_scan)

    def counted(fn):
        def call(*a, **kw):
            plain_calls.append(fn.__name__)
            return fn(*a, **kw)
        return call

    free_weights()
    torch.cuda.reset_peak_memory_stats()
    # what launch.train.main builds for --steps FAMILY_STEPS --model-parallel 2 at the
    # reference launcher's batch (the launcher has no depth flag)
    cfg = cut_config(arch, layers)
    kernel = mesh_kernel(cfg)
    mesh = make_mesh([dev] * MESH_DEVICES, model_parallel=2)
    tc = TrainConfig(batch=TRAIN_BATCH, seq_len=seq, steps=FAMILY_STEPS,
                     checkpoint_every=max(10, FAMILY_STEPS // 5),
                     log_every=max(1, FAMILY_STEPS // 20))
    trainer = Trainer(cfg, tc, mesh=mesh, device=dev)
    loader = DataLoader(cfg, tc.batch, tc.seq_len, mesh=mesh, seed=tc.seed, device=dev)
    attn_mod.dot_attention, ssm_mod.selective_scan = (counted(f) for f in real)
    try:
        reset_counts()
        t0 = time.perf_counter()
        hist = trainer.fit(loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        attn_mod.dot_attention, ssm_mod.selective_scan = real
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = trainer.model.param_count()
    check(n_params == FAMILY_MESH_PARAMS[arch], f"{cfg.name} at {layers} layers has "
                                                f"{n_params:,} params")
    per_step = (launches_a_position(cfg) * mesh.size * trainer.tc.microbatches
                * forward_runs(cfg))
    check(counts[kernel] == per_step * FAMILY_STEPS,
          f"{cfg.name} mesh training launched {kernel.upper()} {counts[kernel]} times, not "
          f"{per_step * FAMILY_STEPS}")
    check(all(counts[k] == 0 for k in COUNTS if k != kernel),
          f"{cfg.name} mesh training launched {counts}")
    check(not plain_calls, f"{cfg.name} mesh training called the plain lane: {plain_calls}")
    check(hist["step"] == list(range(1, FAMILY_STEPS + 1)), f"steps logged {hist['step']}")
    check(all(np.isfinite(hist["loss"])) and all(np.isfinite(hist["grad_norm"]))
          and min(hist["grad_norm"]) > 0, f"losses {hist['loss']}, grad norms {hist['grad_norm']}")
    unmoved, wrong = [], []
    for path, leaf in leaves_with_path(trainer.state.params):
        name = "/".join(path)
        check(isinstance(leaf, Placed), f"{name} is not placed on the mesh")
        wrong += [name for pos, t in leaf.shards.items() if t.device != mesh.device(pos)]
        if torch.equal(gather(leaf), redraw_leaf(trainer.model, name, dev)):
            unmoved.append(name)
    check(not unmoved, f"{cfg.name}: parameters unchanged after {FAMILY_STEPS} steps: {unmoved}")
    check(not wrong, f"{cfg.name}: shards off their positions' devices: {wrong}")
    step_ms = [1e3 * t for t in trainer.monitor.history[1:]]      # the first step warms up
    p50 = statistics.median(step_ms)
    loader = DataLoader(cfg, TRAIN_BATCH, seq, mesh=mesh, seed=0)
    batch = next(loader)
    loader.close()
    state, metrics = trainer.state, {}

    def one_step():
        metrics.update(trainer.step_fn(state, batch)[1])
        float(metrics["loss"])

    name = "selective_scan" if kernel == "k5" else "flash_kernel"
    t_prof = time.perf_counter()
    busy_us, span_us, k_us = device_profile(f"one {cfg.name} mesh training step", one_step,
                                            top=12, kernel=name, host=False)
    t_prof = time.perf_counter() - t_prof
    shard = None
    if kernel == "k4":                # K4 timed at the shard's shape, beside SDPA and its bound
        mla = cfg.attn_type == "mla"
        d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim if mla else cfg.head_dim
        shape = (TRAIN_BATCH // 2, cfg.num_heads // 2, seq, seq, d)
        shard = k4_training_shape(dev, shape, cfg.v_head_dim if mla else 0)
        if cfg.family == "encdec":     # the encoder's and the cross-attention's, non-causal
            shard = dict(causal=shard, non_causal=k4_training_shape(dev, shape, causal=False))
    aux = {k: float(metrics[k]) for k in ("moe_aux", "moe_z") if k in metrics}
    check(set(aux) == ({"moe_aux", "moe_z"} if cfg.family == "moe" else set())
          and all(np.isfinite(list(aux.values()))), f"{cfg.name}: aux losses {aux}")
    tokens = TRAIN_BATCH * seq
    stats = dict(layers=cfg.num_layers, param_count=n_params, kernel=kernel, seq=seq,
                 launches=counts[kernel], per_step=per_step, loss=hist["loss"],
                 grad_norm=hist["grad_norm"], aux=aux, step_ms=step_ms, step_p50_ms=p50,
                 tok_s=tokens / (p50 / 1e3), peak_gb=peak_gb, seconds=seconds,
                 step_idle=1 - busy_us / span_us, step_busy_us=busy_us,
                 kernel_share=k_us / busy_us, kernel_device_us=k_us / per_step,
                 profile_seconds=t_prof, k4_shard=shard)
    print(f"phase {phase} {cfg.name}: FULL width, {cfg.num_layers} layers ({n_params:,} "
          f"params) on a {mesh.shape} mesh of {MESH_DEVICES} x {dev}, {FAMILY_STEPS} steps of "
          f"{TRAIN_BATCH}x{seq} tokens in {seconds:.1f} s: loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f}{f', aux {aux}' if aux else ''}; step p50 {p50:.2f} ms "
          f"({', '.join(f'{m:.1f}' for m in step_ms)}), {stats['tok_s']:.0f} tok/s; "
          f"{kernel.upper()} {counts[kernel]} launches ({per_step} a step), plain calls 0; "
          f"max_memory_allocated {peak_gb:.2f} GB; one step's device time "
          f"{busy_us / 1e3:.1f} ms, idle {100 * stats['step_idle']:.1f}%, {kernel.upper()} "
          f"{100 * stats['kernel_share']:.2f}% ({stats['kernel_device_us']:.1f} us a launch); "
          f"the profiled step took {t_prof:.1f} s")
    del trainer, state, batch
    free_weights()
    return stats


def moe_routing_at_full(cfg, params, batch, trainer) -> dict:
    """The MoE of layer 0 on one device's own input (its normed hidden
    state after layer 0's attention, on one device), run by ``moe.
    apply_moe`` on one device and by ``moe.moe_mesh`` on the mesh from the
    same input split into its batch shards: at FULL qwen3-moe the routing
    group is the whole microbatch's 1,024 tokens, which spans both
    shards. The (token,
    expert) slots kept (``record_routing``) must be equal, the chosen
    experts too; the outputs and aux losses are held within
    ``TRAIN_GRAD_TOL``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import apply_attention
    from repro_torch.models.layers import apply_norm, torch_dtype
    from repro_torch.models.moe import apply_moe, group_size, moe_mesh, record_routing
    from repro_torch.sharding.placed import place
    from repro_torch.sharding.rules import PartitionSpec
    from repro_torch.tree import tree_map

    mesh = trainer.mesh
    dtype = torch_dtype(cfg.dtype)
    lp = T._layer(params["layers"], 0)
    with torch.no_grad():
        x, pos = T._prepare_inputs(params, cfg, batch, dtype)
        x = x + apply_attention(lp["attn"], cfg, apply_norm(lp["ln1"], cfg, x), pos)[0]
        y = apply_norm(lp["ln2"], cfg, x)
        with record_routing() as one:
            want, want_aux = apply_moe(lp["ffn"], cfg, y)
        specs = tree_map(lambda sh: type(sh)(sh.mesh, PartitionSpec(*tuple(sh.spec)[1:])),
                         trainer.state_shardings().params["layers"]["ffn"])
        placed = {"ffn": tree_map(place, lp["ffn"], specs)}
        tokens = place(batch["tokens"], trainer_batch_sharding(trainer, batch))
        active = T._active_positions(mesh, tokens)
        w = T._position_weights(placed, mesh, dtype, active)
        rows = {p: tokens.bounds(p)[0] for p in active}
        with record_routing() as got:
            out, aux = moe_mesh({p: w[p]["ffn"] for p in active}, cfg,
                                {p: y[a:b] for p, (a, b) in rows.items()}, mesh)
    (_, idx1, kept1), = one
    idx2, kept2 = (torch.cat([e[i] for e in got]) for i in (1, 2))
    check(torch.equal(idx1, idx2) and torch.equal(kept1, kept2),
          f"the mesh routes {int((idx1 != idx2).sum())} (token, slot) pairs to other experts "
          f"and keeps {int((kept1 != kept2).sum())} other slots than one device")
    out_err = max(max_rel(out[p], want[a:b]) for p, (a, b) in rows.items())
    aux_err = max(abs(float(aux[k]) - float(want_aux[k])) / abs(float(want_aux[k]))
                  for k in want_aux)
    check(out_err <= TRAIN_GRAD_TOL and aux_err <= TRAIN_GRAD_TOL,
          f"the mesh's MoE output differs by {out_err:.3g}, its aux losses by {aux_err:.3g}")
    return dict(tokens=int(kept1.shape[0]), group=group_size(cfg, int(kept1.shape[0])),
                pairs=int(kept1.numel()), dropped=int((~kept1).sum()), out_err=out_err,
                aux_err=aux_err)


def mesh_step_against_one(cfg, params, batch, single, trainer) -> dict:
    """One f32 step of ``params`` (aux losses included) on ``trainer``'s
    mesh and on one device (``single``), the kernel on both, beside the
    one-ulp control (``random_ulp_params``, and the frontends' inputs moved
    so: ``ulp_frontends``), held by phase 18's rule (``FAMILY_F64_TOL``'s
    comment): the losses within ``MESH_LOSS_RTOL``, its kernel launched
    ``launches_a_position`` x 4 x ``forward_runs`` times, each leaf's gradient within
    ``MESH_GRAD_TOL`` of its largest value or ``MESH_ESCAPE`` x the
    control's. Returns each leaf's error and control by path, the losses'
    errors and the mesh's losses."""
    from repro_torch.sharding.placed import gather, place
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    kernel = mesh_kernel(cfg)
    want, want_m = single.grads_of(params, batch)
    placed = tree_map(place, params, trainer.state_shardings().params)
    reset_counts()
    got, got_m = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
    launched = read_counts()[kernel]
    check(launched == launches_a_position(cfg) * trainer.mesh.size * forward_runs(cfg),
          f"{cfg.name}: the mesh's f32 step launched {kernel.upper()} {launched} times")
    del placed
    paths = ["/".join(p) for p, _ in leaves_with_path(params)]
    errs = [max_rel(gather(g), w) for g, w in zip(leaves(got), leaves(want))]
    del got
    ctrl, _ = single.grads_of(random_ulp_params(params), ulp_frontends(batch))
    control = [max_rel(c, w) for c, w in zip(leaves(ctrl), leaves(want))]
    del ctrl, want
    check(set(got_m) == set(want_m), f"{cfg.name}: metrics {sorted(got_m)} != {sorted(want_m)}")
    loss_errs = {k: abs(float(got_m[k]) - float(want_m[k])) / abs(float(want_m[k]))
                 for k in want_m}
    check(all(np.isfinite(float(got_m[k])) for k in got_m)
          and max(loss_errs.values()) <= MESH_LOSS_RTOL,
          f"{cfg.name}: the mesh's f32 losses differ from one device's by {loss_errs}")
    for path, err, ctl in zip(paths, errs, control):
        check(err <= MESH_GRAD_TOL or err <= MESH_ESCAPE * ctl,
              f"{cfg.name} {path}: the mesh's gradient differs from one device's by {err:.3g} "
              f"of its largest, where the one-ulp control parts them by {ctl:.3g}; > "
              f"{MESH_GRAD_TOL} and > {MESH_ESCAPE} x the control")
    return dict(errs=dict(zip(paths, errs)), control=dict(zip(paths, control)),
                loss_errs=loss_errs, losses={k: float(got_m[k]) for k in got_m},
                launches=launched)


def step_summary(step: dict) -> dict:
    """The worst leaf of ``mesh_step_against_one``'s result, its control
    and the leaves past ``MESH_GRAD_TOL``, with their worst ratio to the
    control."""
    errs, control = step["errs"], step["control"]
    worst = max(errs, key=errs.get)
    past = [k for k, e in errs.items() if e > MESH_GRAD_TOL]
    return dict(loss_rel_err=max(step["loss_errs"].values()), grad_err=errs[worst],
                grad_err_leaf=worst, control_grad_err=max(control.values()),
                control_leaf=max(control, key=control.get), past_tol=past,
                past_control_ratio=max([errs[k] / control[k] for k in past], default=0.0))


def phase_family_f32_step(dev, arch: str, layers: int, seq: int, f64_layers: int,
                          f64_rows: int, phase: str) -> dict:
    """Phases 18's and 19's check of one family at FULL width and
    ``layers`` layers (an encdec model's encoder too), ``seq`` tokens a
    row: one f32 step on the 2x2 mesh against one device
    (``mesh_step_against_one``) from the init's weights drawn on the card,
    and again from the same weights at fan-in scale (``fan_in_params``),
    where the one-ulp control must part every leaf by less than
    ``FAN_IN_CONTROL_MAX`` (not for the moe family, which instead holds the
    routing of a group that spans the batch shards at the init's weights,
    ``moe_routing_at_full``; ``FAN_IN_CONTROL_MAX``'s comment says why);
    at those last weights every block on its own (``mesh_layer_local``: its
    output within ``TRAIN_GRAD_TOL``); then ``family_f64_step`` at
    ``f64_layers`` layers and ``f64_rows`` rows."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.train import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cut_config(arch, layers, dtype="float32")
    kernel = mesh_kernel(cfg)
    tc = TrainConfig(batch=TRAIN_BATCH, seq_len=seq)
    params = Model(cfg).init(0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(cfg, TRAIN_BATCH, seq, seed=0).items()}
    single = Trainer(cfg, tc, device=dev)
    mesh = make_mesh([dev] * MESH_DEVICES, model_parallel=2)
    trainer = Trainer(cfg, tc, mesh=mesh, device=dev)
    runs = {"the init": mesh_step_against_one(cfg, params, batch, single, trainer)}
    routing = {}
    if cfg.family == "moe":
        routing = moe_routing_at_full(cfg, params, batch, trainer)
    else:
        params = fan_in_params(cfg, params)
        runs["fan-in"] = mesh_step_against_one(cfg, params, batch, single, trainer)
        ctl = runs["fan-in"]["control"]
        worst_ctl = max(ctl, key=ctl.get)
        check(ctl[worst_ctl] < FAN_IN_CONTROL_MAX,
              f"{cfg.name} at fan-in weights: the one-ulp control parts {worst_ctl} by "
              f"{ctl[worst_ctl]:.3g} >= {FAN_IN_CONTROL_MAX}, so the check cannot tell a fault")
    weights = "fan-in" if "fan-in" in runs else "the init"
    local = mesh_layer_local(cfg, params, batch, trainer, control=True)
    del params
    steps = {label: step_summary(st) for label, st in runs.items()}
    for label, st in steps.items():
        losses = runs[label]["losses"]
        print(f"phase {phase} {cfg.name}: one f32 step at FULL width, {cfg.num_layers} layers, "
              f"{label} weights, on a {mesh.shape} mesh "
              f"against one device: losses within {st['loss_rel_err']:.3g} relative "
              f"({', '.join(f'{k} {v:.6f}' for k, v in sorted(losses.items()))}); "
              f"{kernel.upper()} {runs[label]['launches']} launches; gradients within "
              f"{st['grad_err']:.3g} of their largest ({st['grad_err_leaf']}); the one-ulp "
              f"control parts them by up to {st['control_grad_err']:.3g} "
              f"({st['control_leaf']}); {len(st['past_tol'])} leaves past {MESH_GRAD_TOL}, at "
              f"most {st['past_control_ratio']:.3g} x the control on the leaf")
    blocks = [v for k, v in local.items() if k.startswith(BLOCKS)]
    print(f"phase {phase} {cfg.name}: each block on its own at {weights} weights: "
          f"outputs within {local['out_err']:.3g}, gradients within {local['grad_err']:.3g} "
          f"({local['grad_leaf']}), the blocks' one-ulp controls up to "
          f"{max(v['control_err'] for v in blocks):.3g} "
          f"(outputs {max(v['control_out_err'] for v in blocks):.3g}), "
          f"past {TRAIN_GRAD_TOL}: {local.get('past_tol', [])}"
          + (f", aux losses within {local['aux_err']:.3g}" if "aux_err" in local else "")
          + (f"; layer 0's MoE on one input: the same (token, expert) slots kept on the mesh "
             f"as on one device, {routing['dropped']} of {routing['pairs']} pairs dropped, "
             f"{routing['tokens']} tokens in groups of {routing['group']}, outputs within "
             f"{routing['out_err']:.3g}, aux within {routing['aux_err']:.3g}" if routing else ""))
    del single, trainer
    free_weights()
    f64 = family_f64_step(dev, arch, f64_layers, seq, f64_rows, phase)
    return dict(steps["the init"], fan_in=steps.get("fan-in"), f64=f64,
                block_out_err=local["out_err"], block_grad_err=local["grad_err"],
                block_grad_leaf=local["grad_leaf"], block_past_tol=local.get("past_tol", []),
                routing=routing)


@contextlib.contextmanager
def f64_throughout():
    """Within it, ``Tensor.float()`` leaves an f64 tensor f64, so an f64
    model's f32 parts (norm statistics, Mamba-2's SSD and gate, softmax
    scores, the sinusoid, the cross-entropy) run in f64 too: the f64 step
    then compares the mesh's arithmetic alone, not the f32 rounding both
    lanes share (Mamba-2's SSD runs in f32 in both packages)."""
    real = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 else real(t)
    try:
        yield
    finally:
        torch.Tensor.float = real


def family_f64_step(dev, arch: str, layers: int, seq: int, batch_rows: int, phase: str) -> dict:
    """One f64 step of ``arch`` at FULL width and ``layers`` layers,
    ``batch_rows`` x ``seq`` tokens, the 2x2 mesh against one device, both
    on the plain lane (the kernels take f32 and bf16) with every f32 part
    in f64 too (``f64_throughout``): the loss and every gathered gradient
    within ``FAMILY_F64_TOL`` of one device's, relative to each leaf's
    largest value. One device's gradients wait on the host while the mesh
    runs, and come back a leaf at a time to be compared."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import Model
    from repro_torch.runtime.elastic import make_mesh
    from repro_torch.sharding.placed import gather, place
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, leaves_with_path, tree_map

    cfg = cut_config(arch, layers, dtype="float64")
    tc = TrainConfig(batch=batch_rows, seq_len=seq)
    params = tree_map(lambda p: p.double(), Model(cfg).init(0, device=dev))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(cfg, batch_rows, seq, seed=0).items()}
    single = Trainer(cfg, tc, device=dev)
    single.model.backend = "torch"
    trainer = Trainer(cfg, tc, mesh=make_mesh([dev] * MESH_DEVICES, model_parallel=2),
                      device=dev)
    trainer.model.backend = "torch"
    with f64_throughout():
        want, want_m = single.grads_of(params, batch)
        want = tree_map(lambda g: g.cpu(), want)
        placed = tree_map(place, params, trainer.state_shardings().params)
        del params
        got, got_m = trainer.mesh_grads_of(placed, trainer._microbatches(batch)[0])
        del placed
    errs = {"/".join(p): max_rel(gather(g), w.to(dev))
            for (p, g), w in zip(leaves_with_path(got), leaves(want))}
    loss_err = abs(float(got_m["loss"]) - float(want_m["loss"])) / abs(float(want_m["loss"]))
    worst = max(errs, key=errs.get)
    check(loss_err <= FAMILY_F64_TOL and errs[worst] <= FAMILY_F64_TOL,
          f"{cfg.name} f64: the mesh's loss differs from one device's by {loss_err:.3g}, its "
          f"gradients by up to {errs[worst]:.3g} ({worst}) > {FAMILY_F64_TOL}")
    print(f"phase {phase} {cfg.name}: one f64 step at FULL width, {cfg.num_layers} layers, "
          f"{batch_rows}x{seq} tokens, plain lane, every f32 part in f64, on the mesh against "
          f"one device: loss within {loss_err:.3g}, gradients within {errs[worst]:.3g} of "
          f"their largest ({worst})")
    del got, want
    free_weights()
    return dict(loss_rel_err=loss_err, grad_err=errs[worst], grad_err_leaf=worst)


def phase_family_mesh_training(dev, single: dict) -> dict:
    """Phases 18 (the ssm, MLA and moe families) and 19 (the hybrid,
    encdec and vlm families): for each of ``FAMILY_MESH`` the main path
    (``phase_family_mesh_train``), then its f32 and f64 checks
    (``phase_family_f32_step``), each model's weights freed before the
    next. ``single`` holds phase 16b's numbers from this run, printed
    beside. Returns each family's numbers by arch and each phase's
    seconds."""
    out, seconds = {}, {}
    for arch, layers, seq, check_layers, f64_layers, f64_rows, phase in FAMILY_MESH:
        t0 = time.perf_counter()
        stats = timed(f"{phase} {arch} mesh training", phase_family_mesh_train, dev, arch,
                      layers, seq, phase)
        stats["f32"] = timed(f"{phase} {arch} f32 step", phase_family_f32_step, dev, arch,
                             check_layers, seq, f64_layers, f64_rows, phase)
        print(f"phase {phase} {arch}: step p50 {stats['step_p50_ms']:.2f} ms, "
              f"{stats['step_p50_ms'] / single['step_p50_ms']:.2f}x phase 16b's one-device "
              f"llama3.2-1b step ({single['step_p50_ms']:.2f} ms, {single['tok_s']:.0f} tok/s, "
              f"idle {100 * single['step_idle']:.1f}%, {single['peak_gb']:.2f} GB) in this run")
        out[arch] = stats
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
    for phase, secs in seconds.items():
        print(f"[phase {phase}: {secs:.1f}s]")
    return dict(families=out, phase_seconds=seconds)


# --- The paged KV cache, the dry run and the roofline (phase 20) ------------

PAGED_PROMPTS = (37, 64, 100, 129)   # ragged prompt lengths, tokens
PAGED_STEPS, PAGED_BLOCK = 16, 16     # greedy decode steps; tokens a block
PAGED_BUCKETS = (64, 128)            # the engine's prefill lengths (contexts of 36-128)


def phase_paged_cache(dev, params) -> dict:
    """Phase 20a: the paged KV cache on the card beside the engine's own.
    Phase 7's FULL llama3.2-1b weights (f32) in an ``Engine`` of 4 slots;
    the 4 ``PAGED_PROMPTS`` admitted (counts set to 0 just before and read
    just after: K4 once a layer a prefill, nothing else), each slot's
    context k/v rows copied into a ``PagedKVCache(block_size=16)`` on the
    card with ``append_prompt``; then ``PAGED_STEPS`` greedy decode steps,
    each slot's new row ``append``-ed after each. The cache has just the
    blocks that the contexts plus 16 rows need. After the prefill and
    after every step, every sequence's ``gather`` equals its slot's rows of
    the engine's cache bit for bit (``torch.equal``). Then one more
    ``allocate`` plus an ``append`` raises ``MemoryError``; a ``free``
    returns its blocks and a new sequence reuses them, its ``gather``
    bit-equal to the rows written. Prints the blocks used, each sequence's
    ``utilization`` and ``gather``'s CUDA-event median."""
    from repro_torch.configs import get_config
    from repro_torch.serve import Engine, PagedKVCache, Request

    cfg = get_config("llama3.2-1b").replace(dtype="float32")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PAGED_PROMPTS]
    eng = Engine(cfg, params, max_batch=len(prompts), max_len=256, prompt_buckets=PAGED_BUCKETS,
                 device=dev)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=PAGED_STEPS))
    reset_counts()
    eng._admit()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["k4"] == cfg.num_layers * len(prompts)
          and all(counts[k] == 0 for k in COUNTS if k != "k4"),
          f"the paged phase's prefills launched {counts}")
    ctx = [n - 1 for n in PAGED_PROMPTS]
    blocks = sum(-(-(c + PAGED_STEPS) // PAGED_BLOCK) for c in ctx)
    rows = lambda: (eng.cache["layers"]["k"], eng.cache["layers"]["v"])  # noqa: E731
    k_all, _ = rows()
    paged = PagedKVCache(layers=cfg.num_layers, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                         num_blocks=blocks, block_size=PAGED_BLOCK, dtype=k_all.dtype, device=dev)
    check(paged.k.device == k_all.device, f"the paged cache is on {paged.k.device}")
    for slot, c in enumerate(ctx):
        paged.allocate(slot)
        paged.append_prompt(slot, *(t[:, slot, :c] for t in rows()))

    def same(when: str) -> None:
        k_all, v_all = rows()
        for slot in range(len(ctx)):
            n = paged.length(slot)
            k, v = paged.gather(slot)
            check(torch.equal(k, k_all[:, slot, :n]) and torch.equal(v, v_all[:, slot, :n]),
                  f"sequence {slot}'s gather differs from the engine's cache {when}")

    same("after the prefill")
    for step in range(PAGED_STEPS):
        written = eng.positions.copy()
        eng._decode_once()
        for slot in range(len(ctx)):
            paged.append(slot, *(t[:, slot, int(written[slot])] for t in rows()))
        same(f"after decode step {step + 1}")
    check(paged.free_blocks == 0 and paged.used_blocks() == blocks,
          f"{paged.used_blocks()} of {blocks} blocks used after the decode")
    util = [paged.utilization(slot) for slot in range(len(ctx))]
    gather_ms = median_ms(lambda: paged.gather(len(ctx) - 1))
    longest = paged.length(len(ctx) - 1)
    gather_mb = 2 * cfg.num_layers * longest * cfg.num_kv_heads * cfg.head_dim * 4 / 1e6
    paged.allocate(99)
    try:
        paged.append(99, *(t[:, 0, 0] for t in rows()))
        check(False, "an append past the last free block did not raise MemoryError")
    except MemoryError:
        pass
    paged.free(99)
    freed = paged._seqs[0].blocks[:]
    paged.free(0)
    check(paged.free_blocks == len(freed), f"free returned {paged.free_blocks} blocks")
    paged.allocate(4)
    paged.append_prompt(4, *(t[:, 1, :ctx[0]] for t in rows()))
    reused = paged.block_table(4).tolist()
    k, v = paged.gather(4)
    k_all, v_all = rows()
    check(set(reused) <= set(freed) and torch.equal(k, k_all[:, 1, :ctx[0]])
          and torch.equal(v, v_all[:, 1, :ctx[0]]),
          f"the new sequence took blocks {reused}, not of the freed {freed}, or its rows differ")
    print(f"phase 20a: paged KV cache of FULL {cfg.name} on {dev}: {len(ctx)} prompts of "
          f"{list(PAGED_PROMPTS)} tokens (K4 {counts['k4']} launches) and {PAGED_STEPS} decode "
          f"steps; gathers bit-equal to the engine's cache after the prefill and after every "
          f"step; {blocks} blocks of {PAGED_BLOCK} used, utilization "
          f"{', '.join(f'{u:.3f}' for u in util)}; MemoryError on the next append; a freed "
          f"sequence's {len(freed)} blocks reused; gather of {longest} tokens "
          f"({gather_mb:.1f} MB of k and v) "
          f"{gather_ms:.4f} ms (CUDA-event median)")
    return dict(k4=counts["k4"], blocks=blocks, utilization=util, gather_ms=gather_ms,
                gather_tokens=longest, gather_mb=gather_mb, steps=PAGED_STEPS)


def phase_planned_bytes(trainer) -> dict:
    """Phase 20b: the dry run's plan of phase 17's cell (FULL llama3.2-1b on
    the 2x2 mesh of one card, ``launch/dryrun.train_state_plan``) against
    the state that phase 17's trainer holds: each leaf's spec the same, and
    its planned bytes a position equal to every ``Placed`` shard's
    ``nbytes``, for the weights and both AdamW moments. Then the planned
    ``argument_size_in_bytes`` of ``train_4k`` on both production
    meshes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.tree import leaves, leaves_with_path

    mesh, state = trainer.mesh, trainer.state
    plan, specs = dryrun.train_state_plan(trainer.cfg, mesh, trainer.tc.microbatches)
    held = {pos: 0 for pos in mesh.positions()}
    planned_total = 0
    for part in ("params", "mu", "nu"):
        got = state.params if part == "params" else getattr(state.opt, part)
        want = plan.params if part == "params" else getattr(plan.opt, part)
        sp = specs.params if part == "params" else getattr(specs.opt, part)
        for (path, leaf), t, spec in zip(leaves_with_path(got), leaves(want), leaves(sp)):
            name = f"{part}/{'/'.join(path)}"
            check(leaf.spec == spec, f"{name}: held spec {leaf.spec}, planned {spec}")
            nbytes = dryrun.shard_nbytes(t, spec, mesh)
            planned_total += nbytes
            for pos, shard in leaf.shards.items():
                check(shard.nbytes == nbytes, f"{name} at {pos}: {shard.nbytes} bytes held, "
                                              f"{nbytes} planned")
                held[pos] += shard.nbytes
    check(set(held.values()) == {planned_total}, f"bytes a position: held {held}, planned "
                                                 f"{planned_total}")
    production = {}
    for name, multi in (("single_pod", False), ("multi_pod", True)):
        big = dryrun.meta_mesh(multi_pod=multi)
        cell = dryrun.cell_arguments(get_config(TRAIN_ARCH), "train_4k", big)
        production[name] = dryrun.memory_analysis(cell, big)["argument_size_in_bytes"]
    print(f"phase 20b: the dry run's plan of phase 17's cell ({trainer.cfg.name} FULL on a "
          f"{mesh.shape} mesh): weights and AdamW moments {planned_total:,} bytes a position, "
          f"equal leaf by leaf to the Placed shards phase 17 holds at all {len(held)} "
          f"positions; train_4k argument_size_in_bytes a device: "
          + ", ".join(f"{k} {v:,}" for k, v in production.items()))
    return dict(bytes_a_position=planned_total, train_4k_arguments=production)


def phase_mfu(single: dict, mesh: dict) -> dict:
    """Phase 20c: the whole training step's share of the card's dense bf16
    rate, ``roofline.analysis.model_flops``' 6*N*D for 8 x 128 tokens over
    phase 16b's step p50 (one device) and phase 17a's (the 2x2 mesh of the
    one card), at ``PEAK_FLOPS_BF16``. A printed line, not a gate. Prints
    the card's memory beside the roofline's ``HBM_PER_CHIP``."""
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.constants import HBM_PER_CHIP, PEAK_FLOPS_BF16

    n_active = model_flops(TRAIN_ARCH, "train_4k", "train")["n_active"]
    flops = 6.0 * n_active * TRAIN_BATCH * TRAIN_SEQ
    mfu = {k: flops / (st["step_p50_ms"] / 1e3) / PEAK_FLOPS_BF16
           for k, st in (("one_device", single), ("mesh", mesh))}
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 20c: MFU of the {TRAIN_ARCH} training step, 6 x {n_active:,} x "
          f"{TRAIN_BATCH * TRAIN_SEQ} = {flops:.4g} flops at {PEAK_FLOPS_BF16:.4g} flop/s: "
          f"one device (16b, p50 {single['step_p50_ms']:.2f} ms) {100 * mfu['one_device']:.2f}%, "
          f"2x2 mesh of the card (17a, p50 {mesh['step_p50_ms']:.2f} ms) "
          f"{100 * mfu['mesh']:.2f}%; card {card_line()}; total_memory {total:,} bytes "
          f"(HBM_PER_CHIP {HBM_PER_CHIP:,})")
    return dict(model_flops=flops, mfu=mfu, total_memory=total)


# --- The twins of examples/* (phase 21) ------------------------------------------

TWIN_CKPT = ROOT / "build" / "chip_smoke" / "train_lm_ckpt"
TWINS = (("quickstart", []),
         ("edge_service", ["--batch", "8", "--size", "2048"]),
         ("serve_lm", []),
         ("long_context", ["--tokens", "512"]),
         ("train_lm", ["--preset", "100m", "--steps", "20", "--ckpt", str(TWIN_CKPT)]))


def load_twin(name: str):
    """``examples_torch/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_twins(dev) -> dict:
    """Phase 21: each of ``examples_torch/*.py`` on the card through its
    ``main`` (default ``--device cuda``), counts set to 0 just before and
    read just after, its output printed. Held: quickstart launches K1 and
    finds it bit-equal to the torch lane; edge_service (8 x 2048 x 2048)
    launches K1 (K2 where phase 3d's tuned depth is 2) once a call a shard
    (its 1x1 mesh: once a call, 4 calls);
    serve_lm launches K4 (once a layer a prefill) and completes its 10
    requests; long_context's decode (plain PyTorch, as the reference's is
    XLA) launches nothing, on the card; train_lm's 100m preset (12 layers,
    remat ``minimal``) launches K4 exactly 12 x 20 steps x 2 (the backward's
    recompute), its losses finite."""
    import contextlib
    import io
    import shutil

    from repro_torch.models import remat

    out = {}
    for name, argv in TWINS:
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = load_twin(name).main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        text = buf.getvalue()
        print("\n".join(f"phase 21 {name}| {ln}" for ln in text.splitlines()))
        edge = counts.get("k1", 0) + counts.get("k2", 0)   # K2 where the tuned depth says
        if name == "quickstart":
            check(edge >= 1 and "(bit-equal)" in text,
                  f"quickstart on the card: {counts}, K1 not bit-equal to the torch lane")
        elif name == "edge_service":
            check(edge == 4 and result.device.type == "cuda",
                  f"edge_service launched {counts}, not K1 (or K2) once each of its 4 calls")
        elif name == "serve_lm":
            check(counts.get("k4", 0) >= 2 and len(result) == 10,
                  f"serve_lm launched {counts} and completed {len(result)} requests")
            check(counts["k4"] % 2 == 0, f"serve_lm's K4 launches {counts} are not 2 a prefill")
        elif name == "long_context":
            check(not counts and result["logits"].device.type == "cuda"
                  and bool(torch.isfinite(result["logits"]).all()),
                  f"long_context on the card launched {counts}")
        else:
            hist, trainer = result
            want = trainer.cfg.num_layers * trainer.tc.steps * remat.forward_runs(trainer.cfg)
            check(counts == {"k4": want} and remat.policy(trainer.cfg) == "minimal",
                  f"train_lm's 100m preset launched {counts}, not K4 {want}")
            check(all(np.isfinite(hist["loss"])), f"train_lm losses {hist['loss']}")
            shutil.rmtree(TWIN_CKPT, ignore_errors=True)
        out[name] = dict(launches=counts, seconds=seconds)
        print(f"phase 21 {name}: {counts or 'no kernel launches'} in {seconds:.1f} s")
        del result
        free_weights()
    return out


def phase_analyzer():
    """Phase 10: the contract analyzer's whole sweep, CPU and card halves,
    against the committed baseline. Returns its summary."""
    from repro_torch.analysis import analyze, load_baseline, render_coverage

    reset_counts()
    t0 = time.perf_counter()
    report = analyze(full=True, backends=("torch", "cuda"))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    report.apply_baseline(load_baseline(str(ROOT / "analysis_baseline_torch.json")))
    print(report.render())
    print(render_coverage(report))
    meta = report.meta
    instances = meta["instances"]
    for key, row in sorted(instances.items()):
        ring = f" copies {row['copies']} waits {row['waits']}" if "copies" in row else ""
        print(f"  {key}: fma.rn.f32 {row['fma.rn.f32']}, FFMA {row['FFMA']}, static smem "
              f"{row['static_smem']} B{ring}")
    for loc, row in sorted(meta["launch_smem"].items()):
        print(f"  {loc}: {row['instance']} asked for {row['dynamic']} B dynamic + "
              f"{row['static']} B static shared memory")
    print(f"  integer-lane accumulators (licensed / on the card): "
          f"{meta['int_lane_accumulators']}")
    print(f"  profiler records taken again for missing device records: "
          f"{meta['profiles_taken_again']}")
    summary = {"checks": report.checks, "artifacts": len(report.combos),
               "new_violations": len(report.violations), "allowlisted": len(report.allowlisted),
               "not_run": meta["not_run"], "seconds": dict(meta["seconds"], total=seconds),
               "functions": meta["functions"], "launches": counts,
               "fma_rn_f32": sum(r["fma.rn.f32"] for r in instances.values()),
               "ffma": {k: r["FFMA"] for k, r in instances.items()}}
    print(json.dumps({k: v for k, v in summary.items() if k != "ffma"}))
    check(report.ok, f"the analyzer found {len(report.violations)} new violation(s)")
    check(not meta["not_run"], f"rules not run on the card: {meta['not_run']}")
    check(len(instances) == 84, f"the listings held {len(instances)} of 84 instances")
    check(summary["fma_rn_f32"] == 0, "fma.rn.f32 in the PTX of a K1-K3 instance")
    check(counts["k1"] >= 1 and counts["k2"] >= 1 and counts["k3"] >= 1,
          f"phase 10 did not launch K1, K2 and K3: {counts}")
    return summary


def phase_fig7(dev):
    """Phase 10b: Fig. 7 on FULL frames, SSIM of K1's unnormalized magnitude
    against the dense oracle (plain lane, on the card) > 0.999999."""
    from repro_torch.api import EdgeConfig, edge_detect
    from repro_torch.configs import get_config
    from repro_torch.core.ssim import ssim
    from repro_torch.kernels.ref import sobel_ref

    full = get_config("sobel-hd")
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.rand((4, full.image_h, full.image_w), generator=g, device=dev) * 255.0
    ref = sobel_ref(x)
    out = {}
    for variant in ("separable", "v1", "v2"):
        cfg = EdgeConfig(variant=variant, normalize=False, block_h=full.sobel_block_h,
                         block_w=full.sobel_block_w)
        reset_counts()
        mag = edge_detect(x, cfg, device=dev).magnitude
        k1 = read_counts()["k1"]
        out[variant] = float(ssim(mag, ref).mean())
        equal = bool(torch.equal(mag, ref))
        print(f"  {variant}: SSIM {out[variant]!r} against sobel_ref ({k1} K1 launch, "
              f"bit-equal {equal})")
        check(k1 == 1, f"Fig. 7 {variant}: {k1} K1 launches, expected 1")
        check(out[variant] > 0.999999, f"Fig. 7 {variant}: SSIM {out[variant]} <= 0.999999")
    return out


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {name}: {time.perf_counter() - t0:.1f}s]")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # This run's tuning cache, inside the checkout: empty until phase 3d.
    cache = ROOT / "build" / "chip_smoke" / "sobel_blocks.json"
    cache.unlink(missing_ok=True)
    os.environ["REPRO_TUNE_CACHE"] = str(cache)
    t_all = time.perf_counter()
    edge_build = timed("1 build", phase_build)
    k4_err = timed("6 K4 vs plain", phase_k4_vs_plain, dev)
    lm = timed("7 LM server", phase_lm_server, dev)
    lm_params = lm.pop("params")
    long_launches = timed("7b long prefill", phase_long_prefill, dev, lm_params)
    timed("20a paged cache", phase_paged_cache, dev, lm_params)
    del lm_params
    free_weights()               # the llama weights go before falcon-mamba's 29 GB
    t_ssm = time.perf_counter()
    k5_err = timed("8 K5 vs plain", phase_k5_vs_plain, dev)
    ssm = timed("9 ssm server", phase_ssm_server, dev)
    ssm_long_launches, ssm_bf16_launches = timed("9b ssm long prefill", phase_ssm_long_prefill,
                                                 dev, ssm.pop("params"))
    free_weights()
    print(f"[phases 8-9b: {time.perf_counter() - t_ssm:.1f}s]")
    t_moe = time.perf_counter()
    moe, moe_cfg, moe_params = timed("11 moe server", phase_moe_server, dev)
    moe_long = timed("11b moe long prefill", phase_moe_long_prefill, dev, moe_cfg, moe_params)
    del moe_params
    free_weights()              # qwen3-moe's 62.3 GB go before phi3.5-moe's 42.7 GB
    phi_long = timed("11c phi3.5-moe prefill", phase_phi_prefill, dev)
    free_weights()
    mla = timed("12 MLA server", phase_mla_server, dev)
    free_weights()
    print(f"[phases 11-12: {time.perf_counter() - t_moe:.1f}s]")
    t_new = time.perf_counter()
    hybrid = timed("13 hybrid engine", phase_hybrid_server, dev)
    free_weights()
    encdec = timed("14 encdec prefill and decode", frontend_serve, ENCDEC_ARCH, dev)
    free_weights()              # every earlier model goes before pixtral's 49.0 GB
    vlm = timed("15 vlm prefill and decode", frontend_serve, VLM_ARCH, dev)
    free_weights()
    print(f"[phases 13-15: {time.perf_counter() - t_new:.1f}s]")
    training = phase_training(dev)
    free_weights()
    mesh_training = phase_mesh_training(dev, training)
    free_weights()
    family_mesh = phase_family_mesh_training(dev, training)["families"]
    free_weights()
    timed("20c MFU", phase_mfu, training, mesh_training)
    timed("1b edge build", phase_edge_build, edge_build)
    rng = np.random.default_rng(0)
    full = timed("2 K1 vs plain", phase_kernel_vs_plain, rng, dev)
    timed("2b K1 out_nms vs plain", phase_nms_vs_plain, rng, dev)
    timed("2c K3 vs plain", phase_stream_vs_plain, rng, dev)
    full_inputs = timed("2d K2 vs plain", phase_k2_vs_plain, rng, dev)
    timed("2e int lane", phase_int_lane, rng, dev, full_inputs)
    timed("2f plans vs plain", phase_plans_vs_plain, rng, dev, full_inputs)
    timed("3 facade", phase_facade, rng, dev)
    timed("3b facade nms", phase_nms_facade, rng, dev)
    main_counts = timed("3c depth and lane", phase_depth_facade, full_inputs, dev)
    tuned_counts, _rows, best = timed("3d tuned facade", phase_tuned_facade, full_inputs, dev)
    for k, v in tuned_counts.items():
        main_counts[k] += v
    plan_counts = timed("3e plan facade", phase_plan_facade, full_inputs, dev)
    shard_counts, shard_rows = timed("3f sharded facade", phase_sharded_facade, full_inputs,
                                     dev)
    check(plan_counts["k1_plan"] >= 1 and plan_counts["k2_plan"] >= 1,
          f"the plan slice's main path did not launch K1 and K2 with pre-stages: {plan_counts}")
    check(main_counts["k2"] >= 1 and main_counts["k1_int"] >= 1 and main_counts["k2_int"] >= 1,
          f"this slice's main path did not launch K2 and both integer lanes: {main_counts}")
    server_launches, edges_launches = timed("4 servers", phase_server, dev)
    runs = timed("4b stream server", phase_stream_server, dev)
    mask = timed("4c stream step", phase_step_parts, runs["motion"], dev)
    timed("4d linking", phase_linking, runs["motion"], dev)
    chaos_runs = timed("4e chaos server", phase_chaos_server, dev)
    twins = timed("21 examples_torch twins", phase_twins, dev)
    k4_mesh = {arch: st for arch, st in family_mesh.items() if st["kernel"] == "k4"}
    paths = {"launches": {f"{MOE_ARCH} engine": moe["k4"], f"{MOE_ARCH} long prefills": moe_long,
                          f"{PHI_ARCH} long prefills": phi_long, f"{MLA_ARCH} server": mla["k4"],
                          f"{MLA_ARCH} long prefills": mla["long_launches"],
                          f"{HYBRID_ARCH} engine": hybrid["k4"],
                          f"{HYBRID_ARCH} long prefills": hybrid["long_launches"],
                          f"{ENCDEC_ARCH} prefills": encdec["k4"],
                          f"{VLM_ARCH} prefills": vlm["k4"],
                          "examples_torch/serve_lm.py": twins["serve_lm"]["launches"]["k4"],
                          "examples_torch/train_lm.py --preset 100m":
                              twins["train_lm"]["launches"]["k4"],
                          f"{TRAIN_ARCH} training": training["k4"],
                          f"{TRAIN_ARCH} mesh training": mesh_training["k4"],
                          **{f"{arch} mesh training": st["launches"]
                             for arch, st in k4_mesh.items()}},
             "servers": {"moe_server": moe, "mla_server": mla, "hybrid_engine": hybrid,
                         "encdec_prefill": encdec, "vlm_prefill": vlm, "training": training,
                         "mesh_training": mesh_training},
             "family_mesh": {f"{arch} mesh training": st for arch, st in k4_mesh.items()}}
    kernels = timed("5 timing", phase_timing, full, dev, mask, server_launches, edges_launches,
                    runs["motion"]["k3"], full_inputs, main_counts, best[None])
    k1_plans, k2_plans = timed("5 plan timing", phase_plan_timing, full_inputs, dev, plan_counts)
    kernels[0].update(k1_plans)
    kernels[1].update(k2_plans)
    kernels[0].update(launches_sharded_facade=shard_counts["k1"], sharded=shard_rows,
                      launches_chaos_server={k: v["launches"] for k, v in chaos_runs.items()},
                      chaos_server=chaos_runs)
    kernels[1].update(launches_sharded_facade=shard_counts["k2"])
    for i, key in ((0, "k1"), (1, "k2")):
        kernels[i]["launches_examples_torch"] = {n: st["launches"].get(key, 0)
                                                 for n, st in twins.items()}
    kernels.append(timed("5 K4 timing", phase_k4_timing, dev, lm, long_launches, k4_err, paths))
    kernels.append(timed("5 K5 timing", phase_k5_timing, dev, ssm, ssm_long_launches, k5_err,
                         {f"{arch} mesh training": st for arch, st in family_mesh.items()
                          if st["kernel"] == "k5"}, ssm_bf16_launches))
    timed("10 contract analyzer", phase_analyzer)
    timed("10b Fig. 7", phase_fig7, dev)
    print(f"chip_smoke: {time.perf_counter() - t_all:.1f}s after the card check")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
