#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, in order; any failure raises and the script exits non-zero:

1. the device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: every CUDA C++ kernel of ``src/repro_torch/kernels/csrc``
   compiled with nvcc for sm_90a (one process per source, in parallel),
   and the TF32 ``HMMA`` instructions in the flash and mamba libraries'
   SASS counted (``cuobjdump -sass``); neither count may be 0;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape (4, 124,662,528), a ragged (3, 1,000,003) and a few
   tiny ragged shapes, with a row switched off by the ``active`` mask
   (and ``fused_sgd`` with one row on); adamw at counts 1 and 1000 (and
   one count per row) with wd 0 and 0.01. Tolerances: ``fused_sgd``
   bit-equal, momentum and adamw rtol 1e-6 / atol 1e-7 (they are written
   to round like the plain version), the norm rtol 1e-5 (another
   summation order), bit-equal on a rerun and one device kernel a call
   (counted by ``torch.profiler``).
   The exchange kernels must equal their plain versions bit for bit:
   ``codec_mix`` in every kind, on the mean and with the ring and gossip
   W at hops 1 and 2, at (4, 124,662,528), (8, 62,331,264), (3,
   1,000,003) and tiny ragged shapes up to G = 16, and through its
   general kernel (more than 16 groups, or an int8 chunk other than 256)
   at (32, 15,582,816), int8 chunks 128 and 512 at (4, 124,662,528) and
   small ragged shapes (G 17-40, chunks 37-1024); ``qdq_int8`` at
   (1,947,852, 256), on ragged row counts with all-zero chunks, and
   through int8z's pinned noise, and at chunks 128, 512 and 37. The
   exchanges past the register kernel (G 32: int8 on server and ring,
   top-k, fp16, bf16; int8 chunks 128 and 512) each launch ``codec_mix``
   once and equal the same exchange with the plain versions bit for bit.
   Each kernel is timed with CUDA events (median of 20 launches after
   warm-up) beside its bound, its plain version and one PyTorch library
   call that computes the same function (a yardstick the port never
   calls; none exists for the exchange kernels); for the update and norm
   kernels and their library calls the device's time is logged beside
   the call's, and ``fused_sgd`` is timed with one active row of four
   beside ``add_`` on that row;
4. a small reference check: the packed round on a paper-mlp reduction,
   on the card with the kernels and on the CPU with the plain versions,
   from the same params and batches: fp32 momentum and adamw, and the
   lossy exchange (server int8 with int8z moments under adamw, ring int8
   at two hops under sgd) with the same injected noise on both sides;
5. the main path at full width: paper-lenet (8 x 768, vocab 32000,
   N = 124,662,528), G = 4, 2 sequences of 128 per group, T = 4, through
   the round builder of ``repro_torch.launch.train``: 3 adamw rounds, one
   sgd and one momentum round, and one adamw round with metrics="traj",
   all server/fp32; then the lossy exchange: 3 adamw rounds with int8
   params and int8z moments, an sgd round on the ring with int8 at two
   hops, a momentum round on gossip over G = 8 with bf16 params and fp16
   moments, an sgd round with top-k, an sgd round on async_stale (s=1)
   with int8, and an adamw round with an int8 downlink. The launch
   counters are set to 0 before this phase and read after it; each
   kernel must have been launched the expected number of times in every
   round, and each round's wire bytes must equal the count worked out
   here from the shapes;
6. one more adamw round of the main path under ``torch.profiler``: the
   device's busy share of the round and its device time by kernel;
7. the serve path's two kernels against their plain versions on the card.
   ``paged_decode_attention`` at paper-lenet's geometry (B 8, H = KV 12,
   hd 64, page 16, 66 blocks, lengths over 1-1056 with page edges, a slot
   on the trash row; float32 and bfloat16 queries), qwen3-32b's head
   geometry (KV 8, g 8, hd 128, page 16, lengths up to 4096), tiny
   ragged ones (GQA, MHA, MQA), g 3, 6 (nemotron-4-15b) and 16
   (llama3-405b), hd 112 (zamba2-7b), hd 50 and 3 (no multiple of 4:
   the kernel's scalar loads) and 65,535 slots, and at the three timed
   shapes below, where each must also give the same bits on a rerun;
   ``flash_attention`` at
   paper-lenet's prefill (1, 12, 1024, 64) float32, (2, 12, 2048, 64), a bfloat16 case,
   GQA at qwen3-32b's head_dim 128, tiny shapes (unequal blocks, a
   sequence that is no multiple of the kernel's 64-row tile), S 1000 and
   1088 (no multiple of 128), qwen3-32b's head geometry at (1, 64, 8,
   2048, 128), head dims 8 and 16 at length, zamba2-7b's hd 112 (32
   heads) and hd 40 and 96 (zero-padded to 64 and 112); flash must give
   the same bits on a rerun, and phase 2's count of TF32 HMMA instructions must
   not be 0 (the tensor-core path is the one built).
   Tolerances: float32 rtol 1e-5 / atol 1e-6 (the sums run in another
   order, so bits may differ), flash against its plain version evaluated
   in float64 (the float32 plain version's own error, logged beside the
   kernel's, is of the order of atol at head_dim 128); bfloat16 outputs
   within one bfloat16 step (rtol 2**-7, atol 1e-6) of the float32 plain
   version on the same bfloat16 inputs, and flash also within the
   reference's own bfloat16 tolerance (atol 2e-2, rtol 2e-1) of its plain
   version, whose probabilities round to bfloat16. Each is timed (CUDA events, median of
   20) at the serve path's shapes beside its bound, its plain version and,
   for flash, ``scaled_dot_product_attention(is_causal=True)`` (a
   yardstick the port never calls; no single PyTorch call computes paged
   attention; the profiler names SDPA's device kernel once). Decode is
   timed, the call and the device alone, at ``decode_timed``'s shapes:
   paper-lenet's step (B 8, lengths 528-1056), one request (B 1, length
   1056) and qwen3-32b's head geometry (B 8, lengths 2064-4096). Flash is
   timed at (1, 12, 1024, 64), (2, 12, 2048, 64), (1, 64, 8, 2048,
   128) and (1, 32, 32, 2048, 112), beside the bound of its design
   (3xTF32 on the tensor cores) and the float32 bound outside them. Times are those of the call (the
   host's time to issue it counts); for flash, ``rmsnorm`` and their
   library calls the device's alone is logged beside;
8. the serve path at full width: phase 5's fp32 adamw server params, saved
   with ``checkpoint/io.save`` to a temporary directory and restored
   through ``serve.handoff.restore_params``, served as paper-lenet with
   ``attn_impl="pallas"`` (``EngineConfig(n_slots=8, page_size=16,
   max_prompt=1024, max_new=32)``: bucket 1024, 66 blocks, 8,449 pool rows
   of 12,288 floats) under ``poisson_workload(rate=50, n=24,
   prompt_len=(512, 1024), max_new=(16, 32), vocab=32000, seed=0)``, with
   the continuous and then the static policy, and each request replayed
   alone at the same slot count. Every request's tokens must be equal in
   all three; with the counts set to 0 before the continuous run,
   ``flash_attention`` must be launched 8 times per prefill and
   ``paged_decode_attention`` 8 times per decode step. Then ``python -m
   repro_torch.launch.serve`` (the normal entry point, default
   ``attn_impl``) on the same checkpoint with ``--check-parity`` must exit
   0. Between the two, three decode steps over 8 active slots run under
   ``torch.profiler``: the device's busy share and time by kernel;
9. the kernels against their plain versions on the whole path: 8 slots
   prefilled at the 1024 bucket and 4 decode steps, once with
   ``impl="torch"`` (both plain versions, no kernel launched) and once
   with the kernels, the kernel run fed the plain run's tokens: the
   logits must agree at rtol 1e-4 / atol 1e-5 and the greedy tokens
   must be equal, except where the plain run's top-2 logit gap lies
   within that tolerance (printed). Phases 5-9 must have launched none
   of the last four kernels below: neither package's training or serving
   path reaches them;
10. the kernel entry point ``repro_torch.kernels.ops`` and the last four
   kernels. First ``rmsnorm`` (float32 and bfloat16), the quantize pair
   and ``mamba_chunk`` against their plain versions on the card:
   ``rmsnorm`` at zamba2-7b's d_model and d_inner over 4096 tokens
   ((4096, 3584), (4096, 7168)), qwen3-32b's qk-norm (262,144, 128) and
   d_model (4096, 5120), a wide D of no register-tile multiple (4096,
   3588), and the reference test's ragged shapes (bfloat16 at both of
   zamba2-7b's widths and the ragged shapes); the quantize pair at (1,947,852,
   256) and at chunks 256, 128 and 37 over row counts that are no
   multiple of 8, with all-zero rows; ``mamba_chunk`` at zamba2-7b's
   full width (B 1, c 32, L 128, H 112, N 64, P 64; float32 and bfloat16
   xh), the reference test's shapes, L 96, a = -50 with dt =
   softplus(3), where the decay above the diagonal overflows, and a =
   0.002, where cum increases (the kernel then takes every weight's exp
   directly, not in factors). Tolerances:
   ``rmsnorm`` float32 rtol/atol 1e-6 (another summation order), bfloat16
   one bfloat16 step; the quantize pair bit-equal, and composed
   bit-equal to ``qdq_int8``'s kernel and plain version; ``mamba_chunk``
   the reference test's 1e-4 (y, states) and 1e-5 (decay, cum), no NaN
   anywhere. Each is timed at full width (CUDA events, median of 20)
   beside its bound, its plain version and, for ``rmsnorm`` and
   dequantize, one PyTorch call (``F.rms_norm``, ``torch.mul(q,
   scales)``; yardsticks the port never calls; for ``rmsnorm`` and its
   library call, and for ``mamba_chunk``, the device's time is logged
   beside the call's; ``mamba_chunk``'s bound is its design's, bytes,
   with the 3xTF32 and float32 operation bounds logged beside it). Then
   this slice's path:
   with every count set to 0, each of the eleven ``ops`` functions is
   called once on the card (the last four at the full-width shapes, the
   others at small ones) against its plain version on the CPU, and every
   kernel must have been launched once (``sq_norm_groups`` twice:
   ``sq_norm`` is its one-row case; the exchange kernels, which ``ops``
   does not front, not at all).

11. the paper's T_i = inf mode, its convex experiments and the sync-DP
   baseline, through the port's entry points on the card. The convex
   suite through ``repro_torch.core.reference.run_alg1`` at each figure's
   own settings (the ``FIG*`` constants, each naming its source line in
   ``benchmarks/``; no cut; phase 16 runs in the main process meanwhile): Fig 2a, 2b, 3, 5 (with the decay fit and the
   T* formulas) and 6-7, each figure's own ``pass`` expression required,
   its integer quantities, slopes, rates and wall time printed; Fig 2b's
   T=10 and threshold runs over 5 rounds on the card against the CPU
   (gsq rtol 1e-4, inner counts equal). Fig 4 on the pytree round
   (paper-mlp at full config, G 4, 4 sequences of 64 a group, sgd, 10
   rounds; T 1, 10, 50 and threshold 3e-2 with ``max_inner`` 100), its
   ``pass`` expression required. The five convex figures and Fig 4 run
   at once, each in a process of its own (``--figure <name>``): they are
   host-bound (~20 small launches a local step), so the host issues them
   in parallel; each figure's wall time is taken under that load. Threshold mode at full width
   (paper-lenet, G 4, 2 sequences of 128 a group, sgd, 2 rounds, eps
   ``LENET_EPS``): counts within the cap, a group that stopped early at
   grad_sq <= eps, two groups at different counts below the cap in round
   1, the wire bytes worked out from the shapes; its fenced time and peak
   memory logged. The pytree round against the packed round at full
   width (sgd, T 4, server/fp32, the same params): server params within
   atol 1e-6. The packed round's microbatch mode at full width (sgd, G 4,
   T 2 microbatches of 2 x 128 tokens a group, server/fp32): with the
   counts set to 0 just before, ``fused_sgd`` launched once a step and
   ``sq_norm_groups`` twice, no exchange kernel; its server params
   within atol 1e-6 of the pytree round's microbatch mode. The packed
   sync step (paper-lenet, 8 x 128 tokens): sgd and momentum one step,
   adamw three, each launching its update kernel and ``sq_norm_groups``
   once a step (the counts set to 0 before each); every step's update and
   norm held against their plain versions (``impl="torch"``) on the
   state it started from and the gradient it was given, at its one-row
   (1, 124,662,528) geometry: the state bit-equal for sgd, rtol 1e-6 /
   atol 1e-7 for momentum and adamw, grad_sq rtol 1e-5; the pytree adamw
   step beside it agreeing after one step (rtol 1e-5 / atol 1e-6). None
   of the convex, Fig 4, threshold or pytree runs launches a kernel. One
   threshold round and one sync step under ``torch.profiler``.
   Then ``python -m repro_torch.launch.train`` at paper-mlp's full config
   with ``--mode sync --packed``, ``--threshold 3e-2`` (pytree) and
   ``--packed --adaptive-t --t-inner 4 --lr 0.02`` (its second round at
   the controller's T) must each exit 0.

12. the exchange on an unreliable network: fault plans, push_sum, the
   hierarchical tiers and overlapped delayed mixing, through the port's
   entry points on the card. First every ``FaultPlan`` mask (active,
   push, matrix at hops 0-1, edge lanes at hops 0-1 and offsets 0-1) of
   fault seeds 0-3, rounds 0-63 and G 1, 2, 4, 8, 17, of flat plans and
   of both tiers of the hierarchical exchange's ``TieredFaultPlan``,
   made for the card, must equal the CPU's bit for bit. Then a small
   reference check as in phase 4 (``FAULT_REF``, a paper-mlp reduction,
   3 rounds on the card with the kernels and on the CPU with the plain
   versions, the same numpy int8 noise): push_sum sgd at drop 0.1 /
   stall 0.05, a faulty server (drop 0.1) under adamw with int8 params
   and int8z moments, the hierarchical ring|push_sum over G 8 / 4 pods at
   DCN drop 0.075, and overlap on the ring with int8; fp32 paths at rtol
   1e-5 / atol 1e-6 (adamw params atol 1e-4, as phase 4), int8 paths by
   phase 4's rule; wire bytes, participation, the mass counters and the
   round counter equal. Then paper-lenet at full width through
   ``build_run`` (``FAULT_PLAN``: push_sum sgd and adamw with a bf16 wire
   at drop 0.05 / stall 0.02, the faulty server adamw int8/int8z, the
   faulty ring int8 at 2 hops, faulty gossip G 8 momentum bf16, server
   top-k at drop 0.1 (its residual deferred), the tiers ring|push_sum at
   DCN drop 0.075 and server|server with an int8 cross-tier codec over G
   8 / 4 pods, and overlap on the ring int8 under sgd and the server fp32
   under adamw; 2 rounds each, the counts set to 0 before the first run):
   every kernel launched as worked out per round (the update kernel T
   times, ``sq_norm_groups`` twice plus once per error-feedback residual,
   ``qdq_int8`` once per staged int8 stream and hop, ``codec_mix`` never,
   no serve or ``ops`` kernel), the wire bytes as worked out from the
   shapes (``expected_fault_wire``), ``|sum(mass) + sum(backlog_w) - G|
   <= 1e-3`` on push_sum, ``0 < participation <= 1``, every state buffer
   finite; each round's fenced time and peak memory logged, one round
   under ``torch.profiler``. Then the fault and tier benchmarks'
   headlines at their own settings (``FAULT_BENCH``, ``TIER_BENCH``: the
   consistent least squares of ``benchmarks/fault_tolerance.py`` and
   ``benchmarks/tier.py``, numpy data as theirs; the bias cells' x numpy
   drawn, where the reference draws it with ``jax.random``), printed
   beside ``BENCH_fault.json`` and ``BENCH_tier.json``: fault margin >= 1
   and unbias >= 100, tier margin >= 1, cross-tier wire reduction >= 3.5
   and unbias >= 1e4. Last, ``python -m repro_torch.launch.train`` at
   paper-mlp's full config with ``--packed`` and ``--comm push_sum
   --drop-rate 0.05``, ``--comm hierarchical --groups 8 --n-pods 4
   --drop-rate 0.075`` and ``--comm ring --codec int8 --overlap`` must
   each exit 0 and print each round's participation.

13. the engine's other model families at their published widths, the
   depth cut only where one card forces it (``FAMILY_SERVED``,
   ``FAMILY_TRAIN``). First the flash kernel in bfloat16 at each dense
   and moe model's 1024-token prefill geometry and the decode kernel with
   bfloat16 queries at each model's decode geometry, against their plain
   versions (``BF16_STEP`` against the float32 plain version; flash also
   within ``BF16_REF`` of the bfloat16 plain version), each timed beside
   its bound and flash beside SDPA. Then, the counts set to 0: packed
   local-SGD rounds (server/fp32, T 4, 2 x 128 tokens a group) of
   granite-moe-1b-a400m (sgd and momentum at G 4 on 9 of 24 layers,
   adamw at G 2 on 19), zamba2-7b (sgd, G 2, 10 of 81 layers) and
   xlstm-1.3b (sgd, G 2, 12 of 48 layers), each round launching its
   update kernel T times and ``sq_norm_groups`` twice, its losses finite
   and, at init, within 1.5 of ln(padded vocab); the granite-moe adamw
   run's server params saved, restored through ``serve.handoff`` equal
   bit for bit, and served. Then every family model through the engine
   from seeded params: granite-moe (all 24 layers), qwen3-32b (8 of 64),
   phi3.5-moe (4 of 32), zamba2-7b (all 81), xlstm-1.3b (all 48),
   nemotron-4-15b (8 of 32), qwen1.5-110b (4 of 80) and llama3-405b (2 of
   126, 2 requests): 8 slots, pages of 16, a Poisson workload of 8
   requests (prompts of 512-1024 tokens for dense and moe, through the
   flash prefill; 4 requests of 32-64 tokens for hybrid and ssm, whose
   prefill runs token by token), the tokens of the 2 requests with the
   shortest prompts equal under the continuous and static policies and
   replayed alone, the attention launches as
   worked out from the engines' steps and prefills, no kernel off the
   path launched (``mamba_chunk`` none: the models' mamba is plain, as
   in the reference). One granite-moe round and three qwen3-32b decode
   steps under ``torch.profiler``. Last, the update kernels and the norm
   against their plain versions at each round's (G, N) buffer.

14. the pytree round's exchange at full width (``TREE_PLAN``):
   paper-lenet, seed 0, T 4, 2 x 128 tokens a group, 2 rounds a run, fault
   seed 1, through ``build_run``, each exchange on the pytree round and
   on the packed round from the same params and batches: server bf16
   (sgd), ring fp16 at 2 hops, gossip bf16 over G 8 (momentum), a bf16
   downlink, bf16 moments (adamw), async_stale s 1 (adamw, moments
   averaged), the faulty server and ring at drop 0.1, push_sum at drop
   0.1, and the tiers ring|push_sum over G 8 / 4 pods at DCN drop 0.075.
   With the counts set to 0 before each run, the pytree runs must launch
   no kernel (a tree stream takes the staged path, as the reference's
   ``_fusable`` routes it) and the packed runs their update kernel T
   times, ``sq_norm_groups`` twice and ``codec_mix`` once per fused
   stream a round. Participation, round counters and wire bytes equal
   every round, push-sum's ``|sum(mass) + sum(backlog_w) - G| <= 1e-3``
   every round, and the params after 2 rounds: with a cast codec every
   group's within one step of the codec at each leaf's magnitude (at
   least 1e-6), else the server params within 1e-6, adamw's within 1e-5
   on all but 1e-6 of the elements and every one within 0.25 lr (phase
   4's rule: the two rounds' adamw formulas round v differently in the
   last bit, which adamw carries into near-eps-gradient weights' steps). Each round's fenced time and the peak memory of both
   rounds logged side by side. Then ``python -m
   repro_torch.launch.train`` without ``--packed`` (paper-lenet,
   ``--comm push_sum --drop-rate 0.1``, 2 rounds) must exit 0 and print
   each round's participation.

15. round telemetry, through ``python -m repro_torch.launch.train``'s
   ``main``, each run in a fresh process (``python3 chip_smoke.py
   --counted-train <flags>``, which prints the process's launches last).
   (a) alone: paper-lenet adamw (lr 1e-3), G 4, T 4, the ring with int8
   and ``--overlap`` (one hop: both packages refuse overlap with more),
   3 rounds, ``--trace`` and ``--checkpoint``: exit 0, the port's
   ``obs.report.check`` finds no problem, every round ``exchange_exposed
   <= exchange_total``; the calibrated local and exchange times, each
   round's phases and the overlap efficiency logged; ``fused_adamw``
   launched 36 times (the 3 rounds and the calibration's 6) and
   ``qdq_int8`` 3. Then at once: (b) the online controller at paper-mlp
   (sgd, lr 0.02, 4 rounds, ``--t-max 16``: a round that fits no decay
   asks for the cap, 10,000 steps by default), each round's T (at most
   16) and seconds logged, ``fused_sgd`` 12 (the calibration) plus its T
   a round; (c) ``--mode sync`` with
   ``--checkpoint`` (2 steps: ``fused_sgd`` and ``sq_norm_groups`` 2
   each, records ``step``, ``step``, ``checkpoint``) and the pytree
   round with push_sum at drop 0.1 (no kernel, no exchange split); (d)
   one paper-lenet adamw round under ``--profile``: one Chrome trace
   holding the ``round`` annotation, kernel events and 4 of the
   ``fused_adamw`` kernel (``fused_adamw`` 4). Every trace passes the
   check. (e) The OnlineT headline of ``benchmarks/overlap.py``
   (``ONLINE_T``) on the card with the kernels, the counts set to 0
   before it: both runs reach the floor 1e-3 within 600 rounds, the
   static/online wire ratio is at least 1.0, ``fused_sgd`` launched once
   a local step (the T-8 probe included) and ``sq_norm_groups`` 2 + T a
   round; its rounds and ratio logged beside ``BENCH_overlap.json``'s.

16. the vlm and audio families at their published widths and the
   ring-cache decode, seed 0, run while phase 11's figure processes run
   (they are host-bound; the script has 1200 s in all), so its times are
   taken under their load. (d) first: flash at internvl2-1b's prefill
   geometry (2, 14, 2, 1024, 64) bf16 (g 7) against its plain versions
   (``BF16_REF``, ``BF16_STEP``), timed beside SDPA and its bound. Then,
   the counts set to 0: (a) internvl2-1b (24 x 896, 14/2 heads, vocab
   151,655, bf16 over f32 params) through ``launch.train.build_run``,
   packed, server/fp32, G 2, T 4, 2 x 1024 tokens a group with 256 patch
   embeddings a sequence (``add_modalities``): 2 adamw rounds and 1 sgd
   round, each launching its update kernel T times and
   ``sq_norm_groups`` twice, the last round of each also run with the
   plain versions from a copy of its state (sgd bit-equal, adamw within
   ``EW_TOL``); the trained params' forward on 2 x 1024 tokens with
   patches under ``attn_impl="pallas"`` (24 flash launches) against
   ``"blocked"``: in float32 within ``PATH_TOL``'s rtol of the largest
   logit, in bfloat16 the flash path at most twice as far from the
   float32 logits as the blocked path; a 64-step greedy text decode on a
   ring of 48 slots in float32 and bfloat16 (``ring_decode_hold``: the
   float32 steps within 5e-2 of the teacher-forced log-softmax, the
   bfloat16 ones at most twice as far from the float32 teacher-forced as
   the bfloat16 teacher-forced; past the window the ring holds the last
   48 positions). (b) whisper-base (6 + 6 x 512, 1500 frames, vocab
   51,865): packed sgd and adamw rounds at G 4, T 4, 2 x 448 tokens a
   group over their frames (the same launch counts), then the launcher's
   ``main`` on the pytree round (no launch) and ``--mode sync --packed``
   (one ``fused_sgd`` and one ``sq_norm_groups``); 4 x 1500 frames
   encoded, the cross caches filled with ``cross_attention_cache``, 32
   greedy steps held as in (a). (c) paper-lenet's ring ``prefill`` of a
   1024-token prompt under ``attn_impl="pallas"`` (8 flash launches)
   against token-by-token ``decode_step`` over it (log-softmax within
   5e-2, slot positions equal), then 8 greedy steps from each cache,
   tokens equal. Each part's seconds and peak memory are logged.

17. sharded execution (``repro_torch.sharding``), run after phase 16
   while phase 11's figure processes run: paper-lenet at full
   width on a (G 4 x S 2) rank grid, N = 124,662,528 padded to
   124,662,784 (``packing.shard_layout``, a shard of 62,331,392), 8 rank
   processes on ``cuda:0`` joined over gloo, every collective through
   the ranks' CUDA IPC mailboxes on the card (the ``cuda-ipc``
   transport; NCCL refuses two ranks on one card), T 4, 2 x 128 tokens
   a group, 2 rounds a run: server fp32 sgd, momentum and adamw; adamw
   with int8 params; ring int8 at 2 hops with the ppermute hop and with
   the allgather hop; gossip bf16 momentum; top-k sgd; async_stale int8
   sgd; ``FAULT_PLAN``'s faulty server (momentum, int8/int8z, drop 0.1)
   and its push_sum sgd (drop 0.05, stall 0.02); the two tiers in 2 pods
   of 2 (``--comm hierarchical``, fault seed 1): a ring within pods and
   push_sum across them, sgd, drop 0.3, stall 0.1, intra drop 0.05; the
   same with bf16 intra and inter codecs, momentum, drop 0.08, stall
   0.05; a server on both tiers with an int8 inter codec, sgd, intra
   stall 0.1; and the overlapped exchange (``--overlap``), server int8
   and ring int8z (one hop), sgd. Each run first runs
   unsharded in this process on the same ``ShardedLayout`` (the port's
   packed round on the card), its buffers and metrics written to a
   temporary directory; each rank then reads its own block of them and
   holds its block, relative to the stream's largest element: a
   lossless (fp32) exchange every element within ``SHARD_REL`` (1e-5);
   a lossy one (int8, int8z, bf16, top-k: a last-bit difference of the
   mean's summation order can move a codec's rounding by a quantum) at
   most ``SHARD_OFF`` of the elements past 1e-5 and every element
   within ``SHARD_LOSSY``; the control, the block held one element
   over, must fail the same hold; under overlap each stream's in-flight
   payload is held alike. The loss and grad_sq at rtol 1e-4 (lossy:
   2e-3), wire bytes and the three participations exactly, push-sum's
   mass and its backlog within 1e-3 of G. The counts are
   set to 0 in each rank before each run and read after it: each rank
   launches its update kernel T times a round, ``sq_norm_groups`` 2 + T
   times (traj metrics; +1 for top-k's residual), ``qdq_int8`` once per
   int8 stream and hop (the int8 inter codec and the overlap encode
   once a round), and ``codec_mix`` never (``shard_launches``, summed
   over the ranks). Each rank's fenced round seconds, its seconds in
   collectives and their share are logged. A rank's failure fails the
   phase.
   Then the launcher as a user starts it, ``python -m
   repro_torch.launch.train --arch paper-lenet --packed --groups 4
   --shard 2`` (2 rounds, T 4, 2 x 128 tokens, ``--trace`` and
   ``--checkpoint``) in a fresh process beside the same launcher
   without ``--shard``: the round lines agree to their printed digits,
   the trace passes the port's check, the checkpoints (gathered to
   rank 0) agree within rtol 1e-5.

The line before the last is one JSON object with each kernel's numbers
(the launches of phases 5 and 8 for the first eight, of phase 10's
``ops`` path for the last four; the update kernels and
``sq_norm_groups`` also carry phase 11's ``microbatch_launches`` and
``sync_launches``, and every kernel phase 12's full-width
``fault_launches``, and the kernels of phase 13's path its
``family_launches``, and phase 14's ``tree_exchange_launches`` (the
pytree runs: 0) and ``tree_exchange_packed_launches`` (their packed
comparisons), and phase 15's ``telemetry_launches`` (its launcher
processes and the headline), and phase 16's ``modality_launches``
(parts (a)-(c)), and the update kernels, ``sq_norm_groups``,
``codec_mix`` and ``qdq_int8`` phase 17's ``shard_launches`` (summed
over its 8 ranks), each path's own count; ``paged_decode_attention``
and ``mamba_chunk`` also carry ``device_ms``, the device's time alone at
the shape of their ``ms``); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

MAIN = (4, 124_662_528)          # paper-lenet's packed buffer at G = 4
RAGGED = (3, 1_000_003)
# rows shorter than a float4, and rows whose starts fall on every
# alignment: the kernels' ragged head and tail
TINY = ((5, 1), (3, 2), (4, 3), (2, 7), (1, 4099))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # the same, float32 outside tensor cores
TF32_OPS_PER_S = 495e12          # the same, TF32 on the tensor cores, dense
SLEEP_CYCLES = 2_000_000         # ~1 ms of an H100's clock, ahead of a timed call
EW_TOL = dict(rtol=1e-6, atol=1e-7)
NORM_RTOL = 1e-5

SOURCES = {
    "fused_sgd": ("src/repro_torch/kernels/csrc/fused_update.cu",
                  "src/repro/kernels/fused_sgd.py:28"),
    "fused_momentum": ("src/repro_torch/kernels/csrc/fused_update.cu",
                       "src/repro/kernels/fused_momentum.py:32"),
    "fused_adamw": ("src/repro_torch/kernels/csrc/fused_update.cu",
                    "src/repro/kernels/fused_adamw.py:42"),
    "sq_norm_groups": ("src/repro_torch/kernels/csrc/sq_norm.cu",
                       "src/repro/kernels/sq_norm.py:38"),
    "codec_mix": ("src/repro_torch/kernels/csrc/exchange_epilogue.cu",
                  "src/repro/kernels/exchange_epilogue.py:204"),
    "qdq_int8": ("src/repro_torch/kernels/csrc/exchange_epilogue.cu",
                 "src/repro/kernels/exchange_epilogue.py:232"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:159"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:84"),
    "quantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:38"),
    "dequantize_int8": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:64"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:34"),
    "mamba_chunk": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                    "src/repro/kernels/mamba_scan.py:61"),
}
# bytes moved (each input read once, each output written once) and
# float32 operations, per element of the (G, N) buffer. codec_mix as the
# main path's int8 params stream runs it (server, one hop): x, x0 and the
# noise in, the mix out; sub, abs, max, div, add, floor, 2 clips, mul,
# add, the G-sum and the division. qdq_int8: x and u in, out; abs, max,
# div, add, floor, 2 clips, mul.
PER_ELEMENT = {"fused_sgd": (12, 2), "fused_momentum": (20, 4),
               "fused_adamw": (28, 16), "sq_norm_groups": (4, 2),
               "codec_mix": (16, 12), "qdq_int8": (12, 8)}
SPLIT = (8, 62_331_264)          # the same element count over G = 8
WIDE = (32, 15_582_816)          # and over G = 32: codec_mix's general kernel
# codec_mix past its register kernel: G 17-40 (every kind), and (shape,
# int8 chunk) for the chunks other than 256
WIDE_G = (WIDE, (17, 100_003), (40, 4099), (33, 257))
WIDE_CHUNK = ((MAIN, 128), (MAIN, 512), ((5, 100_003), 37),
              ((3, 4099), 1024), ((20, 10_007), 128))
QDQ_ROWS = (1_947_852, 256)      # MAIN's int8 rows
TINY_G = ((1, 1), (2, 3), (16, 700), (5, 4099), (7, 257))


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def compare(name, got, want, rtol, atol):
    """Max abs error of got vs want; raise where |got-want| > atol+rtol|want|."""
    diff = (got - want).abs_()
    err = diff.max().item()
    if bool((diff > atol + rtol * want.abs()).any()):
        fail(f"{name}: kernel disagrees with the plain version "
             f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
    return err


def time_ms(fn, torch, reps=20, warmup=3, device_only=False):
    """Median ms of one call between CUDA events: the time of the call,
    which counts the host's time to issue it where that is the longer (a
    short kernel's). ``device_only``: the card is first held busy
    (``torch.cuda._sleep``, ~1 ms) while the host enqueues the start event
    and the call, so the time is the device's alone (where issuing takes
    longer than the sleep, part of it still counts)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def call_and_device_ms(torch, kern, lib):
    """The kernel's and the library call's ms, each as the call's time
    (``ms``, ``library_ms``: the ``kernels`` line's measure) and as the
    device's alone (``device_ms``, ``library_device_ms``)."""
    return dict(ms=time_ms(kern, torch),
                device_ms=time_ms(kern, torch, device_only=True),
                library_ms=time_ms(lib, torch),
                library_device_ms=time_ms(lib, torch, device_only=True))


def bound(name, shape):
    rows, n = shape
    nbytes, ops = PER_ELEMENT[name]
    return bound_of(nbytes * rows * n, ops * rows * n)


def bound_of(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / ops_per_s * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_kernels(torch, K, ref):
    """Phase 3: every kernel against its plain version, and its times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {name: {"max_abs_err": 0.0} for name in SOURCES}

    def rand(shape, scale=1.0, positive=False):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.abs_() if positive else x

    def note(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for shape in (MAIN, RAGGED) + TINY:
        rows = shape[0]
        p, g = rand(shape), rand(shape)
        m, v = rand(shape, 0.1), rand(shape, 0.01, positive=True)
        off = rows // 2
        mask = torch.ones(rows, dtype=torch.bool, device=dev)
        mask[off] = False
        for active in (None, mask):
            tag = f"{shape} " + ("all rows" if active is None
                                 else f"row {off} off")
            # sgd: bit-equal
            _sgd_case(torch, K, p, g, active, tag, note)
            # momentum
            kp, kmu = p.clone(), m.clone()
            K.fused_momentum.fused_momentum(kp, g, kmu, lr=0.05, beta=0.9,
                                            active=active, impl="cuda")
            wp, wmu = ref.momentum_ref(p, g, m, lr=0.05, beta=0.9)
            if active is not None:
                wp[off], wmu[off] = p[off], m[off]
            note("fused_momentum", max(
                compare(f"fused_momentum p {tag}", kp, wp, **EW_TOL),
                compare(f"fused_momentum mu {tag}", kmu, wmu, **EW_TOL)))
            del kp, kmu, wp, wmu
            # adamw: counts 1 and 1000, one count per row, wd 0 and 0.01
            counts = [torch.tensor(1, device=dev),
                      torch.tensor(1000, device=dev),
                      torch.arange(1, rows + 1, device=dev) * 250]
            for count in counts:
                for wd in (0.0, 0.01):
                    kp, km, kv = p.clone(), m.clone(), v.clone()
                    K.fused_adamw.fused_adamw(kp, g, km, kv, count, lr=1e-3,
                                              wd=wd, active=active,
                                              impl="cuda")
                    bc = ref.adamw_bias_correction(count.expand(rows))
                    want = ref.adamw_ref(p, g, m, v, bc, lr=1e-3, wd=wd)
                    errs = []
                    for label, k, w, old in zip("pmv", (kp, km, kv), want,
                                                (p, m, v)):
                        if active is not None:
                            w[off] = old[off]
                        errs.append(compare(
                            f"fused_adamw {label} {tag} count "
                            f"{count.tolist()} wd {wd}", k, w, **EW_TOL))
                    note("fused_adamw", max(errs))
                    del kp, km, kv, want
        if rows > 1:
            # a step of the per-group T_i schedule: one active row
            only = torch.zeros(rows, dtype=torch.bool, device=dev)
            only[off] = True
            _sgd_case(torch, K, p, g, only, f"{shape} only row {off} on",
                      note)
        # the norm, twice: the reduction must not depend on block order
        s1 = K.sq_norm.sq_norm_groups(p, impl="cuda")
        s2 = K.sq_norm.sq_norm_groups(p, impl="cuda")
        if not torch.equal(s1, s2):
            fail(f"sq_norm_groups {shape}: two runs differ")
        note("sq_norm_groups", compare(f"sq_norm_groups {shape}", s1,
                                       ref.sq_norm_groups_ref(p),
                                       rtol=NORM_RTOL, atol=0.0))
        log(f"kernels agree with their plain versions at {shape}")

        if shape == MAIN:
            step = torch.tensor(1000.0, device=dev)
            timed = {
                "fused_sgd": (
                    lambda: K.fused_sgd.fused_sgd(p, g, lr=1e-4, impl="cuda"),
                    lambda: ref.sgd_ref(p, g, lr=1e-4),
                    lambda: p.add_(g, alpha=-1e-4)),
                "fused_momentum": (
                    lambda: K.fused_momentum.fused_momentum(
                        p, g, m, lr=1e-4, beta=0.9, impl="cuda"),
                    lambda: ref.momentum_ref(p, g, m, lr=1e-4, beta=0.9),
                    lambda: torch._fused_sgd_(
                        [p], [g], [m], weight_decay=0.0, momentum=0.9,
                        lr=1e-4, dampening=0.0, nesterov=False,
                        maximize=False, is_first_step=False)),
                "fused_adamw": (
                    lambda: K.fused_adamw.fused_adamw(
                        p, g, m, v, step, lr=1e-4, wd=0.01, impl="cuda"),
                    lambda: ref.adamw_ref(p, g, m, v,
                                          ref.adamw_bias_correction(
                                              step.expand(rows)),
                                          lr=1e-4, wd=0.01),
                    lambda: torch._fused_adamw_(
                        [p], [g], [m], [v], [], [step], lr=1e-4, beta1=0.9,
                        beta2=0.999, weight_decay=0.01, eps=1e-8,
                        amsgrad=False, maximize=False)),
                "sq_norm_groups": (
                    lambda: K.sq_norm.sq_norm_groups(p, impl="cuda"),
                    lambda: ref.sq_norm_groups_ref(p),
                    lambda: torch.linalg.vector_norm(p, dim=1)),
            }
            for name, (kern, plain, lib) in timed.items():
                r = results[name]
                t = call_and_device_ms(torch, kern, lib)
                r.update(ms=t["ms"], library_ms=t["library_ms"])
                r["plain_ms"] = time_ms(plain, torch)
                r["bound_ms"], r["bound_by"] = bound(name, MAIN)
                log(f"{name:15s} kernel_ms {r['ms']:.4f} (device "
                    f"{t['device_ms']:.4f}) bound_ms "
                    f"{r['bound_ms']:.4f} ({r['bound_by']}: "
                    f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                    f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s f32, H100 SXM data "
                    f"sheet) plain_ms {r['plain_ms']:.4f} library_ms "
                    f"{r['library_ms']:.4f} (device "
                    f"{t['library_device_ms']:.4f}) max_abs_err "
                    f"{r['max_abs_err']:.3e}")
            # a step of the per-group T_i schedule: one active row of four
            only = torch.zeros(rows, dtype=torch.bool, device=dev)
            only[off] = True
            t = call_and_device_ms(
                torch,
                lambda: K.fused_sgd.fused_sgd(p, g, lr=1e-4, active=only,
                                              impl="cuda"),
                lambda: p[off].add_(g[off], alpha=-1e-4))
            every = torch.ones(rows, dtype=torch.bool, device=dev)
            masked = time_ms(lambda: K.fused_sgd.fused_sgd(
                p, g, lr=1e-4, active=every, impl="cuda"), torch,
                device_only=True)
            log(f"fused_sgd one active row of {rows} kernel_ms "
                f"{t['ms']:.4f} (device {t['device_ms']:.4f}) bound_ms "
                f"{bound('fused_sgd', (1, shape[1]))[0]:.4f} library_ms "
                f"(add_ on the row) {t['library_ms']:.4f} (device "
                f"{t['library_device_ms']:.4f}); every row by an all-true "
                f"mask: device {masked:.4f}")
            _sq_norm_launches(torch, K, p)
        del p, g, m, v
        torch.cuda.empty_cache()
    return results


def _sgd_case(torch, K, p, g, active, tag, note):
    """fused_sgd against its plain version, bit for bit; rows that are not
    active must keep their values."""
    kp = p.clone()
    K.fused_sgd.fused_sgd(kp, g, lr=0.05, active=active, impl="cuda")
    wp = p.clone()
    K.fused_sgd.fused_sgd(wp, g, lr=0.05, active=active, impl="torch")
    err = (kp - wp).abs_().max().item()
    note("fused_sgd", err)
    if not torch.equal(kp, wp):
        fail(f"fused_sgd {tag}: differs from the plain version (max abs "
             f"err {err:.3e})")
    if active is not None and not torch.equal(kp[~active], p[~active]):
        fail(f"fused_sgd {tag}: changed an inactive row")
    del kp, wp


def _sq_norm_launches(torch, K, x, calls=5):
    """sq_norm_groups is one launch a call: the profiler counts the
    device kernels of ``calls`` calls at ``x``."""
    from torch.profiler import ProfilerActivity, profile
    K.sq_norm.sq_norm_groups(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            K.sq_norm.sq_norm_groups(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    if sum(kernels.values()) != calls:
        fail(f"sq_norm_groups: {calls} calls ran the device kernels "
             f"{kernels}, not one each")
    log(f"sq_norm_groups: {calls} calls, device kernels {kernels}")


def check_exchange_kernels(torch, ee, results):
    """Phase 3, the exchange kernels: bit-equal to their plain versions
    (the max abs error of each comparison is logged and must be 0), and
    timed at the main path's shapes."""
    from repro_torch.comm import codecs, topology

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def same(what, name, got, want):
        err = (got - want).abs().max().item() if got.numel() else 0.0
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           err)
        if not torch.equal(got, want):
            fail(f"{what}: kernel differs from the plain version "
                 f"(max abs err {err:.3e})")

    # the register kernel (G <= 16, the int8 chunk 256), then the general
    # one: more than 16 groups in every kind, other int8 chunks
    cases = ([(shape, 256, ee.KINDS) for shape in (MAIN, SPLIT, RAGGED)
              + TINY_G]
             + [(shape, 256, ee.KINDS) for shape in WIDE_G]
             + [(shape, chunk, ("int8",)) for shape, chunk in WIDE_CHUNK])
    for shape, chunk, kinds in cases:
        g, n = shape
        x0 = torch.randn(shape, generator=gen, device=dev)
        x = x0 + 0.01 * torch.randn(shape, generator=gen, device=dev)
        res = 0.01 * torch.randn(shape, generator=gen, device=dev)
        c = (x - x0 + res).abs_()
        tau = torch.topk(c, max(1, round(0.05 * n)), dim=-1,
                         sorted=False).values.amin(-1, keepdim=True)
        del c
        u2 = torch.rand((2, g * -(-n // chunk), chunk), generator=gen,
                        device=dev)
        mixes = [("mean", None, 1)] + [
            (f"{t} hops {h}", topology.mixing_matrix(t, g, seed=0), h)
            for t in ("ring", "gossip") for h in (1, 2)]
        for kind in kinds:
            for label, w, hops in mixes:
                if kind == "thresh" and w is not None:
                    continue
                kw = dict(kind=kind, w=w, hops=hops)
                if kind == "int8":
                    kw.update(chunk=chunk,
                              u=u2[:hops if w is not None else 1])
                if kind == "thresh":
                    kw.update(residual=res, tau=tau)
                before = ee.launches["codec_mix"]
                got, got_res = ee.codec_mix(x, x0, impl="cuda", **kw)
                want, want_res = ee.codec_mix(x, x0, impl="torch", **kw)
                what = f"codec_mix {kind} {label} {shape} chunk {chunk}"
                if ee.launches["codec_mix"] != before + 1:
                    fail(f"{what}: the kernel was not launched once")
                same(what, "codec_mix", got, want)
                if kind == "thresh":
                    same(what + " residual", "codec_mix", got_res, want_res)
                del got, want, got_res, want_res
        # in place, as the exchange calls it
        kw = (dict(kind="bf16") if "bf16" in kinds else
              dict(kind="int8", u=u2[:1], chunk=chunk))
        want, _ = ee.codec_mix(x, x0, impl="torch", **kw)
        ee.codec_mix(x, x0, out=x, impl="cuda", **kw)
        same(f"codec_mix {kw['kind']} in place {shape} chunk {chunk}",
             "codec_mix", x, want)
        log(f"codec_mix equals its plain version at {shape}, "
            f"{'/'.join(kinds)} chunk {chunk}")
        del x, x0, res, u2, want
        torch.cuda.empty_cache()

    # qdq_int8: MAIN's rows, ragged row counts, all-zero chunks, int8z
    for rows_n in (QDQ_ROWS[0], 1, 7, 3907):
        rows = torch.randn((rows_n, 256), generator=gen, device=dev)
        rows[rows_n // 2] = 0.0
        rows[: max(1, rows_n // 3), :128] *= 1e-6
        u = torch.rand((rows_n, 256), generator=gen, device=dev)
        same(f"qdq_int8 ({rows_n}, 256)", "qdq_int8",
             ee.qdq_int8(rows, u, impl="cuda"),
             ee.qdq_int8(rows, u, impl="torch"))
        same(f"qdq_int8 int8z ({rows_n}, 256)", "qdq_int8",
             codecs.int8z(impl="cuda").compress_rows(rows, u),
             codecs.int8z(impl="torch").compress_rows(rows, u))
        if rows_n != QDQ_ROWS[0]:
            continue
        r = results["qdq_int8"]
        r["ms"] = time_ms(lambda: ee.qdq_int8(rows, u, impl="cuda"), torch)
        r["plain_ms"] = time_ms(lambda: ee.qdq_int8(rows, u, impl="torch"),
                                torch)
        r["bound_ms"], r["bound_by"] = bound("qdq_int8", QDQ_ROWS)
        r["library_ms"] = None
        log(f"qdq_int8 {QDQ_ROWS} kernel_ms {r['ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) plain_ms "
            f"{r['plain_ms']:.4f} library_ms none (no single PyTorch call)")
        del rows, u
    log("qdq_int8 equals its plain version (rows of 256, int8z too)")

    # times at MAIN: the int8 params stream of the main path (the JSON
    # line's numbers), and the other kinds beside it
    g, n = MAIN
    x0 = torch.randn(MAIN, generator=gen, device=dev)
    x = x0 + 0.01 * torch.randn(MAIN, generator=gen, device=dev)
    res = 0.01 * torch.randn(MAIN, generator=gen, device=dev)
    tau = torch.full((g, 1), 0.02, device=dev)
    out, res_out = torch.empty_like(x), torch.empty_like(x)
    u2 = torch.rand((2, g * -(-n // 256), 256), generator=gen, device=dev)
    ring = topology.ring_matrix(g)
    cases = {
        "int8 mean": (dict(kind="int8", u=u2[:1], chunk=256), 16, 12),
        "bf16 mean": (dict(kind="bf16"), 12, 6),
        "fp16 mean": (dict(kind="fp16"), 12, 6),
        "thresh mean": (dict(kind="thresh", residual=res, tau=tau), 20, 9),
        "int8 ring hops 2": (dict(kind="int8", u=u2, chunk=256, w=ring,
                                  hops=2), 20, 40),
    }
    for label, (kw, nbytes, ops) in cases.items():
        extra = dict(residual_out=res_out) if kw["kind"] == "thresh" else {}
        ms = time_ms(lambda: ee.codec_mix(x, x0, out=out, impl="cuda",
                                          **kw, **extra), torch)
        plain = time_ms(lambda: ee.codec_mix(x, x0, impl="torch", **kw),
                        torch, reps=5, warmup=1)
        bms, by = bound_of(nbytes * g * n, ops * g * n)
        log(f"codec_mix {label:16s} {MAIN} kernel_ms {ms:.4f} bound_ms "
            f"{bms:.4f} ({by}, {nbytes} B/element) plain_ms {plain:.4f}")
        if label == "int8 mean":
            r = results["codec_mix"]
            r.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None)
    del x, x0, res, out, res_out, u2
    torch.cuda.empty_cache()

    # the general kernel: G 32 over MAIN's element count, and MAIN at the
    # int8 chunk 128 (a W hop: the G-term contraction and the codec)
    for shape, chunk in ((WIDE, 256), (MAIN, 128)):
        g, n = shape
        x0 = torch.randn(shape, generator=gen, device=dev)
        x = x0 + 0.01 * torch.randn(shape, generator=gen, device=dev)
        out = torch.empty_like(x)
        u2 = torch.rand((2, g * -(-n // chunk), chunk), generator=gen,
                        device=dev)
        cases = {"int8 mean": (dict(kind="int8", u=u2[:1], chunk=chunk),
                               16, 12)}
        if chunk == 256:
            cases["bf16 mean"] = (dict(kind="bf16"), 12, 6)
            cases["int8 ring hops 2"] = (
                dict(kind="int8", u=u2, chunk=chunk,
                     w=topology.ring_matrix(g), hops=2),
                20, 2 * (2 * g + 12))
        for label, (kw, nbytes, ops) in cases.items():
            ms = time_ms(lambda: ee.codec_mix(x, x0, out=out, impl="cuda",
                                              **kw), torch)
            bms, by = bound_of(nbytes * g * n, ops * g * n)
            log(f"codec_mix {label:16s} {shape} chunk {chunk} (general "
                f"kernel) kernel_ms {ms:.4f} bound_ms {bms:.4f} ({by}, "
                f"{nbytes} B/element)")
        del x, x0, out, u2
        torch.cuda.empty_cache()


# Exchanges past codec_mix's register kernel, which run its general one
# (topology, codec, G, int8 chunk), at N = COVER_N: G 32 as a 32-worker
# run would send them, and int8 chunks other than 256
COVER_N = 100_003
COVER = [("server", "int8", 32, 256), ("ring", "int8", 32, 256),
         ("server", "topk", 32, 256), ("server", "fp16", 32, 256),
         ("gossip", "bf16", 32, 256), ("server", "int8", 4, 128),
         ("ring", "int8", 4, 512)]


def check_exchange_coverage(torch, ee, results):
    """Phase 3: the staged int8 core ``qdq_int8`` at chunks 128, 512 and
    37, bit-equal to its plain version; then each ``COVER`` exchange on
    the card, with the kernels and with their plain versions, from the
    same inputs and noise: equal bits, and one ``codec_mix`` launch (the
    exchange fuses these streams, as the reference does)."""
    from repro_torch.comm import exchange

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for rows_n, chunk in ((3907, 128), (3907, 512), (9, 37), (1, 512)):
        x = torch.randn((rows_n, chunk), generator=gen, device=dev)
        x[rows_n // 2] = 0.0
        u = torch.rand((rows_n, chunk), generator=gen, device=dev)
        got = ee.qdq_int8(x, u, impl="cuda")
        if not torch.equal(got, ee.qdq_int8(x, u, impl="torch")):
            fail(f"qdq_int8 ({rows_n}, {chunk}): differs from the plain "
                 "version")
    log("qdq_int8 equals its plain version at chunks 128, 512 and 37")
    for topo, codec, g, chunk in COVER:
        x0 = torch.randn((1, COVER_N), generator=gen, device=dev).repeat(g, 1)
        x = x0 + 0.01 * torch.randn((g, COVER_N), generator=gen, device=dev)
        hops = 2 if topo == "ring" else 1
        out, launched = {}, None
        for impl in ("auto", "torch"):
            ex = exchange.get_exchange(topo, codec, g, chunk=chunk,
                                       mix_rounds=hops, seed=3, impl=impl)
            before = dict(ee.launches)
            mixed, _ = ex.streams({"params": x.clone()},
                                   {"params": x0.clone()},
                                   ex.init(x0.clone()))
            got = {k: v - before[k] for k, v in ee.launches.items()}
            want = {"codec_mix": 1 if impl == "auto" else 0, "qdq_int8": 0}
            if got != want:
                fail(f"exchange {topo} {codec} G {g} chunk {chunk} "
                     f"impl={impl}: launches {got}, expected {want}")
            out[impl] = mixed["params"]
            launched = launched if impl == "torch" else got
        what = f"exchange {topo} {codec} G {g} chunk {chunk}"
        err = (out["auto"] - out["torch"]).abs().max().item()
        if not torch.equal(out["auto"], out["torch"]):
            fail(f"{what}: the card's kernels differ from the plain versions "
                 f"(max abs err {err:.3e})")
        results["codec_mix"]["max_abs_err"] = max(
            results["codec_mix"]["max_abs_err"], err)
        log(f"{what}: fused on the card (launches {launched}), equal to "
            "the plain versions")
        del x0, x, out
    torch.cuda.empty_cache()


def reference_check(torch):
    """Phase 4: the round with the kernels on the card against the same
    round with the plain versions on the CPU, on a paper-mlp reduction."""
    import numpy as np

    from repro_torch import comm, optim, tree
    from repro_torch.configs.base import get_config
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import packing

    cfg = get_config("paper-mlp").reduced()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator().manual_seed(7))
    layout = packing.layout_of(params)
    pipe = TokenPipeline(cfg.vocab_size, 32, seed=7).batches((3, 2))
    batches = [torch.as_tensor(next(pipe)["tokens"]) for _ in range(2)]
    # momentum moves each weight by lr*g; adamw by ~lr whatever |g| is, so
    # its near-zero-gradient weights carry the CPU/GPU matmul differences
    # into their steps at up to ~1e-2 of lr
    for name, lr, t_i, atol in (("momentum", 0.05, None, 1e-6),
                                ("adamw", 1e-3, (1, 3, 2), 1e-4)):
        lcfg = lsgd.LocalSGDConfig(n_groups=3, inner_steps=3, t_i=t_i,
                                   metrics="traj")
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.get(name, lr, packed=True)
            rnd = lsgd.make_local_round(model.loss, opt, lcfg, layout=layout)
            state = lsgd.init_state(tree.tree_map(lambda x: x.to(dev), params),
                                    opt, 3, layout)
            for b in batches:
                state, m = rnd(state, {"tokens": b.to(dev)})
            out[dev] = (state["params"].cpu(),
                        {k: v.cpu() for k, v in m.items()
                         if isinstance(v, torch.Tensor)})
        compare(f"round {name} params (cuda vs cpu)", out["cuda"][0],
                out["cpu"][0], rtol=1e-4, atol=atol)
        for k in ("loss", "grad_sq_traj", "consensus_sq", "consensus_sq_post"):
            compare(f"round {name} {k} (cuda vs cpu)", out["cuda"][1][k],
                    out["cpu"][1][k], rtol=1e-4, atol=1e-6)
        log(f"reference check: {name} round on the card agrees with the CPU")

    # The lossy exchange, both sides fed the same numpy noise. The card's
    # gradients and W products differ from the CPU's in the last bits, so
    # a quantized delta can round one step differently on a few elements
    # (int8: one chunk quantum): params and moments agree at rtol 1e-4 /
    # atol 1e-6 (adamw params atol 1e-4, as above) on all but 1% of the
    # elements, every element within 2e-3 (a few quanta of these rounds'
    # deltas), and the metrics at rtol 2e-3. adamw runs with eps 1e-3:
    # with int8z moments at eps 1e-8 this model's adamw diverges on both
    # devices (see tests/test_torch_lossy_round.py), and a diverging run
    # cannot be compared.
    def numpy_noise(seed):
        def fn(count, shape):
            return np.random.default_rng([seed, count]).random(
                shape, dtype=np.float32)
        return fn

    for name, lr, okw, topo, codec, mcodec, mix, G in (
            ("adamw", 1e-3, dict(eps=1e-3), "server", "int8", "int8z", 1, 3),
            ("sgd", 0.05, {}, "ring", "int8", "fp32", 2, 4)):
        lcfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=3, metrics="final")
        pipe = TokenPipeline(cfg.vocab_size, 32, seed=7).batches((G, 2))
        lbatches = [torch.as_tensor(next(pipe)["tokens"]) for _ in range(3)]
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.get(name, lr, packed=True, **okw)
            ex = comm.get_exchange(topo, codec, G, moment_codec=mcodec,
                                   mix_rounds=mix, noise_hook=numpy_noise)
            rnd = lsgd.make_local_round(model.loss, opt, lcfg, layout=layout,
                                        exchange=ex)
            state = lsgd.init_state(tree.tree_map(lambda x: x.to(dev), params),
                                    opt, G, layout, exchange=ex)
            for b in lbatches:
                state, m = rnd(state, {"tokens": b.to(dev)})
            out[dev] = ({k: v.cpu() for k, v in
                         [("params", state["params"])]
                         + [(k, state["opt"][k]) for k in opt.moment_keys]},
                        {k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in m.items()})
        tag = f"{topo} {codec}/{mcodec} {name}"
        for k, want in out["cpu"][0].items():
            got = out["cuda"][0][k]
            atol = 1e-4 if (k == "params" and name == "adamw") else 1e-6
            off = ((got - want).abs() > atol + 1e-4 * want.abs())
            err = compare(f"round {tag} {k} (cuda vs cpu)", got, want,
                          rtol=0.0, atol=2e-3)
            frac = off.double().mean().item()
            if frac > 0.01:
                fail(f"round {tag} {k}: {frac:.2%} of the elements differ "
                     "beyond rtol 1e-4 (allowed 1%)")
            log(f"reference check: {tag} {k}: max abs err {err:.3e}, "
                f"{frac:.4%} of the elements beyond rtol 1e-4")
        for k in ("loss", "grad_sq", "consensus_sq", "consensus_sq_post"):
            compare(f"round {tag} {k} (cuda vs cpu)", out["cuda"][1][k],
                    out["cpu"][1][k], rtol=2e-3, atol=1e-6)
        for k, v in out["cpu"][1].items():
            if k.startswith("wire_bytes") and v != out["cuda"][1][k]:
                fail(f"round {tag} {k}: {v} on the CPU, "
                     f"{out['cuda'][1][k]} on the card")
        log(f"reference check: {tag} round on the card agrees with the CPU")


# Phase 5's runs: optimizer, lr, metrics, rounds, groups, the exchange
# (launcher flags), and per round the launches of codec_mix and qdq_int8
# and the streams whose error-feedback residual sq_norm_groups reduces.
PLAN = [
    dict(opt="adamw", lr=1e-3, metrics="final", rounds=3),
    dict(opt="sgd", lr=0.05, metrics="final", rounds=1),
    dict(opt="momentum", lr=0.05, metrics="final", rounds=1),
    dict(opt="adamw", lr=1e-3, metrics="traj", rounds=1),
    dict(opt="adamw", lr=1e-3, rounds=3, codec="int8", moment_codec="int8z",
         codec_mix=1, qdq_int8=2, wire=3_038_649_120),
    dict(opt="sgd", lr=0.05, rounds=1, comm="ring", codec="int8",
         mix_rounds=2, codec_mix=1, wire=2_025_766_080),
    dict(opt="momentum", lr=0.05, rounds=1, groups=8, comm="gossip",
         codec="bf16", moment_codec="fp16", codec_mix=2,
         wire=22 * 2 * 249_325_056),
    dict(opt="sgd", lr=0.05, rounds=1, codec="topk", codec_mix=1,
         residuals=1, wire=398_920_064),
    dict(opt="sgd", lr=0.05, rounds=1, comm="async_stale", codec="int8",
         staleness=1, qdq_int8=1),
    dict(opt="adamw", lr=1e-3, rounds=1, downlink_codec="int8", qdq_int8=3),
]
MOMENTS = {"sgd": 0, "momentum": 1, "adamw": 2}


def expected_wire(run, n):
    """A round's wire bytes from the shapes: each stream's payload through
    its codec (fp32 4 bytes/element, fp16/bf16 2, int8/int8z 1 plus a
    4-byte scale per 256, top-k 8 bytes for each of round(0.05 n) entries);
    server and async_stale count the pushes and the broadcast replies
    (the replies at the downlink codec's width when one is set), ring and
    gossip one payload per directed edge of W per hop."""
    import numpy as np

    from repro_torch.comm import topology

    def width(codec):
        return {"fp32": 4 * n, "fp16": 2 * n, "bf16": 2 * n,
                "int8": n + 4 * -(-n // 256), "int8z": n + 4 * -(-n // 256),
                "topk": 8 * max(1, round(0.05 * n))}[codec]

    g, comm_ = run.get("groups", 4), run.get("comm", "server")
    codecs_ = ([run.get("codec", "fp32")]
               + [run.get("moment_codec", "fp32")] * MOMENTS[run["opt"]])
    up = sum(width(c) for c in codecs_)
    if comm_ in ("ring", "gossip"):
        w = topology.mixing_matrix(comm_, g, seed=0)
        edges = int((w - np.diag(np.diag(w)) != 0).sum())
        return edges * run.get("mix_rounds", 1) * up
    down = (sum(width(run["downlink_codec"]) for _ in codecs_)
            if run.get("downlink_codec") else up)
    senders = g // (run.get("staleness", 1) + 1) if comm_ == "async_stale" \
        else g
    return senders * (up + down)


def main_path(torch, K, ee, ckpt):
    """Phase 5: paper-lenet at full width through the launcher's builder,
    server/fp32 and then the lossy exchange. The first run's server params
    are saved to ``ckpt`` for the serve phases; they are returned."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    T, per_group, seq = 4, 2, 128
    mods = {"fused_sgd": K.fused_sgd, "fused_momentum": K.fused_momentum,
            "fused_adamw": K.fused_adamw, "sq_norm_groups": K.sq_norm}

    def counts():
        c = {name: mod.launches for name, mod in mods.items()}
        c.update(ee.launches)
        return c

    for mod in mods.values():
        mod.launches = 0
    for k in ee.launches:
        ee.launches[k] = 0
    expected = dict.fromkeys(counts(), 0)
    first_loss = {}
    for run in PLAN:
        opt, rounds, G = run["opt"], run["rounds"], run.get("groups", 4)
        metrics = run.get("metrics", "final")
        flags = {k: run[k] for k in ("comm", "codec", "moment_codec",
                                     "downlink_codec", "mix_rounds",
                                     "staleness") if k in run}
        tag = f"{opt} {flags or 'server/fp32'}"
        torch.cuda.reset_peak_memory_stats()
        cfg, _, layout, rnd, state, *_ = build_run(
            "paper-lenet", groups=G, t_inner=T, opt=opt, lr=run["lr"],
            metrics=metrics, seed=0, device="cuda", **flags)
        if layout.size != MAIN[1]:
            fail(f"paper-lenet packs to {layout.size}, expected {MAIN[1]}")
        wire = expected_wire(run, layout.size)
        if "wire" in run and wire != run["wire"]:
            fail(f"{tag}: wire worked out as {wire}, not {run['wire']}")
        # the paper's full-batch local GD: each group keeps one fixed shard
        tokens = next(TokenPipeline(cfg.vocab_size, seq, seed=0).batches(
            (G, per_group)))["tokens"]
        batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
        losses = []
        for n in range(rounds):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = rnd(state, batch)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            # one update launch per local step; the norm twice per round
            # (consensus before and after the exchange), once per step
            # with metrics="traj" and once per error-feedback residual;
            # the exchange kernels as routed for this exchange
            want = dict.fromkeys(counts(), 0)
            want[f"fused_{opt}"] = T
            want["sq_norm_groups"] = (2 + (T if metrics == "traj" else 0)
                                      + run.get("residuals", 0))
            want["codec_mix"] = run.get("codec_mix", 0)
            want["qdq_int8"] = run.get("qdq_int8", 0)
            got = {k: v - before[k] for k, v in counts().items()}
            if got != want:
                fail(f"{tag} round {n}: launches {got}, expected {want}")
            for k, v in want.items():
                expected[k] += v
            if m["wire_bytes"] != wire:
                fail(f"{tag} round {n}: wire_bytes {m['wire_bytes']}, "
                     f"expected {wire}")
            loss = m["loss"]
            if loss.shape != (G,) or not bool(torch.isfinite(loss).all()):
                fail(f"{tag} round {n}: loss {loss.tolist()}")
            if not bool(torch.isfinite(state["params"]).all()):
                fail(f"{tag} round {n}: params are not finite")
            cons, post = m["consensus_sq"].sum(), m["consensus_sq_post"].sum()
            if flags.get("comm") in ("ring", "gossip") and not post < cons:
                fail(f"{tag} round {n}: consensus {cons.item():.4e} -> "
                     f"{post.item():.4e} did not shrink")
            err = m["codec_err/params"]
            if run.get("residuals") and not (
                    bool(torch.isfinite(err).all()) and bool((err > 0).all())):
                fail(f"{tag} round {n}: codec_err/params {err.tolist()}")
            losses.append(loss.mean().item())
            log(f"main path {tag} metrics={metrics} round {n}: "
                f"{sec:.4f} s fenced, loss {losses[-1]:.4f}, gsq "
                f"{m['grad_sq'].mean().item():.4e}, cons "
                f"{cons.item():.4e} -> {post.item():.4e}, codec_err/params "
                f"{err.sum().item():.4e}, wire {m['wire_bytes']:,} B, peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if n == 0 and opt == "adamw" and metrics == "final":
                first_loss.setdefault(opt, (tag, loss.clone()))
                # the loss is taken before the first exchange, so every
                # adamw run starts from the same round-0 losses, up to the
                # card's nondeterministic reductions
                ref_tag, ref = first_loss[opt]
                if not torch.allclose(loss, ref, rtol=1e-5, atol=0.0):
                    fail(f"{tag} round-0 loss {loss.tolist()} differs from "
                         f"{ref_tag}'s {ref.tolist()} beyond rtol 1e-5")
        if rounds == 3:
            log(f"main path {tag}: loss {losses}")
            if not losses[2] < losses[0]:
                fail(f"{tag}: loss did not fall over 3 rounds: {losses}")
        if run is PLAN[0]:
            server = {k: v.clone() for k, v in zip(
                *_flat(lsgd.server_params(state, layout)))}
            ckpt_io.save(ckpt, lsgd.server_params(state, layout),
                         metadata={"arch": cfg.name, "rounds": rounds,
                                   "mode": "localsgd"})
            log(f"main path {tag}: server params -> {ckpt}.npz")
        del state, rnd
        torch.cuda.empty_cache()
    total = counts()
    log(f"main path launches {total} (expected {expected})")
    if total != expected:
        fail(f"launch counts {total} != expected {expected}")
    return total, server


def _flat(params):
    """(keys, leaves) of a params tree, keys "/"-joined."""
    from repro_torch import tree
    paths, leaves = tree.flatten(params)
    return ["/".join(p) for p in paths], leaves


def profile_round(torch):
    """Phase 6: one more adamw round of the main path under torch.profiler
    (after the launch counts are read): the device's busy share of the
    fenced round and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    cfg, _, _, rnd, state, *_ = build_run("paper-lenet", groups=4,
                                          t_inner=4, opt="adamw", lr=1e-3,
                                          seed=0, device="cuda")
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (4, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    state, _ = rnd(state, batch)                 # warm-up round
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = rnd(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log("profile: the profiler captured no device time")
        return
    log(f"profile: adamw round {wall_ms:.1f} ms fenced (profiler on), "
        f"device busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    groups = {"port kernels": ("update_rows", "sgd_strips", "sq_norm_"),
              "matmul": ("gemm", "sm90", "cutlass", "splitK", "Kernel2"),
              "copy/fill": ("copy", "fill", "Memcpy", "Memset")}
    shares = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in kernels:
        name = next((g for g, keys in groups.items()
                     if any(k in e.key for k in keys)), "other")
        shares[name] += e.self_device_time_total / 1e3
    log("profile: device ms by kind " + ", ".join(
        f"{k} {v:.1f}" for k, v in shares.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:110]}")
    del state, rnd
    torch.cuda.empty_cache()


ATTN_TOL = dict(rtol=1e-5, atol=1e-6)          # float32 against plain
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-6)     # one bfloat16 step
BF16_REF = dict(rtol=2e-1, atol=2e-2)           # the reference's bf16 test
PATH_TOL = dict(rtol=1e-4, atol=1e-5)           # logits, kernels vs plain
LENET_HEADS = (12, 64)                          # paper-lenet: KV = H, hd
SERVE = dict(n_slots=8, page_size=16, max_prompt=1024, max_new=32)
WORKLOAD = dict(rate=50, n=24, prompt_len=(512, 1024), max_new=(16, 32),
                vocab=32000, seed=0)


def _decode_case(torch, gen, B, n_kv, g, hd, ps, nblk, lengths, trash=()):
    """A random pool with permuted page tables (real rows from 1 on),
    random queries, and the given slots pointed at trash row 0."""
    dev = torch.device("cuda")
    used = ps * n_kv * hd
    n_pages = 1 + 2 * B * nblk
    pool = torch.randn((n_pages, -(-used // 256) * 256), generator=gen,
                       device=dev)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(
        torch.int32)
    rows_k = perm[:B * nblk].reshape(B, nblk).clone()
    rows_v = perm[B * nblk:].reshape(B, nblk).clone()
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for b in trash:
        rows_k[b] = rows_v[b] = 0
        lengths[b] = 1
    q = torch.randn((B, n_kv * g, hd), generator=gen, device=dev)
    return q, pool, rows_k, rows_v, lengths


# phase 7's decode cases, (geometry, lengths, trash slots): paper-lenet's
# geometry with lengths on page edges, qwen3-32b's head geometry, tiny
# ragged ones (GQA, MHA, MQA), head groups of 3, nemotron-4-15b's 6 and
# llama3-405b's 16, zamba2-7b's head dim 112 (alone and with 16 heads a KV
# head), head dims that are no multiple of 4 (the kernel's scalar loads),
# and CUDA's 65,535 slots
_LENET_DECODE = dict(B=8, n_kv=LENET_HEADS[0], g=1, hd=LENET_HEADS[1], ps=16,
                     nblk=66)
DECODE_CASES = [
    (_LENET_DECODE, [1, 15, 16, 17, 512, 1023, 1056, 1], (7,)),
    (dict(B=4, n_kv=8, g=8, hd=128, ps=16, nblk=256), [4096, 1, 2049, 17], ()),
    (dict(B=3, n_kv=2, g=2, hd=8, ps=4, nblk=5), [1, 7, 20], (1,)),
    (dict(B=5, n_kv=4, g=1, hd=16, ps=8, nblk=3), [24, 9, 1, 8, 16], ()),
    (dict(B=2, n_kv=1, g=8, hd=32, ps=4, nblk=2), [5, 8], ()),
    (dict(B=3, n_kv=4, g=3, hd=64, ps=16, nblk=20), [320, 1, 77], (1,)),
    (dict(B=3, n_kv=8, g=6, hd=128, ps=16, nblk=64), [1024, 513, 1], ()),
    (dict(B=2, n_kv=8, g=16, hd=128, ps=16, nblk=128), [2048, 17], ()),
    (dict(B=4, n_kv=32, g=1, hd=112, ps=16, nblk=32), [512, 1, 300, 17], ()),
    (dict(B=2, n_kv=2, g=16, hd=112, ps=8, nblk=9), [72, 5], ()),
    (dict(B=3, n_kv=2, g=2, hd=50, ps=16, nblk=12), [180, 1, 33], (1,)),
    (dict(B=2, n_kv=3, g=5, hd=3, ps=4, nblk=40), [160, 7], ()),
    (dict(B=65535, n_kv=1, g=2, hd=4, ps=2, nblk=2),
     [1 + b % 4 for b in range(65535)], (5,)),
]


def check_decode_case(torch, da, gen, kw, lengths, trash=()):
    """The decode kernel against its plain version at one case, float32
    (``ATTN_TOL``) and bfloat16 queries (``BF16_STEP``); returns the
    float32 max abs error."""
    q, pool, rk, rv, ln = _decode_case(torch, gen, **kw, lengths=lengths,
                                       trash=trash)
    args = (pool, rk, rv, ln)
    ak = dict(page_size=kw["ps"], n_kv=kw["n_kv"])
    shown = lengths if len(lengths) <= 16 else f"{len(lengths)} lengths"
    got = da.paged_decode_attention(q, *args, impl="cuda", **ak)
    want = da.paged_decode_attention(q, *args, impl="torch", **ak)
    err = compare(f"paged_decode_attention {kw} lengths {shown}", got, want,
                  **ATTN_TOL)
    qb = q.to(torch.bfloat16)
    got = da.paged_decode_attention(qb, *args, impl="cuda", **ak)
    want = da.paged_decode_attention(qb.float(), *args, impl="torch",
                                     **ak).to(torch.bfloat16)
    e16 = compare(f"paged_decode_attention bf16 {kw}", got.float(),
                  want.float(), **BF16_STEP)
    log(f"paged_decode_attention agrees with its plain version at {kw}, "
        f"lengths {shown}, trash slots {list(trash)} (max abs err "
        f"{err:.3e}; bf16 q: {e16:.3e})")
    return err


def decode_timed(torch):
    """The decode times of phase 7, (name, geometry, lengths): paper-lenet's
    decode step over 8 slots (lengths from the serve workload's prompt
    range plus the generated tokens, seed 0), one request alone at the
    longest length, and qwen3-32b's head geometry (64 query heads over 8
    KV heads of 128, pages of 16) at lengths over its upper half of 4096
    (seed 0)."""
    H, hd = LENET_HEADS
    lenet = dict(n_kv=H, g=1, hd=hd, ps=16, nblk=66)
    seed = torch.Generator().manual_seed(0)
    rng_len = torch.randint(512 + 16, 1056 + 1, (8,), generator=seed).tolist()
    seed = torch.Generator().manual_seed(0)
    long_len = torch.randint(2048 + 16, 4096 + 1, (8,),
                             generator=seed).tolist()
    return (("paper-lenet B 8", dict(B=8, **lenet), rng_len),
            ("paper-lenet B 1", dict(B=1, **lenet), [1056]),
            ("qwen3-32b heads B 8", dict(B=8, n_kv=8, g=8, hd=128, ps=16,
                                         nblk=256), long_len))


def decode_times(torch, da, gen, kw, lengths, plain=False):
    """The decode kernel at one timed shape: held against its plain
    version (``ATTN_TOL``) and bit-equal on a rerun; then the call's and
    the device's ms, the bound and, where ``plain``, the plain version's
    ms."""
    q, pool, rk, rv, ln = _decode_case(torch, gen, **kw, lengths=lengths)
    ak = dict(page_size=kw["ps"], n_kv=kw["n_kv"])

    def run(impl="cuda"):
        return da.paged_decode_attention(q, pool, rk, rv, ln, impl=impl, **ak)
    got = run()
    err = compare(f"paged_decode_attention {kw} lengths {lengths}", got,
                  run("torch"), **ATTN_TOL)
    if not torch.equal(got, run()):
        fail(f"paged_decode_attention {kw}: two runs differ")
    t = dict(err=err, ms=time_ms(run, torch),
             device_ms=time_ms(run, torch, device_only=True),
             bound=_decode_bound(q, kw["n_kv"], ln, kw["nblk"]),
             plain_ms=time_ms(lambda: run("torch"), torch) if plain else None)
    del q, pool
    return t


def _decode_bound(q, n_kv, lengths, nblk):
    """Bytes: q and out, each live token's K and V of every KV head once,
    the two page tables and the lengths; operations: q.k and p.v, 2 flops
    per multiply-add, over the live tokens."""
    B, H, hd = q.shape
    live = int(lengths.sum())
    nbytes = 2 * q.numel() * 4 + live * n_kv * hd * 4 * 2 + B * (
        2 * nblk + 1) * 4
    return bound_of(nbytes, 4 * live * H * hd)


def _flash_bound(B, H, KV, S, hd, itemsize=4, tensor_cores=False):
    """Bytes: q, out (B, H, S, hd) and k, v (B, KV, S, hd) once;
    operations: the causal half of QK^T and P@V, 2 flops per
    multiply-add, at the float32 rate outside the tensor cores, or, for
    the kernel's design (``tensor_cores``), three TF32 products each (the
    3xTF32 split) at the TF32 tensor-core rate."""
    nbytes = (2 * B * H + 2 * B * KV) * S * hd * itemsize
    ops = 4 * hd * S * (S + 1) // 2 * B * H
    if tensor_cores:
        return bound_of(nbytes, 3 * ops, TF32_OPS_PER_S)
    return bound_of(nbytes, ops)


# the flash times of phase 7, (B, H, KV, S, hd) float32: paper-lenet's
# prefill, a longer one, and qwen3-32b's head geometry (64 query heads
# over 8 KV heads of 128)
FLASH_TIMED = ((1, 12, 12, 1024, 64), (2, 12, 12, 2048, 64),
               (1, 64, 8, 2048, 128))
# zamba2-7b's shared attention (32 heads of 112), timed beside them
FLASH_112 = (1, 32, 32, 2048, 112)


def _flash_times(torch, fa, shape, gen):
    """The kernel's and SDPA's times (``call_and_device_ms``; the KV heads
    repeated for SDPA) and both bounds, at (B, H, KV, S, hd) float32."""
    B, H, KV, S, hd = shape
    q = torch.randn((B, H, S, hd), generator=gen, device="cuda")
    k, v = (torch.randn((B, KV, S, hd), generator=gen, device="cuda")
            for _ in range(2))
    kr, vr = (k, v) if KV == H else (k.repeat_interleave(H // KV, 1),
                                     v.repeat_interleave(H // KV, 1))
    t = call_and_device_ms(
        torch, lambda: fa.flash_attention(q, k, v, impl="cuda"),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, is_causal=True))
    t["bound"] = _flash_bound(*shape, tensor_cores=True)
    t["f32_bound"] = _flash_bound(*shape)
    log(f"flash_attention {shape} f32 kernel_ms {t['ms']:.4f} (device "
        f"{t['device_ms']:.4f}) bound_ms {t['bound'][0]:.4f} "
        f"({t['bound'][1]}: 3xTF32 at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s) "
        f"f32-SIMT bound_ms {t['f32_bound'][0]:.4f} ({t['f32_bound'][1]}: "
        f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s) library_ms "
        f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f}; sdpa "
        "causal)")
    return q, k, v, t


def _sdpa_kernel_name(torch, q, k, v):
    """SDPA's backend for these inputs (``torch._fused_sdp_choice``) and
    its device kernels over ten calls, by the profiler."""
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile
    f = torch.nn.functional.scaled_dot_product_attention
    names = {b.value: n for n, b in SDPBackend.__members__.items()}
    backend = names.get(int(torch._fused_sdp_choice(q, k, v, None, 0.0, True)))
    f(q, k, v, is_causal=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            f(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    kernels = sorted({e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA})
    return backend, kernels or ["(the profiler captured no device kernel)"]


def sass_tf32_mma(build, stem):
    """The TF32 HMMA instructions in the SASS of ``csrc/<stem>.cu``'s
    library."""
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", str(build.library_path(stem))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    return sum(1 for line in sass.splitlines()
               if "HMMA" in line and "TF32" in line)


def check_attention_kernels(torch, results, tf32_mma):
    """Phase 7: the serve path's kernels against their plain versions,
    and their times at the path's shapes. ``tf32_mma``: phase 2's count
    of TF32 HMMA instructions in the flash library, which must not be 0."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    H, hd = LENET_HEADS

    def note(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for kw, lengths, trash in DECODE_CASES:
        note("paged_decode_attention",
             check_decode_case(torch, da, gen, kw, lengths, trash))

    # flash: (B, H, KV, S, hd, dtype, block_q, block_k)
    flash_cases = [
        (1, 12, 12, 1024, 64, torch.float32, 128, 128),
        (2, 12, 12, 2048, 64, torch.float32, 128, 128),
        (1, 12, 12, 1024, 64, torch.bfloat16, 128, 128),
        (1, 8, 2, 384, 128, torch.float32, 128, 128),
        (1, 2, 2, 256, 64, torch.float32, 64, 128),
        (2, 1, 1, 64, 16, torch.float32, 64, 64),
        (1, 3, 3, 40, 32, torch.float32, 128, 128),
        (1, 2, 1, 16, 8, torch.float32, 16, 16),
        # sequences that are no multiple of 128 (1000 of no 64 either),
        # qwen3-32b's head geometry, and head dims 8 and 16 at length
        (1, 4, 2, 1000, 64, torch.float32, 1000, 1000),
        (1, 4, 4, 1088, 64, torch.float32, 64, 64),
        (1, 4, 4, 1000, 64, torch.bfloat16, 1000, 1000),
        (1, 64, 8, 2048, 128, torch.float32, 128, 128),
        (1, 4, 2, 520, 8, torch.float32, 520, 520),
        (2, 4, 4, 384, 16, torch.float32, 128, 128),
        (1, 4, 4, 384, 16, torch.bfloat16, 128, 128),
        # zamba2-7b's heads (32 of 112), and head dims padded to the next
        # instantiation (40 -> 64, 96 -> 112)
        (1, 32, 32, 1024, 112, torch.float32, 128, 128),
        (1, 8, 2, 384, 112, torch.bfloat16, 128, 128),
        (1, 4, 4, 200, 40, torch.float32, 200, 200),
        (1, 4, 2, 256, 96, torch.float32, 128, 128),
    ]
    if tf32_mma == 0:
        fail("flash_attention: no TF32 HMMA instruction in the library's "
             "SASS; the tensor-core path is not the one built")
    log(f"flash_attention library: {tf32_mma} TF32 HMMA instructions")
    for B, nh, kv, S, d, dt, bq, bk in flash_cases:
        q = torch.randn((B, nh, S, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, kv, S, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, kv, S, d), generator=gen, device="cuda").to(dt)
        kw = dict(block_q=bq, block_k=bk)
        tag = f"flash_attention {(B, nh, kv, S, d)} {dt} blocks {(bq, bk)}"
        got = fa.flash_attention(q, k, v, impl="cuda", **kw)
        want = fa.flash_attention(q, k, v, impl="torch", **kw)
        if dt == torch.float32:
            truth = ref.flash_attention_ref(q.double(), k.double(), v.double())
            err = compare(tag + " (float64 plain)", got.double(), truth,
                          **ATTN_TOL)
            note("flash_attention", err)
            log(f"{tag}: max abs err {err:.3e} against the float64 plain "
                f"version; the float32 plain version's own "
                f"{(want.double() - truth).abs().max().item():.3e}")
            del truth
        else:
            e1 = compare(tag + " (plain, bf16 p)", got.float(), want.float(),
                         **BF16_REF)
            f32 = fa.flash_attention(q.float(), k.float(), v.float(),
                                     impl="torch", **kw).to(dt)
            e2 = compare(tag + " (float32 plain)", got.float(), f32.float(),
                         **BF16_STEP)
            log(f"{tag}: max abs err {e1:.3e} against the plain version, "
                f"{e2:.3e} against the float32 plain version")
        log(f"flash_attention agrees with its plain version at {tag}")
        if (B, nh, S, d) in ((1, 12, 1024, 64), (1, 64, 2048, 128)):
            again = fa.flash_attention(q, k, v, impl="cuda", **kw)
            if not torch.equal(got, again):
                fail(f"{tag}: two runs differ")
            log(f"{tag}: a rerun gives the same bits")
            del again
        del q, k, v, got, want

    # times at the serve path's shapes: the decode step (and one request,
    # and qwen3-32b's heads), the prefill at the 1024 bucket
    r = results["paged_decode_attention"]
    for i, (name, kw, lengths) in enumerate(decode_timed(torch)):
        t = decode_times(torch, da, gen, kw, lengths, plain=i == 0)
        note("paged_decode_attention", t["err"])
        log(f"paged_decode_attention {name} {kw}, lengths {lengths}: a rerun "
            f"gives the same bits; kernel_ms {t['ms']:.4f} (device "
            f"{t['device_ms']:.4f}) bound_ms {t['bound'][0]:.4f} "
            f"({t['bound'][1]}) max_abs_err {t['err']:.3e}")
        if i == 0:
            r.update(ms=t["ms"], device_ms=t["device_ms"],
                     plain_ms=t["plain_ms"], library_ms=None)
            r["bound_ms"], r["bound_by"] = t["bound"]
    log(f"paged_decode_attention {decode_timed(torch)[0][0]} plain_ms "
        f"{r['plain_ms']:.4f} library_ms none (no single PyTorch call) "
        f"max_abs_err {r['max_abs_err']:.3e}")
    q, k, v, t = _flash_times(torch, fa, FLASH_TIMED[0], gen)
    r = results["flash_attention"]
    r["plain_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, impl="torch"),
                            torch)
    r.update(ms=t["ms"], library_ms=t["library_ms"])
    r["bound_ms"], r["bound_by"] = t["bound"]
    log(f"flash_attention (1, {H}, 1024, {hd}) f32 plain_ms "
        f"{r['plain_ms']:.4f} max_abs_err {r['max_abs_err']:.3e}")
    backend, kernels = _sdpa_kernel_name(torch, q, k, v)
    log(f"sdpa at (1, {H}, 1024, {hd}) f32: backend {backend}, device "
        f"kernels {kernels}")
    del q, k, v
    for shape in FLASH_TIMED[1:] + (FLASH_112,):
        _flash_times(torch, fa, shape, gen)
    torch.cuda.empty_cache()


def _serve_model(torch, ckpt, server):
    """paper-lenet with attn_impl="pallas" and phase 5's params through
    the handoff; the restored leaves must equal the saved ones."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve import restore_params

    cfg = dataclasses.replace(get_config("paper-lenet"), attn_impl="pallas")
    model = build_model(cfg)
    params = restore_params(ckpt, model, device="cuda")
    keys, leaves = _flat(params)
    if keys != list(server) or not all(
            torch.equal(a, server[k]) for k, a in zip(keys, leaves)):
        fail("the restored params differ from phase 5's server params")
    return model, params


def serve_path(torch, ckpt, server, tmp):
    """Phase 8: the serve path at full width. Returns the launch counts of
    the continuous run."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.obs.trace import Trace
    from repro_torch.serve import (Engine, EngineConfig, Request,
                                   drive_workload, poisson_workload)

    model, params = _serve_model(torch, ckpt, server)
    reqs = poisson_workload(**WORKLOAD)

    def fresh():
        return [Request(r.rid, r.prompt.copy(), r.max_new, r.arrival)
                for r in reqs]

    eng = Engine(model, params, EngineConfig(**SERVE))
    g = eng.geom
    if (eng.bucket, g.max_blocks, g.page_elems, g.n_pages) != \
            (1024, 66, 12_288, 8_449):
        fail(f"serve geometry {eng.bucket} {g}")
    eng.warmup()
    trace_path = os.path.join(tmp, "serve.jsonl")
    eng.trace = Trace(trace_path, meta={"launcher": "chip_smoke",
                                        "arch": model.cfg.name})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    da.launches = fa.launches = 0
    t0 = time.perf_counter()
    done, makespan = drive_workload(eng, fresh())
    wall = time.perf_counter() - t0
    counts = {"paged_decode_attention": da.launches,
              "flash_attention": fa.launches}
    eng.trace.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = [json.loads(line) for line in open(trace_path)]
    steps = [s for s in steps if s["kind"] == "step"]
    prefills = sum(s["metrics"]["admitted"] for s in steps)
    decode = [s["phase_s"]["decode_step"] for s in steps
              if "decode_step" in s["phase_s"]]
    per_prefill = [s["phase_s"]["prefill"] / s["metrics"]["admitted"]
                   for s in steps if s["metrics"]["admitted"]]
    want = {"paged_decode_attention": 8 * len(decode),
            "flash_attention": 8 * prefills}
    if prefills != WORKLOAD["n"] or counts != want:
        fail(f"serve launches {counts}, expected {want} ({prefills} "
             f"prefills, {len(decode)} decode steps)")
    cont = {c.rid: c.tokens for c in done}
    for r in reqs:
        toks = cont.get(r.rid)
        if toks is None or len(toks) != min(r.max_new, SERVE["max_new"]) or \
                not all(0 <= t < 32000 for t in toks):
            fail(f"serve rid {r.rid}: tokens {toks}")
    committed = sum(len(t) for t in cont.values())
    lat = sorted(c.latency for c in done)
    q = statistics.quantiles
    log(f"serve paper-lenet continuous: {len(done)} requests, {committed} "
        f"tokens in {makespan:.4f} s virtual ({committed / makespan:.1f} "
        f"tok/s committed; {wall:.4f} s wall), latency p50 "
        f"{statistics.median(lat):.4f} s p99 {q(lat, n=100)[98]:.4f} s, "
        f"decode step ms median {statistics.median(decode) * 1e3:.3f} p99 "
        f"{q(decode, n=100)[98] * 1e3:.3f} over {len(decode)} steps, "
        f"prefill ms median {statistics.median(per_prefill) * 1e3:.3f} "
        f"(bucket 1024), peak memory {peak:.2f} GiB")
    log(f"serve launches {counts}: 8 per prefill ({prefills}) and 8 per "
        f"decode step ({len(decode)})")
    del eng
    torch.cuda.empty_cache()

    stat = Engine(model, params, EngineConfig(policy="static", **SERVE))
    sdone, smakespan = drive_workload(stat, fresh())
    scommitted = sum(len(c.tokens) for c in sdone)
    slat = sorted(c.latency for c in sdone)
    log(f"serve paper-lenet static: {scommitted / smakespan:.1f} tok/s "
        f"committed, latency p50 {statistics.median(slat):.4f} s p99 "
        f"{q(slat, n=100)[98]:.4f} s")
    bad = [c.rid for c in sdone if c.tokens != cont[c.rid]]
    if len(sdone) != len(reqs) or bad:
        fail(f"static policy tokens differ for rids {bad}")
    del stat
    torch.cuda.empty_cache()

    iso = Engine(model, params, EngineConfig(**SERVE))
    bad = []
    for r in fresh():
        if iso.run([r])[0].tokens != cont[r.rid]:
            bad.append(r.rid)
    if bad:
        fail(f"isolated replay tokens differ for rids {bad}")
    log(f"serve parity: all {len(reqs)} requests' tokens equal under the "
        "continuous and static policies and replayed alone")
    del iso
    profile_decode_steps(torch, Engine(model, params, EngineConfig(**SERVE)),
                         fresh()[:SERVE["n_slots"]])
    del params
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "paper-lenet", "--from-checkpoint", ckpt, "--slots", "8",
           "--page-size", "16", "--prompt-max", "128", "--gen-max", "32",
           "--requests", "16", "--check-parity"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=SRC))
    for line in (out.stdout + out.stderr).strip().splitlines()[-8:]:
        log(f"launcher: {line}")
    if out.returncode != 0:
        fail(f"python -m repro_torch.launch.serve exited {out.returncode}")
    return counts


def profile_decode_steps(torch, eng, reqs):
    """Three decode steps over 8 active slots under torch.profiler (after
    the launch counts are read): the device's busy share of the fenced
    steps and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(r)
    eng.step()                  # the 8 prefills and a first decode step
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the engine's phases are record_function ranges, which the profiler
    # also reports on the device: they are not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ("prefill", "decode_step")]
    if not kernels:
        log("profile: the profiler captured no device time")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: 3 serve decode steps (8 active slots) {wall_ms:.1f} ms "
        f"fenced (profiler on), device busy {busy_ms:.2f} ms = "
        f"{busy_ms / wall_ms:.1%}, {sum(e.count for e in kernels) // 3} "
        "kernel launches per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:100]}")


def serve_reference_check(torch, ckpt, server):
    """Phase 9: 8 slots prefilled at the 1024 bucket and 4 decode steps,
    with both plain versions (no launch) and with the kernels fed the
    plain run's tokens; logits and greedy tokens compared."""
    import numpy as np

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import decode as sdecode
    from repro_torch.serve import poisson_workload
    from repro_torch.serve.paging import FreeList

    model, params = _serve_model(torch, ckpt, server)
    reqs = poisson_workload(**WORKLOAD)[:SERVE["n_slots"]]
    geom = sdecode.geom_for(model, n_slots=SERVE["n_slots"], page_size=16,
                            max_len=1024 + SERVE["max_new"])
    runs = {}
    for impl in ("torch", "cuda"):
        progs = sdecode.build_programs(model, geom, impl)
        pool, free = geom.pool("cuda"), FreeList(geom.n_pages)
        before = (da.launches, fa.launches)
        nk = geom.n_layers_kv * geom.max_blocks
        tables = [free.alloc(geom.rows_per_slot) for _ in reqs]
        rk = np.stack([t[:nk].reshape(geom.n_layers_kv, -1) for t in tables])
        rv = np.stack([t[nk:].reshape(geom.n_layers_kv, -1) for t in tables])
        logits, pos = [], []
        for i, r in enumerate(reqs):
            toks = np.zeros((1, 1024), np.int32)
            toks[0, :len(r.prompt)] = r.prompt
            lg, pool = progs.prefill_logits(params, pool, toks, len(r.prompt),
                                            rk[i], rv[i])
            logits.append(lg)
            pos.append(len(r.prompt))
        steps = [torch.cat(logits)]
        pos = np.asarray(pos, np.int32)
        active = np.ones(len(reqs), bool)
        for n in range(4):
            feed = runs["torch"][n].argmax(-1) if impl == "cuda" else \
                steps[-1][:, :32000].argmax(-1)
            lg, pool = progs.step_logits(params, pool, feed.cpu().numpy()
                                         .astype(np.int32), pos + n, rk, rv,
                                         active)
            steps.append(lg)
        launched = (da.launches - before[0], fa.launches - before[1])
        want = (0, 0) if impl == "torch" else (8 * 4, 8 * len(reqs))
        if launched != want:
            fail(f"serve check impl={impl}: launches {launched}, want {want}")
        runs[impl] = [s[:, :32000] for s in steps]
        del pool
    flips = 0
    for n, (plain, kern) in enumerate(zip(runs["torch"], runs["cuda"])):
        what = "prefill" if n == 0 else f"decode step {n}"
        err = compare(f"serve logits, {what} (kernels vs plain)", kern,
                      plain, **PATH_TOL)
        top2 = plain.topk(2, dim=-1).values
        tied = (top2[:, 0] - top2[:, 1]) <= (PATH_TOL["atol"] + PATH_TOL[
            "rtol"] * top2[:, 0].abs())
        for b in torch.nonzero(kern.argmax(-1) != plain.argmax(-1)).flatten():
            b = int(b)
            gap = float(top2[b, 0] - top2[b, 1])
            if not bool(tied[b]):
                fail(f"serve {what} slot {b}: kernel token "
                     f"{int(kern[b].argmax())} != plain {int(plain[b].argmax())}"
                     f" with top-2 gap {gap:.3e}")
            flips += 1
            log(f"serve {what} slot {b}: token differs where the plain "
                f"run's top-2 gap {gap:.3e} is within the tolerance")
        log(f"serve {what}: logits max abs err {err:.3e} (kernels vs plain)")
    log(f"serve check: kernels and plain versions agree over the prefill "
        f"and 4 decode steps of {len(reqs)} slots ({flips} near-tie token "
        "differences)")
    del params
    torch.cuda.empty_cache()


# Phase 10: the kernel entry point and the last four kernels.
# (rows, D): zamba2-7b's d_model and d_inner over one 4096-token sequence
# (src/repro/configs/zamba2.py), and qwen3-32b's qk-norm (4096 tokens x 64
# heads of 128)
RMS_FULL = ((4096, 3584), (4096, 7168), (262_144, 128))
RMS_EDGE = ((4, 64), (2, 8, 128), (1, 31, 33), (300, 256), (1, 1, 1, 16))
# qwen3-32b's d_model over 4096 tokens (src/repro/configs/qwen3_32b.py), and a
# wide D that is no multiple of the register tile (897 float4 over 128
# threads)
RMS_WIDE = ((4096, 5120), (4096, 3588))
# bfloat16 at zamba2-7b's two widths (and at RMS_EDGE)
RMS_BF16 = ((4096, 3584), (4096, 7168))
RMS_F32 = dict(rtol=1e-6, atol=1e-6)            # sum order, rsqrt
# B, c, L, H, N, P: zamba2-7b's SSD at full width (d_inner 7168 / P 64,
# ssm_state 64, chunk 128) over a 4096-token sequence; the reference
# test's shapes and an L that is no power of two
MAMBA_FULL = (1, 32, 128, 112, 64, 64)
MAMBA_EDGE = ((1, 1, 8, 2, 4, 4), (2, 3, 16, 2, 8, 8), (1, 2, 128, 4, 64, 64),
              (1, 2, 96, 3, 16, 8))
MAMBA_YS = dict(rtol=1e-4, atol=1e-4)           # the reference test's
MAMBA_CUM = dict(rtol=1e-5, atol=1e-5)
LAST_FOUR = ("quantize_int8", "dequantize_int8", "rmsnorm", "mamba_chunk")


def _rms_bound(rows, d, itemsize):
    """Bytes: x in, y out, w once; operations: square, add, two products
    per element."""
    return bound_of(2 * rows * d * itemsize + 4 * d, 4 * rows * d)


def _quant_bounds(rows, chunk):
    """quantize: x and u in, q and the scales out; abs, max, division,
    add, floor, two clips per element. dequantize: q and the scales in,
    the float32 out; one product per element."""
    n = rows * chunk
    return (bound_of(9 * n + 4 * rows, 7 * n),
            bound_of(5 * n + 4 * rows, n))


def _mamba_ops(B, c, L, H, N, P):
    """Operations (2 per multiply-add): the causal half of C B^T once per
    chunk, the causal half of (C B^T * W) x and the state product per
    (chunk, head)."""
    bc, tri = B * c, L * (L + 1) // 2
    return bc * 2 * N * tri + bc * H * (2 * P * tri + 2 * N * P * L)


def _mamba_bound(B, c, L, H, N, P, tensor_cores=True):
    """Bytes: xh and y, bmat and cmat, dt and cum, a, the states and the
    decay, each once; operations: ``_mamba_ops``, for the kernel's design
    (``tensor_cores``) three TF32 products each (the 3xTF32 split) at the
    TF32 tensor-core rate, else at the float32 rate outside the tensor
    cores."""
    bc = B * c
    nbytes = 4 * (2 * bc * L * H * P + 2 * bc * L * N + 2 * bc * L * H + H
                  + bc * H * N * P + bc * H)
    ops = _mamba_ops(B, c, L, H, N, P)
    if tensor_cores:
        return bound_of(nbytes, 3 * ops, TF32_OPS_PER_S)
    return bound_of(nbytes, ops)


def _mamba_inputs(torch, gen, shape, xdtype=None, a=None, dt=None):
    B, c, L, H, N, P = shape
    dev = torch.device("cuda")
    xh = torch.randn((B, c, L, H, P), generator=gen, device=dev)
    bm = torch.randn((B, c, L, N), generator=gen, device=dev)
    cm = torch.randn((B, c, L, N), generator=gen, device=dev)
    dtv = (torch.nn.functional.softplus(torch.randn(
        (B, c, L, H), generator=gen, device=dev)) if dt is None else
        torch.full((B, c, L, H), dt, device=dev))
    av = (-torch.randn((H,), generator=gen, device=dev).abs() - 0.1
          if a is None else torch.full((H,), a, device=dev))
    return (xh if xdtype is None else xh.to(xdtype)), bm, cm, dtv, av


def _mamba_compare(torch, tag, got, want, ys=MAMBA_YS):
    for name, g in zip(("y", "states", "decay", "cum"), got):
        if not bool(torch.isfinite(g).all()):
            fail(f"mamba_chunk {tag}: {name} holds a NaN or inf")
    errs = [compare(f"mamba_chunk {tag} y", got[0].float(), want[0].float(),
                    **ys),
            compare(f"mamba_chunk {tag} states", got[1], want[1], **MAMBA_YS),
            compare(f"mamba_chunk {tag} decay", got[2], want[2], **MAMBA_CUM),
            compare(f"mamba_chunk {tag} cum", got[3], want[3], **MAMBA_CUM)]
    return max(errs)


def check_last_four(torch, results):
    """Phase 10, first half: rmsnorm, the quantize pair and mamba_chunk
    against their plain versions on the card, at full width, ragged and
    edge shapes, and their times at full width."""
    from repro_torch.kernels import exchange_epilogue as ee
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")

    def note(name, err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    # rmsnorm: float32 within RMS_F32, bfloat16 within one bfloat16 step
    cases = [(s, torch.float32) for s in RMS_FULL + RMS_WIDE + RMS_EDGE] + [
        (s, torch.bfloat16) for s in RMS_BF16 + RMS_EDGE]
    for shape, dt in cases:
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        w = torch.randn(shape[-1:], generator=gen, device=dev) + 1.0
        got = rn.rmsnorm(x, w, impl="cuda")
        want = rn.rmsnorm(x, w, impl="torch")
        if got.dtype != dt or got.shape != x.shape:
            fail(f"rmsnorm {shape} {dt}: got {got.dtype} {tuple(got.shape)}")
        tol = RMS_F32 if dt == torch.float32 else BF16_STEP
        note("rmsnorm", compare(f"rmsnorm {shape} {dt}", got.float(),
                                want.float(), **tol))
        del x, w, got, want
    log(f"rmsnorm agrees with its plain version at {RMS_FULL + RMS_WIDE} "
        f"and {RMS_EDGE}, float32 (rtol 1e-6, atol 1e-6), and at "
        f"{RMS_BF16} and {RMS_EDGE}, bfloat16 (one bfloat16 step)")
    for (rows, d), dt in [(s, torch.float32) for s in RMS_FULL + RMS_WIDE] + [
            (s, torch.bfloat16) for s in RMS_BF16]:
        x = torch.randn((rows, d), generator=gen, device=dev).to(dt)
        w = torch.randn((d,), generator=gen, device=dev) + 1.0
        t = call_and_device_ms(
            torch, lambda: rn.rmsnorm(x, w, impl="cuda"),
            lambda: torch.nn.functional.rms_norm(x, (d,), w.to(dt), 1e-5))
        plain = time_ms(lambda: rn.rmsnorm(x, w, impl="torch"), torch)
        bms, by = _rms_bound(rows, d, x.element_size())
        log(f"rmsnorm ({rows}, {d}) {dt} layout {rn.layout(d, x.element_size())} "
            f"kernel_ms {t['ms']:.4f} (device {t['device_ms']:.4f}) bound_ms "
            f"{bms:.4f} ({by}) plain_ms {plain:.4f} library_ms "
            f"{t['library_ms']:.4f} (device {t['library_device_ms']:.4f}; "
            "F.rms_norm)")
        if (rows, d) == RMS_FULL[0] and dt == torch.float32:
            results["rmsnorm"].update(ms=t["ms"], plain_ms=plain,
                                      library_ms=t["library_ms"],
                                      bound_ms=bms, bound_by=by)
        del x, w
    torch.cuda.empty_cache()

    # the quantize pair: bit-equal to the plain versions, and composed,
    # to qdq_int8's kernel and plain version (chunk 256)
    for rows_n, chunk in ((QDQ_ROWS[0], 256), (3907, 256), (7, 256),
                          (3907, 128), (1, 128), (3907, 37), (9, 37)):
        x = torch.randn((rows_n, chunk), generator=gen, device=dev)
        x[rows_n // 2] = 0.0
        x[: max(1, rows_n // 3), : chunk // 2] *= 1e-6
        u = torch.rand((rows_n, chunk), generator=gen, device=dev)
        tag = f"({rows_n}, {chunk})"
        q, s = qz.quantize_int8(x, u, impl="cuda")
        wq, ws = qz.quantize_int8(x, u, impl="torch")
        if not (torch.equal(q, wq) and torch.equal(s, ws)):
            fail(f"quantize_int8 {tag}: q or scales differ from the plain "
                 f"version ({int((q != wq).sum())} q, "
                 f"{int((s != ws).sum())} scales)")
        if float(s[rows_n // 2]) != 1.0 or bool(q[rows_n // 2].any()):
            fail(f"quantize_int8 {tag}: an all-zero row did not give "
                 "scale 1 and q 0")
        back = qz.dequantize_int8(q, s, impl="cuda")
        if not torch.equal(back, qz.dequantize_int8(q, s, impl="torch")):
            fail(f"dequantize_int8 {tag}: differs from the plain version")
        if not torch.equal(back, ref.qdq_int8_ref(x, u)):
            fail(f"quantize+dequantize {tag}: differs from qdq_int8_ref")
        if chunk == 256 and not torch.equal(
                back, ee.qdq_int8(x, u, impl="cuda")):
            fail(f"quantize+dequantize {tag}: differs from the qdq_int8 "
                 "kernel")
        del wq, ws, back
        if (rows_n, chunk) == QDQ_ROWS:
            (qb, qby), (db, dby) = _quant_bounds(rows_n, chunk)
            r = results["quantize_int8"]
            r.update(ms=time_ms(lambda: qz.quantize_int8(x, u, impl="cuda"),
                                torch),
                     plain_ms=time_ms(lambda: qz.quantize_int8(
                         x, u, impl="torch"), torch),
                     library_ms=None, bound_ms=qb, bound_by=qby)
            d = results["dequantize_int8"]
            d.update(ms=time_ms(lambda: qz.dequantize_int8(q, s, impl="cuda"),
                                torch),
                     plain_ms=time_ms(lambda: qz.dequantize_int8(
                         q, s, impl="torch"), torch),
                     library_ms=time_ms(lambda: torch.mul(q, s), torch),
                     bound_ms=db, bound_by=dby)
            log(f"quantize_int8 {QDQ_ROWS} kernel_ms {r['ms']:.4f} bound_ms "
                f"{qb:.4f} ({qby}) plain_ms {r['plain_ms']:.4f} library_ms "
                "none (no single PyTorch call)")
            log(f"dequantize_int8 {QDQ_ROWS} kernel_ms {d['ms']:.4f} "
                f"bound_ms {db:.4f} ({dby}) plain_ms {d['plain_ms']:.4f} "
                f"library_ms {d['library_ms']:.4f} (torch.mul(q, scales))")
        del x, u, q, s
        torch.cuda.empty_cache()
    log("quantize_int8 and dequantize_int8 equal their plain versions bit "
        "for bit (chunks 256, 128, 37; all-zero rows), and the pair equals "
        "qdq_int8's kernel and plain version")

    # mamba_chunk: full width, the reference test's shapes, L 96, a large
    # |a| (exp above the diagonal overflows), bfloat16 xh
    cases = ([(MAMBA_FULL, {}), (MAMBA_FULL, dict(xdtype=torch.bfloat16))]
             + [(s, {}) for s in MAMBA_EDGE]
             + [(MAMBA_EDGE[2], dict(a=-50.0, dt=3.0485873222351074)),
                (MAMBA_EDGE[2], dict(a=0.002)),
                (MAMBA_EDGE[3], dict(xdtype=torch.bfloat16))])
    for shape, kw in cases:
        args = _mamba_inputs(torch, gen, shape, **kw)
        tag = f"{shape} {kw or 'float32'}"
        got = ms.mamba_chunk(*args, impl="cuda")
        want = ms.mamba_chunk(*args, impl="torch")
        ys = MAMBA_YS if "xdtype" not in kw else dict(rtol=2.0 ** -7,
                                                      atol=1e-4)
        note("mamba_chunk", _mamba_compare(torch, tag, got, want, ys))
        log(f"mamba_chunk agrees with its plain version at {tag}")
        if shape == MAMBA_FULL and not kw:
            r = results["mamba_chunk"]
            run = lambda: ms.mamba_chunk(*args, impl="cuda")  # noqa: E731
            r["ms"] = time_ms(run, torch)
            r["device_ms"] = time_ms(run, torch, device_only=True)
            r["plain_ms"] = time_ms(lambda: ms.mamba_chunk(
                *args, impl="torch"), torch)
            r["library_ms"] = None
            r["bound_ms"], r["bound_by"] = _mamba_bound(*shape)
            ops = _mamba_ops(*shape)
            log(f"mamba_chunk {shape} f32 kernel_ms {r['ms']:.4f} (device "
                f"{r['device_ms']:.4f}) bound_ms {r['bound_ms']:.4f} "
                f"({r['bound_by']}; 3xTF32 operations "
                f"{3 * ops / TF32_OPS_PER_S * 1e3:.4f}, float32 SIMT "
                f"{_mamba_bound(*shape, tensor_cores=False)[0]:.4f}) "
                f"plain_ms {r['plain_ms']:.4f} library_ms none (no single "
                f"PyTorch call) max_abs_err {r['max_abs_err']:.3e}")
        del args, got, want
        torch.cuda.empty_cache()


def ops_path(torch):
    """Phase 10, second half: this slice's path, the public entry point
    ``repro_torch.kernels.ops``. Every count is set to 0, each of its
    eleven functions is called once on the card (the last four kernels at
    full width, the others at small shapes) and held against its plain
    version on the CPU, and the counts are read. Returns them."""
    import numpy as np

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import exchange_epilogue as ee
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import (fused_adamw, fused_momentum, fused_sgd,
                                     mamba_scan, ops, quantize, rmsnorm,
                                     sq_norm)

    gen = torch.Generator().manual_seed(4)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def both(name, fn, *args, tol=None, **kw):
        """fn on the card and on the CPU, the CPU's plain version as the
        reference; tol None: bit-equal."""
        got = fn(*(a.cuda() if isinstance(a, torch.Tensor) else a
                   for a in args), **kw)
        want = fn(*(a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for k, (g, w) in enumerate(zip(got, want)):
            g, w = g.cpu(), w
            t = tol[k] if isinstance(tol, list) else tol
            if t is None:
                if not torch.equal(g, w):
                    fail(f"ops.{name} output {k}: the card differs from the "
                         "CPU's plain version")
            else:
                err = max(err, compare(f"ops.{name} output {k} (card vs CPU)",
                                       g.float(), w.float(), **t))
        log(f"ops.{name}: the card agrees with the CPU's plain version "
            f"(max abs err {err:.3e})")

    mods = {"fused_sgd": fused_sgd, "fused_momentum": fused_momentum,
            "fused_adamw": fused_adamw, "sq_norm_groups": sq_norm,
            "paged_decode_attention": da, "flash_attention": fa,
            "rmsnorm": rmsnorm, "mamba_chunk": mamba_scan}

    def counts():
        c = {name: mod.launches for name, mod in mods.items()}
        c.update(ee.launches)
        c.update(quantize.launches)
        return c

    # the eight earlier kernels at small shapes
    q, k, v = rand(1, 2, 128, 32), rand(1, 2, 128, 32), rand(1, 2, 128, 32)
    nblk, n_pages = 5, 31
    pool = rand(n_pages, 256)
    rows = torch.randperm(n_pages - 1, generator=gen).to(torch.int32) + 1
    dq = rand(3, 4, 8)
    p, g, m = rand(1003), rand(1003), rand(1003, scale=0.1)
    vv = rand(1003, scale=0.01).abs()
    x2 = rand(3, 1003)
    # the last four at full width
    rx, rw = rand(*RMS_FULL[0]), rand(RMS_FULL[0][1]) + 1.0
    qx = rand(*QDQ_ROWS)
    qu = torch.rand(QDQ_ROWS, generator=gen)
    qq = torch.randint(-127, 128, QDQ_ROWS, generator=gen).to(torch.int8)
    qs = rand(QDQ_ROWS[0], 1).abs()
    B, c, L, H, N, P = MAMBA_FULL
    mam = (rand(B, c, L, H, P), rand(B, c, L, N), rand(B, c, L, N),
           torch.nn.functional.softplus(rand(B, c, L, H)),
           -rand(H).abs() - 0.1)
    ew = dict(rtol=1e-6, atol=1e-7)

    for mod in mods.values():
        mod.launches = 0
    for d in (ee.launches, quantize.launches):
        for key in d:
            d[key] = 0
    both("flash_attention", ops.flash_attention, q, k, v, 64, 64,
         tol=ATTN_TOL)
    both("paged_decode_attention", ops.paged_decode_attention, dq, pool,
         rows[:3 * nblk].reshape(3, nblk), rows[15:15 + 3 * nblk].reshape(
             3, nblk), torch.tensor([1, 7, 20], dtype=torch.int32), 4, 2,
         tol=ATTN_TOL)
    both("rmsnorm", ops.rmsnorm, rx, rw, tol=RMS_F32)
    both("fused_adamw", ops.fused_adamw, p, g, m, vv, 7, 1e-3, 0.9, 0.999,
         1e-8, 0.01, tol=ew)
    both("fused_sgd", ops.fused_sgd, p, g, 0.1, tol=ew)
    both("fused_momentum", ops.fused_momentum, p, g, m, 0.1, 0.9, tol=ew)
    both("sq_norm", ops.sq_norm, p, tol=dict(rtol=NORM_RTOL, atol=0.0))
    both("sq_norm_groups", ops.sq_norm_groups, x2,
         tol=dict(rtol=NORM_RTOL, atol=0.0))
    both("mamba_chunk", ops.mamba_chunk, *mam,
         tol=[MAMBA_YS, MAMBA_YS, MAMBA_CUM, MAMBA_CUM])
    both("quantize_int8", ops.quantize_int8, qx, qu)
    both("dequantize_int8", ops.dequantize_int8, qq, qs)
    got = counts()
    want = dict.fromkeys(got, 1)
    want.update(sq_norm_groups=2, codec_mix=0, qdq_int8=0)
    log(f"ops path launches {got}")
    if got != want:
        fail(f"ops path launches {got}, expected {want}")
    del rx, rw, qx, qu, qq, qs, mam
    return {name: got[name] for name in LAST_FOUR}


# ---------------------------------------------------------------------------
# Phase 11: the paper's T_i = inf mode, its convex experiments and the
# sync-DP baseline
# ---------------------------------------------------------------------------
# Each figure's settings, copied from its driver in benchmarks/:
# fig2a_feasibility.py:15-18
FIG2A = dict(w0=(1.5, 0.8), lr=0.4, T=10, rounds=2000)
# fig2b_linear_rate.py:14-28
FIG2B = dict(n=62, d=2000, m=2, lr=2.0, Ts=(1, 10, 100), eps=1e-8,
             rounds=150, tol=1e-7)
# fig3_intersection.py:41-55
FIG3 = dict(n=500, side=28, m=10, T=100, lr=0.5, rounds=40)
# fig5_quartic.py:19-36
FIG5 = dict(n=20, d=400, m=2, w0=0.3, Ts=(10, 100, 1000), eps=1e-8,
            rounds=12, cases=(("quadratic", 1, 1.0), ("quartic", 2, 0.5)))
# fig67_nodes.py:13-18
FIG67 = dict(n=60, d=1200, ms=(2, 5, 10), lr=2.0, T=100, rounds=40)
# fig4_deepnet.py:22-34, 37-50
FIG4 = dict(G=4, per_group=4, seq=64, lr=0.05, rounds=10, Ts=(1, 10, 50),
            threshold=3e-2, max_inner=100)
# full-width threshold mode: paper-lenet, G 4, 2 sequences of 128 a group,
# sgd. eps is chosen from the groups' |g(w_t)|^2 over 30 fixed steps of
# round 1 (PERF.md §6, PR 18, run 1: 74-78 at w_0, 24.0 and 24.6 at w_1
# for groups 0 and 2, 26.5 and 27.1 for groups 3 and 1, 17-21 at w_2):
# groups 0 and 2 stop after 2 steps, 1 and 3 after 3
LENET_EPS = 25.5
LENET_MAX_INNER = 30
CONVEX_RTOL = 1e-4           # card against CPU on Fig 2b's prefix


def _zero_update_counts(K):
    for m in (K.fused_sgd, K.fused_momentum, K.fused_adamw, K.sq_norm):
        m.launches = 0


def _update_counts(K):
    return {"fused_sgd": K.fused_sgd.launches,
            "fused_momentum": K.fused_momentum.launches,
            "fused_adamw": K.fused_adamw.launches,
            "sq_norm_groups": K.sq_norm.launches}


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fig2a(torch, run_alg1, convex, np):
    c = FIG2A
    out, s = _timed(torch, lambda: run_alg1(
        convex.beck_teboulle_losses(), torch.tensor(c["w0"]), lr=c["lr"],
        T=c["T"], rounds=c["rounds"], device="cuda"))
    gsq = np.asarray(out["gsq"])
    n = np.arange(1, c["rounds"] + 1)
    tail = slice(c["rounds"] // 10, None)
    slope = float(np.polyfit(np.log(n[tail]), np.log(gsq[tail]), 1)[0])
    ok = bool(slope < -0.5 and gsq[-1] < 1e-6)
    log(f"fig2a: {c['rounds']} rounds T {c['T']} in {s:.2f} s; log-log slope "
        f"{slope:.4f}, gsq first {gsq[0]:.4e} last {gsq[-1]:.4e}, final x "
        f"{out['w'].tolist()}; pass {ok}")
    return ok, s


def fig2b(torch, run_alg1, rounds_to, convex, np):
    c = FIG2B
    prob = convex.make_overparam_regression(n=c["n"], d=c["d"], m=c["m"],
                                            seed=0)
    losses = prob.local_losses("cuda")
    w0 = torch.zeros(c["d"])
    rt, r2, s_all = {}, {}, 0.0
    runs = [(f"T={T}", T, None) for T in c["Ts"]] + [("T=inf", None,
                                                      c["eps"])]
    for label, T, thr in runs:
        out, s = _timed(torch, lambda: run_alg1(
            losses, w0, lr=c["lr"], T=T, rounds=c["rounds"], threshold=thr,
            stop_below=c["tol"] * 1e-6, device="cuda"))
        s_all += s
        gsq = np.asarray(out["gsq"])
        rt[label] = rounds_to(gsq, c["tol"])
        above = np.nonzero(gsq <= c["tol"])[0]
        k = max(int(above[0]) + 1 if above.size else len(gsq), 3)
        y, x = np.log(gsq[:k]), np.arange(k)
        cf = np.polyfit(x, y, 1)
        r2[label] = float(1 - np.sum((y - np.polyval(cf, x)) ** 2)
                          / max(np.sum((y - y.mean()) ** 2), 1e-30))
        inner = (f", inner steps {sum(map(sum, out['inner']))} over "
                 f"{len(out['inner'])} rounds, first rounds "
                 f"{out['inner'][:3]}" if thr else "")
        log(f"fig2b {label}: {len(gsq)} rounds in {s:.2f} s, rounds to "
            f"{c['tol']} {rt[label]}, linear r2 {r2[label]:.4f}{inner}")
    R = c["rounds"]
    mono = ((rt["T=100"] or R) <= (rt["T=10"] or R) <= (rt["T=1"] or R)
            and (rt["T=inf"] or R) <= (rt["T=100"] or R) + 2)
    ok = bool(mono and all(v and v > 0.9 for v in r2.values()))
    log(f"fig2b: rounds_to {rt}; pass {ok}")
    return ok, s_all


def fig2b_prefix_parity(torch, run_alg1, convex, np):
    """Fig 2b's T=10 and threshold runs, 5 rounds, on the card and on the
    CPU: gsq within CONVEX_RTOL and the inner counts equal."""
    c = FIG2B
    prob = convex.make_overparam_regression(n=c["n"], d=c["d"], m=c["m"],
                                            seed=0)
    for T, thr in ((10, None), (None, c["eps"])):
        outs = [run_alg1(prob.local_losses(dev), torch.zeros(c["d"]),
                         lr=c["lr"], T=T, rounds=5, threshold=thr,
                         device=dev) for dev in ("cuda", "cpu")]
        gc, gh = np.asarray(outs[0]["gsq"]), np.asarray(outs[1]["gsq"])
        err = float(np.max(np.abs(gc / gh - 1)))
        if err > CONVEX_RTOL or outs[0]["inner"] != outs[1]["inner"]:
            fail(f"fig2b prefix T={T} threshold={thr}: card and CPU differ "
                 f"(gsq rel err {err:.3e}, inner {outs[0]['inner']} vs "
                 f"{outs[1]['inner']})")
        log(f"fig2b prefix T={T} threshold={thr}: card = CPU over 5 rounds "
            f"(gsq max rel err {err:.3e}, inner {outs[0]['inner']})")


def fig3(torch, run_alg1, convex, synthetic, np):
    c = FIG3
    x, labels = synthetic.gaussian_classification(n=c["n"], side=c["side"],
                                                  seed=0)
    x = x / np.abs(x).max()
    cases = {"intersected": x,
             "non_intersected": synthetic.maxpool2x2_twice(x)}
    res, s_all = {}, 0.0
    for name, xc in cases.items():
        losses_m, dim = convex.affine_softmax_losses(xc, labels, c["m"],
                                                     device="cuda")
        losses_1, _ = convex.affine_softmax_losses(xc, labels, 1,
                                                   device="cuda")
        outs = []
        for losses in (losses_m, losses_1):
            out, s = _timed(torch, lambda: run_alg1(
                losses, torch.zeros(dim), lr=c["lr"], T=c["T"],
                rounds=c["rounds"], device="cuda"))
            outs.append(out)
            s_all += s
        res[name] = {"gsq_10node": outs[0]["gsq"][-1],
                     "gsq_1node": outs[1]["gsq"][-1],
                     "gap": outs[0]["f"][-1] - outs[1]["f"][-1]}
        log(f"fig3 {name}: {dim} params; {c['m']}-node gsq "
            f"{res[name]['gsq_10node']:.4e}, 1-node gsq "
            f"{res[name]['gsq_1node']:.4e}, f gap vs centralized "
            f"{res[name]['gap']:.4e}")
    inter, non = res["intersected"], res["non_intersected"]
    ok = bool(inter["gap"] < 1e-3
              and non["gap"] > 100 * max(inter["gap"], 1e-6)
              and inter["gsq_10node"] < 1e-4)
    log(f"fig3: {s_all:.2f} s; pass {ok}")
    return ok, s_all


def fig5(torch, run_alg1, rounds_to, convex, theory, np):
    c = FIG5
    cases, s_all = {}, 0.0
    for name, power, lr in c["cases"]:
        prob = convex.make_overparam_regression(n=c["n"], d=c["d"],
                                                m=c["m"], power=power, seed=0)
        losses = prob.local_losses("cuda")
        w0 = torch.ones(c["d"]) * c["w0"]
        final, r2t = {}, {}
        runs = [(f"T={T}", T, None) for T in c["Ts"]] + [
            ("threshold", None, c["eps"])]
        for label, T, thr in runs:
            out, s = _timed(torch, lambda: run_alg1(
                losses, w0, lr=lr, T=T, rounds=c["rounds"], threshold=thr,
                record_local_traj=(label == "T=1000"), device="cuda"))
            s_all += s
            final[label] = out["gsq"][-1]
            r2t[label] = rounds_to(out["gsq"], 1e-6)
            if label == "T=1000":
                traj = np.asarray(out["local_traj"][:1000])
            extra = ""
            if thr:
                extra = (f", inner steps {sum(map(sum, out['inner']))}: "
                         f"{out['inner']}")
            log(f"fig5 {name} {label}: {s:.2f} s, final gsq "
                f"{final[label]:.4e}, rounds to 1e-6 {r2t[label]}{extra}")
        traj = traj[traj > traj[0] * 1e-10][:200]
        fit = theory.fit_decay(traj)
        cases[name] = {"final": final, "fit": fit}
        log(f"fig5 {name}: decay fit {fit}")
    r = 0.01
    h_lin = lambda t: 0.9 ** t
    h_sub = lambda t: (1 + 2.0 * t) ** -1.5
    t_lin = theory.t_star_linear(0.9, r)
    t_sub = theory.t_star_sublinear(2.0, 1.5, r)
    lin_ratio = theory.cost_bound(max(int(round(t_lin)), 1), r, h_lin) / \
        theory.cost_bound(theory.t_star_numeric(r, h_lin), r, h_lin)
    sub_ratio = theory.cost_bound(max(int(round(t_sub)), 1), r, h_sub) / \
        theory.cost_bound(theory.t_star_numeric(r, h_sub), r, h_sub)
    quad, quar = cases["quadratic"], cases["quartic"]
    ok = bool(quad["fit"] is not None and quar["fit"] is not None
              and quad["fit"].kind == "linear"
              and quar["fit"].kind == "sublinear"
              and quar["final"]["T=1000"] < 0.5 * quar["final"]["T=100"]
              and lin_ratio <= 1.1 and sub_ratio <= 1.15)
    log(f"fig5: T* linear {t_lin:.3f} (cost ratio {lin_ratio:.4f}), "
        f"sublinear {t_sub:.3f} (cost ratio {sub_ratio:.4f}); {s_all:.2f} s;"
        f" pass {ok}")
    return ok, s_all


def fig67(torch, run_alg1, rounds_to, convex, np):
    c = FIG67
    rates, s_all = [], 0.0
    for m in c["ms"]:
        prob = convex.make_overparam_regression(n=c["n"], d=c["d"], m=m,
                                                seed=0)
        out, s = _timed(torch, lambda: run_alg1(
            prob.local_losses("cuda"), torch.zeros(c["d"]), lr=c["lr"],
            T=c["T"], rounds=c["rounds"], device="cuda"))
        s_all += s
        gsq = np.asarray(out["gsq"])
        rates.append(float((gsq[-1] / gsq[0]) ** (1.0 / (len(gsq) - 1))))
        log(f"fig67 m={m}: {s:.2f} s, final gsq {gsq[-1]:.4e}, rounds to "
            f"1e-9 {rounds_to(gsq, 1e-9)}, rate {rates[-1]:.6f}")
    ok = bool(rates[0] < rates[1] < rates[2])
    log(f"fig67: rates {rates}; pass {ok}")
    return ok, s_all


def convex_suite(torch, beside=None):
    """Phase 11, part 1: the convex figures through run_alg1 on the card,
    and Fig 4 on the pytree round, each in a process of its own, with
    ``beside()`` run here meanwhile."""
    import numpy as np

    from repro_torch.core import theory
    from repro_torch.core.reference import rounds_to, run_alg1
    from repro_torch.data import convex, synthetic

    fig2b_prefix_parity(torch, run_alg1, convex, np)
    prob = convex.make_overparam_regression(n=FIG2B["n"], d=FIG2B["d"],
                                            m=FIG2B["m"], seed=0)
    _profiled(torch, "convex: fig2b T=10, 5 rounds", lambda: run_alg1(
        prob.local_losses("cuda"), torch.zeros(FIG2B["d"]), lr=FIG2B["lr"],
        T=10, rounds=5, device="cuda"))
    _profiled(torch, "convex: fig2b threshold, 5 rounds", lambda: run_alg1(
        prob.local_losses("cuda"), torch.zeros(FIG2B["d"]), lr=FIG2B["lr"],
        T=None, rounds=5, threshold=FIG2B["eps"], device="cuda"))
    results = _run_figures(beside)
    log("convex suite wall s (the figures at once): " + ", ".join(
        f"fig{k} {s:.2f}" for k, (_, s) in results.items()))
    failed = [k for k, (ok, _) in results.items() if not ok]
    if failed:
        fail(f"convex suite: the pass expression of fig {failed} is false")


# the figures phase 11 runs at once, one process each
FIGURES = ("2a", "2b", "3", "5", "6-7", "4")


def _figure(torch, name):
    """One of FIGURES in this process: (pass, wall s)."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.core import theory
    from repro_torch.core.reference import rounds_to, run_alg1
    from repro_torch.data import convex, synthetic
    from repro_torch.kernels import (fused_adamw, fused_momentum,  # noqa: F401
                                     fused_sgd, sq_norm)

    if name == "2a":
        return fig2a(torch, run_alg1, convex, np)
    if name == "2b":
        return fig2b(torch, run_alg1, rounds_to, convex, np)
    if name == "3":
        return fig3(torch, run_alg1, convex, synthetic, np)
    if name == "5":
        return fig5(torch, run_alg1, rounds_to, convex, theory, np)
    if name == "6-7":
        return fig67(torch, run_alg1, rounds_to, convex, np)
    t0 = time.perf_counter()
    fig4(torch, K)               # fails on its own pass expression
    return True, time.perf_counter() - t0


def figure_main(name) -> int:
    """``chip_smoke.py --figure <name>``: one of FIGURES on the card; its
    log, then ``{"figure", "pass", "s"}`` as the last line."""
    import torch
    if name not in FIGURES or not torch.cuda.is_available():
        print(f"chip_smoke --figure: {name!r} needs CUDA and one of "
              f"{FIGURES}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    ok, s = _figure(torch, name)
    print(json.dumps({"figure": name, "pass": ok, "s": s}))
    return 0


def _run_figures(beside=None):
    """FIGURES at once, one process each (their output in temporary
    files), and ``beside()`` in this process while they run:
    {name: (pass, wall s)}. Fails if one fails; kills every process still
    running when it stops."""
    procs, outs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fig_") as tmp:
        try:
            for name in FIGURES:
                outs[name] = open(os.path.join(tmp, f"{name}.out"), "w+")
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--figure",
                     name], cwd=ROOT, stdout=outs[name],
                    stderr=subprocess.STDOUT, text=True)
            if beside is not None:
                beside()
            results = {}
            for name, p in procs.items():
                p.wait(timeout=1000)
                outs[name].seek(0)
                lines = outs[name].read().splitlines()
                for line in lines[:-1]:
                    log(line)
                if p.returncode != 0 or not lines:
                    fail(f"fig {name} exited {p.returncode}: "
                         + "\n".join(lines[-20:]))
                res = json.loads(lines[-1])
                results[name] = (res["pass"], res["s"])
            return results
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in outs.values():
                f.close()


def fig4(torch, K):
    """Phase 11, part 2: Fig 4 on the pytree round, paper-mlp at full
    config. Launches no kernel."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import fixed_group_batches
    from repro_torch.models.api import build_model

    c = FIG4
    cfg = get_config("paper-mlp")
    model = build_model(cfg, schedule="rect")
    params0 = model.init(torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    batch = {"tokens": torch.as_tensor(fixed_group_batches(
        cfg.vocab_size, c["seq"], c["G"], c["per_group"], seed=0)["tokens"],
        device="cuda")}
    final, before = {}, _update_counts(K)
    runs = [(f"T={T}", T, None) for T in c["Ts"]] + [
        ("threshold", None, c["threshold"])]
    for label, T, thr in runs:
        opt = optim.sgd(c["lr"])
        rnd = lsgd.make_local_round(model.loss, opt, lsgd.LocalSGDConfig(
            n_groups=c["G"], inner_steps=T or 1, threshold=thr,
            max_inner=c["max_inner"]))
        state = lsgd.init_state(params0, opt, n_groups=c["G"])
        losses, inners = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(c["rounds"]):
            state, m = rnd(state, batch)
            losses.append(float(m["loss"].mean()))
            inners.append(m["inner_steps"].tolist())
        s = time.perf_counter() - t0
        final[label] = losses[-1]
        log(f"fig4 {label}: {c['rounds']} rounds in {s:.2f} s, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}"
            + (f", inner steps {inners}" if thr else ""))
    if _update_counts(K) != before:
        fail("fig4: the pytree round launched a kernel")
    ok = (final["T=50"] < final["T=10"] < final["T=1"]
          and final["threshold"] < final["T=1"])
    log(f"fig4: final losses {final}; pass {ok}")
    if not ok:
        fail("fig4: the pass expression is false")


def _lenet(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("paper-lenet")
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    return cfg, model, params


def _profiled(torch, label, fn, cpu=True):
    """Run ``fn`` once under torch.profiler: the device's busy share of the
    fenced call and its device time by kernel. Returns what ``fn``
    returns. ``cpu=False`` records the device's activity alone (a call of
    100k launches and more, whose host events would take minutes to
    gather)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"profile {label}: the profiler captured no device time")
        return out
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {label}: {wall_ms:.1f} ms fenced (profiler on), device "
        f"busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%}, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile:   {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:<5d} {e.key[:100]}")
    return out


def lenet_threshold(torch, K):
    """Phase 11, part 3: threshold mode at full width (paper-lenet, G 4, 2
    sequences of 128 a group, sgd, 2 rounds), on the pytree round."""
    from repro_torch import optim, tree
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline

    cfg, model, params = _lenet(torch)
    G, opt = 4, optim.sgd(0.05)
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (G, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    n = sum(x.numel() for x in tree.leaves(params))
    rnd = lsgd.make_local_round(model.loss, opt, lsgd.LocalSGDConfig(
        n_groups=G, inner_steps=1, threshold=LENET_EPS,
        max_inner=LENET_MAX_INNER))
    state = lsgd.init_state(params, opt, n_groups=G)
    before = _update_counts(K)
    wire = 2 * G * 4 * n          # server/fp32: G pushes and G replies
    for r in range(2):
        torch.cuda.reset_peak_memory_stats()
        (state, m), s = _timed(torch, lambda: rnd(state, batch))
        steps, gsq = m["inner_steps"].tolist(), m["grad_sq"].tolist()
        log(f"lenet threshold round {r}: inner steps {steps}, grad_sq "
            + " ".join(f"{v:.4e}" for v in gsq) + f", {s:.3f} s fenced, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"wire {int(m['wire_bytes']):,} B")
        if any(t > LENET_MAX_INNER for t in steps):
            fail(f"lenet threshold: inner steps {steps} past the cap")
        for t, v in zip(steps, gsq):
            if t < LENET_MAX_INNER and v > LENET_EPS:
                fail(f"lenet threshold: a group stopped at {t} steps with "
                     f"grad_sq {v} > eps {LENET_EPS}")
        if int(m["wire_bytes"]) != wire:
            fail(f"lenet threshold: wire {int(m['wire_bytes'])} != {wire}")
        if r == 0 and len({t for t in steps if t < LENET_MAX_INNER}) < 2:
            fail(f"lenet threshold: counts {steps}; eps {LENET_EPS} should "
                 "stop two groups at different counts below the cap")
    if _update_counts(K) != before:
        fail("lenet threshold: the pytree round launched a kernel")
    # round 0 again, from the same start (10 local steps): the profiler's
    # own processing grows with the launches it records
    state = lsgd.init_state(params, opt, n_groups=G)
    _profiled(torch, "threshold round 0 (paper-lenet)",
              lambda: rnd(state, batch))


def pytree_vs_packed(torch):
    """Phase 11, part 4: the pytree round against the packed round at full
    width (paper-lenet, sgd, T 4, server/fp32) from the same params."""
    from repro_torch import optim, tree
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.optim import packing

    cfg, model, params = _lenet(torch)
    G = 4
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (G, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    lcfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=4)
    layout = packing.layout_of(params)
    popt = optim.packed("sgd", 0.05)
    prnd = lsgd.make_local_round(model.loss, popt, lcfg, layout=layout)
    (pst, _), ps = _timed(torch, lambda: prnd(
        lsgd.init_state(params, popt, G, layout), batch))
    packed_server = tree.leaves(lsgd.server_params(pst, layout))
    del pst
    topt = optim.sgd(0.05)
    trnd = lsgd.make_local_round(model.loss, topt, lcfg)
    (tst, _), ts = _timed(torch, lambda: trnd(
        lsgd.init_state(params, topt, G), batch))
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(lsgd.server_params(tst)), packed_server))
    log(f"pytree vs packed round (paper-lenet, sgd, T 4): server params max "
        f"abs diff {err:.3e}; pytree {ts:.3f} s, packed {ps:.3f} s fenced")
    if err > 1e-6:
        fail(f"pytree and packed rounds differ by {err:.3e} > 1e-6")


def microbatch_round(torch, K):
    """Phase 11, part 5: the packed round's microbatch mode at full width
    (paper-lenet, G 4, T 2 microbatches of 2 sequences of 128 a group,
    sgd, server/fp32). Its launches are counted from 0 (the update kernel
    once a step, the norm twice: the consensus before and after the
    exchange; no exchange kernel on server/fp32), then its server params
    are held against the pytree round's microbatch mode from the same
    params (atol 1e-6). Returns its launches."""
    from repro_torch import optim, tree
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.optim import packing

    cfg, model, params = _lenet(torch)
    G, T = 4, 2
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (G, T, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    lcfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=T,
                               inner_mode="microbatch")
    layout = packing.layout_of(params)
    popt = optim.packed("sgd", 0.05)
    prnd = lsgd.make_local_round(model.loss, popt, lcfg, layout=layout)
    pst = lsgd.init_state(params, popt, G, layout)
    ee = K.exchange_epilogue
    _zero_update_counts(K)
    for k in ee.launches:
        ee.launches[k] = 0
    (pst, pm), ps = _timed(torch, lambda: prnd(pst, batch))
    got = dict(_update_counts(K), **ee.launches)
    want = dict.fromkeys(got, 0)
    want.update(fused_sgd=T, sq_norm_groups=2)
    if got != want:
        fail(f"microbatch round: launches {got}, expected {want}")
    packed_server = tree.leaves(lsgd.server_params(pst, layout))
    del pst
    topt = optim.sgd(0.05)
    trnd = lsgd.make_local_round(model.loss, topt, lcfg)
    (tst, tm), ts = _timed(torch, lambda: trnd(
        lsgd.init_state(params, topt, G), batch))
    if dict(_update_counts(K), **ee.launches) != got:
        fail("microbatch round: the pytree round launched a kernel")
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(lsgd.server_params(tst)), packed_server))
    log(f"microbatch round (paper-lenet, sgd, T {T}): launches {got}; "
        f"loss {pm['loss'].tolist()}; server params against the pytree "
        f"round max abs diff {err:.3e}; packed {ps:.3f} s, pytree "
        f"{ts:.3f} s fenced")
    if err > 1e-6:
        fail(f"microbatch: pytree and packed rounds differ by {err:.3e} "
             "> 1e-6")
    return {k: got[k] for k in _update_counts(K)}


def _hold_sync_step(torch, K, name, i, pst, pm, plain, g):
    """A packed sync step's kernels against their plain versions on the
    step's own inputs, at its one-row (1, N) geometry: ``plain`` is the
    state the plain update (``impl="torch"``) makes from the state the
    step started from and the gradient ``g`` it was given. The params
    (and moments) bit-equal for sgd, ``EW_TOL`` for momentum and adamw,
    as in phase 3; grad_sq (``sq_norm``) within ``NORM_RTOL``."""
    errs = []
    for key, k, w in [("params", pst["params"], plain["params"])] + [
            (m, pst["opt"][m], plain["opt"][m]) for m in pst["opt"]
            if m != "count"]:
        if name == "sgd":
            if not torch.equal(k, w):
                fail(f"sync sgd step {i}: {key} differ from the plain "
                     "update's")
            errs.append(0.0)
        else:
            errs.append(compare(f"sync {name} step {i} {key}", k, w,
                                **EW_TOL))
    g_err = compare(f"sync {name} step {i} grad_sq", pm["grad_sq"],
                    K.sq_norm.sq_norm(g, impl="torch"), rtol=NORM_RTOL,
                    atol=0.0)
    log(f"sync {name} step {i}: kernels against plain versions at (1, "
        f"{pst['params'].numel():,}): state max abs err {max(errs):.3e}, "
        f"grad_sq {float(pm['grad_sq']):.6e} (err {g_err:.3e})")


def sync_baseline(torch, K):
    """Phase 11, part 6: the sync-DP baseline at full width. Returns the
    packed sync steps' launches (counts set to 0 just before them)."""
    from repro_torch import optim
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.optim import packing

    cfg, model, params = _lenet(torch)
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (8,)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    layout = packing.layout_of(params)
    # the pytree step first, from the same params, beside the packed one
    topt = optim.adamw(1e-3)
    tstep = lsgd.make_sync_step(model.loss, topt)
    before = _update_counts(K)
    (tst, tm), ts = _timed(torch, lambda: tstep(
        lsgd.init_state(params, topt), batch))
    if _update_counts(K) != before:
        fail("sync: the pytree step launched a kernel")
    tree_buf = packing.pack(tst["params"], layout)
    del tst
    counts = {}
    for name, steps in (("sgd", 1), ("momentum", 1), ("adamw", 3)):
        lr = 1e-3 if name == "adamw" else 0.05
        popt = optim.packed(name, lr)
        plain_opt = optim.packed(name, lr, impl="torch")
        given = {}

        def kept(buf, g, state, active=None, _step=popt.step):
            # the gradient the update is given (read, not written, by it):
            # the plain update is held against the kernel's on it
            given["g"] = g
            return _step(buf, g, state, active)

        pstep = lsgd.make_sync_step(
            model.loss, dataclasses.replace(popt, step=kept), layout=layout)
        pst = lsgd.init_state(params, popt, layout=layout)
        _zero_update_counts(K)
        for i in range(steps):
            start = {"params": pst["params"].clone(),
                     "opt": {k: v.clone() for k, v in pst["opt"].items()}}
            (pst, pm), s = _timed(torch, lambda: pstep(pst, batch))
            launched = _update_counts(K)
            rp, ro = plain_opt.step(start["params"], given["g"],
                                    start["opt"])
            _hold_sync_step(torch, K, name, i, pst, pm,
                            {"params": rp, "opt": ro}, given.pop("g"))
            if _update_counts(K) != launched:
                fail(f"sync {name}: the plain versions launched a kernel")
            del start, rp, ro
            if name == "adamw":
                log(f"sync step {i} (packed adamw, paper-lenet, batch 8 x "
                    f"128): loss {float(pm['loss']):.4f} gsq "
                    f"{float(pm['grad_sq']):.4e}, {s:.3f} s fenced")
                if i == 0:
                    diff = (pst["params"] - tree_buf).abs()
                    err = float(diff.max())
                    if bool((diff > 1e-6 + 1e-5 * tree_buf.abs()).any()):
                        fail(f"sync: the packed and pytree adamw steps "
                             f"differ (max abs err {err:.3e})")
                    log(f"sync: packed and pytree adamw steps agree (max abs "
                        f"err {err:.3e}; pytree step {ts:.3f} s, loss "
                        f"{float(tm['loss']):.4f})")
        got = _update_counts(K)
        want = {"fused_sgd": 0, "fused_momentum": 0, "fused_adamw": 0,
                "sq_norm_groups": steps}
        want["fused_" + name] = steps
        if got != want:
            fail(f"sync {name}: launches {got}, expected {want}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    log(f"sync steps launched {counts}")
    _profiled(torch, "sync step (packed adamw, paper-lenet)",
              lambda: pstep(pst, batch))
    return counts


def launcher_runs(torch):
    """Phase 11, part 7: the train launcher's new modes at paper-mlp's full
    config, as a user runs them; each must exit 0."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "paper-mlp", "--rounds", "2"]
    runs = {"sync": ["--mode", "sync", "--packed"],
            "threshold": ["--threshold", "3e-2"],
            # at lr 0.02 a group's ||g||^2 decays over the round and the
            # Sec-4 fit finds its order; at the default 0.05 it grows, and
            # the controller asks for its cap, T = 10,000 (PR 18 run 1)
            "adaptive": ["--packed", "--adaptive-t", "--t-inner", "4",
                         "--lr", "0.02"]}
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {k: subprocess.Popen(base + v, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in runs.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k], err = p.communicate(timeout=300)
            for line in outs[k].splitlines():
                log(f"launcher {k}: {line}")
            if p.returncode != 0:
                fail(f"launcher {k} {runs[k]} exited {p.returncode}: "
                     f"{err[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    # the adaptive run's T comes from the controller after round 0
    ts = [int(l.split(" T ")[1].split()[0])
          for l in outs["adaptive"].splitlines() if l.startswith("round ")]
    if len(ts) != 2 or ts[0] != 4 or ts[1] == 4:
        fail(f"launcher adaptive: T {ts}, expected 4 then the controller's")


def phase11(torch, K, beside=None):
    """Phase 11: the convex suite, Fig 4, full-width threshold mode, the
    pytree round against the packed one, the packed microbatch round and
    the sync-DP baseline, then the launcher; ``beside()`` runs in this
    process while the figures' processes run. Returns the launches of the
    microbatch round and of the packed sync steps, by path."""
    t0 = time.perf_counter()

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        log(f"phase 11 {name}: {time.perf_counter() - t:.1f} s")
        return out

    part("convex suite and fig 4", lambda: convex_suite(torch, beside))
    part("threshold at full width", lambda: lenet_threshold(torch, K))
    part("pytree vs packed", lambda: pytree_vs_packed(torch))
    micro = part("microbatch round", lambda: microbatch_round(torch, K))
    sync = part("sync baseline", lambda: sync_baseline(torch, K))
    part("launchers", lambda: launcher_runs(torch))
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return {"microbatch_launches": micro, "sync_launches": sync}


# ---------------------------------------------------------------------------
# Phase 12: the exchange on an unreliable network: fault masks, push_sum,
# the hierarchical tiers and overlapped delayed mixing
# ---------------------------------------------------------------------------
# the mask grid: fault seeds, rounds, hops, circulant offset lanes, G
MASK_SEEDS, MASK_ROUNDS, MASK_GS = range(4), range(64), (1, 2, 4, 8, 17)
# the small reference check: (tag, optimizer, lr, optimizer kwargs, G,
# exchange kwargs); adamw at eps 1e-3 where int8z carries its moments, as
# in phase 4
FAULT_REF = [
    ("push_sum sgd", "sgd", 0.05, {}, 4,
     dict(topology="push_sum", drop_rate=0.1, stall_rate=0.05)),
    ("faulty server adamw int8/int8z", "adamw", 1e-3, dict(eps=1e-3), 4,
     dict(topology="server", codec="int8", moment_codec="int8z",
          drop_rate=0.1)),
    ("hierarchical ring|push_sum sgd", "sgd", 0.05, {}, 8,
     dict(topology="hierarchical", n_pods=4, drop_rate=0.075)),
    ("overlap ring int8 sgd", "sgd", 0.05, {}, 4,
     dict(topology="ring", codec="int8", overlap=True)),
]
# phase 12's full-width runs (paper-lenet, 2 x 128 tokens a group, T 4, 2
# rounds each, through build_run): launcher flags, and per round the
# launches of qdq_int8 and the error-feedback residuals sq_norm_groups
# reduces; codec_mix never runs (every stream is staged under a fault
# plan, on push_sum, the tiers and the overlap encode). "profile": the
# second round runs under torch.profiler (one run: the profiler's
# processing of a round's ~28k launches takes 25-50 s).
FAULT_PLAN = [
    dict(opt="sgd", lr=0.05, comm="push_sum", drop_rate=0.05,
         stall_rate=0.02),
    dict(opt="adamw", lr=1e-3, comm="push_sum", codec="bf16",
         drop_rate=0.05, stall_rate=0.02, profile=True),
    dict(opt="adamw", lr=1e-3, comm="server", codec="int8",
         moment_codec="int8z", drop_rate=0.1, qdq_int8=3),
    dict(opt="sgd", lr=0.05, comm="ring", codec="int8", mix_rounds=2,
         drop_rate=0.1, qdq_int8=2),
    dict(opt="momentum", lr=0.05, groups=8, comm="gossip", codec="bf16",
         drop_rate=0.1),
    dict(opt="sgd", lr=0.05, comm="server", codec="topk", drop_rate=0.1,
         residuals=1),
    dict(opt="sgd", lr=0.05, groups=8, comm="hierarchical", n_pods=4,
         drop_rate=0.075),
    dict(opt="sgd", lr=0.05, groups=8, comm="hierarchical", n_pods=4,
         intra_topology="server", inter_topology="server",
         inter_codec="int8", qdq_int8=1),
    dict(opt="sgd", lr=0.05, comm="ring", codec="int8", overlap=True,
         qdq_int8=1),
    dict(opt="adamw", lr=1e-3, comm="server", overlap=True),
]
FAULT_FLAGS = ("comm", "codec", "moment_codec", "mix_rounds", "drop_rate",
               "stall_rate", "overlap", "n_pods", "intra_topology",
               "inter_topology", "inter_codec")
# the convex headlines' settings: benchmarks/fault_tolerance.py:60-66
# (G 4, D 400, lr 0.4, T 16, 120 rounds, bias at 5% drop with fault seed
# 2 over 60 iterations) and benchmarks/tier.py:68-80 (G 8 over 4 pods,
# DCN loss 0.075; the same D, lr, T, rounds and bias cell), with their
# bars and floors
FAULT_BENCH = dict(G=4, D=400, lr=0.4, T=16, rounds=120, drop=0.05,
                   floor=1e-10, bias_seed=2, bias_iters=60, unbias_bar=100)
TIER_BENCH = dict(G=8, pods=4, D=400, lr=0.4, T=16, rounds=120, drop=0.075,
                  floor=1e-7, bias_seed=2, bias_iters=60, unbias_bar=1e4,
                  wire_bar=3.5)


def _all_counts(K):
    """Every kernel's launch count, by the ``kernels`` line's names."""
    c = dict(_update_counts(K), **K.exchange_epilogue.launches,
             **K.quantize.launches)
    c.update(flash_attention=K.flash_attention.launches,
             paged_decode_attention=K.decode_attention.launches,
             rmsnorm=K.rmsnorm.launches, mamba_chunk=K.mamba_scan.launches)
    return c


def _zero_all_counts(K):
    from repro_torch.kernels import (decode_attention,  # noqa: F401
                                     flash_attention, mamba_scan, quantize,
                                     rmsnorm)
    _zero_update_counts(K)
    for d in (K.exchange_epilogue.launches, K.quantize.launches):
        for k in d:
            d[k] = 0
    for m in (K.flash_attention, K.decode_attention, K.rmsnorm,
              K.mamba_scan):
        m.launches = 0


def numpy_noise(seed):
    """int8 noise from numpy, per (seed, count): the same bits on the card
    and on the CPU."""
    import numpy as np

    def fn(count, shape):
        return np.random.default_rng([seed, count]).random(shape,
                                                           dtype=np.float32)
    return fn


def fault_masks(torch):
    """Phase 12, part 1: every FaultPlan mask of the grid, copied to the
    card as the exchange copies them, equal to the CPU's bit for bit; flat
    plans and the tiers of the hierarchical exchange's TieredFaultPlan."""
    from repro_torch.comm import faults, get_exchange

    t0 = time.perf_counter()
    dev, host = [], []
    for seed in MASK_SEEDS:
        kw = dict(drop_rate=(0.05, 0.1, 0.3, 1 / 3)[seed],
                  stall_rate=(0.0, 0.05, 0.2, 0.02)[seed],
                  dropouts=((1, 3, 9), (0, 0, 64))[:seed % 3])
        tiered = get_exchange("hierarchical", "fp32", 4, n_pods=2,
                              fault_seed=seed, intra_drop_rate=0.1,
                              intra_stall_rate=0.05, **kw).fault_plan
        for plan in (faults.FaultPlan(seed=seed, **kw), tiered.intra,
                     tiered.inter):
            for rnd in MASK_ROUNDS:
                for n in MASK_GS:
                    masks = [plan.active_mask(rnd, n), plan.push_mask(rnd, n)]
                    for h in (0, 1):
                        masks.append(plan.matrix_mask(rnd, h, n))
                        masks += [plan.edge_mask(rnd, h, o, n) for o in (0, 1)]
                    host += [torch.as_tensor(m).reshape(-1) for m in masks]
                    dev += [torch.as_tensor(m, device="cuda").reshape(-1)
                            for m in masks]
    got = torch.cat(dev).cpu()
    want = torch.cat(host)
    if not torch.equal(got, want):
        fail(f"fault masks: the card's differ from the CPU's at "
             f"{int((got != want).sum())} of {want.numel()} entries")
    log(f"fault masks: {len(dev)} masks ({want.numel()} entries; seeds "
        f"{list(MASK_SEEDS)}, rounds 0-{MASK_ROUNDS[-1]}, hops 0-1, offsets "
        f"0-1, G {MASK_GS}; flat and both tiers) equal on the card and the "
        f"CPU; drop share {1 - float(want.mean()):.4f}; "
        f"{time.perf_counter() - t0:.1f} s")


def fault_reference_check(torch):
    """Phase 12, part 2: the packed round under faults, push_sum, the tiers
    and overlap on a paper-mlp reduction, on the card with the kernels and
    on the CPU with the plain versions, from the same params, batches and
    numpy int8 noise, 3 rounds each. fp32 paths: params, moments and the
    metrics at rtol 1e-5 / atol 1e-6 (adamw params atol 1e-4, as phase 4:
    a near-zero gradient's step is ~lr whatever its size). int8 paths:
    phase 4's rule (all but 1% of the elements within rtol 1e-4, all
    within 2e-3; metrics rtol 2e-3): a last-bit difference between the
    card's and the CPU's gradients can move an int8 rounding by one
    quantum. Wire bytes, participation, the mass counters and the round
    counter equal."""
    from repro_torch import comm, optim, tree
    from repro_torch.configs.base import get_config
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import packing

    cfg = get_config("paper-mlp").reduced()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator().manual_seed(7))
    layout = packing.layout_of(params)
    for tag, name, lr, okw, G, ekw in FAULT_REF:
        lossy = ekw.get("codec", "fp32") == "int8"
        lcfg = lsgd.LocalSGDConfig(n_groups=G, inner_steps=3)
        pipe = TokenPipeline(cfg.vocab_size, 32, seed=7).batches((G, 2))
        batches = [torch.as_tensor(next(pipe)["tokens"]) for _ in range(3)]
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.get(name, lr, packed=True, **okw)
            ex = comm.get_exchange(n_groups=G, noise_hook=numpy_noise,
                                   fault_seed=3, **ekw)
            rnd = lsgd.make_local_round(model.loss, opt, lcfg, layout=layout,
                                        exchange=ex)
            state = lsgd.init_state(tree.tree_map(lambda x: x.to(dev),
                                                  params),
                                    opt, G, layout, exchange=ex)
            ms = []
            for b in batches:
                state, m = rnd(state, {"tokens": b.to(dev)})
                ms.append({k: v.cpu() if isinstance(v, torch.Tensor) else v
                           for k, v in m.items()})
            bufs = {"params": state["params"].cpu()}
            bufs.update({k: state["opt"][k].cpu() for k in opt.moment_keys})
            bufs.update({f"inflight/{k}": v.cpu() for k, v in
                         state["comm"].get("inflight", {}).items()})
            comm_ = {k: state["comm"][k].cpu() for k in
                     ("round", "mass", "backlog_w") if k in state["comm"]}
            out[dev] = (bufs, ms, comm_)
        for k, want in out["cpu"][0].items():
            got = out["cuda"][0][k]
            atol = 1e-4 if (k == "params" and name == "adamw") else 1e-6
            if not lossy:
                err = compare(f"{tag} {k} (cuda vs cpu)", got, want,
                              rtol=1e-5, atol=atol)
                log(f"fault reference check: {tag} {k}: max abs err "
                    f"{err:.3e}")
                continue
            off = (got - want).abs() > atol + 1e-4 * want.abs()
            err = compare(f"{tag} {k} (cuda vs cpu)", got, want, rtol=0.0,
                          atol=2e-3)
            frac = off.double().mean().item()
            if frac > 0.01:
                fail(f"{tag} {k}: {frac:.2%} of the elements differ beyond "
                     "rtol 1e-4 (allowed 1%)")
            log(f"fault reference check: {tag} {k}: max abs err {err:.3e}, "
                f"{frac:.4%} of the elements beyond rtol 1e-4")
        for n, (mc, mg) in enumerate(zip(out["cpu"][1], out["cuda"][1])):
            for k in ("loss", "grad_sq", "consensus_sq", "consensus_sq_post"):
                compare(f"{tag} round {n} {k} (cuda vs cpu)", mg[k], mc[k],
                        rtol=2e-3 if lossy else 1e-5, atol=1e-6)
            for k, v in mc.items():
                if (k.startswith(("wire_bytes", "participation",
                                  "delivery_rate")) and not
                        bool(torch.equal(torch.as_tensor(v),
                                         torch.as_tensor(mg[k])))):
                    fail(f"{tag} round {n} {k}: {v} on the CPU, {mg[k]} on "
                         "the card")
        for k, v in out["cpu"][2].items():
            if not torch.equal(v, out["cuda"][2][k]):
                fail(f"{tag} comm[{k!r}]: {v} on the CPU, "
                     f"{out['cuda'][2][k]} on the card")
        log(f"fault reference check: {tag} on the card agrees with the CPU "
            f"(participation {[float(m['participation']) for m in out['cuda'][1]]})")


def expected_fault_wire(run, n):
    """A phase-12 round's wire bytes from the shapes. push_sum: one (value,
    weight) payload per directed ring edge (offsets 1 and G-1) per hop,
    priced at the delivery rate (1 - drop)(1 - stall)^2, the params
    payload 4 bytes longer (the weight counter), each edge counted once.
    Hierarchical, G over P pods of s: the pod ring's edges (1 offset at s
    2, 2 above) per hop, or each member's push and the pod mean's reply
    (server); across pods, one leader payload per pod per pod-ring edge
    at the DCN delivery rate (push_sum, +4 bytes), or each leader's push
    and reply (server), through the cross-tier codec. The flat faulty
    topologies and overlap: phase 5's count (a dropped push is priced as
    an attempt)."""
    if run["comm"] not in ("push_sum", "hierarchical"):
        return expected_wire(run, n)

    def width(codec):
        return {"fp32": 4 * n, "fp16": 2 * n, "bf16": 2 * n,
                "int8": n + 4 * -(-n // 256)}[codec]

    g = run.get("groups", 4)
    codecs_ = ([run.get("codec", "fp32")]
               + [run.get("moment_codec", "fp32")] * MOMENTS[run["opt"]])
    deliv = (1 - run.get("drop_rate", 0.0)) * (1 - run.get("stall_rate",
                                                           0.0)) ** 2
    if run["comm"] == "push_sum":
        edges = 2 * g * run.get("mix_rounds", 1) * deliv
        return sum(round(edges * (width(c) + (4 if i == 0 else 0)))
                   for i, c in enumerate(codecs_))
    pods = run["n_pods"]
    s = g // pods
    if run.get("intra_topology", "ring") == "server":
        intra = sum(2 * round(g * width(c)) for c in codecs_)
    else:
        sends = g * (1 if s == 2 else 2) * run.get("mix_rounds", 1)
        intra = sum(round(sends * width(c)) for c in codecs_)
    xcodecs = [run.get("inter_codec") or c for c in codecs_]
    if run.get("inter_topology", "push_sum") == "server":
        inter = sum(2 * round(pods * width(c)) for c in xcodecs)
    else:
        sends = (1 if pods == 2 else 2) * pods * deliv
        inter = sum(round(sends * (width(c) + (4 if i == 0 else 0)))
                    for i, c in enumerate(xcodecs))
    return intra + inter


def fault_path(torch, K):
    """Phase 12, part 3: paper-lenet at full width through the launcher's
    builder under each FAULT_PLAN run, 2 rounds each, with the launches
    counted from 0 before the first run. Returns every kernel's launches
    over the part."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    T, per_group, seq = 4, 2, 128
    _zero_all_counts(K)
    expected = dict.fromkeys(_all_counts(K), 0)
    for run in FAULT_PLAN:
        opt, G = run["opt"], run.get("groups", 4)
        flags = {k: run[k] for k in FAULT_FLAGS if k in run}
        tag = f"{opt} {flags}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cfg, _, layout, rnd, state, _, _, ex = build_run(
            "paper-lenet", groups=G, t_inner=T, opt=opt, lr=run["lr"],
            seed=0, device="cuda", fault_seed=1, **flags)
        if layout.size != MAIN[1]:
            fail(f"paper-lenet packs to {layout.size}, expected {MAIN[1]}")
        wire = expected_fault_wire(run, layout.size)
        tokens = next(TokenPipeline(cfg.vocab_size, seq, seed=0).batches(
            (G, per_group)))["tokens"]
        batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
        for n in range(2):
            before = _all_counts(K)
            profiled = run.get("profile") and n == 1
            if profiled:
                # the round alone is timed: the profiler's own processing
                # after it takes longer than the round
                (state, m), sec = _profiled(
                    torch, f"fault path {tag} round 1",
                    lambda: _timed(torch, lambda: rnd(state, batch)))
            else:
                (state, m), sec = _timed(torch, lambda: rnd(state, batch))
            want = dict.fromkeys(before, 0)
            want[f"fused_{opt}"] = T
            want["sq_norm_groups"] = 2 + run.get("residuals", 0)
            want["qdq_int8"] = run.get("qdq_int8", 0)
            got = {k: v - before[k] for k, v in _all_counts(K).items()}
            if got != want:
                fail(f"{tag} round {n}: launches {got}, expected {want}")
            for k, v in want.items():
                expected[k] += v
            if m["wire_bytes"] != wire:
                fail(f"{tag} round {n}: wire_bytes {m['wire_bytes']}, "
                     f"expected {wire}")
            cst = state["comm"]
            part = float(m["participation"])
            if not 0.0 < part <= 1.0:
                fail(f"{tag} round {n}: participation {part}")
            mass = None
            if "mass" in cst:
                mass = float(cst["mass"].sum() + cst["backlog_w"].sum())
                if abs(mass - G) > 1e-3:
                    fail(f"{tag} round {n}: sum(mass) + sum(backlog_w) = "
                         f"{mass!r}, not {G} within 1e-3")
            bufs = [state["params"]] + [v for k, v in state["opt"].items()
                                        if k != "count"]
            bufs += list(cst.get("backlog", {}).values())
            bufs += list(cst.get("inflight", {}).values())
            if not all(bool(torch.isfinite(b).all()) for b in bufs):
                fail(f"{tag} round {n}: a state buffer is not finite")
            if not bool(torch.isfinite(m["loss"]).all()):
                fail(f"{tag} round {n}: loss {m['loss'].tolist()}")
            log(f"fault path {ex.name} {opt} G {G} round {n}: {sec:.4f} s "
                f"fenced{' (profiler on)' if profiled else ''}, loss "
                f"{m['loss'].mean().item():.4f}, participation {part:.4f} "
                f"(intra {float(m['participation_intra']):.4f}, inter "
                f"{float(m['participation_inter']):.4f}), mass {mass!r}, "
                f"backlog {float(m['backlog_mass']):.4e}, cons "
                f"{m['consensus_sq'].sum().item():.4e} -> "
                f"{m['consensus_sq_post'].sum().item():.4e}, wire "
                f"{m['wire_bytes']:,} B, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del state, rnd
        torch.cuda.empty_cache()
    total = _all_counts(K)
    log(f"fault path launches {total} (expected {expected})")
    if total != expected:
        fail(f"fault path launch counts {total} != expected {expected}")
    return total


def _feasibility(np, G, D, rows=20, seed=0):
    """The reference benchmarks' make_feasibility, in numpy: consistent
    least squares over G nodes. As there, A and b are formed in float64
    (a float32 draw over numpy's float64 sqrt) and stored as float32."""
    rng = np.random.RandomState(seed)
    A = rng.randn(G, rows, D).astype(np.float32) / np.sqrt(D)
    w_star = rng.randn(D).astype(np.float32)
    b = np.einsum("grd,d->gr", A, w_star)
    return ({"w": rng.randn(D).astype(np.float32)},
            {"A": A.astype(np.float32), "b": b.astype(np.float32)})


def _quad_loss(params, batch):
    r = batch["A"] @ params["w"] - batch["b"]
    return 0.5 * (r * r).sum()


def _convex_cell(torch, np, c, **ekw):
    """One packed sgd cell of the feasibility problem on the card: mean
    grad_sq after ``c["rounds"]`` rounds of T local steps."""
    from repro_torch import bridge, comm, optim
    from repro_torch.core import localsgd as lsgd
    from repro_torch.optim import packing

    params, batch = _feasibility(np, c["G"], c["D"])
    p = bridge.params_from_numpy(params, "cuda")
    b = bridge.params_from_numpy(batch, "cuda")
    layout = packing.layout_of(p)
    opt = optim.packed("sgd", c["lr"])
    ex = comm.get_exchange(n_groups=c["G"], **ekw)
    rnd = lsgd.make_local_round(_quad_loss, opt, lsgd.LocalSGDConfig(
        n_groups=c["G"], inner_steps=c["T"]), layout=layout, exchange=ex)
    st = lsgd.init_state(p, opt, c["G"], layout, exchange=ex)
    for _ in range(c["rounds"]):
        st, m = rnd(st, b)
    return float(m["grad_sq"].mean()), ex


def _bias(torch, np, G, iters, cells):
    """Mixing-only consensus of numpy-drawn x (randn(G, 20) * 3, seed 0;
    the reference draws its x with jax.random, which cannot be
    reproduced) through each exchange's params map on the card: the max
    drift of the mean."""
    from repro_torch import comm

    x = np.random.RandomState(0).randn(G, 20).astype(np.float32) * 3
    out = {}
    for tag, kw in cells.items():
        ex = comm.get_exchange(n_groups=G, **kw)
        y = torch.tensor(x, device="cuda")
        st = ex.init(y)
        for _ in range(iters):
            y, st = ex.params(y, None, st)
        o = y.cpu().numpy()
        out[tag] = float(np.abs(o.mean(0) - x.mean(0)).max())
    return out


def convex_headlines(torch):
    """Phase 12, part 4: the fault and tier benchmarks' headlines on the
    card, at their own settings (FAULT_BENCH, TIER_BENCH), beside the
    committed BENCH_fault.json and BENCH_tier.json values; each bar must
    hold."""
    import numpy as np

    ref = {}
    for key, name in (("fault", "BENCH_fault.json"),
                      ("tier", "BENCH_tier.json")):
        with open(os.path.join(ROOT, name)) as f:
            ref[key] = json.load(f)["headline"]
    c = FAULT_BENCH
    (gsq0, _), s0 = _timed(torch, lambda: _convex_cell(
        torch, np, c, topology="server", fault_seed=0))
    (gsq5, ex5), s5 = _timed(torch, lambda: _convex_cell(
        torch, np, c, topology="push_sum", drop_rate=c["drop"],
        fault_seed=0))
    margin = 10.0 * max(gsq0, c["floor"]) / max(gsq5, c["floor"])
    bias = _bias(torch, np, c["G"], c["bias_iters"], {
        t: dict(topology=t, drop_rate=c["drop"], fault_seed=c["bias_seed"])
        for t in ("gossip", "push_sum")})
    unbias = bias["gossip"] / max(bias["push_sum"], 1e-12)
    r = ref["fault"]
    log(f"fault headline: lossless gsq {gsq0:.4e} ({s0:.1f} s), push_sum "
        f"at {c['drop']} gsq {gsq5:.4e} ({s5:.1f} s, {ex5.name}) -> margin "
        f"{margin:.4f} (bar 1; BENCH_fault.json {r['push_sum_gsq_margin']}, "
        f"gsq {r['lossless_gsq']:.4e} / {r['push_sum_gsq']:.4e}); bias "
        f"gossip {bias['gossip']:.4e} push_sum {bias['push_sum']:.4e} -> "
        f"unbias {unbias:.1f} (bar {c['unbias_bar']}; BENCH_fault.json "
        f"{r['push_sum_unbias_factor']:.1f}, gossip "
        f"{r['gossip_bias_at_5pct']:.4e})")
    c = TIER_BENCH
    hier = dict(topology="hierarchical", n_pods=c["pods"])
    (gsq0, _), s0 = _timed(torch, lambda: _convex_cell(
        torch, np, c, fault_seed=0, **hier))
    (gsqx, exx), sx = _timed(torch, lambda: _convex_cell(
        torch, np, c, drop_rate=c["drop"], fault_seed=0, **hier))
    tmargin = 10.0 * max(gsq0, c["floor"]) / max(gsqx, c["floor"])
    from repro_torch import comm
    ss = dict(hier, intra_topology="server", inter_topology="server")
    bt_f = comm.get_exchange(n_groups=c["G"], **ss).wire_bytes_by_tier(
        c["D"])
    bt_q = comm.get_exchange(n_groups=c["G"], inter_codec="int8",
                             **ss).wire_bytes_by_tier(c["D"])
    wire = bt_f["inter"] / bt_q["inter"]
    tbias = _bias(torch, np, c["G"], c["bias_iters"], {
        "gossip": dict(topology="gossip", drop_rate=c["drop"],
                       fault_seed=c["bias_seed"]),
        "hier": dict(drop_rate=c["drop"], fault_seed=c["bias_seed"],
                     **hier)})
    tunbias = tbias["gossip"] / max(tbias["hier"], 1e-12)
    r = ref["tier"]
    log(f"tier headline: lossless gsq {gsq0:.4e} ({s0:.1f} s), DCN loss "
        f"{c['drop']} gsq {gsqx:.4e} ({sx:.1f} s, {exx.name}) -> margin "
        f"{tmargin:.4f} (bar 1; BENCH_tier.json {r['tier_gsq_margin']}, "
        f"gsq {r['lossless_gsq']:.4e} / {r['dcn_loss_gsq']:.4e}); inter "
        f"wire {bt_f['inter']:,} -> {bt_q['inter']:,} B = {wire:.4f}x (bar "
        f"{c['wire_bar']}; BENCH_tier.json "
        f"{r['cross_tier_wire_reduction']:.4f}); bias gossip "
        f"{tbias['gossip']:.4e} tiered {tbias['hier']:.4e} -> unbias "
        f"{tunbias:.1f} (bar {c['unbias_bar']:g}; BENCH_tier.json "
        f"{r['tier_unbias_factor']:.1f})")
    bars = {"fault margin": margin >= 1.0,
            "fault unbias": unbias >= FAULT_BENCH["unbias_bar"],
            "tier margin": tmargin >= 1.0, "tier wire": wire >= c["wire_bar"],
            "tier unbias": tunbias >= c["unbias_bar"]}
    if not all(bars.values()):
        fail(f"convex headlines: bars {bars}")


def fault_launcher_runs(torch):
    """Phase 12, part 5: the train launcher at paper-mlp's full config with
    push_sum under drops, the tiers over a lossy DCN and the overlapped
    ring with int8; each must exit 0 and print its participation."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "paper-mlp", "--rounds", "2", "--packed"]
    runs = {"push_sum": ["--comm", "push_sum", "--drop-rate", "0.05"],
            "hierarchical": ["--comm", "hierarchical", "--groups", "8",
                             "--n-pods", "4", "--drop-rate", "0.075"],
            "overlap": ["--comm", "ring", "--codec", "int8", "--overlap"]}
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {k: subprocess.Popen(base + v, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, v in runs.items()}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=300)
            for line in out.splitlines():
                log(f"launcher {k}: {line}")
            if p.returncode != 0:
                fail(f"launcher {k} {runs[k]} exited {p.returncode}: "
                     f"{err[-2000:]}")
            if sum(" part " in l for l in out.splitlines()) != 2:
                fail(f"launcher {k}: no participation in its round lines")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def phase12(torch, K):
    """Phase 12: the exchange on an unreliable network. Returns the full-
    width part's launches, as ``fault_launches``."""
    t0 = time.perf_counter()

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        log(f"phase 12 {name}: {time.perf_counter() - t:.1f} s")
        return out

    part("masks", lambda: fault_masks(torch))
    part("reference check", lambda: fault_reference_check(torch))
    counts = part("full width", lambda: fault_path(torch, K))
    part("convex headlines", lambda: convex_headlines(torch))
    part("launchers", lambda: fault_launcher_runs(torch))
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return {"fault_launches": counts}


# Phase 13: the engine's other model families at full width (their
# published widths; depth cut where one card forces it). Served: (arch,
# layers on the card or None for all, requests); dense and moe through the
# flash prefill at the 1024 bucket, hybrid and ssm token by token at 64,
# 4 requests (at 81 and 48 layers a prompt token costs ~70-150 ms of the
# host's time, and the script has 1200 s in all).
FAMILY_SERVE = dict(n_slots=8, page_size=16, max_prompt=1024, max_new=16)
FAMILY_LOAD = dict(rate=50, prompt_len=(512, 1024), max_new=(8, 16), seed=0)
RECURRENT_SERVE = dict(FAMILY_SERVE, max_prompt=64)
RECURRENT_LOAD = dict(FAMILY_LOAD, prompt_len=(32, 64))
FAMILY_SERVED = (
    ("granite-moe-1b-a400m", None, 8),
    ("qwen3-32b", 8, 8),
    ("phi3.5-moe-42b-a6.6b", 4, 8),
    ("zamba2-7b", None, 4),
    ("xlstm-1.3b", None, 4),
    ("nemotron-4-15b", 8, 8),
    ("qwen1.5-110b", 4, 8),
    ("llama3-405b", 2, 2),
)
# packed rounds, server/fp32, T 4, 2 x 128 tokens a group: (arch, layers,
# G, opt, lr, rounds). The packed round refuses a (G, N) buffer past the
# int32 index space (2**31 - 1 elements) as the reference's does, which
# sets each depth: G * N stays under it.
FAMILY_TRAIN = (
    ("granite-moe-1b-a400m", 9, 4, "sgd", 0.05, 2),
    ("granite-moe-1b-a400m", 9, 4, "momentum", 0.05, 2),
    ("granite-moe-1b-a400m", 19, 2, "adamw", 1e-3, 2),
    ("zamba2-7b", 10, 2, "sgd", 0.05, 1),
    ("xlstm-1.3b", 12, 2, "sgd", 0.05, 1),
)
PARITY_REQUESTS = 2          # replayed under the static policy and alone
LOSS_NEAR_LN_V = 1.5         # |loss at init - ln(padded vocab)|
BF16_OPS_PER_S = 989e12      # H100 SXM data sheet, bf16 tensor cores, dense
FAMILY_PATH = ("fused_sgd", "fused_momentum", "fused_adamw",
               "sq_norm_groups", "flash_attention", "paged_decode_attention")


def _family_cfg(arch, layers=None, **changes):
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if layers is not None:
        changes["n_layers"] = layers
    return dataclasses.replace(cfg, **changes)


def family_kernel_holds(torch):
    """Flash (bf16 prefill at the 1024 bucket) and paged decode (bf16 q
    over the f32 pool) against their plain versions at each family
    model's geometry, and their times beside their bounds (and SDPA's,
    for flash). Returns the max abs errors by kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {"flash_attention": 0.0, "paged_decode_attention": 0.0}
    seen_flash, seen_decode = set(), set()
    for arch, _, _ in FAMILY_SERVED:
        cfg = _family_cfg(arch)
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.family in ("dense", "moe") and (H, KV, hd) not in seen_flash:
            seen_flash.add((H, KV, hd))
            S = FAMILY_SERVE["max_prompt"]
            q = torch.randn((1, H, S, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((1, KV, S, hd), generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(2))
            tag = f"flash_attention {arch} (1, {H}, {KV}, {S}, {hd}) bf16"
            got = fa.flash_attention(q, k, v, impl="cuda")
            e1 = compare(tag + " (plain, bf16 p)", got.float(),
                         fa.flash_attention(q, k, v, impl="torch").float(),
                         **BF16_REF)
            f32 = fa.flash_attention(q.float(), k.float(), v.float(),
                                     impl="torch").to(torch.bfloat16)
            e2 = compare(tag + " (float32 plain)", got.float(), f32.float(),
                         **BF16_STEP)
            errs["flash_attention"] = max(errs["flash_attention"], e2)
            kr, vr = (k.repeat_interleave(H // KV, 1),
                      v.repeat_interleave(H // KV, 1))
            t = call_and_device_ms(
                torch, lambda: fa.flash_attention(q, k, v, impl="cuda"),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True))
            nbytes = (2 * H + 2 * KV) * S * hd * 2
            b_ms, b_by = bound_of(nbytes, 4 * hd * S * (S + 1) // 2 * H,
                                  BF16_OPS_PER_S)
            log(f"{tag}: max abs err {e1:.3e} against the plain version, "
                f"{e2:.3e} against the float32 plain version; kernel_ms "
                f"{t['ms']:.4f} (device {t['device_ms']:.4f}) bound_ms "
                f"{b_ms:.4f} ({b_by}: bf16 at {BF16_OPS_PER_S / 1e12:.0f} "
                f"TFLOP/s) library_ms {t['library_ms']:.4f} (device "
                f"{t['library_device_ms']:.4f}; sdpa causal, bf16)")
            del q, k, v, kr, vr, got, f32
        if cfg.family == "ssm":
            continue
        g = H // KV
        if (KV, g, hd, cfg.family) in seen_decode:
            continue
        seen_decode.add((KV, g, hd, cfg.family))
        kw_serve = RECURRENT_SERVE if cfg.family == "hybrid" else FAMILY_SERVE
        lo, hi = (RECURRENT_LOAD if cfg.family == "hybrid"
                  else FAMILY_LOAD)["prompt_len"]
        max_len = kw_serve["max_prompt"] + kw_serve["max_new"]
        nblk = -(-max_len // 16)
        lens = torch.randint(lo + 1, max_len + 1, (8,), generator=torch.
                             Generator().manual_seed(0)).tolist()
        kw = dict(B=8, n_kv=KV, g=g, hd=hd, ps=16, nblk=nblk)
        q, pool, rk, rv, ln = _decode_case(torch, gen, **kw, lengths=lens)
        qb = q.to(torch.bfloat16)
        ak = dict(page_size=16, n_kv=KV)

        def run(impl="cuda"):
            return da.paged_decode_attention(qb, pool, rk, rv, ln, impl=impl,
                                             **ak)
        got = run()
        want = da.paged_decode_attention(qb.float(), pool, rk, rv, ln,
                                         impl="torch", **ak)
        err = compare(f"paged_decode_attention {arch} {kw} bf16 q", got.float(),
                      want.to(torch.bfloat16).float(), **BF16_STEP)
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"],
                                             err)
        b_ms, b_by = _decode_bound(q, KV, ln, nblk)
        log(f"paged_decode_attention {arch} {kw} bf16 q, lengths {lens}: "
            f"max abs err {err:.3e} (BF16_STEP); kernel_ms "
            f"{time_ms(run, torch):.4f} (device "
            f"{time_ms(run, torch, device_only=True):.4f}) bound_ms "
            f"{b_ms:.4f} ({b_by}) plain_ms "
            f"{time_ms(lambda: run('torch'), torch):.4f}")
        del q, qb, pool, got, want
    torch.cuda.empty_cache()
    return errs


def hold_updates(torch, K, shape, opts):
    """The update kernels ``opts`` and ``sq_norm_groups`` against their
    plain versions at a family round's (G, N) buffer (random values, all
    rows active): sgd bit-equal, momentum and adamw within ``EW_TOL`` (the
    plain version taken slice by slice of the columns: it is elementwise,
    and the whole buffer three times over would not fit beside the
    kernel's), the norm within ``NORM_RTOL``. Returns the errors."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows, n = shape
    errs = {}
    p = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda")
    step = 1 << 27

    def sliced(name, outs, plain):
        err = 0.0
        for a in range(0, n, step):
            want = plain(slice(a, a + step))
            for label, k, w in zip("pmv", outs, want):
                err = max(err, compare(f"{name} {label} {shape}",
                                       k[:, a:a + step], w, **EW_TOL))
        return err

    if "sgd" in opts:
        kp, wp = p.clone(), p.clone()
        K.fused_sgd.fused_sgd(kp, g, lr=0.05, impl="cuda")
        K.fused_sgd.fused_sgd(wp, g, lr=0.05, impl="torch")
        if not torch.equal(kp, wp):
            fail(f"fused_sgd {shape}: differs from the plain version")
        errs["fused_sgd"] = 0.0
        del kp, wp
    if "momentum" in opts:
        m = torch.randn(shape, generator=gen, device="cuda") * 0.1
        kp, km = p.clone(), m.clone()
        K.fused_momentum.fused_momentum(kp, g, km, lr=0.05, beta=0.9,
                                        impl="cuda")
        errs["fused_momentum"] = sliced(
            "fused_momentum", (kp, km), lambda s: ref.momentum_ref(
                p[:, s], g[:, s], m[:, s], lr=0.05, beta=0.9))
        del m, kp, km
    if "adamw" in opts:
        m = torch.randn(shape, generator=gen, device="cuda") * 0.1
        v = torch.rand(shape, generator=gen, device="cuda") * 0.01
        count = torch.arange(1, rows + 1, device="cuda") * 3
        kp, km, kv = p.clone(), m.clone(), v.clone()
        K.fused_adamw.fused_adamw(kp, g, km, kv, count, lr=1e-3, wd=0.01,
                                  impl="cuda")
        bc = ref.adamw_bias_correction(count)
        errs["fused_adamw"] = sliced(
            "fused_adamw", (kp, km, kv), lambda s: ref.adamw_ref(
                p[:, s], g[:, s], m[:, s], v[:, s], bc, lr=1e-3, wd=0.01))
        del m, v, kp, km, kv
    errs["sq_norm_groups"] = compare(
        f"sq_norm_groups {shape}", K.sq_norm.sq_norm_groups(p, impl="cuda"),
        ref.sq_norm_groups_ref(p), rtol=NORM_RTOL, atol=0.0)
    log(f"update kernels {sorted(errs)} agree with their plain versions at "
        f"{shape}: {errs}")
    del p, g
    torch.cuda.empty_cache()
    return errs


def family_round(torch, K, arch, layers, G, opt, lr, rounds, ckpt=None,
                 profile=False):
    """A family model's packed local-SGD round at full width (server/fp32,
    T 4, 2 x 128 tokens a group): the launches of each round, finite
    losses near ln(vocab) at init, fenced seconds and peak memory. With
    ``ckpt`` the server params are saved there and returned (on the
    host); with ``profile`` one more round runs under torch.profiler."""
    from repro_torch import comm, optim
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import localsgd as lsgd
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models.api import build_model
    from repro_torch.optim import packing

    T = 4
    cfg = _family_cfg(arch, layers)
    tag = f"family train {arch} {layers} layers G {G} {opt}"
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, schedule="rect")
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    layout = packing.layout_of(params)
    optimizer = optim.get(opt, lr, packed=True, impl="auto")
    exchange = comm.get_exchange("server", "fp32", G)
    rnd = lsgd.make_local_round(
        model.loss, optimizer, lsgd.LocalSGDConfig(n_groups=G, inner_steps=T),
        layout=layout, exchange=exchange)
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (G, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    ln_v = float(torch.log(torch.tensor(float(cfg.padded_vocab))))
    with torch.no_grad():
        loss0 = model.loss(params, {"tokens": batch["tokens"][0]}).item()
    if not abs(loss0 - ln_v) <= LOSS_NEAR_LN_V:
        fail(f"{tag}: the loss at init {loss0:.4f} is not near ln(padded "
             f"vocab) = {ln_v:.4f}")
    state = lsgd.init_state(params, optimizer, G, layout, exchange=exchange)
    del params
    mods = {"fused_sgd": K.fused_sgd, "fused_momentum": K.fused_momentum,
            "fused_adamw": K.fused_adamw, "sq_norm_groups": K.sq_norm}
    for n in range(rounds):
        before = {k: m.launches for k, m in mods.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = rnd(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: mod.launches - before[k] for k, mod in mods.items()}
        want = dict.fromkeys(mods, 0)
        want[f"fused_{opt}"], want["sq_norm_groups"] = T, 2
        if got != want:
            fail(f"{tag} round {n}: launches {got}, expected {want}")
        loss = m["loss"]
        if loss.shape != (G,) or not bool(torch.isfinite(loss).all()) or \
                not bool(torch.isfinite(state["params"]).all()):
            fail(f"{tag} round {n}: loss {loss.tolist()} or params not "
                 "finite")
        log(f"{tag} round {n}: {sec:.4f} s fenced, loss "
            f"{[round(x, 4) for x in loss.tolist()]} (at init {loss0:.4f}, "
            f"ln padded vocab {ln_v:.4f}), gsq {m['grad_sq'].mean().item():.4e}, N "
            f"{layout.size:,}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    server = None
    if ckpt:
        tree = lsgd.server_params(state, layout)
        ckpt_io.save(ckpt, tree, metadata={"arch": cfg.name, "mode":
                                           "localsgd", "rounds": rounds})
        server = {k: v.cpu() for k, v in zip(*_flat(tree))}
        log(f"{tag}: server params -> {ckpt}.npz")
    if profile:
        t = time.perf_counter()
        _profiled(torch, f"{tag} round", lambda: rnd(state, batch), cpu=False)
        log(f"{tag}: the profiled round took {time.perf_counter() - t:.1f} s "
            "with the profiler's gathering")
    del state, rnd, model
    torch.cuda.empty_cache()
    return server, (G, layout.size)


def _counted_engine(torch, model, params, ecfg, tally):
    """An Engine whose step and prefill calls are tallied (steps,
    prefills, prefill tokens), for the expected kernel launches."""
    from repro_torch.serve import Engine, EngineConfig
    eng = Engine(model, params, EngineConfig(**ecfg))
    tally["bucket"] = eng.bucket
    step, prefill = eng.progs.step, eng.progs.prefill

    def counted_step(*a, **kw):
        tally["steps"] += 1
        return step(*a, **kw)

    def counted_prefill(params, pool, toks, length, *a, **kw):
        tally["prefills"] += 1
        tally["prefill_tokens"] += int(length)
        return prefill(params, pool, toks, length, *a, **kw)

    eng.progs = dataclasses.replace(eng.progs, step=counted_step,
                                    prefill=counted_prefill)
    return eng


def family_serve(torch, cfg, params, n_req, tmp, tally, profile=False):
    """One family model through the engine at full width: the workload
    under the continuous policy (fenced decode-step and prefill ms,
    committed tok/s, peak memory), then the ``PARITY_REQUESTS`` with the
    shortest prompts under the static policy and alone, whose tokens must
    equal the continuous run's integer for integer."""
    from repro_torch.models.api import build_model
    from repro_torch.obs.trace import Trace
    from repro_torch.serve import Request, drive_workload, poisson_workload

    recurrent = cfg.family in ("hybrid", "ssm")
    ecfg = RECURRENT_SERVE if recurrent else FAMILY_SERVE
    load = RECURRENT_LOAD if recurrent else FAMILY_LOAD
    model = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    reqs = poisson_workload(n=n_req, vocab=cfg.vocab_size, **load)

    def fresh(rs):
        return [Request(r.rid, r.prompt.copy(), r.max_new, r.arrival)
                for r in rs]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = _counted_engine(torch, model, params, ecfg, tally)
    path = os.path.join(tmp, f"{cfg.name}.jsonl")
    eng.trace = Trace(path, meta={"launcher": "chip_smoke", "arch": cfg.name})
    t0 = time.perf_counter()
    done, makespan = drive_workload(eng, fresh(reqs))
    wall = time.perf_counter() - t0
    eng.trace.close()
    steps = [s for s in map(json.loads, open(path)) if s["kind"] == "step"]
    decode = [s["phase_s"]["decode_step"] for s in steps
              if "decode_step" in s["phase_s"]]
    prefill = [s["phase_s"]["prefill"] / s["metrics"]["admitted"]
               for s in steps if s["metrics"]["admitted"]]
    cont = {c.rid: c.tokens for c in done}
    for r in reqs:
        toks = cont.get(r.rid)
        if toks is None or len(toks) != min(r.max_new, ecfg["max_new"]) or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{cfg.name} rid {r.rid}: tokens {toks}")
    committed = sum(len(t) for t in cont.values())
    log(f"family serve {cfg.name} ({cfg.n_layers} layers, {cfg.family}): "
        f"{len(done)} requests, {committed} tokens in {makespan:.4f} s "
        f"virtual ({committed / makespan:.1f} tok/s committed; {wall:.2f} s "
        f"wall), decode step ms median {statistics.median(decode) * 1e3:.3f} "
        f"over {len(decode)} steps, prefill ms median "
        f"{statistics.median(prefill) * 1e3:.3f} (bucket {eng.bucket}), peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del eng
    # the shortest prompts: the recurrent prefill runs token by token
    first = sorted(reqs, key=lambda r: len(r.prompt))[:PARITY_REQUESTS]
    stat = _counted_engine(torch, model, params, dict(ecfg, policy="static"),
                           tally)
    sdone, _ = drive_workload(stat, fresh(first))
    iso = _counted_engine(torch, model, params, ecfg, tally)
    bad = [c.rid for c in sdone if c.tokens != cont[c.rid]]
    bad += [r.rid for r in fresh(first) if iso.run([r])[0].tokens
            != cont[r.rid]]
    if len(sdone) != len(first) or bad:
        fail(f"{cfg.name}: static or isolated tokens differ for rids {bad}")
    log(f"family serve {cfg.name}: {len(first)} requests' tokens equal "
        "under the continuous and static policies and replayed alone")
    del stat, iso
    if profile:
        profile_decode_steps(torch, _counted_engine(
            torch, model, params, ecfg, tally), fresh(reqs))
    torch.cuda.empty_cache()


def _expected_attention(cfg, tally):
    """The attention launches a family model's engines make: dense and
    moe one flash launch a layer a prefill where the bucket holds two
    512-blocks (the model's blocked branch) and one decode launch a layer
    a step; hybrid one decode launch per shared attention use per step
    and per prompt token; ssm none."""
    if cfg.family in ("dense", "moe"):
        flash = tally["bucket"] % 512 == 0 and tally["bucket"] >= 1024
        return {"flash_attention": cfg.n_layers * tally["prefills"] * flash,
                "paged_decode_attention": cfg.n_layers * tally["steps"]}
    if cfg.family == "hybrid":
        uses = cfg.n_layers // cfg.attn_every
        return {"flash_attention": 0, "paged_decode_attention": uses * (
            tally["steps"] + tally["prefill_tokens"])}
    return {"flash_attention": 0, "paged_decode_attention": 0}


def family_path(torch, K, tmp):
    """Phase 13's counted path: the packed rounds of FAMILY_TRAIN (the
    granite-moe adamw run's server params checkpointed, restored through
    ``serve.handoff`` bit for bit and served), then every FAMILY_SERVED
    model through the engine. Returns the launch counts of the path."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model

    _zero_all_counts(K)
    shapes = {}
    for i, (arch, layers, G, opt, lr, rounds) in enumerate(FAMILY_TRAIN):
        t = time.perf_counter()
        ckpt = os.path.join(tmp, "granite") if opt == "adamw" else None
        server, shape = family_round(torch, K, arch, layers, G, opt, lr,
                                     rounds, ckpt=ckpt, profile=i == 0)
        _freed(torch, f"train {arch} {opt}")
        shapes.setdefault(shape, set()).add(opt)
        log(f"phase 13 train {arch} {opt}: {time.perf_counter() - t:.1f} s")
        if ckpt:
            _serve_trained(torch, arch, layers, ckpt, server, tmp)
            del server
            _freed(torch, f"serve the trained {arch}")
    for arch, layers, n_req in FAMILY_SERVED:
        t = time.perf_counter()
        cfg = _family_cfg(arch, layers)
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        tally = dict(steps=0, prefills=0, prefill_tokens=0)
        before = (fa.launches, da.launches)
        family_serve(torch, cfg, params, n_req, tmp, tally,
                     profile=arch == "qwen3-32b")
        _check_attention(cfg, tally, before, fa, da)
        del params, model
        _freed(torch, f"serve {arch}")
        log(f"phase 13 serve {arch}: {time.perf_counter() - t:.1f} s")
    counts = _all_counts(K)
    log(f"phase 13 launches {counts}")
    off = {k: v for k, v in counts.items() if k not in FAMILY_PATH and v}
    if off:
        fail(f"phase 13 launched kernels off its path: {off} (the models' "
             "mamba stays plain, as in the reference)")
    missing = [k for k in FAMILY_PATH if not counts[k]]
    if missing:
        fail(f"phase 13 never launched {missing}")
    return {k: counts[k] for k in FAMILY_PATH}, shapes


def _serve_trained(torch, arch, layers, ckpt, server, tmp):
    """The trained checkpoint through ``serve.handoff``: the restored
    params equal the round's server params bit for bit, and serve."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model
    from repro_torch.serve import restore_params

    cfg = _family_cfg(arch, layers)
    model = build_model(dataclasses.replace(cfg, attn_impl="pallas"))
    params = restore_params(ckpt, model, device="cuda")
    keys, leaves = _flat(params)
    if keys != list(server) or not all(
            torch.equal(a.cpu(), server[k]) for k, a in zip(keys, leaves)):
        fail(f"{arch}: the served params differ from the round's server "
             "params")
    log(f"{arch} {layers} layers: the checkpoint restores through "
        "serve.handoff equal to the round's server params bit for bit")
    tally = dict(steps=0, prefills=0, prefill_tokens=0)
    before = (fa.launches, da.launches)
    family_serve(torch, cfg, params, PARITY_REQUESTS, tmp, tally)
    _check_attention(cfg, tally, before, fa, da)


def _freed(torch, what, base=0.0):
    """Each model is freed before the next is built: nothing of it may
    stay allocated on the card (reference cycles collected first); at
    most 1 GiB above ``base`` GiB."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30 - base
    if held > 1.0:
        live = sorted((o for o in gc.get_objects()
                       if type(o) is torch.Tensor and o.is_cuda),
                      key=lambda o: -o.numel())[:8]
        fail(f"{what}: {held:.2f} GiB still allocated after it was freed; "
             f"the largest live tensors {[tuple(o.shape) for o in live]}")
    log(f"{what}: freed ({held:.2f} GiB allocated)")


def _check_attention(cfg, tally, before, fa, da):
    got = {"flash_attention": fa.launches - before[0],
           "paged_decode_attention": da.launches - before[1]}
    want = _expected_attention(cfg, tally)
    if got != want:
        fail(f"{cfg.name}: attention launches {got}, expected {want} "
             f"({tally})")
    log(f"{cfg.name}: attention launches {got} ({tally})")


def phase13(torch, K):
    """Phase 13: the engine's other model families at full width. Returns
    the path's launches, as ``family_launches``."""
    t0 = time.perf_counter()
    errs = family_kernel_holds(torch)
    log(f"phase 13 kernel holds: {time.perf_counter() - t0:.1f} s, {errs}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p13_") as tmp:
        counts, shapes = family_path(torch, K, tmp)
    t = time.perf_counter()
    for shape, opts in shapes.items():
        hold_updates(torch, K, shape, opts)
    log(f"phase 13 update holds: {time.perf_counter() - t:.1f} s")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return {"family_launches": counts}, errs


# ---------------------------------------------------------------------------
# Phase 14: the pytree round's exchange at full width
# ---------------------------------------------------------------------------
# phase 14's runs (paper-lenet, seed 0, T 4, 2 x 128 tokens a group, 2
# rounds each, fault seed 1, through build_run): each exchange on the
# pytree round and on the packed round, from the same params and batches.
# "codec_mix": the packed round's fused streams a round (a width codec on
# server, ring or gossip over a reliable network); the pytree round fuses
# none, as the reference's does not
TREE_PLAN = [
    dict(opt="sgd", lr=0.05, comm="server", codec="bf16", codec_mix=1),
    dict(opt="sgd", lr=0.05, comm="ring", codec="fp16", mix_rounds=2,
         codec_mix=1),
    dict(opt="momentum", lr=0.05, groups=8, comm="gossip", codec="bf16",
         codec_mix=1),
    dict(opt="sgd", lr=0.05, comm="server", downlink_codec="bf16"),
    dict(opt="adamw", lr=1e-3, comm="server", moment_codec="bf16",
         codec_mix=2),
    dict(opt="adamw", lr=1e-3, comm="async_stale", staleness=1),
    dict(opt="sgd", lr=0.05, comm="server", drop_rate=0.1),
    dict(opt="sgd", lr=0.05, comm="ring", drop_rate=0.1),
    dict(opt="sgd", lr=0.05, comm="push_sum", drop_rate=0.1),
    dict(opt="sgd", lr=0.05, groups=8, comm="hierarchical", n_pods=4,
         drop_rate=0.075),
]
TREE_FLAGS = ("comm", "codec", "moment_codec", "downlink_codec",
              "mix_rounds", "staleness", "drop_rate", "n_pods")
TREE_ARCH = "paper-lenet"
# one step of each cast codec relative to the values it casts
CODEC_STEP = {"fp16": 2.0 ** -10, "bf16": 2.0 ** -7}


def _tree_exchange_run(torch, K, run, packed):
    """One TREE_PLAN run on the pytree (or packed) round, 2 rounds: the
    final state, each round's (participation, round counter, wire bytes,
    fenced s), the launches over the run and the peak memory (GiB).
    push-sum's mass is held every round."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.train import build_run

    G = run.get("groups", 4)
    flags = {k: run[k] for k in TREE_FLAGS if k in run}
    mode = "packed" if packed else "pytree"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, _, layout, rnd, state, _, _, ex = build_run(
        TREE_ARCH, groups=G, t_inner=4, opt=run["opt"], lr=run["lr"],
        packed=packed, seed=0, device="cuda", fault_seed=1, **flags)
    tokens = next(TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (G, 2)))["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device="cuda")}
    before = _all_counts(K)
    rounds = []
    for n in range(2):
        (state, m), sec = _timed(torch, lambda: rnd(state, batch))
        cst = state.get("comm", {})
        if "mass" in cst:
            mass = float(cst["mass"].sum() + cst["backlog_w"].sum())
            if abs(mass - G) > 1e-3:
                fail(f"tree exchange {ex.name} ({mode}) round {n}: "
                     f"sum(mass) + sum(backlog_w) = {mass!r}, not {G} "
                     "within 1e-3")
        if not bool(torch.isfinite(m["loss"]).all()):
            fail(f"tree exchange {ex.name} ({mode}) round {n}: loss "
                 f"{m['loss'].tolist()}")
        rounds.append((float(m["participation"]),
                       int(cst["round"]) if "round" in cst else None,
                       int(m["wire_bytes"]), sec))
    got = {k: v - before[k] for k, v in _all_counts(K).items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del rnd
    return state, rounds, got, peak, ex, layout


def tree_exchange_path(torch, K):
    """Phase 14, part 1: each TREE_PLAN exchange on the pytree round
    against the packed round at full width. Holds: the pytree runs launch
    no kernel; the packed runs launch their update kernel T times, the
    norm twice and codec_mix once per fused stream a round; participation,
    round counters and wire bytes equal every round; with a cast codec
    the params of every group within one step of the codec at each leaf's
    magnitude (at least 1e-6), else the server params within 1e-6; adamw's
    server params within 1e-5 on all but 1e-6 of the elements, every one
    within 0.25 lr. Returns the pytree runs' and the packed runs'
    launches."""
    from repro_torch import tree

    tree_total = dict.fromkeys(_all_counts(K), 0)
    packed_total = dict(tree_total)
    for run in TREE_PLAN:
        opt, G = run["opt"], run.get("groups", 4)
        tst, trounds, tgot, tpeak, ex, _ = _tree_exchange_run(
            torch, K, run, packed=False)
        if any(tgot.values()):
            fail(f"tree exchange {ex.name}: the pytree round launched "
                 f"{ {k: v for k, v in tgot.items() if v} }")
        tparams = tst["params"]
        topt = {k: v for k, v in tst["opt"].items() if k != "count"}
        del tst
        pst, prounds, pgot, ppeak, _, layout = _tree_exchange_run(
            torch, K, run, packed=True)
        want = dict.fromkeys(pgot, 0)
        want[f"fused_{opt}"] = 4 * 2
        want["sq_norm_groups"] = 2 * 2
        want["codec_mix"] = run.get("codec_mix", 0) * 2
        if pgot != want:
            fail(f"tree exchange {ex.name}: the packed round launched "
                 f"{pgot}, expected {want}")
        for k in tree_total:
            tree_total[k] += tgot[k]
            packed_total[k] += pgot[k]
        for n, (t, p) in enumerate(zip(trounds, prounds)):
            if t[:3] != p[:3]:
                fail(f"tree exchange {ex.name} round {n}: pytree "
                     f"(participation, round, wire) {t[:3]} != packed "
                     f"{p[:3]}")
        cast = next((CODEC_STEP[run[k]] for k in ("codec", "moment_codec",
                                                  "downlink_codec")
                     if run.get(k) in CODEC_STEP), None)
        # fp32 streams: phase 11's bar on the server params. adamw: the
        # reference's pytree adamw squares g before scaling it, (1 - b2)
        # * square(g), its kernel scales first, (1 - b2) * g * g, so v
        # differs in the last bit between the two rounds, and adamw
        # carries that into the steps of weights whose |g| is near eps at
        # a fraction of lr each step (phase 4's rule; PERF.md §6, PR 22):
        # its server params within 1e-5 on all but 1e-6 of the elements,
        # every one within 0.25 lr. A cast codec: one step at each leaf's
        # magnitude, every group
        srv_bar = (1e-5 if opt == "adamw" else
                   1e-6 if cast is None else None)
        off_bar = 0.25 * run["lr"] if opt == "adamw" else srv_bar
        row_err = srv_err = worst = 0.0
        n_off = 0
        mom_err = dict.fromkeys(topt, 0.0)
        for i, leaf in enumerate(tree.leaves(tparams)):
            sl = slice(layout.offsets[i], layout.offsets[i] + layout.sizes[i])
            a, b = leaf.reshape(G, -1), pst["params"][:, sl]
            err = float((a - b).abs().max())
            row_err = max(row_err, err)
            d = (a.mean(0) - b.mean(0)).abs()
            srv_err = max(srv_err, float(d.max()))
            if srv_bar is not None:
                n_off += int((d > srv_bar).sum())
            del d
            if cast is not None:
                bar = max(cast * float(b.abs().max()), 1e-6)
                worst = max(worst, err / bar)
            for k, v in topt.items():
                mom_err[k] = max(mom_err[k], float(
                    (tree.leaves(v)[i].reshape(G, -1)
                     - pst["opt"][k][:, sl]).abs().max()))
        log(f"tree exchange {ex.name} {opt} G {G}: fenced s a round pytree "
            + ", ".join(f"{r[3]:.4f}" for r in trounds) + " / packed "
            + ", ".join(f"{r[3]:.4f}" for r in prounds)
            + f"; peak {tpeak:.2f} / {ppeak:.2f} GiB; participation "
            f"{[r[0] for r in trounds]}, wire {trounds[0][2]:,} B; params "
            f"max abs diff every group {row_err:.3e}"
            + (f" ({worst:.3f} of one codec step)" if cast else "")
            + f", server {srv_err:.3e} ({n_off} past {srv_bar}); moments "
            + ", ".join(f"{k} {v:.3e}" for k, v in mom_err.items()))
        n_ok = layout.size * 1e-6 if opt == "adamw" else 0
        if srv_bar is not None and (srv_err > off_bar or n_off > n_ok):
            fail(f"tree exchange {ex.name}: server params differ from the "
                 f"packed round's by up to {srv_err:.3e}, {n_off} past "
                 f"{srv_bar:g} (bars: {off_bar:g}, {n_ok:g} elements)")
        if worst > 1.0:
            fail(f"tree exchange {ex.name}: params differ from the packed "
                 f"round's by {worst:.3f} codec steps at their magnitude")
        del tparams, topt, pst
    log(f"tree exchange launches: pytree {tree_total}, packed "
        f"{packed_total}")
    return tree_total, packed_total


def tree_launcher_run(torch):
    """Phase 14, part 2: the train launcher without --packed on the card
    (paper-lenet, push_sum at drop 0.1, 2 rounds): exit 0, two round
    lines with their participation, the pytree round."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TREE_ARCH, "--rounds", "2", "--comm", "push_sum", "--drop-rate",
           "0.1"]
    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    for line in out.stdout.splitlines():
        log(f"launcher pytree push_sum: {line}")
    if out.returncode != 0:
        fail(f"launcher {cmd[3:]} exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    rounds = [l for l in out.stdout.splitlines() if l.startswith("round ")]
    if len(rounds) != 2 or not all(" part " in l for l in rounds) or (
            "mode=localsgd pytree" not in out.stdout):
        fail(f"launcher pytree push_sum: round lines {rounds}")


def phase14(torch, K):
    """Phase 14: the pytree round's exchange at full width. Returns the
    pytree runs' launches (``tree_exchange_launches``, all 0) and the
    packed comparison runs' (``tree_exchange_packed_launches``)."""
    t0 = time.perf_counter()
    _zero_all_counts(K)
    tree_counts, packed_counts = tree_exchange_path(torch, K)
    log(f"phase 14 pytree vs packed: {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    tree_launcher_run(torch)
    log(f"phase 14 launcher: {time.perf_counter() - t:.1f} s")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return {"tree_exchange_launches": tree_counts,
            "tree_exchange_packed_launches": packed_counts}


# ---------------------------------------------------------------------------
# Phase 15: round telemetry (fenced traces, the exchange-time split,
# --profile, the online T controller)
# ---------------------------------------------------------------------------
# the OnlineT headline of benchmarks/overlap.py (online_t_section,
# :249-296; _quad_problem, :174-181, whose draws _feasibility repeats;
# WIRE_BAR, :68): G 4, r 8, d 40, server/fp32, packed sgd at lr 0.3, a
# T-8 probe for the static T*, OnlineT(r=1, t_min=1, t_max=256) fed the
# simulated times local_s = r * T, exchange_s = 1
ONLINE_T = dict(G=4, rows=8, D=40, lr=0.3, probe_t=8, r_cost=1.0,
                floor=1e-3, max_rounds=600, wire_bar=1.0)
# BENCH_overlap.json's online_t: the reference's own figures (CPU; round
# counts and bytes, not times)
ONLINE_T_REF = dict(static_rounds=419, online_rounds=37, ratio=11.32)
TELEMETRY_ARCH = "paper-lenet"
TELEMETRY_SMALL = "paper-mlp"
ONLINE_T_MAX = 16            # the launcher's --t-max for the online run


def online_t_headline(torch, device, floor=ONLINE_T["floor"],
                      max_rounds=ONLINE_T["max_rounds"]):
    """The reference's ``online_t_section`` on the port: static T* (the
    Sec-4 fit of a T-8 probe round's decay, frozen) against ``OnlineT``
    on the same problem and exchange, each run until the group-mean
    grad_sq reaches ``floor``. Rounds are built once per distinct T, as
    the launcher rebuilds on a T change. Returns the reference's keys."""
    import numpy as np

    from repro_torch import bridge, comm, optim
    from repro_torch.core import controller, localsgd as lsgd, theory
    from repro_torch.optim import packing

    c = ONLINE_T
    G, r_cost = c["G"], c["r_cost"]
    params, batch = _feasibility(np, G, c["D"], rows=c["rows"])
    p = bridge.params_from_numpy(params, device)
    b = bridge.params_from_numpy(batch, device)
    layout = packing.layout_of(p)
    ex = comm.get_exchange("server", "fp32", G)
    opt = optim.packed("sgd", c["lr"])

    def build(t):
        return lsgd.make_local_round(_quad_loss, opt, lsgd.LocalSGDConfig(
            n_groups=G, inner_steps=t, metrics="traj"), layout=layout,
            exchange=ex)

    _, m0 = build(c["probe_t"])(lsgd.init_state(p, opt, G, layout,
                                                exchange=ex), b)
    fit = theory.fit_decay(m0["grad_sq_traj"][0].cpu().numpy())
    t_static = max(1, int(round(theory.t_star_from_fit(fit, r_cost))))

    def run_to_floor(make_t, on_round=None):
        st = lsgd.init_state(p, opt, G, layout, exchange=ex)
        cache, n, gsq, t_total = {}, 0, float("inf"), 0
        wire_round = ex.wire_bytes_per_round(layout.padded)
        while n < max_rounds and gsq > floor:
            t_cur = int(make_t())
            if t_cur not in cache:
                cache[t_cur] = build(t_cur)
            st, m = cache[t_cur](st, b)
            n += 1
            t_total += t_cur
            gsq = float(m["grad_sq"].mean())
            if on_round is not None:
                on_round(m, t_cur)
        return {"rounds": n, "local_steps": t_total,
                "wire_bytes_total": wire_round * n, "gsq_final": gsq,
                "reached_floor": gsq <= floor, "distinct_t": sorted(cache)}

    static = run_to_floor(lambda: t_static)
    ctl = controller.OnlineT(r=r_cost, t_min=1, t_max=256)
    state = {"t": t_static}

    def on_round(m, t_used):
        codec_err = sum(float(v.mean()) for k, v in m.items()
                        if k.startswith("codec_err/"))
        state["t"] = ctl.update(
            m["grad_sq_traj"][0].cpu().numpy(), t_used=t_used,
            local_s=r_cost * t_used, exchange_s=1.0,
            consensus_pre=float(m["consensus_sq"].mean()),
            consensus_post=float(m["consensus_sq_post"].mean()),
            codec_err=codec_err)

    online = run_to_floor(lambda: state["t"], on_round)
    return {"floor": floor, "t_static": t_static, "static": static,
            "online": online,
            "controller_tail": ctl.history[-3:] if ctl.history else [],
            "wire_ratio_static_over_online":
                static["wire_bytes_total"]
                / max(online["wire_bytes_total"], 1)}


def counted_train_main(argv) -> int:
    """``python3 chip_smoke.py --counted-train <launcher flags>``: the train
    launcher's ``main`` in this (fresh) process, then every kernel's
    launches over the process as a last line ``launches {...}``."""
    sys.path.insert(0, SRC)
    from repro_torch import kernels as K
    from repro_torch.kernels import (decode_attention,  # noqa: F401
                                     exchange_epilogue, flash_attention,
                                     fused_adamw, fused_momentum, fused_sgd,
                                     mamba_scan, quantize, rmsnorm, sq_norm)
    from repro_torch.launch import train
    train.main(argv)
    print("launches " + json.dumps(_all_counts(K)))
    return 0


def _telemetry_start(name, args):
    """A --counted-train process of phase 15 (its output in pipes)."""
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
           "--counted-train"] + args
    log(f"telemetry {name}: train {' '.join(args)}")
    # unbuffered: a process killed at its limit leaves every line it printed
    return subprocess.Popen(cmd, cwd=ROOT, env=dict(
        os.environ, PYTHONPATH=SRC, PYTHONUNBUFFERED="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _telemetry_finish(name, proc, timeout):
    """Wait for a phase-15 process: its stdout lines (logged) and the
    launches it counted. Fails on a non-zero exit, and past ``timeout``
    seconds kills it and logs what it printed (the online run's T of
    each round before it runs) before failing."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        for line in out.splitlines():
            log(f"telemetry {name}: {line}")
        fail(f"telemetry {name}: no exit within {timeout} s: {err[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.splitlines()
    for line in lines:
        if not line.startswith("launches "):
            log(f"telemetry {name}: {line}")
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith("launches "):
        fail(f"telemetry {name} exited {proc.returncode}: {err[-3000:]}")
    return lines, json.loads(lines[-1][len("launches "):])


def _checked_trace(name, path):
    """The port's report.check on a launcher's trace (no problem allowed):
    (meta, records, summary)."""
    from repro_torch.obs import report
    meta, records = report.load(path)
    problems = report.check(meta, records)
    if problems:
        fail(f"telemetry {name}: {path} fails the check: {problems}")
    return meta, records, report.summarize(meta, records)


def _hold_launches(name, got, want):
    """Exact counts for the kernels in ``want``."""
    bad = {k: (got.get(k, 0), v) for k, v in want.items()
           if got.get(k, 0) != v}
    if bad:
        fail(f"telemetry {name}: launches (got, expected) {bad}; all {got}")


def telemetry_launcher_runs(torch, tmp):
    """Phase 15, parts (a)-(d): the train launcher with --trace, the
    calibrated split, --adaptive-t online, --mode sync, the pytree round
    and --profile, each in a fresh process. Returns the launches of all
    of them, summed."""
    total = {}

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    # (a) alone: its calibrated times are the part's measurement.
    # --mix-rounds stays 1: both packages refuse overlap with more hops
    lenet = ["--arch", TELEMETRY_ARCH, "--packed", "--groups", "4",
             "--t-inner", "4"]
    over = os.path.join(tmp, "overlap.jsonl")
    lines, got = _telemetry_finish("overlap", _telemetry_start(
        "overlap", lenet + ["--opt", "adamw", "--lr", "1e-3", "--comm",
                            "ring", "--codec", "int8", "--overlap",
                            "--rounds", "3", "--trace", over,
                            "--checkpoint", os.path.join(tmp, "ck")]), 300)
    meta, recs, summ = _checked_trace("overlap", over)
    rounds = [r for r in recs if r["kind"] == "round"]
    for r in rounds:
        ph = r["phase_s"]
        if not ph["exchange_exposed"] <= ph["exchange_total"]:
            fail(f"telemetry overlap round {r['round']}: exposed > total "
                 f"{ph}")
        log(f"telemetry overlap round {r['round']}: phases {ph}")
    log(f"telemetry overlap: {next(l for l in lines if 'fences' in l)}; "
        f"overlap efficiency {summ.get('overlap_efficiency')!r}; "
        f"records {[r['kind'] for r in recs]}")
    if len(rounds) != 3 or recs[-1]["kind"] != "checkpoint":
        fail(f"telemetry overlap: records {[r['kind'] for r in recs]}")
    # the run's 3 rounds and the calibration's 2 x 3 (comm none and the
    # barrier ring, each a warm-up and two timed), T 4 each; the overlap
    # encode's qdq_int8 once a run round
    _hold_launches("overlap", got, {"fused_adamw": 4 * 9, "qdq_int8": 3})
    add(got)

    # (b)-(d) at once
    online = os.path.join(tmp, "online.jsonl")
    sync = os.path.join(tmp, "sync.jsonl")
    tree = os.path.join(tmp, "pytree.jsonl")
    prof = os.path.join(tmp, "prof")
    small = ["--arch", TELEMETRY_SMALL]
    procs = {
        # lr 0.02 as phase 11's static controller run; rounds cut to 4 and
        # T to ONLINE_T_MAX: a round whose gradient norm ends above where
        # it began fits no decay, and the controller then asks for its cap
        # (10,000 steps, some 400-1000 s here, by default)
        "online": _telemetry_start("online", small + [
            "--packed", "--opt", "sgd", "--lr", "0.02", "--adaptive-t",
            "online", "--t-max", str(ONLINE_T_MAX), "--rounds", "4",
            "--trace", online]),
        "sync": _telemetry_start("sync", small + [
            "--packed", "--mode", "sync", "--rounds", "2", "--trace", sync,
            "--checkpoint", os.path.join(tmp, "ck_sync")]),
        "pytree": _telemetry_start("pytree", small + [
            "--comm", "push_sum", "--drop-rate", "0.1", "--rounds", "2",
            "--trace", tree]),
        "profile": _telemetry_start("profile", lenet + [
            "--opt", "adamw", "--lr", "1e-3", "--rounds", "1", "--profile",
            prof]),
    }
    try:
        res = {k: _telemetry_finish(k, p, 400) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()

    meta, recs, _ = _checked_trace("online", online)
    ts = [int(max(r["metrics"]["inner_steps"])) for r in recs]
    secs = [r["phase_s"]["round"] for r in recs]
    ctl_lines = [l for l in res["online"][0] if l.startswith("fences")]
    log(f"telemetry online: T {ts}, round s {secs}, {ctl_lines}")
    if len(ts) != 4 or ts[0] != 4 or max(ts) > ONLINE_T_MAX:
        fail(f"telemetry online: T {ts} (at most {ONLINE_T_MAX})")
    # calibration: 3 rounds of T 4 on comm none
    _hold_launches("online", res["online"][1],
                   {"fused_sgd": 12 + sum(ts)})

    meta, recs, _ = _checked_trace("sync", sync)
    kinds = [r["kind"] for r in recs]
    if kinds != ["step", "step", "checkpoint"]:
        fail(f"telemetry sync: records {kinds}")
    _hold_launches("sync", res["sync"][1], {"fused_sgd": 2,
                                            "sq_norm_groups": 2})

    meta, recs, _ = _checked_trace("pytree", tree)
    if any("exchange_total" in r["phase_s"] for r in recs):
        fail("telemetry pytree: an exchange split on the pytree round")
    _hold_launches("pytree", res["pytree"][1],
                   dict.fromkeys(res["pytree"][1], 0))

    files = [os.path.join(prof, f) for f in os.listdir(prof)
             if f.endswith(".json")] if os.path.isdir(prof) else []
    if len(files) != 1:
        fail(f"telemetry profile: Chrome traces {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    adamw = [e for e in kernels if "update_rows" in e.get("name", "")
             and "AdamW" in e.get("name", "")]
    log(f"telemetry profile: {os.path.getsize(files[0]):,} B, "
        f"{len(events)} events, {len(kernels)} kernel events, "
        f"{len(adamw)} fused_adamw ({adamw[0]['name'] if adamw else None})")
    if "round" not in names or not kernels or len(adamw) != 4:
        fail("telemetry profile: the trace lacks the round annotation or "
             "the kernel events (4 of fused_adamw)")
    _hold_launches("profile", res["profile"][1], {"fused_adamw": 4})
    for k in ("online", "sync", "pytree", "profile"):
        add(res[k][1])
    return total


def telemetry_headline(torch, K):
    """Phase 15, part (e): the OnlineT headline on the card with the
    kernels, its launches counted from 0 (fused_sgd T a round, the probe
    included, sq_norm_groups 2 + T a round with the trajectory). Holds:
    both runs reach the floor, static/online wire >= WIRE_BAR."""
    _zero_all_counts(K)
    t0 = time.perf_counter()
    h = online_t_headline(torch, "cuda")
    sec = time.perf_counter() - t0
    got = _all_counts(K)
    st, on = h["static"], h["online"]
    log(f"telemetry headline: T* {h['t_static']}, static {st['rounds']} "
        f"rounds ({st['local_steps']} steps, gsq {st['gsq_final']!r}), "
        f"online {on['rounds']} rounds ({on['local_steps']} steps, gsq "
        f"{on['gsq_final']!r}, T {on['distinct_t']}), wire ratio "
        f"{h['wire_ratio_static_over_online']!r} (the reference on the "
        f"CPU, BENCH_overlap.json: {ONLINE_T_REF}); {sec:.1f} s")
    if not (st["reached_floor"] and on["reached_floor"]) or \
            h["wire_ratio_static_over_online"] < ONLINE_T["wire_bar"]:
        fail(f"telemetry headline: {h}")
    rounds = st["rounds"] + on["rounds"] + 1
    steps = st["local_steps"] + on["local_steps"] + ONLINE_T["probe_t"]
    want = dict.fromkeys(got, 0)
    want.update(fused_sgd=steps, sq_norm_groups=2 * rounds + steps)
    if got != want:
        fail(f"telemetry headline launches {got}, expected {want}")
    return got


def phase15(torch, K):
    """Phase 15: round telemetry. Returns the launches of its runs (the
    launcher processes' and the headline's) as ``telemetry_launches``."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tel_") as tmp:
        counts = telemetry_launcher_runs(torch, tmp)
    log(f"phase 15 launchers: {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    for k, v in telemetry_headline(torch, K).items():
        counts[k] = counts.get(k, 0) + v
    log(f"phase 15 headline: {time.perf_counter() - t:.1f} s")
    log(f"phase 15: {time.perf_counter() - t0:.1f} s; launches {counts}")
    return {"telemetry_launches": counts}


# ---------------------------------------------------------------------------
# Phase 16: the vlm and audio families and the ring-cache decode
# ---------------------------------------------------------------------------

# packed rounds at the published widths through launch.train.build_run,
# server/fp32, T 4, seed 0: (arch, G, sequences a group, tokens a
# sequence). internvl2-1b has 630,741,760 params, so the packed round's
# 2**31 - 1 limit allows G <= 3 at full depth; whisper-base 97,562,112.
MODAL_VLM = ("internvl2-1b", 2, 2, 1024)
MODAL_AUDIO = ("whisper-base", 4, 2, 448)
MODAL_T = 4
MODAL_LR = {"sgd": 0.05, "adamw": 1e-3}
VLM_DECODE = dict(B=2, W=48, steps=64)     # positions pass the ring
AUDIO_DECODE = dict(B=4, steps=32)
RING_PREFILL = dict(arch="paper-lenet", S=1024, new=8)
NEXT_TOKEN = 5e-2            # tests/test_archs.py's log-softmax contract
VLM_FLASH = (2, 14, 2, 1024, 64)           # (B, H, KV, S, hd), bf16
MODAL_MEMORY = 0.8           # of the card, for phase 16's process


def _peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2**30


def _part_start(torch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def _part_end(torch, name, t0):
    torch.cuda.synchronize()
    log(f"phase 16 {name}: {time.perf_counter() - t0:.1f} s, peak memory "
        f"{_peak_gib(torch):.2f} GiB")


def vlm_flash_hold(torch):
    """Part (d): flash at internvl2-1b's prefill geometry, (2, 14, 2,
    1024, 64) bf16 (g = 7), against its plain versions at phase 7's bf16
    tolerances, timed (median of 20, the call's and the device's alone)
    beside SDPA and its bound."""
    from repro_torch.kernels import flash_attention as fa
    B, H, KV, S, hd = VLM_FLASH
    gen = torch.Generator(device="cuda").manual_seed(16)
    q = torch.randn((B, H, S, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, KV, S, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    tag = f"flash_attention internvl2-1b {VLM_FLASH} bf16"
    got = fa.flash_attention(q, k, v, impl="cuda")
    e1 = compare(tag + " (plain, bf16 p)", got.float(),
                 fa.flash_attention(q, k, v, impl="torch").float(), **BF16_REF)
    f32 = fa.flash_attention(q.float(), k.float(), v.float(),
                             impl="torch").to(torch.bfloat16)
    e2 = compare(tag + " (float32 plain)", got.float(), f32.float(),
                 **BF16_STEP)
    if not torch.equal(got, fa.flash_attention(q, k, v, impl="cuda")):
        fail(f"{tag}: differs on a rerun")
    kr, vr = (k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1))
    t = call_and_device_ms(
        torch, lambda: fa.flash_attention(q, k, v, impl="cuda"),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, is_causal=True))
    plain_ms = time_ms(lambda: fa.flash_attention(q, k, v, impl="torch"),
                       torch)
    nbytes = (2 * B * H + 2 * B * KV) * S * hd * 2
    b_ms, b_by = bound_of(nbytes, 4 * hd * S * (S + 1) // 2 * B * H,
                          BF16_OPS_PER_S)
    log(f"{tag}: max abs err {e1:.3e} against the plain version (BF16_REF), "
        f"{e2:.3e} against the float32 plain version (BF16_STEP); kernel_ms "
        f"{t['ms']:.4f} (device {t['device_ms']:.4f}) bound_ms {b_ms:.4f} "
        f"({b_by}: bf16 at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s) plain_ms "
        f"{plain_ms:.4f} library_ms {t['library_ms']:.4f} (device "
        f"{t['library_device_ms']:.4f}; sdpa causal, bf16)")
    del q, k, v, kr, vr, got, f32
    torch.cuda.empty_cache()


def _modal_batch(torch, cfg, G, per_group, seq):
    """Tokens (G, per_group, seq) and the launcher's modality inputs."""
    import numpy as np
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch import train
    tokens = next(TokenPipeline(cfg.vocab_size, seq, seed=0).batches(
        (G, per_group)))["tokens"]
    return train.add_modalities(
        {"tokens": torch.as_tensor(tokens, device="cuda")}, cfg,
        np.random.RandomState(0))


def modal_rounds(torch, K, spec, opt, rounds, hold_plain=False):
    """``rounds`` packed rounds of ``spec`` (MODAL_VLM / MODAL_AUDIO) from
    ``launch.train.build_run`` with the kernels: each round launches the
    update kernel T times and ``sq_norm_groups`` twice and nothing else,
    its losses finite (at init within LOSS_NEAR_LN_V of ln(padded
    vocab)). With ``hold_plain`` the last round also runs with the plain
    versions (``impl="torch"``, no launch) from a copy of the same state:
    sgd bit-equal, adamw params and moments within EW_TOL; the kernel
    round's state waits on the host meanwhile, so the card holds one
    state and one copy (phase 16 runs beside phase 11's processes).
    Returns (cfg, model, the server params, the batch)."""
    from repro_torch import tree
    from repro_torch.core import localsgd as lsgd
    from repro_torch.launch import train

    arch, G, per_group, seq = spec
    tag = f"phase 16 {arch} G {G} {opt}"
    cfg, model, layout, rnd, state, lcfg, _, exchange = train.build_run(
        arch, groups=G, t_inner=MODAL_T, opt=opt, lr=MODAL_LR[opt],
        device="cuda")
    batch = _modal_batch(torch, cfg, G, per_group, seq)
    ln_v = float(torch.log(torch.tensor(float(cfg.padded_vocab))))
    with torch.no_grad():
        loss0 = model.loss(lsgd.server_params(state, layout), tree.tree_map(
            lambda x: x[0], batch)).item()
    if not abs(loss0 - ln_v) <= LOSS_NEAR_LN_V:
        fail(f"{tag}: the loss at init {loss0:.4f} is not near ln(padded "
             f"vocab) = {ln_v:.4f}")
    mods = {"fused_sgd": K.fused_sgd, "fused_adamw": K.fused_adamw,
            "fused_momentum": K.fused_momentum, "sq_norm_groups": K.sq_norm,
            "flash_attention": K.flash_attention}
    for n in range(rounds):
        plain = None
        if hold_plain and n == rounds - 1:
            plain = _copied(state)
        before = {k: m.launches for k, m in mods.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = rnd(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: mod.launches - before[k] for k, mod in mods.items()}
        want = dict.fromkeys(mods, 0)
        want[f"fused_{opt}"], want["sq_norm_groups"] = MODAL_T, 2
        if got != want:
            fail(f"{tag} round {n}: launches {got}, expected {want}")
        loss = m["loss"]
        if loss.shape != (G,) or not bool(torch.isfinite(loss).all()) or \
                not bool(torch.isfinite(state["params"]).all()):
            fail(f"{tag} round {n}: loss {loss.tolist()} or params not "
                 "finite")
        log(f"{tag} round {n}: {sec:.4f} s fenced, loss "
            f"{[round(x, 4) for x in loss.tolist()]} (at init {loss0:.4f}, "
            f"ln padded vocab {ln_v:.4f}), N {layout.size:,}, peak memory "
            f"{_peak_gib(torch):.2f} GiB")
        if plain is not None:
            state = _copied(state, "cpu")
            torch.cuda.empty_cache()
            _hold_plain_round(torch, tag, model, opt, lcfg, layout,
                              exchange, plain, batch, state, mods)
            del plain
            torch.cuda.empty_cache()
            state = _copied(state, "cuda")
    server = lsgd.server_params(state, layout)
    del state, rnd
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, model, server, batch


def _copied(state, device=None):
    """A copy of a round state (nested dicts of tensors, empty ones
    kept), on ``device`` (default: where it is)."""
    if isinstance(state, dict):
        return {k: _copied(v, device) for k, v in state.items()}
    return state.clone() if device is None else state.to(device)


def _hold_plain_round(torch, tag, model, opt, lcfg, layout, exchange,
                      start, batch, kernel_state, mods):
    """The same round with the plain versions, from ``start``, against
    ``kernel_state`` (on the host), tensor by tensor on the card."""
    from repro_torch import optim
    from repro_torch.core import localsgd as lsgd
    before = {k: m.launches for k, m in mods.items()}
    rnd = lsgd.make_local_round(
        model.loss, optim.get(opt, MODAL_LR[opt], packed=True, impl="torch"),
        lcfg, layout=layout, exchange=exchange)
    plain, _ = rnd(start, batch)
    if any(m.launches != before[k] for k, m in mods.items()):
        fail(f"{tag}: the plain round launched a kernel")
    pairs = [("params", kernel_state["params"], plain["params"])]
    pairs += [(k, kernel_state["opt"][k], plain["opt"][k])
              for k in ("m", "v") if k in plain["opt"]]
    errs = {}
    for name, got, want in pairs:
        got = got.to(want.device)
        if opt == "sgd":
            if not torch.equal(got, want):
                fail(f"{tag}: the kernel round's {name} differ from the "
                     "plain round's (sgd: bit-equal expected), max abs "
                     f"{(got - want).abs().max().item():.3e}")
            errs[name] = 0.0
        else:
            errs[name] = compare(f"{tag} {name}, kernels against plain",
                                 got, want, **EW_TOL)
    log(f"{tag}: the round with the kernels against the plain versions "
        f"from the same state: max abs err {errs}")


def vlm_part(torch, K):
    """Part (a): internvl2-1b at full width (24 x 896, 14/2 heads, vocab
    151,655, bf16 over f32 params): 2 adamw and 1 sgd packed rounds, the
    last of each held against the plain versions; the trained params'
    forward with patches under ``attn_impl="pallas"`` against
    ``"blocked"`` (``vlm_flash_forward``); a 64-token greedy text decode
    on a ring of 48 slots (``ring_decode_hold``)."""
    base = torch.cuda.memory_allocated() / 2**30
    modal_rounds(torch, K, MODAL_VLM, "adamw", 2, hold_plain=True)
    _freed(torch, "internvl2-1b adamw rounds", base)
    cfg, _, params, batch = modal_rounds(torch, K, MODAL_VLM, "sgd", 1,
                                         hold_plain=True)
    one = {"tokens": batch["tokens"][0], "patches": batch["patches"][0]}
    with torch.inference_mode():
        vlm_flash_forward(torch, cfg, params, one)
        ring_decode_hold(torch, cfg, params, one["tokens"][:, :1],
                         VLM_DECODE["steps"], VLM_DECODE["W"],
                         "internvl2-1b")
    del params, batch, one


def vlm_flash_forward(torch, cfg, params, batch):
    """The trained internvl2-1b's forward on ``batch`` with patches under
    ``attn_impl="pallas"`` (one flash launch a layer) against
    ``"blocked"``, in float32 (the kernel's 3xTF32 against the plain
    path, within PATH_TOL's rtol of the largest logit: a logit near 0
    keeps the rounding of the large terms it sums, through 24 layers) and
    in bfloat16, the config's. In bfloat16 the
    two paths round apart by a bfloat16 step a layer, which 24 layers of
    a bfloat16 residual stream carry into the logits, so each is held
    against the float32 forward: the flash path's error may be at most
    twice the blocked path's own."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model

    logits = {}
    for dt in ("float32", "bfloat16"):
        for impl in ("blocked", "pallas"):
            model = build_model(dataclasses.replace(cfg, dtype=dt,
                                                    attn_impl=impl))
            before = fa.launches
            logits[dt, impl] = model.logits(params, batch)
            n_flash = fa.launches - before
            want = cfg.n_layers if impl == "pallas" else 0
            if n_flash != want or not bool(
                    torch.isfinite(logits[dt, impl]).all()):
                fail(f"internvl2-1b {dt} {impl} forward: {n_flash} flash "
                     f"launches (expected {want}), or logits not finite")
    f32 = logits["float32", "blocked"]
    scale = f32.abs().max().item()
    e32 = compare("internvl2-1b float32 logits, pallas against blocked",
                  logits["float32", "pallas"], f32, rtol=0.0,
                  atol=PATH_TOL["rtol"] * scale)
    e_flash = (logits["bfloat16", "pallas"] - f32).abs().max().item()
    e_plain = (logits["bfloat16", "blocked"] - f32).abs().max().item()
    e_pair = (logits["bfloat16", "pallas"]
              - logits["bfloat16", "blocked"]).abs().max().item()
    if not e_flash <= 2 * e_plain:
        fail(f"internvl2-1b bfloat16 logits: the flash path is "
             f"{e_flash:.3e} from the float32 forward, more than twice the "
             f"blocked path's {e_plain:.3e}")
    log(f"internvl2-1b forward on {tuple(batch['tokens'].shape)} tokens "
        f"with {tuple(batch['patches'].shape)} patches, {cfg.n_layers} "
        f"flash launches a pallas forward: float32 logits pallas against "
        f"blocked max abs {e32:.3e} (bound {PATH_TOL['rtol'] * scale:.3e}); "
        f"bfloat16: pallas "
        f"{e_flash:.3e} and blocked {e_plain:.3e} from the float32 logits "
        f"(max |logit| {scale:.3f}), {e_pair:.3e} apart")


def _ring_run(torch, model, params, cache, first, steps, feed=None):
    """``decode_step`` at positions 0..steps-1 from ``cache``: token 0 is
    ``first`` (B, 1), each next one the argmax over the vocab (greedy) or
    ``feed[:, t]``. Returns (tokens (B, steps), log-softmax (B, steps,
    V), the cache, seconds)."""
    vocab = model.cfg.vocab_size
    tok, toks, logps = first.to(torch.int32), [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(steps):
        logits, cache = model.decode_step(params, cache, tok, pos)
        toks.append(tok)
        logps.append(torch.log_softmax(logits[:, 0], -1))
        tok = (logits[:, :, :vocab].argmax(-1).to(torch.int32) if feed is None
               else feed[:, pos + 1:pos + 2])
    torch.cuda.synchronize()
    return (torch.cat(toks, 1), torch.stack(logps, 1), cache,
            time.perf_counter() - t0)


def ring_decode_hold(torch, cfg, params, first, steps, W, tag, frames=None):
    """Greedy decode of ``steps`` tokens from ``first`` (B, 1) on a ring of
    W slots (whisper: over the cross caches of ``frames``' encoder output,
    filled with ``attention.cross_attention_cache``), in float32 and in
    bfloat16, the configs' dtype (fed the float32 run's tokens). Every
    step's log-softmax finite; past W the ring holds the last W
    positions. Before the ring wraps, each step is held against the
    teacher-forced ``Model.logits`` of the decoded sequence: in float32
    within NEXT_TOKEN (the reference's float32 contract); in bfloat16 the
    decode may be at most twice as far from the float32 teacher-forced
    log-probabilities as the bfloat16 teacher-forced ones are (24 layers
    of a bfloat16 residual stream carry a bfloat16 step a layer)."""
    from repro_torch import tree
    from repro_torch.models import attention as attn
    from repro_torch.models.api import build_model

    B, held = first.shape[0], min(steps, W)
    runs = {}
    for dt in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg, dtype=dt))
        cache = model.init_cache(B, W, device="cuda")
        batch = {}
        if frames is not None:
            enc = model.encode(params, frames)
            ks, vs = zip(*(attn.cross_attention_cache(
                tree.tree_map(lambda a: a[i], params["dec"]["cross_attn"]),
                enc, cfg) for i in range(cfg.n_layers)))
            cache["cross_k"], cache["cross_v"] = (torch.stack(ks),
                                                  torch.stack(vs))
            batch["frames"] = frames
        feed = runs["float32"][0] if dt == "bfloat16" else None
        toks, logps, cache, sec = _ring_run(torch, model, params, cache,
                                            first, steps, feed)
        if not bool(torch.isfinite(logps).all()):
            fail(f"{tag} {dt} decode: logits not finite")
        if "kv" in cache and steps > W:
            slots = sorted(cache["kv"]["slot_pos"][0].tolist())
            if slots != list(range(steps - W, steps)):
                fail(f"{tag} {dt} decode: the ring holds positions {slots}")
        batch["tokens"] = toks[:, :held]
        forced = torch.log_softmax(model.logits(params, batch), -1)
        runs[dt] = (toks, logps[:, :held], forced, sec)
        log(f"{tag} {dt} decode: {steps} steps of {B} on a ring of {W} "
            f"slots in {sec:.2f} s ({sec / steps * 1e3:.2f} ms a step)")
    toks, dec32, forced32, _ = runs["float32"]
    e32 = (dec32 - forced32).abs().max().item()
    if not e32 < NEXT_TOKEN:
        fail(f"{tag} float32 decode: log-softmax {e32:.3e} from the "
             f"teacher-forced logits over the first {held} steps (contract "
             f"{NEXT_TOKEN})")
    _, dec16, forced16, _ = runs["bfloat16"]
    e_dec = (dec16 - forced32).abs().max().item()
    e_forced = (forced16 - forced32).abs().max().item()
    e_pair = (dec16 - forced16).abs().max().item()
    if not e_dec <= 2 * e_forced:
        fail(f"{tag} bfloat16 decode: {e_dec:.3e} from the float32 "
             f"teacher-forced log-softmax, more than twice the bfloat16 "
             f"teacher-forced logits' {e_forced:.3e}")
    log(f"{tag} decode, log-softmax over the first {held} steps: float32 "
        f"{e32:.3e} from teacher-forced (contract {NEXT_TOKEN}); bfloat16 "
        f"{e_dec:.3e} from the float32 teacher-forced (the bfloat16 "
        f"teacher-forced {e_forced:.3e}), {e_pair:.3e} from the bfloat16 "
        f"teacher-forced; greedy tokens {toks[0, :12].tolist()} ...")


def audio_part(torch, K):
    """Part (b): whisper-base at full width (6 + 6 x 512, 1500 frames,
    vocab 51,865): a packed sgd round and an adamw round, one pytree round
    and one sync step through the launcher's ``main``; then 4 x 1500
    frames encoded, the cross caches filled, 32 greedy steps
    (``ring_decode_hold``)."""
    from repro_torch.launch import train

    base = torch.cuda.memory_allocated() / 2**30
    modal_rounds(torch, K, MODAL_AUDIO, "sgd", 1)
    _freed(torch, "whisper-base sgd round", base)
    cfg, _, params, batch = modal_rounds(torch, K, MODAL_AUDIO, "adamw", 1)
    before = _all_counts(K)
    arch, G, per_group, seq = MODAL_AUDIO
    common = ["--device", "cuda", "--arch", arch, "--groups", str(G),
              "--per-group", str(per_group), "--seq", str(seq), "--rounds",
              "1", "--t-inner", str(MODAL_T)]
    for extra in ([], ["--mode", "sync", "--packed"]):
        t0 = time.perf_counter()
        train.main(common + extra)
        log(f"phase 16 whisper-base launcher {extra or ['pytree']}: "
            f"{time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    launched = {k: v - before[k] for k, v in _all_counts(K).items()}
    want = dict.fromkeys(launched, 0)
    want.update(fused_sgd=1, sq_norm_groups=1)
    if launched != want:
        fail(f"whisper-base launcher runs: launches {launched}, expected "
             f"{want} (the pytree round none, the sync step one each)")
    B, steps = AUDIO_DECODE["B"], AUDIO_DECODE["steps"]
    frames = batch["frames"].reshape(-1, cfg.n_frames, cfg.d_model)[:B]
    first = batch["tokens"].reshape(-1, seq)[:B, :1]
    with torch.inference_mode():
        ring_decode_hold(torch, cfg, params, first, steps, steps,
                         "whisper-base", frames=frames)
    del params, batch, frames, first


def ring_prefill_part(torch):
    """Part (c): the ring-cache prefill of paper-lenet at full width (8 x
    768, f32) under ``attn_impl="pallas"``: a 1024-token prompt (8 flash
    launches) against token-by-token ``decode_step`` over it; then 8
    greedy steps from each cache, tokens equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model

    S, new = RING_PREFILL["S"], RING_PREFILL["new"]
    cfg = dataclasses.replace(get_config(RING_PREFILL["arch"]),
                              attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt = torch.as_tensor(next(TokenPipeline(cfg.vocab_size, S, seed=0)
                                  .batches((1,)))["tokens"], device="cuda")
    W = S + new
    with torch.inference_mode():
        before = fa.launches
        t0 = time.perf_counter()
        logits_pf, cache_pf = model.prefill(params, {"tokens": prompt}, W)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        n_flash = fa.launches - before
        if n_flash != cfg.n_layers:
            fail(f"paper-lenet prefill: {n_flash} flash launches, expected "
                 f"{cfg.n_layers}")
        cache = model.init_cache(1, W, device="cuda")
        t0 = time.perf_counter()
        for t in range(S):
            logits_st, cache = model.decode_step(params, cache,
                                                 prompt[:, t:t + 1], t)
        torch.cuda.synchronize()
        t_st = time.perf_counter() - t0
        err = (torch.log_softmax(logits_pf[:, 0], -1)
               - torch.log_softmax(logits_st[:, 0], -1)).abs().max().item()
        kv_err = max((cache_pf["kv"][k] - cache["kv"][k]).abs().max().item()
                     for k in ("k", "v"))
        if not err < NEXT_TOKEN or not torch.equal(
                cache_pf["kv"]["slot_pos"], cache["kv"]["slot_pos"]):
            fail(f"paper-lenet prefill against stepwise decode: log-softmax "
                 f"{err:.3e} (contract {NEXT_TOKEN}) or slot positions "
                 "differ")
        runs = []
        for c, lg in ((cache_pf, logits_pf), (cache, logits_st)):
            tok, toks = lg[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32), []
            for pos in range(S, S + new):
                toks.append(int(tok))
                lg, c = model.decode_step(params, c, tok, pos)
                tok = lg[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
            runs.append(toks)
        if runs[0] != runs[1]:
            fail(f"paper-lenet: the greedy continuation differs: from the "
                 f"prefill {runs[0]}, from the stepwise cache {runs[1]}")
    log(f"paper-lenet ring prefill of {S} tokens: {n_flash} flash launches, "
        f"{t_pf:.3f} s; stepwise decode over the prompt {t_st:.2f} s "
        f"({t_st / S * 1e3:.2f} ms a step); next-token log-softmax max abs "
        f"{err:.3e}, K/V max abs {kv_err:.3e}; the greedy continuations "
        f"equal: {runs[0]}")
    del params, model, cache, cache_pf


def phase16(torch, K):
    """Phase 16: the vlm and audio families at full width and the
    ring-cache decode. Returns the launches of parts (a)-(c), as
    ``modality_launches``."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2**30
    log(f"phase 16: {base:.2f} GiB allocated at its start")
    # the figure processes of phase 11 share the card: this process's
    # allocator returns cached blocks before it passes MODAL_MEMORY of it
    torch.cuda.set_per_process_memory_fraction(MODAL_MEMORY)
    try:
        t0 = _part_start(torch)
        vlm_flash_hold(torch)
        _part_end(torch, "(d) flash at internvl2-1b's geometry", t0)
        _zero_all_counts(K)
        for name, part in (("(a) internvl2-1b", vlm_part),
                           ("(b) whisper-base", audio_part),
                           ("(c) paper-lenet ring prefill",
                            lambda torch, K: ring_prefill_part(torch))):
            t = _part_start(torch)
            part(torch, K)
            _freed(torch, name, base)
            _part_end(torch, name, t)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    counts = _all_counts(K)
    # (a) 2 adamw rounds and 1 sgd round, 24 flash launches in each of
    # the float32 and bfloat16 forwards; (b) 1 sgd and 1 adamw round, the
    # sync step; (c) 8 flash launches
    want = dict.fromkeys(counts, 0)
    want.update(fused_adamw=3 * MODAL_T, fused_sgd=2 * MODAL_T + 1,
                sq_norm_groups=2 * 5 + 1, flash_attention=2 * 24 + 8)
    if counts != want:
        fail(f"phase 16 launches {counts}, expected {want}")
    log(f"phase 16: {time.perf_counter() - t0:.1f} s; launches {counts}")
    return {"modality_launches": counts}


# Phase 17: sharded execution at paper-lenet's full width on (G 4 x S 2),
# traj metrics (a step's gradient norm comes from the shard's gradient, so
# no fifth params gather a round for a final evaluation)
SHARD_GRID = (4, 2)
SHARD_T = 4
SHARD_ROUNDS = 2
SHARD_REL = 1e-5                 # the CPU tests' relative tolerance
# a lossy stream (int8, int8z, bf16, top-k): a last-bit difference of the
# mean's summation order can move a codec's rounding by a quantum. The
# share of elements past SHARD_REL and the largest error, of the stream's
# largest element: the card read at most 2.0e-5 and 3.0e-5 (top-k; a
# share of 1.4e-4 under a gloo all_reduce's summation order), the control
# at least 0.20 and 5.5e-2 (PERF.md, PR 25)
SHARD_OFF = 1e-3
SHARD_LOSSY = 1e-3
# each run: optimizer, lr, the exchange (launcher flags; fault seed 1, as
# phase 12), the hop collective, and per round the launches of qdq_int8
# and the error-feedback residuals sq_norm_groups reduces
SHARD_PLAN = [
    dict(name="sgd", opt="sgd", lr=0.05),
    dict(name="momentum", opt="momentum", lr=0.05),
    dict(name="adamw", opt="adamw", lr=1e-3),
    dict(name="adamw int8", opt="adamw", lr=1e-3, codec="int8", qdq_int8=1),
    dict(name="ring int8 ppermute", opt="sgd", lr=0.05, comm="ring",
         codec="int8", mix_rounds=2, qdq_int8=2),
    dict(name="ring int8 allgather", opt="sgd", lr=0.05, comm="ring",
         codec="int8", mix_rounds=2, qdq_int8=2, hop_impl="allgather"),
    dict(name="gossip bf16 momentum", opt="momentum", lr=0.05, comm="gossip",
         codec="bf16"),
    dict(name="topk sgd", opt="sgd", lr=0.05, codec="topk", residuals=1),
    dict(name="async_stale int8", opt="sgd", lr=0.05, comm="async_stale",
         codec="int8", staleness=1, qdq_int8=1),
    # FAULT_PLAN[2]'s exchange under momentum: adamw with int8z moments
    # at eps 1e-8 diverges (phase 4), and a diverging run cannot be held
    dict(FAULT_PLAN[2], name="faulty server", opt="momentum", lr=0.05,
         qdq_int8=2),
    dict(FAULT_PLAN[0], name="push_sum"),
    # the two tiers (the reference's sharded cells, tests/
    # test_hierarchical.py:491) and the overlapped exchange, 2 pods of 2
    dict(name="hier ring|push_sum sgd", opt="sgd", lr=0.05,
         comm="hierarchical", n_pods=2, drop_rate=0.3, stall_rate=0.1,
         intra_drop_rate=0.05),
    # exact: a cast or int8 run that mixes by the unsharded round's ops
    # in its order (the tiers' hops and pod sums, a server's sum read as
    # the same host arrays) is held like fp32, not with the lossy limits
    dict(name="hier bf16 momentum", opt="momentum", lr=0.05,
         comm="hierarchical", codec="bf16", inter_codec="bf16", n_pods=2,
         drop_rate=0.08, stall_rate=0.05, exact=True),
    dict(name="hier server int8 sgd", opt="sgd", lr=0.05,
         comm="hierarchical", n_pods=2, intra_topology="server",
         inter_topology="server", inter_codec="int8", intra_stall_rate=0.1,
         qdq_int8=1, exact=True),
    dict(name="overlap server int8 sgd", opt="sgd", lr=0.05, codec="int8",
         overlap=True, qdq_int8=1, exact=True),
    # one hop: both packages refuse overlap with more
    dict(name="overlap ring int8z sgd", opt="sgd", lr=0.05, comm="ring",
         codec="int8z", overlap=True, qdq_int8=1),
]
SHARD_FLAGS = ("comm", "codec", "moment_codec", "mix_rounds", "staleness",
               "drop_rate", "stall_rate", "overlap", "n_pods",
               "intra_topology", "inter_topology", "inter_codec",
               "intra_drop_rate", "intra_stall_rate")


def _shard_exchange(run):
    return dict({k: run[k] for k in SHARD_FLAGS if k in run}, fault_seed=1)


def _shard_streams(run):
    """The streams a run holds: params and the moments, and under overlap
    each one's in-flight payload (``inflight.<stream>``)."""
    own = ("params",) + {"sgd": (), "momentum": ("mu",),
                         "adamw": ("m", "v")}[run["opt"]]
    return own + (tuple(f"inflight.{k}" for k in own)
                  if run.get("overlap") else ())


def _shard_buffer(state, k):
    """A stream of ``_shard_streams`` in a round's state."""
    if k.startswith("inflight."):
        return state["comm"]["inflight"][k.split(".", 1)[1]]
    return state["params"] if k == "params" else state["opt"][k]


def _shard_batches(torch, cfg, device):
    from repro_torch.data.synthetic import TokenPipeline
    pipe = TokenPipeline(cfg.vocab_size, 128, seed=0).batches(
        (SHARD_GRID[0], 2))
    return [{"tokens": torch.as_tensor(next(pipe)["tokens"], device=device)}
            for _ in range(SHARD_ROUNDS)]


def _shard_unsharded(torch, run, out_dir):
    """One run unsharded on the card, on the sharded run's padded layout:
    its buffers written raw (float32, (G, Np) row-major) and its metrics
    as JSON, then the ``ready`` mark. Returns the round seconds."""
    from repro_torch import comm
    from repro_torch.core import localsgd as lsgd
    from repro_torch.launch import train
    from repro_torch.optim import packing

    G, S = SHARD_GRID
    cfg, model, params, layout, opt = train._model_and_opt(
        "paper-lenet", False, True, run["opt"], run["lr"], "auto", 0,
        torch.device("cuda"))
    layout = packing.shard_layout(layout, S)
    flags = _shard_exchange(run)
    ex = comm.get_exchange(flags.pop("comm", "server"),
                           flags.pop("codec", "fp32"), G, **flags)
    rnd = lsgd.make_local_round(
        model.loss, opt, lsgd.LocalSGDConfig(n_groups=G, inner_steps=SHARD_T,
                                             metrics="traj"),
        layout=layout, exchange=ex)
    state = lsgd.init_state(params, opt, G, layout, exchange=ex)
    del params
    secs, metrics = [], []
    for b in _shard_batches(torch, cfg, "cuda"):
        t0 = _part_start(torch)
        state, m = rnd(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: (v.tolist() if isinstance(v, torch.Tensor) else v)
                        for k, v in m.items()})
    amax = {}
    for k in _shard_streams(run):
        v = _shard_buffer(state, k)
        amax[k] = float(v.abs().max())
        v.cpu().numpy().tofile(os.path.join(out_dir, f"{k}.f32"))
    del state, rnd, v
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump({"metrics": metrics, "amax": amax}, f)
    open(os.path.join(out_dir, "ready"), "w").close()
    return secs


def _shard_wait(path, what, timeout=900.0):
    t_end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            fail(f"phase 17: {what} not there after {timeout:.0f} s")
        time.sleep(0.2)


def _shard_hold(tag, got, want, amax, exact):
    """One rank's block against the unsharded run's, relative to the
    stream's largest element, and the control: the block held one element
    over (the least misplaced block), which the limits must refuse.
    Returns (err / amax, share off, control err / amax, control share
    off)."""
    def reading(a, b):
        diff = (a - b).abs_()
        return (diff.max().item() / amax,
                (diff > SHARD_REL * amax).double().mean().item())

    def passes(err, off):
        if exact:
            return err <= SHARD_REL
        return off <= SHARD_OFF and err <= SHARD_LOSSY

    err, off = reading(got, want)
    ctl_err, ctl_off = reading(got[1:], want[:-1])
    if not passes(err, off):
        fail(f"phase 17 {tag}: max abs err {err:.3e} of the largest element "
             f"{amax:.3e}, {off:.4%} of the elements beyond {SHARD_REL} of "
             "it")
    if passes(ctl_err, ctl_off):
        fail(f"phase 17 {tag}: the control (the block one element over) "
             f"passes the hold ({ctl_err:.3e}, {ctl_off:.4%} off)")
    return err, off, ctl_err, ctl_off


def shard_rank(rank, world, ref_dir):
    """One rank of phase 17: every run of ``SHARD_PLAN`` sharded, each
    held against the unsharded run's buffers and metrics in ``ref_dir``.
    Returns one record a run."""
    import numpy as np
    import torch

    from repro_torch import kernels as K
    from repro_torch.kernels import (decode_attention,  # noqa: F401
                                     exchange_epilogue, flash_attention,
                                     fused_adamw, fused_momentum, fused_sgd,
                                     mamba_scan, quantize, rmsnorm, sq_norm)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.sharding import shardexec as shx

    G, S = SHARD_GRID
    mesh = mesh_mod.make_local_mesh(G, S, "cuda")
    if mesh.transport != "cuda-ipc" or mesh.device.type != "cuda":
        fail(f"phase 17 rank {rank}: transport {mesh.transport} on "
             f"{mesh.device}, expected cuda-ipc mailboxes on the card")
    records = []
    for i, run in enumerate(SHARD_PLAN):
        # the card is either the unsharded run's or the ranks': run i
        # starts once the unsharded run i has freed its memory
        d = os.path.join(ref_dir, str(i))
        _shard_wait(os.path.join(d, "ready"), f"run {i}'s unsharded buffers")
        torch.cuda.reset_peak_memory_stats()
        sexec = shx.plan_for(mesh, require=True,
                             hop_impl=run.get("hop_impl", "ppermute"))
        cfg, model, layout, rnd, state, _, _, _ = train.build_run(
            "paper-lenet", groups=G, t_inner=SHARD_T, opt=run["opt"],
            lr=run["lr"], device=mesh.device, shardexec=sexec,
            metrics="traj", **_shard_exchange(run))
        if layout.size != MAIN[1] or layout.padded != 124_662_784:
            fail(f"phase 17: paper-lenet pads {layout.size} to "
                 f"{layout.padded}")
        _zero_all_counts(K)
        secs, coll, metrics = [], [], []
        for b in _shard_batches(torch, cfg, mesh.device):
            torch.cuda.synchronize()
            c0, t0 = mesh.seconds, time.perf_counter()
            state, m = rnd(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            coll.append(mesh.seconds - c0)
            metrics.append(m)
        counts = _all_counts(K)
        streams = _shard_streams(run)
        bufs = {k: _shard_buffer(state, k) for k in streams}
        if any(not v.is_cuda for v in bufs.values()):
            fail(f"phase 17 rank {rank} {run['name']}: a buffer left the card")
        with open(os.path.join(d, "ref.json")) as f:
            ref = json.load(f)
        lossy = not run.get("exact") and (
            run.get("codec", "fp32") != "fp32" or "moment_codec" in run)
        lo, hi = sexec.bounds(layout)
        errs = {}
        for k, v in bufs.items():
            want = np.fromfile(os.path.join(d, f"{k}.f32"), dtype=np.float32,
                               count=hi - lo, offset=4 * (
                                   sexec.group_index * layout.padded + lo))
            errs[k] = _shard_hold(
                f"rank {rank} {run['name']} {k}", v[0],
                torch.from_numpy(want).to(v.device), ref["amax"][k],
                exact=not lossy)
        rtol = 2e-3 if lossy else 1e-4
        for r, (m, m_ref) in enumerate(zip(metrics, ref["metrics"])):
            for k in ("loss", "grad_sq"):
                got_k = m[k].cpu().double()
                want_k = torch.tensor(m_ref[k], dtype=torch.float64)
                if not torch.allclose(got_k, want_k, rtol=rtol, atol=1e-6):
                    fail(f"phase 17 rank {rank} {run['name']} round {r} {k}: "
                         f"{got_k.tolist()} against {want_k.tolist()}")
            for k, v in m_ref.items():
                if (k.startswith("wire_bytes")
                        or k.startswith("participation")) \
                        and float(m[k]) != float(v):
                    fail(f"phase 17 rank {rank} {run['name']} round {r} {k}: "
                         f"{float(m[k])} against {v}")
        comm_state = state.get("comm", {})
        if "mass" in comm_state:
            # push-sum's invariant, flat or across the pods
            total = float(comm_state["mass"].sum()
                          + comm_state["backlog_w"].sum())
            if abs(total - G) > 1e-3:
                fail(f"phase 17 rank {rank} {run['name']}: mass + backlog "
                     f"{total} against G {G}")
        want = dict.fromkeys(counts, 0)
        want[f"fused_{run['opt']}"] = SHARD_T * SHARD_ROUNDS
        want["sq_norm_groups"] = ((2 + SHARD_T + run.get("residuals", 0))
                                  * SHARD_ROUNDS)
        want["qdq_int8"] = run.get("qdq_int8", 0) * SHARD_ROUNDS
        if counts != want:
            fail(f"phase 17 rank {rank} {run['name']}: launches {counts}, "
                 f"expected {want}")
        open(os.path.join(d, f"done.{rank}"), "w").close()
        records.append(dict(secs=secs, coll=coll, counts=counts, errs=errs,
                            transport=mesh.transport,
                            peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        del state, rnd, bufs, metrics, model, v, comm_state
        gc.collect()
        torch.cuda.empty_cache()
    return records


# the launcher's sharded run, as a user starts it (README), held against
# the unsharded launcher on the same flags
SHARD_LAUNCH = ["--arch", "paper-lenet", "--packed", "--groups", "4",
                "--rounds", "2", "--t-inner", "4", "--per-group", "2",
                "--seq", "128"]


def _launcher_rounds(out):
    """(loss, gsq, T, wire, cons) of each printed round line."""
    import re
    pat = re.compile(r"round +\d+ loss (\S+) gsq (\S+) T (\d+) wire (\S+)B "
                     r"part \S+ cons (\S+)")
    got = [pat.match(line) for line in out.splitlines()
           if line.startswith("round ")]
    if len(got) != 2 or not all(got):
        fail(f"phase 17 launcher: no 2 round lines in {out[-2000:]!r}")
    return [(float(m[1]), float(m[2]), int(m[3]),
             int(m[4].replace(",", "")), float(m[5])) for m in got]


def shard_launcher(tmp):
    """Phase 17's launcher part: ``train --shard 2`` in a fresh process
    (it builds the libraries, starts its 8 ranks, calibrates the fences
    for ``--trace``, and rank 0 gathers and saves the checkpoint) beside
    the unsharded launcher. The round lines agree to their printed
    digits (loss within 1e-4; grad_sq and consensus within 1e-3
    relative, their fourth digit), T equal, the sharded wire the padded
    buffer's; the trace passes the port's check with ``shard`` 2; the
    checkpoints agree within rtol 1e-5 / atol 1e-6."""
    import numpy as np

    runs = {"sharded": ["--shard", "2", "--world-timeout", "300"],
            "unsharded": []}
    procs = {}
    for k, extra in runs.items():
        cmd = ([sys.executable, "-m", "repro_torch.launch.train"]
               + SHARD_LAUNCH + extra
               + ["--trace", os.path.join(tmp, f"{k}.jsonl"),
                  "--checkpoint", os.path.join(tmp, k)])
        log(f"phase 17 launcher {k}: {' '.join(cmd[3:])}")
        procs[k] = subprocess.Popen(
            cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
    outs = {}
    try:
        for k, p in procs.items():
            out, err = p.communicate(timeout=420)
            for line in out.splitlines():
                log(f"phase 17 launcher {k}: {line}")
            if p.returncode != 0:
                fail(f"phase 17 launcher {k} exited {p.returncode}: "
                     f"{err[-3000:]}")
            outs[k] = out
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    if "transport cuda-ipc" not in outs["sharded"]:
        fail("phase 17 launcher: the sharded run names no cuda-ipc transport")
    got, want = (_launcher_rounds(outs[k]) for k in ("sharded", "unsharded"))
    for r, (a, b) in enumerate(zip(got, want)):
        if not (abs(a[0] - b[0]) <= 1e-4 and a[2] == b[2] and a[3] > b[3]
                and all(abs(x - y) <= 1e-3 * abs(y) for x, y in
                        ((a[1], b[1]), (a[4], b[4])))):
            fail(f"phase 17 launcher round {r}: sharded (loss, gsq, T, wire, "
                 f"cons) {a} against unsharded {b}")
    meta, _, _ = _checked_trace("phase 17 sharded",
                                os.path.join(tmp, "sharded.jsonl"))
    if meta.get("shard") != 2:
        fail(f"phase 17 launcher: the trace's meta says shard "
             f"{meta.get('shard')}")
    a = np.load(os.path.join(tmp, "sharded.npz"))
    b = np.load(os.path.join(tmp, "unsharded.npz"))
    if sorted(a.files) != sorted(b.files):
        fail("phase 17 launcher: the checkpoints hold other leaves")
    err = 0.0
    for k in b.files:
        x, y = a[k], b[k]
        if x.shape != y.shape or not np.allclose(x, y, rtol=1e-5, atol=1e-6):
            fail(f"phase 17 launcher: checkpoint leaf {k} differs")
        err = max(err, float(np.abs(x - y).max()))
    log(f"phase 17 launcher: rounds {got} against {want}; checkpoint max "
        f"abs err {err:.3e}")


def phase17(torch, K):
    """Phase 17: the sharded packed round on 8 ranks sharing the card,
    then the launcher's sharded run. Returns ``shard_launches`` (each
    kernel's launches summed over the ranks and runs)."""
    import threading

    from repro_torch.launch import mesh as mesh_mod

    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    world = SHARD_GRID[0] * SHARD_GRID[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        for i in range(len(SHARD_PLAN)):
            os.mkdir(os.path.join(tmp, str(i)))
        box = {}

        def ranks():
            try:
                box["records"] = mesh_mod.run_ranks(
                    shard_rank, world, tmp, device_type="cuda", timeout=600.0)
            except BaseException as e:          # noqa: BLE001 - re-raised
                box["err"] = e

        th = threading.Thread(target=ranks, daemon=True)
        th.start()
        # each unsharded run once the ranks have held the one before (the
        # card holds one run at a time: the ranks and this process each
        # take tens of GiB at paper-lenet's width); its buffers go then
        for i, run in enumerate(SHARD_PLAN):
            if i >= 1:
                d = os.path.join(tmp, str(i - 1))
                while th.is_alive() and not all(
                        os.path.exists(os.path.join(d, f"done.{r}"))
                        for r in range(world)):
                    time.sleep(0.1)
                for f in os.listdir(d):
                    if f.endswith(".f32"):
                        os.remove(os.path.join(d, f))
            if not th.is_alive():
                break
            secs = _shard_unsharded(torch, run, os.path.join(tmp, str(i)))
            log(f"phase 17 {run['name']}: unsharded rounds "
                f"{[round(x, 3) for x in secs]} s")
        th.join(660.0)
        if "err" in box:
            raise box["err"]
        if "records" not in box:
            fail("phase 17: the ranks did not finish")
        log(f"phase 17 ranks: {time.perf_counter() - t_start:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t_launch = time.perf_counter()
        shard_launcher(tmp)
        log(f"phase 17 launcher: {time.perf_counter() - t_launch:.1f} s")
    total = {}
    for i, run in enumerate(SHARD_PLAN):
        recs = [r[i] for r in box["records"]]
        log(f"phase 17 {run['name']} ({recs[0]['transport']}): fenced round "
            "s by rank " + "; ".join(
                f"{r}: {[round(x, 4) for x in rec['secs']]} (collectives "
                f"{[round(x, 4) for x in rec['coll']]}, share "
                f"{sum(rec['coll']) / sum(rec['secs']):.3f})"
                for r, rec in enumerate(recs)))
        log(f"phase 17 {run['name']}: by stream, over the 8 ranks: max err / "
            "largest element, max share off; control (one element over): "
            "min err / largest, min share off: " + ", ".join(
                f"{k} {max(rec['errs'][k][0] for rec in recs):.3e} "
                f"{max(rec['errs'][k][1] for rec in recs):.4e}; control "
                f"{min(rec['errs'][k][2] for rec in recs):.3e} "
                f"{min(rec['errs'][k][3] for rec in recs):.4e}"
                for k in recs[0]["errs"])
            + f"; launches a rank {recs[0]['counts']}; peak GiB by rank "
            + str([round(rec["peak_gib"], 2) for rec in recs]))
        for rec in recs:
            for k, v in rec["counts"].items():
                total[k] = total.get(k, 0) + v
    log(f"phase 17: {time.perf_counter() - t_start:.1f} s; shard_launches "
        f"{total}")
    return {"shard_launches": total}


def _kernel_name(mangled):
    """A ptxas entry name, short: the kernel's name after its namespace
    and its raw template arguments (``paged_decode_kernel ILi64ELi1EE``:
    hd 64, g 1), or the name as given."""
    import re
    ns = re.match(r"_ZN(\d+)", mangled)
    at = ns.end() + int(ns.group(1)) if ns else 0
    n = re.match(r"\d+", mangled[at:])
    if not ns or not n:
        return mangled
    at += n.end()
    name, rest = mangled[at:at + int(n.group())], mangled[at + int(n.group()):]
    return name + (" " + rest[:rest.find("EE") + 2] if rest[:1] == "I"
                   else "")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--figure":
        return figure_main(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "--counted-train":
        return counted_train_main(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import kernels as K
    # the wrapper modules, reached below as attributes of K
    from repro_torch.kernels import (build, decode_attention,  # noqa: F401
                                     exchange_epilogue, flash_attention,
                                     fused_adamw, fused_momentum, fused_sgd,
                                     mamba_scan, quantize, ref, rmsnorm,
                                     sq_norm)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi = smi.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.load_all()
    built = (f"build: {time.perf_counter() - t0:.1f} s for "
             f"{sorted(build.SIGNATURES)}")
    log(built)
    for stem in sorted(build.SIGNATURES):
        entry, spill = "?", ""
        for line in build.build_log(stem).splitlines():
            if "Compiling entry function" in line:
                entry = _kernel_name(line.split("'")[1] if "'" in line
                                     else line)
            elif "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif "registers" in line:
                log(f"  {stem} {entry}: {line.split(':', 1)[-1].strip()}; "
                    f"{spill}")
    tf32_mma = {stem: sass_tf32_mma(build, stem)
                for stem in ("flash_attention", "mamba_scan")}
    for stem, n in tf32_mma.items():
        log(f"{stem} library SASS: {n} TF32 HMMA instructions")
        if n == 0:
            fail(f"{stem}: no TF32 HMMA instruction in the library's SASS; "
                 "the tensor-core path is not the one built")

    results = check_kernels(torch, K, ref)
    check_exchange_kernels(torch, exchange_epilogue, results)
    check_exchange_coverage(torch, exchange_epilogue, results)
    reference_check(torch)
    for c in K.quantize.launches:
        K.quantize.launches[c] = 0
    K.rmsnorm.launches = K.mamba_scan.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt = os.path.join(tmp, "paper-lenet")
        counts, server = main_path(torch, K, exchange_epilogue, ckpt)
        profile_round(torch)
        check_attention_kernels(torch, results,
                                tf32_mma["flash_attention"])
        counts.update(serve_path(torch, ckpt, server, tmp))
        serve_reference_check(torch, ckpt, server)
    # neither package's training or serving path reaches the last four
    off_path = dict(K.quantize.launches, rmsnorm=K.rmsnorm.launches,
                    mamba_chunk=K.mamba_scan.launches)
    log(f"phases 5-9 launched the last four kernels {off_path} times")
    if any(off_path.values()):
        fail(f"the train and serve paths launched {off_path}")
    check_last_four(torch, results)
    counts.update(ops_path(torch))
    # phases 16 and then 17 run on the card while phase 11's figure
    # processes keep the host busy (they are host-bound), within the
    # script's 1200 s; one after the other, as each takes a large share of
    # the card
    beside = {}

    def modal_and_sharded():
        beside.update(phase16(torch, K))
        gc.collect()
        torch.cuda.empty_cache()
        beside.update(phase17(torch, K))

    by_path = phase11(torch, K, beside=modal_and_sharded)
    by_path.update(phase12(torch, K))
    by_path.update(phase13(torch, K)[0])
    by_path.update(phase14(torch, K))
    by_path.update(phase15(torch, K))
    by_path.update(beside)

    # again at the end, where a tail of the output still holds them
    log(built)
    log(smi)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if "device_ms" in r:
            kernels[-1]["device_ms"] = r["device_ms"]
        for path, got in by_path.items():
            if name in got:
                kernels[-1][path] = got[name]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
