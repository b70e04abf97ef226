#!/usr/bin/env python3
"""Smoke run of the areal_tpu_torch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

 (a) card: print its name and power limit, which of zmq, aiohttp, msgpack,
     yaml and ml_dtypes import here (a record only: the port needs none
     of them), the seconds ``import torch`` took here and whether torch
     ships its bytecode (the script keeps what it compiles under
     ``build/pycache`` for itself and every process it starts), build the
     CUDA kernels from the
     sources in this checkout (one nvcc per source, in parallel, sm_90a) and
     print ptxas's registers and spills for each kernel instance (29: K1-K3
     at head_dim 64, 128 and 256, f32, bf16 and fp16, and K2's two
     reductions; the head_dim-256 ones on a line of their own); the
     tensor-core instances (bf16, fp16) must not spill;
 (b) K1, the packed flash-attention kernel, against its plain PyTorch
     version computed in float32 on the same bf16 inputs: the main-path
     shape (B=8, T=S=512, 14/2 heads of 64, packed segments and pad rows),
     a head_dim-128 GQA case (28/4 heads), a ragged T=200, and Gemma's
     serving shape (head_dim 256, 8 q heads over 1 kv head, B=8, T=512)
     with a ragged T=200 at head_dim 256. Tolerance: one
     bf16 ulp at the output's largest magnitude (2**-8 * max|ref|); pad rows
     exactly 0; nothing NaN. Times the kernel, the plain version and SDPA
     (a yardstick only; the port never calls it), at head_dim 64 and 256;
 (c) the slice: Qwen2.5-0.5B at full width in bf16 with weights from a
     seed, behind the port's GenerationServer on a free localhost port.
     Eight concurrent POST /generate requests (prompts of 100-900 tokens,
     greedy and temperature/top-p mixed) each with a 192-token budget: the
     server's 128-token chunk answers first, then continuations with the
     same rid fetch the remaining 64 from the retained KV. Then one greedy
     request twice, alone. Checks reply lengths, finite logprobs <= 0,
     greedy repeatability, K1 launches == n_layers per prefill, and no
     prefill for the continuations;
 (d) the prefill's last logits through K1 against the same prefill through
     the plain attention on the card (tolerance: 5% of the largest |logit|;
     the plain attention rounds scores and probabilities to bf16, K1 keeps
     scores and the softmax in f32 and rounds only P before P V, and 24
     layers carry the difference forward);
 (e) where the time goes: warm prefill and decode-step times at the
     slice's widest prefill, K1's share of the prefill's device time, and
     the device's idle share during decode (from torch.profiler);
 (f) K2 (dk, dv) and K3 (dq), the flash-attention backward kernels (both on
     tensor cores for bf16), against their plain PyTorch version computed
     in float32 on the same bf16 inputs (K1's out and logsumexp, a random
     dO): the train shape (B=2, T=S=1792, 14/2 heads of 64, packed segments
     with pad tails), D=128 with GQA (28/4 heads), a ragged T=200, and
     Gemma's train micro-batch (D=256, 8/1 heads, [1, 4096]) with a ragged
     T=200 at D=256.
     Tolerance: two bf16 ulps at each gradient's largest magnitude (2**-7 *
     max|ref|; the kernels and the plain version both sum in f32 from the
     same bf16 inputs and round once); pad rows and columns exactly 0;
     nothing NaN. Times K2, K3, the plain backward and SDPA's backward at
     the train shape and at Gemma's, and counts the tile pairs K1, K2 and
     K3 execute there against the causal walk's, each at its own tiles
     (K3 must execute fewer);
 (g) the train slice: PPO actor train steps of Qwen2.5-0.5B at full width
     and depth (bf16 compute, f32 masters, weights from seed 0) on
     bench.py's batch and recipe (32 trajectories, 27,554 tokens, cap 4096
     tokens per micro-batch -> 8 micro-batches of [2, 1792]; "dots" remat,
     log-prob chunks of 512, AdamW lr 1e-5 with bf16 moments). One warm-up
     step and 3 timed ones: trained tokens/s, ms per step, the fwd-bwd /
     optimizer split, peak memory, the tile pairs K1, K2 and K3 execute on
     the micro-batches against the causal walk's. Checks finite loss and
     grad norm > 0, moved parameters, K2 and K3 launched layers x
     micro-batches x steps times, and K1 twice that (the "dots" remat
     reruns K1 in the backward). Then the packer on the same batch as
     the engine runs it, forced through the native host ops
     (``ops/native.py``, which must build and load here) and through the
     NumPy path: the host ms of a step's split and of the
     first-fit-decreasing bins, each path's micro-batches (layouts and
     grids) and bins equal; and the sweep of 8-4096 sequences that
     places the native path's thresholds (``native_sweep``);
 (h) one micro-batch's loss and per-parameter grad norms through K1-K3
     against the same micro-batch through the plain attention, on the card;
     the micro-batch with the most positive-advantage tokens, since with
     random weights only those carry a gradient (tolerance: loss within 1%,
     each grad norm within 10%, gradient cosine >= 0.99; the plain
     attention rounds scores and probabilities to bf16, the kernels keep
     scores in f32 and round only P and dS before their products, and 24
     layers carry the difference forward and back);
 (i) where the time goes in one train step (torch.profiler): the device ms,
     share and launches of K1, K2 (its partial and reduction kernels), K3,
     GEMMs and the rest of the device time, the device's idle share and the
     kernels per step; K1, K2 and K3 must each show device time;
 (j)-(o) run at 4 of the model's 24 layers (full width; ``CUT_LAYERS``),
     as do (q2), (q3) with (p), (r), (s) and (u)-(x); (t) at 8
     (``ELASTIC_LAYERS``: at 4 its loop ends before the second server is
     given work): the cuts that make room for the later phases in the
     time limit. Wherever a check of these phases counts per layer, it
     counts 4 (8 in (t)). (c)-(i) and (q1) run at 24.
     After (i) two lanes share the card: the loop lane, a spawned process
     of its own, runs (o), (q3) with (p), (r) and (s) one after another,
     while this process runs (j)-(n), (q1), (q2), (u)-(y), (bb), (cc) and
     (z); then (t), (aa), (dd), (ee) and (ff) run alone. Each phase of
     either lane starts once the card has room for it (``LANE_ROOM_GB``),
     so the times of those phases are readings on a shared card; (a)-(i),
     (t), (aa), (dd), (ee) and (ff), and every kernel time of the JSON
     line, have the card to themselves.
 (j) the trainer's model functions of the async-PPO recipe (the README's
     `ppo.use_decoupled_loss=true group_size=16`, the rest at defaults:
     kl_ctl 0.1, a critic, 4 PPO minibatches, advantage whitening), the
     engines of (g) freed first: an actor and a critic (same geometry with
     a value head; trunk from the actor's seed) with f32 masters and bf16
     moments, and a bf16 reference engine without optimizer. Batch: (g)'s
     32 trajectories as 2 prompts x 16 samples, behaviour logprobs set to
     ref_inf's output (importance ratios start at 1). One warm-up and 2
     timed steps of ref_inf -> actor_inf -> critic_inf -> actor_train ->
     critic_train: ms per MFC and per step, trained tokens/s, peak memory,
     K1-K3 launches per MFC. Checks: prox_logprobs == packed_ref_logprobs
     before the first update (exactly), the first actor minibatch's
     importance weight within 2% of 1, finite losses, grad norms > 0,
     finite value moments, both models' parameters moved, no early stop,
     each inference MFC launches K1 n_layers x its micro-batches and no
     K2/K3, each train MFC K2 and K3 n_layers x its micro-batches and K1
     twice that.
     Then actor_inf and one actor step with group_adv_norm (the host
     advantage path through train_batch), the same checks; before it, its
     first PPO minibatch's logprobs recomputed by engine.forward under the
     minibatch's own packing, printed against actor_inf's (which packed
     the whole batch) with the importance weight each gives; ref_inf's logprobs on one
     micro-batch's sequences through K1 against the plain attention
     (tolerance 0.3 nats: twice (d)'s logits bound, as a logprob is a logit
     minus a logsumexp); and the device ms and idle share of each MFC of
     one profiled step;
 (k) checkpoints at full width under a temporary directory (deleted): the
     actor's HF checkpoint loads into a new inference engine whose
     actor_inf logprobs equal the saved engine's exactly; the train state
     loads into a fresh engine, and one actor step on each gives equal
     masters. Seconds and bytes of each write and read;
 (l) one SFT train_step on the batch: finite loss and perplexity, K2 and
     K3 launched n_layers x the micro-batches;
 (m) weight sync at full width, under a temporary directory (deleted): a
     port server in bf16 on the seed-0 weights, holding one retained KV
     state, swaps through POST /update_weights to (1) the trained actor's
     weights, published in bf16 by a TrainerWorker over "disk" (a native
     checkpoint), then (2) seed-1 weights, published over "stream" by a
     TrainerWorker on a bf16 inference engine in a second process (spawned;
     it builds the same seed-1 weights), while a client sends one greedy
     request at a time and a sampler reads the server's prefill and decode
     counters every 10 ms. Checks: each update answers 200 with its version
     and /health shows it; the KV store is empty after each swap; the live
     weights equal the published ones bit for bit; the disk swap changed
     some elements; every reply under load carries the old or the new
     version, the last one the new, and exactly the greedy tokens of its
     version's weights (the replies before the swap; a fresh server on the
     new weights). Then (3) an update from a dead endpoint answers 500 and
     leaves the version and the tokens as they were. Bytes, trainer-side
     publish seconds, seconds from the publish's start to the server's
     reply; for the stream the gather (d2h and CRCs, in the publisher's
     process), the server thread's legs (wire wait, CRCs with the
     reassembly, h2d with the layout conversion, the rest), the runner's
     decode ms per step and busy share before and during the update, the
     longest reply before and during it, and a replay of the cached publish
     into host memory (the transport alone); peak device memory and K1's
     launches per transport; K1 launches n_layers x the server's prefills;
 (n) the sync-PPO loop, the engines of (j) freed first: the README's sync
     recipe (`ppo.kl_ctl=0.05 group_size=8`, the rest at defaults: a
     critic, 4 PPO minibatches, no actor_inf) as the graph of
     experiments/ppo_math_exp.py:111 build_dfg (actor_gen -> rew_inf,
     ref_inf, critic_inf -> actor_train, which publishes the actor over
     disk -> critic_train), walked by the port's MasterWorker in this
     process (in a thread joined within 600 s) over the port's request
     stream to a TrainerWorker in a spawned process, which loads the
     kernels (a) built. Every role loads one HF checkpoint written from
     seed 0 under a temporary directory (deleted): actor and critic on
     (g)'s backend (the critic with a value head), a bf16 reference
     engine, a tokenizer-only reward role; a byte tokenizer (eos 151643);
     the "math_code_prompt" dataset of seeded math records (prompts of
     100-400 byte tokens); 4 prompts x 8 samples of 256 new tokens at
     temperature 1 per step; 4096 tokens per micro-batch in the forward
     and train MFCs. 3 steps, the first a warm-up: ms per step and per MFC
     (the master's timeperf/* and the trainer's CUDA-event ms), generated
     and trained tokens/s, publish seconds, the trainer's peak memory,
     K1-K3 launches per MFC, the reward mean and verdicts, whether sympy
     imports. Checks: 3 steps; finite losses, action tokens and grad norms
     > 0 for actor and critic every step; model_version >= 3; the last
     published checkpoint holds model.safetensors and its native JSON, its
     tensors hash to the trainer's actor bit for bit and differ from the
     initial weights; K1 launches n_layers x the prefills in actor_gen and
     n_layers x the micro-batches in each forward MFC, K2 and K3 n_layers x
     the micro-batches in each train MFC and K1 twice that; the trainer
     exits 0. Rehearse on the CPU with
     `run_sync_loop(tiny_cfg, tmpdir, device="cpu", eos=...)` (tied
     embeddings; the launch checks run only on the card);
 (o) the async-PPO loop, the trainer of (n) gone, at 4 layers: the
     README's async recipe
     (`max_head_offpolicyness=4 ppo.use_decoupled_loss=true group_size=16`,
     the rest at defaults: a critic, kl_ctl 0.1, 4 PPO minibatches, 256
     new tokens at temperature 1, 64 concurrent rollouts, server batches of
     up to 64, the stream weight sync) through the port's run_experiment
     (what `python -m areal_tpu_torch.training.main_async_ppo` calls): the
     master here, the trainer, the generation fleet (one bf16 server and
     the manager) and one rollout worker spawned, all on this card, every
     role from one seed-0 HF checkpoint and the byte tokenizer. Cuts:
     dataset.train_bs_n_seqs=4 (64 trajectories a step),
     new_tokens_per_chunk=128 (two chunks a trajectory, a weight swap may
     land between them), 4 steps (the first a warm-up), seeded math
     records. The launcher's probes record each child's counters and send
     them through pipes. Prints ms per step, the trainer's wall and
     CUDA-event ms per MFC, trained and generated tokens/s, each version's
     publish-to-swap and fanout seconds, the staleness histogram and the
     share of trajectories spanning versions, allocation denials by
     reason, the server's batch sizes and decode ms per step during
     training and outside it, both peak memories. Checks: 4 steps within
     600 s; finite losses and grad norms > 0 for actor and critic; each MFC
     once a step; version_start <= version_end <= the trainer's version at
     its train step for every trained trajectory; the manager and the
     server at one version >= 3, and the server's weights the actor
     published as that version, bit for bit; running_rollouts 0 after the
     master stops; the rollout worker never initialised CUDA; K1 launched
     n_layers x the server's prefills, K1-K3 per MFC as in (n); every child
     gone after the teardown. With every observability switch off, no
     telemetry endpoint is advertised and no telemetry thread runs in the
     master's process (watched every 0.2 s). Rehearse on the CPU with
     `run_async_loop(tiny_cfg, tmpdir, device="cpu", ...)` under a
     `__main__` guard;
 (p) the loop of (o) again, run as (q3) (one loop for both, to make
     room for (y) and (z)), 3 steps (the first a warm-up), with
     telemetry (the merged /metrics on a free port, flight dumps on
     SIGTERM), goodput, compile_watch (memory sampled every serve-loop
     iteration) and the sentinel (the default rules and an operator rule
     `master/step_secs > 0 for 1 s`) on. Once step 2's batch is in, a
     ~3 s torch.profiler capture is requested from the trainer through
     the trigger; as the master closes its aggregator, its merged /metrics
     (found through names.telemetry_http), the server's /metrics and
     /metrics.json and the manager's /metrics are scraped. Checks: the
     merged scrape has series of the master, trainer, generation server,
     manager and rollout worker; the trainer's and the server's goodput
     ledgers sum to their wall within 1% (and export it all); fleet
     goodput of each side in (0, 1]; live MFU of trainer and server in
     (0, 1), against the peak of the card's name; each process's
     hbm/peak_bytes within 1% of its torch.cuda.max_memory_allocated; one
     stitched trace per trained trajectory of the timed steps, each
     joining a rollout, a server and a trainer span; the operator rule in
     alerts.jsonl and areal_alerts_total, with a flight dump of every
     worker in its evidence directory; the capture shows K1, K2 and K3
     with device time; the flight dumps written on SIGTERM parse; (o)'s
     launch and teardown checks. Prints ms per step beside (o)'s, fleet
     goodput, each ledger's state seconds, live MFU beside the master's
     timeperf/mfu, both peaks and their sum, the trainer's split_pack /
     fwd_bwd / optimizer spans, the server's decode-chunk spans, the
     default rules that fired and the device's busy share in the capture;
 (q) the serving engine on the seed-0 weights in bf16 (a fresh copy, the
     earlier phases' engines freed; (q1) at 24 layers, (q2) at 4), every
     server with ``serving.enabled=true`` at its defaults but as said.
     (q1) prefix reuse: a donor (a 768-token preamble + 32 tokens, greedy,
     one full chunk of 128) on a server with prefix reuse and on one
     without; then eight concurrent requests of the preamble + suffixes of
     16-64 tokens (first tokens distinct, none the donor's), 32 greedy
     tokens each, on both. Checks: prefix hits +8, tokens saved +8 x 768,
     prefill tokens + the suffixes' sum, no batched prefill and no K1
     launch for the seeded requests (eight B=1 suffix extends through the
     plain attention), the donor's K and V bytes unchanged (SHA-256),
     each seeded row's first logits within 5% of max|logit| of the
     reuse-off server's full K1 prefill of the same prompt, which two
     wrong seeds (the donor cloned one token short, a donor of another
     768-token preamble) must fail; and within 1e-4 of max|logit| of the
     same extend redone outside the server on a fresh clone of the donor
     at the server's shapes, which both wrong seeds must fail too. Prints
     each reading, and the seeded rows against a plain-attention full
     prefill. A request
     whose prompt is the donor's whole sequence is a pure clone (no
     prefill, no extend) and its greedy tokens and logprobs equal the
     donor's rid continuation bit for bit; a 100-token overlap counts as
     prefix_skipped_no_savings; K1 launched n_layers x the batched
     prefills. Prints the seeded extend and unseeded prefill ms and how
     many of the eight greedy continuations equal reuse-off's.
     (q2) classes, on one server (telemetry on, batches of up to 16,
     queue_limit_interactive=4) behind a manager: 64 rollouts of 160
     tokens at temperature 1 (two chunks each, 128 and 32 tokens, through
     the manager's leases; 256 before the script outgrew its time limit)
     in flight, then a burst of 16 interactive requests
     (32 greedy tokens) and a 16,400-token prompt. Checks: some
     interactive requests get 429 with Retry-After "1" and the
     reference's body, the rest 200; the admitted interactive requests'
     mean queue wait is below the rollouts'; the long prompt gets 413 and
     every rollout finishes; the server's /metrics has the areal_serving_*
     families and the manager's areal_gsmgr_inflight_{interactive,eval,
     rollout}; ``perf_probe decode-bench`` (24 mixed requests) sees no
     non-200 reply but 429 and 413; K1 launched n_layers x the prefills,
     the decode-bench's included.
     Prints per-class latency, queue wait and time to first chunk, the
     429/413 counts and the share of decode row-steps that are dummies.
     (q3) the loop of (o) at 4 layers with ``serving.enabled=true`` and
     (p)'s observability, 3 steps (the first a warm-up), while a thread
     here sends three interactive requests through the manager: (o)'s and
     (p)'s checks and at least one interactive reply.
     Prints ms per step beside (o)'s, prefill tokens per step, prefix hits,
     continuations that re-prefilled and the retained KV's peak bytes,
     beside (o)'s.

 (r) the reward fleet and respawns: (o)'s loop at 4 layers, 3
     steps (the first a
     warm-up), with ``reward_service.enabled=true n_workers=2`` and
     ``fault_tolerance`` at its defaults, on seeded records half math and
     half python code (2-4 stdin/stdout cases each), through the
     launcher's supervisor. The script SIGKILLs ``reward0`` and then
     ``rollout0`` after step 1 and the generation fleet (server and
     manager) after step 2 (as the trainer publishes that step's
     version; 4 steps and a kill a step before the script outgrew its
     time limit), and waits after each kill until the worker's next
     incarnation has registered; the trainer holds step 3, outside its MFCs' timing, until the
     fleet's respawn has registered (fast steps could otherwise end the
     loop first). While the loop runs: the open /dev/nvidia* nodes of the
     reward workers (the trainer and the fleet the control), each reward worker's /metrics.json, and ``perf_probe
     reward-bench`` (32 seeded tasks) at the live fleet. Checks: 3 steps
     with finite losses; restarts {reward: 1, rollout: 1, gen_fleet: 1},
     no escalation; no local fallback and no local grade in the rollout
     process, its answered tasks at least the trained trajectories, and
     the fleet's grades between the answers and the tasks sent (a grade
     whose worker or client was killed before its answer landed is the
     difference; reward-bench's included); no reward worker holds a CUDA
     context, imported torch or saw a card; the respawned server's
     weights, as its first batch at a version > 0 starts, equal the
     actor the trainer published as that version (SHA-256 per tensor);
     quota 0 after the master stops; (o)'s launch checks on the
     respawned fleet; no child left. Prints ms per step and the step
     after each kill, respawn seconds per kind from the kill to the new
     incarnation's registration (the fleet's split into the supervisor's
     backoff, process start, model build and start, first weight update),
     the client's tasks, answers, retries and fallbacks, the fleet's
     verdicts by task kind, the grading call's ms beside (o)'s, each
     reward worker's peak RSS beside a bare ``import torch``'s and
     reward-bench's line;
 (s) relaunch and drain with the durable spool: (o)'s loop at 4 layers
     with
     ``recover_mode=auto``, a recover checkpoint every step,
     ``durability.enabled=true`` and 4 steps, through ``run_experiment``.
     Once step 1's checkpoint and the actor's v1 publish are in, and the
     trainer holds a group of spooled samples it has not acked, the
     trainer is SIGKILLed: the supervisor escalates, ``run_experiment``
     clears the trial's name-resolve subtree and relaunches with
     ``resume``, and the relaunched rollout worker replays its spool;
     after the relaunched run's first step, ``request_drain()`` (the
     SIGTERM handler's path): pause, checkpoint, exit. Checks: the first
     launch failed on the escalation; none of its children lived when the
     relaunch started; the relaunched trainer's first step ran at the
     checkpoint's actor version and the master resumed at its step; the
     drain ended the run before its 4 steps; the relaunched actor's first
     publish (at the restore) equals the killed trainer's publish of that
     version bit for bit; the trainer and the rollout worker exit 0 and a
     complete recover checkpoint is at the last step; no sample lost: on
     disk the spool's appended records equal the acked watermark plus its
     depth, every sample of every prompt in the consumed log was acked by
     a trainer (trained in a committed step), dropped as a stale replay or
     is still spooled, no prompt was consumed twice, both incarnations'
     appends add up to the spool's and the relaunch replayed; no child
     left. Prints kill-to-escalation, escalation-to-relaunch and
     escalation-to-first-step seconds (beside PR 11's 53.37), the card's
     memory in use as the relaunch starts, the drain seconds, the recover
     checkpoints' bytes and write seconds, the steps before the kill
     beside (o)'s, and the spool's delivery counters (appended, acked,
     replayed, resent), the trainer's duplicate and stale drops, the
     samples trained twice, the peak depth and bytes and the append
     (write and fsync) ms p50 and p99, overall and during a checkpoint's
     write;
 (t) the elastic fleet: (o)'s loop at 8 layers, 5 steps, with
     ``autoscale.enabled=true min_servers=1 max_servers=2
     interval_secs=1`` (the rest at the
     reference's defaults; the one-second tick is a cut: the replacement
     a cordoned gen0 draws is scaled down as soon as it is admitted, so
     that a third server's memory is held briefly on the one card) through
     the launcher. While it runs, the script waits for
     the manager's plan to ask for a dynamic server (64 rollouts in flight
     against ``max_concurrent_rollouts=64``: utilization 1.0), its spawn,
     registration, admission and first generated tokens (a rollout keeps
     its server for all its chunks, so the new server's share starts with
     the next rollouts the gate admits); keeps two servers for 10 s and runs
     ``perf_probe fleet-status`` (the card's memory in use is sampled with
     nvidia-smi every second throughout);
     cordons gen0 with ``perf_probe cordon`` (a preemption notice) and
     follows its drain on the manager's fleet map; then ``perf_probe
     uncordon`` and its re-admission through the health gate. The cordon
     leaves one routable server under a target of 2, so the plan may spawn
     a replacement; the re-admission puts the fleet over its target and
     the loop scales a dynamic server down (cordon, drain, commanded
     exit). Checks: 5 steps with finite losses; the plan reached 2 and the
     first spawn was dyn1; every dynamic server sent its record and exited
     0; dyn1's weights, as its first batch at a version > 0 starts, equal
     the actor the trainer published as that version (SHA-256 per tensor,
     as (r)); the cordoned gen0's outstanding leases only fell to 0 (no new
     lease), it was re-admitted at the fleet's version; no rollout
     abandoned, quota 0 at the end; K1 n_layers x prefills on every
     server, plus the launches of a prefill that raised (its request
     answered 500 and failed over), K1-K3 per MFC as in (n); no child
     left. Prints the failed prefills per server, the seconds
     from the plan to the spawn, the process start, the model built, its
     registration and admission; each server's decode ms per step and
     generated tokens/s with one server and with two; the loop's ms per
     step after the scale-up beside (o)'s; the card's memory with two
     servers and at its most, and each process's peak; the drain and
     re-admission seconds;
 (u) SFT through its entry point with automatic evaluation, every earlier
     engine and server gone: ``run_experiment`` on the port's SFTConfig
     (what ``python -m areal_tpu_torch.training.main_sft`` builds) at full
     width and 4 layers from the seed-0 HF checkpoint, on seeded records of
     prompts of 64-512 and answers of 128-768 byte tokens (the byte
     tokenizer), ``dataset.max_seqlen=1024 dataset.train_bs_n_seqs=64``
     (~40k tokens a step), 4096 tokens per micro-batch, 4 steps, a save
     every 2; ``auto_eval=true`` on a seeded 32-record math + code jsonl,
     ``max_gen_tokens=128 eval_k=4``: the launcher's evaluator scores each
     ``default/step*`` in an eval subprocess on the card beside the
     trainer, in bf16 (the generation servers' dtype). K1 is first checked
     against its plain version, as in (b), at the eval's prefill shapes
     ([16, P] for each batch's longest prompt P). The trainer holds step 3,
     outside its timing, until the launcher's evaluator has scored step 2;
     the last save's evaluation is stopped with the run, and an evaluator
     of the phase's own scores it after the run. Checks: finite loss and
     perplexity every step; K2 and K3 n_layers x micro-batches a step and
     K1 twice that; the launcher built one evaluator, on ``default``, and
     its result holds step 2 done with its scores; both saves scored with
     pass@1, pass@4 and pass^4 overall and per task kind; each eval child
     generated in bf16 and launched K1 n_layers x its prefills (4 draws x
     2 batches), as its own count says; no eval process of the phase or
     other child left. Prints ms per step, trained tokens/s, the trainer's
     and each eval child's peak memory, seconds per eval, the card's
     memory while both run (nvidia-smi every second), when step 2 was
     scored and how long the trainer waited for it;
 (v) reward-model training at full width and 4 layers: a critic-headed engine
     from the seed-0 checkpoint (its value head), 16 seeded paired records
     of 2 pairs (prompts of 32-64, answers of 64-256 byte tokens), 3
     ``RewardModelingInterface.train_step``s, then ``inference`` on the
     flattened pairs (one micro-batch, so that no pair is split). Checks:
     finite loss, grad norm > 0, orphan pairs 0, K1-K3 as in (u), a
     finite score per sequence, and one micro-batch's loss through K1-K3
     within 1% of the same micro-batch through the plain attention.
     Prints ms per step and the peak memory;
 (w) the fused node at full width and 4 layers: ``FusedForwardInterface``
     with the children ``ref_inf`` and ``rew_inf`` on a bf16 reference
     engine from the seed-0 checkpoint, on 64 seeded math trajectories of
     (o)'s shape (16 prompts x 4, 256 tokens each, the first of each group
     ending in its boxed answer), against the two children alone on the
     same batch. Checks: the fused sample's ``packed_ref_logprobs`` equal
     the lone ``ref_inf``'s bit for bit and its rewards the lone
     ``rew_inf``'s (1 for the first of each group, else 0); K1 n_layers x
     micro-batches; the pool thread's forward runs without grad mode and
     keeps no device memory. Prints the fused wall against the two serial
     walls;
 (x) the multi-turn agent: ``MathMultiTurnAgent`` (2 turns, a turn-level
     discount of 0.9, 128 tokens a turn) on 8 seeded math prompts, its
     observations answered over HTTP by one port ``GenerationServer`` on
     the seed-0 weights at 4 of 24 layers, its answers graded by the math
     environment. Checks: turn 2's prompt is turn 1's context plus the
     feedback tokens; the rewards follow the reference's discount of the
     verdicts; K1 n_layers x the server's prefills;
 (y) GPT-2 small (124M) at full width and depth (12 layers, hidden 768,
     12 heads of 64, vocab 50257, 1024 learned positions): an HF directory
     in GPT-2's own layout (fused ``c_attn``, Conv1D, tied, the
     ``transformer.`` prefix) written from seed 0 and read back through
     ``load_hf_model`` (weights equal); served in bf16 by a
     ``GenerationServer``: 8 concurrent byte-token requests (prompts of
     100-900, 64-120 new tokens, greedy and sampled; positions up to
     1019), then a request whose prompt plus budget passes 1024 answers 413
     ``prompt_too_long`` before any prefill and the server stays healthy;
     the batch's prefill logits through K1 against the plain attention
     (5% of max|logit|); one greedy request twice gives the same tokens;
     K1 n_layers x the prefills. Then three SFT ``train_step``s (bench.py's
     backend: f32 masters, bf16 compute) on 24 packed byte-token records a
     step (max_seqlen 1024, 4096 tokens per micro-batch), K2 and K3
     n_layers x the micro-batches and K1 twice that, and one micro-batch
     through K1-K3 against the plain attention (loss 1%, every grad norm,
     the position table's among them, 10%, cosine >= 0.99);
 (z) Gemma-2B at full width and 6 of its 18 layers (``GEMMA_LAYERS``;
     all 18 before the script outgrew its time limit; hidden 2048, 8 q
     heads over 1 kv head of 256, GeGLU 16384, vocab 256000): an HF
     directory in
     Gemma's layout (bf16, norm scales stored as w - 1) from seed 0, read
     through ``load_hf_model``; served in process as in (y) (no 413: RoPE);
     the server freed, SFT through ``run_experiment`` on the SFTConfig that
     ``python -m areal_tpu_torch.training.main_sft`` builds (the launcher
     spawns the trainer; f32 masters, bf16 compute and Adam moments, full
     remat): 2 steps (the first a warm-up) of 24 records (~17k tokens),
     4096 tokens per micro-batch, with ms per step, trained tokens/s, the
     trainer's peak memory and K1-K3 per step (finite losses, grad norms >
     0, the launch counts); then one micro-batch through K1-K3 against the
     plain attention on a fresh engine of those 6 layers, as in (y);
(aa) Mixture-of-Experts, every earlier engine gone: first K1 against its
     plain version (as (b)) at Qwen3-30B-A3B's heads (B=8, T=1024, 32 q
     over 4 kv heads of 128: G=8 at head_dim 128) and K2/K3 (as (f)) at
     [2, 1792], timed against SDPA. Then Qwen3-30B-A3B at full width and
     6 of its 48 layers (``MOE_SERVE_LAYERS``; hidden 2048, 128 experts
     of 768, top-8; bf16 weights made on the card from seed 0; all 48,
     then 12, before the script outgrew its time limit) served as (y) (8
     concurrent byte-token requests of 24-38 new tokens since PR 16,
     64-120 before, a 16-token greedy request twice, K1 n_layers x the
     prefills). On the same model: the batch's prefill with
     each layer's K1 output against the plain attention on that layer's own
     q, k, v (tolerance one bf16 ulp at max|plain|: 2**(floor(log2 max) -
     7); pad rows 0); the same prefill through the plain attention, whose
     last logits and top-k expert choices are reported, not gated (near
     ties of router probabilities flip under bf16 noise and the layers
     carry them); the prefill's and a 4-step decode's drop fractions (the
     reference's capacity rule: the decode routes all 8 rows, capacity
     1); prefill and decode ms and the decode's device-idle share. Then
     the MoE layer (1 x 4096 tokens, the last eighth padding, bf16 from a
     seed) at Qwen3-30B-A3B's width, at Mixtral-8x7B's (8 experts of
     14336 over hidden 4096, top-2) and at Qwen3's with capacity factor
     0.5 (it must drop): the grouped dispatch against the einsum oracle,
     forward and backward, within two bf16 ulps at each output's and
     gradient's largest magnitude (2**-7 * max|ref|), keep masks and drop
     fractions equal, pad rows of the output and of dx exactly 0. At the
     first two widths the layer's time split (router and top-k, the sort
     with its one host read, the permute, the three grouped GEMMs, the
     combine; CUDA events, launches included) and the segment loop's
     expert MLP against ``torch._grouped_mm`` on the same segments (a
     yardstick the port never calls) at 4096 tokens and at 8 decode rows.
     Then PPO actor steps as (g) at full width and 2 of the 48 layers
     (1.87 B parameters; bench.py's batch, 8 micro-batches of [2, 1792]):
     a warm-up and 2 timed steps; finite losses with ``moe_aux_total`` >
     0, grad norms > 0, the router moved, finite ``moe_*`` stats, each
     step's expert-load shares summing to 1, the ``train/moe_*`` gauges
     (``moe_ep_engaged`` 0), K2 and K3 layers x micro-batches x steps and
     K1 twice that, and one micro-batch through K1-K3 against the plain
     attention as (h). Last, an HF directory of the model cut to 2 layers in
     ``Qwen3MoeForCausalLM``'s layout from seed 0 reads back through
     ``load_hf_model`` with its config and every weight equal.
(bb) multi-GPU parallelism, part one, every earlier engine gone. First
     the mesh step: a one-rank NCCL process group
     (``parallel/distributed.py initialize(..., force=True)``) and a
     ``make_mesh(ParallelSpec())`` mesh on the card, so that the DTensor
     masters (``parallel/sharding.py`` placements), the cast-then-gather
     (the identity at degree 1) and the optimizer on local shards run;
     then (g)'s recipe, model and batch (24 layers, 8 micro-batches of
     [2, 1792]) on the mesh engine from the same seed-0 weights, one
     warm-up and 3 timed steps with the engine's phase timing on, as (g)
     ran them on the plain engine ((g)'s run is the plain one: its
     stats, its masters after the last step, copied to the host before
     (h), and its times). Checks: loss and pre-clip grad norm of every
     step within 1e-5 relative of (g)'s, every master after the last step
     within 1e-6 absolute, and in each timed step K2 and K3 launched
     n_layers x micro-batches and K1 twice that ((g) checks its own).
     Prints ms per step, fwd-bwd and optimizer ms and peak memory of
     both. At degree 1 no collective moves a byte on the card, so this
     measures the mesh machinery's cost, not a sharded step's. (Two ranks sharing the card over gloo are not run: DTensor's
     redistribute over gloo on CUDA tensors dies with SIGSEGV in torch
     2.11's functional collectives; PERF.md §7.) Then the device
     transport at full depth: a port server (bf16, seed 0) holding one
     retained KV state, and a TrainerWorker in a spawned process with a
     bf16 engine on the seed-1 weights publishing over ``device``; the
     manager's ``_update_payload`` gives the ``/update_weights`` body.
     Checks: 200 with the version, ``/health`` at it, the live weights
     equal to the published ones bit for bit, the KV store empty, greedy
     tokens equal to a fresh server's on the seed-1 weights, K1 n_layers x
     the prefills after the swap. The same publisher then publishes over
     disk and over stream, each swapped in (200) with its publish-to-reply
     seconds at the same depth. Last the gates, each 500 with the version
     and the greedy tokens unchanged: a wrong digest, a skewed version, and
     a publisher killed (SIGKILL) after its publication (v5, published
     over v4, which no consumer opened). Checks too that the trainer's
     memory drops back when a consumed publication (v1) and an unopened
     one (v4) are replaced (the IPC buffer freed). Prints each
     transport's trainer-side publish seconds and publish-to-reply seconds
     (from the publish's start to the server's reply), the consume's
     buffer open and device copy ms, and the trainer's and the server's
     memory around each swap.
(cc) multi-GPU parallelism, part two: zig-zag ring attention over ``sp``
     with K1-K3 as its block compute, and the pipeline over ``pp``, at
     Qwen2.5-0.5B's width (hidden 896, 14/2 heads of 64). Two ranks
     cannot share the card, so the ring's ranks and the pipeline's stages
     run in this one process (``RingCtx(group=None)``, ``PipeCtx(stage=
     None)``): the per-rank and per-stage code of the multi-rank path,
     rotated by re-indexing. (cc1) ring attention alone on bf16 packed
     rows [2, 7168] of four seeded documents a row and a padded tail, a
     ring of 4, both schedules: the forward against one K1 call over the
     whole rows (2^-8 of max|ref|, the merged logsumexp within 1e-3 where
     finite, -inf where not), dq, dk, dv against one K2/K3 call (2^-7),
     pad rows 0, no NaN; K1 launched n + 2n(n-1) = 28 times a forward for
     zig-zag (24 of them ``causal=False`` c x c tiles), n + n(n-1)/2 = 10
     for naive, K2 and K3 as many; ``ring_skip_ratio`` (n+1)/2n = 0.625;
     the ring's ms, each rank's body's (their sum and maximum) and one K1
     call's, and the ring's backward against one K2/K3 call; a zig-zag
     ring of 8 at the same limits, untimed (2n-1 = 15 tiles a block, each
     output rounded to bf16 before the f32 merge or sum). (cc2) and (cc3)
     run 8 of the 24 layers (``PAR_LAYERS``; 24 before the script outgrew
     its time limit). (cc2) one
     forward and backward of (g)'s PPO loss (8 layers) on a [2, 7168]
     micro-batch (trajectories of 5000, 4000, 2100 and 3000 tokens)
     through an engine with a one-process ring of 4 against a plain engine from
     the same weights: (h)'s limits on the loss, every grad norm and the
     gradient's cosine; K1 2 x 8 x 28 (forward and the "dots" recompute)
     and K2/K3 8 x 28; each engine's fwd-bwd ms and peak memory. (cc3) a
     PPO train step (8 layers, (g)'s recipe) on one [8, 1792]
     micro-batch through 4 one-process stages (2 layers a stage), which
     ``pick_pp_microbatches`` splits 8 ways, with 1F1B and with GPipe,
     against the plain engine: loss and grad norm within 1e-4 relative,
     every master within 1e-7 of the plain step's (``PP_LIMITS``, set
     between sound and faulty readings); two broken 1F1B
     runs, stage 0's gradients zeroed and one pipeline micro-batch's
     backward left out, must each break a limit; K1 16 (plain), 8 x 8 x 2
     (GPipe) and 8 x 8 x 3 (1F1B: its backward recomputes each stage
     from the saved input), K2/K3 8 (plain) and 8 x 8; then a second,
     timed step of each: ms and peak memory, 1F1B's peak below GPipe's.

 (dd) expert parallelism at Qwen3-30B-A3B's width, in one process (the
     card runs one-process EP: ``ExpertCtx(ep)``, every source and owner
     here, the exchange a re-indexing; two ranks cannot share the card).
     (dd1) the MoE layer (128 experts of 768, top-8, hidden 2048, bf16,
     seeded) on [8, 512] tokens (the last eighth of each row padding) at
     ep 4 and 8: at the capacity factor E/k (no drops) the output within
     2 bf16 ulps of the grouped dispatch's largest magnitude and the drop
     fraction 0; at the model's capacity factor and at 0.5 (which must
     drop) the keep masks and drop fraction exactly those of the einsum
     oracle run on each source's rows with capacity(N_source), the output
     within 2 ulps of it; wall and device ms of the EP and grouped
     layers, the exchange's share. (dd2) 2 of the 48 layers at full
     width, capacity factor E/k, a PPO batch of 16 trajectories of 1024
     tokens (4 micro-batches of [4, 1024]) through one engine with its
     ``_spec.ep`` at 4 and at 1 (plain): every micro-batch's loss and
     gradients from the same weights, EP's within ``EP_LIMITS`` of
     plain's (loss, each grad norm, the gradient's cosine) and a
     misrouted exchange's (two sources' buffers swapped) outside them;
     ``train/moe_ep_engaged`` 1 under EP and 0 plain; two timed steps of
     each (ms, peak memory), no drops, K2/K3 2 x 4 x 2 and K1 twice that.

 (ee) the decoupled generation fleet: a tp=2 meshed server of
     Qwen2.5-0.5B (24 layers, full width, bf16, seed 0) whose two ranks
     are processes on the one card joined over gloo (two NCCL ranks cannot
     share it; gloo's plain collectives stage the CUDA tensors through the
     host); each rank holds 7 q and 1 kv head of every layer. K1 at 7/1
     heads on [8, 1024] against its plain version and timed. (ee1) (c)'s 8
     requests (100-900 prompt tokens, 192-token budgets, greedy and
     sampled, chunks of 128) with continuations: replies well formed; K1
     24 x prefills on each rank and never the plain attention in a
     prefill; no prefill for continuations; the greedy prompts' prefill
     last logits within 5% of max|logit| of the unsharded model's and the
     first greedy tokens its argmax; each rank's KV bytes half the
     unsharded state's; prefill ms a call and decode ms a step beside
     (c)'s; each rank's device memory at rest and its peak in that
     prefill and in a 32-step greedy decode after it. (ee2) a trainer process publishes the seed-1 weights over
     ``device`` in the t2 layout (``gen_parallel_spec``,
     ``transfer_group_mb`` 16): one buffer a rank, the publish's extra
     memory at most the buffers plus one group; the swap answered 200 and
     every rank's weights bit for bit its slices of the seed-1 weights; a
     wrong digest and a wrong version each answered 500 with the weights
     and the version kept; publish-to-reply seconds beside (bb)'s. (ee3)
     the shares name the card's UUID, which each rank opens (one card: no
     copy between GPUs).

 (ff) generation servers over fsdp and pp: an f2p2 meshed server of
     Qwen2.5-0.5B (24 layers, full width, bf16, seed 0) whose four ranks
     are processes on the one card over gloo; each rank holds its stage's
     12 layers and the embedding, every tensor cut to half its fsdp
     width, gathers a layer's shards over fsdp just before it runs (the
     embedding and the head once a call), and hands its hidden state to
     the next stage through host memory. (ff1) (ee1)'s traffic and
     checks: K1 12 x prefills on each rank and never the plain attention
     in a prefill; no prefill for continuations; the greedy prefills'
     last logits bit-equal to the unsharded model's (fsdp and pp move no
     arithmetic) and the first greedy tokens its argmax; each rank's KV bytes what its layout
     implies (its stage's layers, every kv head: half the unsharded
     state's) and its parameter bytes its layout's cuts (beside what it
     would hold at fsdp 1); its memory as (ee1) reads it; prefill ms a
     call and decode ms a step beside (c)'s and (ee)'s. (ff2) (ee2)'s device
     publication into the f2p2 layout (one buffer a rank holding only its
     tensors) and its checks; every rank's swapped weights bit for bit its
     part of the seed-1 weights. (ff3) as (ee3).

The script exits 0 only when every phase passed and the last line is
printed; any failed check raises and exits 1, as does a run where
areal_tpu_torch is not beside the script. The line before the last is the
card's name and power limit, the line before that the kernels' JSON
record, and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def _torch_ships_bytecode() -> bool:
    import importlib.util

    spec = importlib.util.find_spec("torch")
    return spec is None or not spec.origin or os.path.isdir(
        os.path.join(os.path.dirname(spec.origin), "__pycache__"))


if __name__ == "__main__" and not _torch_ships_bytecode():
    # Where torch is installed without bytecode (and PYTHONDONTWRITEBYTECODE
    # is set), every process would compile torch's sources anew, seconds
    # for each process this script starts (PERF.md §5). The bytecode is
    # kept under the checkout's build/ for this process and every one it
    # starts (they inherit the environment).
    _pycache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = _pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = _pycache
    sys.dont_write_bytecode = False

if __name__ == "__mp_main__" and os.environ.get("CUDA_VISIBLE_DEVICES") == "":
    # A sandbox reward worker, spawned from this script, imports it again
    # to find its probe: it loads no torch, as under the port's own entry
    # points (``training/main_async_ppo.py``).
    torch = None
else:
    _t_import = time.monotonic()
    import torch  # noqa: E402
    IMPORT_TORCH_S = time.monotonic() - _t_import

# (j)-(o), (q3) with (p), (r), (s) and (u)-(x) run at this many of the
# model's layers (full width)
CUT_LAYERS = 4
# (t) runs at this many: at 4 its loop ends before the autoscaler's second
# server is given work
ELASTIC_LAYERS = 8
# (z) runs Gemma-2B at this many of its 18 layers, and (aa) serves
# Qwen3-30B-A3B at this many of its 48 (full width)
GEMMA_LAYERS = 6
MOE_SERVE_LAYERS = 6
# (cc2) and (cc3) run Qwen2.5-0.5B at this many of its 24 layers (full
# width; 2 a pipeline stage)
PAR_LAYERS = 8
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = False) -> float:
    """Milliseconds per call of `fn` between CUDA events. With `queued`, the
    timed calls are enqueued behind a ~25 ms device-side sleep, so kernels
    shorter than their host launch path (tens of microseconds) run back to
    back and the events time the device, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(50_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log: str) -> list:
    """(kernel, type, head_dim, spill-store bytes, registers) of every
    kernel instance in an `nvcc -Xptxas -v` log."""
    out = []
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes "
                         r"spill stores.*?Used (\d+) registers", log, re.S):
        name = m.group(1)
        kernel = re.search(r"(flash_(?:fwd|bwd)[a-z_]*?_kernel)I", name)
        dtype = ("bf16" if "__nv_bfloat16" in name else
                 "fp16" if "6__half" in name else "f32")
        dim = re.search(r"Li(\d+)E", name)
        out.append((kernel.group(1) if kernel else name, dtype,
                    int(dim.group(1)) if dim else None, int(m.group(2)),
                    int(m.group(3))))
    return out


# ---------------- (b) K1 against its plain version ----------------

def packed_inputs(B, T, Hq, Hkv, D, seed, device: str = "cuda"):
    """bf16 q/k/v on the card and int32 segment ids with several packed
    documents per row and a padded tail (pad rows have segment 0)."""
    gen = torch.Generator().manual_seed(seed)
    seg = torch.zeros(B, T, dtype=torch.int32)
    for b in range(B):
        pad = int(torch.randint(0, T // 8, (1,), generator=gen))
        cuts = sorted(torch.randint(1, T - pad, (3,), generator=gen).tolist())
        edges = [0] + cuts + [T - pad]
        for i in range(4):
            seg[b, edges[i]:edges[i + 1]] = i + 1
    q = torch.randn(B, T, Hq, D, generator=gen)
    k = torch.randn(B, T, Hkv, D, generator=gen)
    v = torch.randn(B, T, Hkv, D, generator=gen)
    dev = torch.device(device)
    return ([x.to(dev, torch.bfloat16) for x in (q, k, v)], seg.to(dev))


def check_k1(fa, B, T, Hq, Hkv, D, seed) -> dict:
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    out, lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            seg, seg)
    err = (out.float() - ref).abs().max().item()
    tol = 2.0 ** -8 * ref.abs().max().item()
    pad = seg == 0
    fin = torch.isfinite(ref_lse)
    lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
    rec = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=err, tol=tol,
               lse_max_abs_err=lse_err, pad_rows=int(pad.sum()))
    print("K1 check", json.dumps(rec), flush=True)
    check(not torch.isnan(out).any().item(), f"K1 NaN at {rec}")
    check(err <= tol, f"K1 disagrees with its plain version: {rec}")
    check(bool((out[pad] == 0).all().item()), f"K1 pad rows not 0: {rec}")
    check(torch.equal(torch.isfinite(lse), fin) and lse_err <= 1e-4,
          f"K1 logsumexp disagrees: {rec}")
    return rec


def kept_mask(seg):
    """[B, T, T] bool: the (row, column) pairs the kernels keep."""
    T = seg.shape[1]
    keep = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
    return keep & torch.ones(T, T, dtype=torch.bool, device=seg.device).tril()


def bound(flops: int, nbytes: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def k1_record(fa, B, T, Hq=14, Hkv=2, D=64, seed=0) -> dict:
    """Times at one shape, and the bound of the same work."""
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg),
                        queued=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg),
                       queued=True)
    keep = kept_mask(seg)
    pairs = int(keep.sum())  # (row, column) pairs this data needs, per head
    flops = 4 * D * Hq * pairs  # q.k and p.v, 2 flops per multiply-add
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) \
        + 4 * 2 * seg.numel() + 4 * B * Hq * T  # q,k,v,o bf16; segs; lse
    # The yardstick: one PyTorch call of the same function (the port never
    # calls it). Its rows with no valid key come out NaN; only timed.
    mask = keep[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), queued=True)
    return dict(B=B, T=T, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound(flops, nbytes))


# ---------------- (f) K2 and K3 against their plain version ----------------

def bwd_inputs(fa, B, T, Hq, Hkv, D, seed):
    """q, k, v, segment ids, K1's out and lse, and a random dO (bf16)."""
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed)
    out, lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=gen).to("cuda", torch.bfloat16)
    return q, k, v, seg, out, lse, dout


def check_bwd(fa, B, T, Hq, Hkv, D, seed) -> dict:
    q, k, v, seg, out, lse, dout = bwd_inputs(fa, B, T, Hq, Hkv, D, seed)
    got = fa.flash_attention_bwd(q, k, v, seg, seg, out, lse, dout)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), seg,
                                       seg, out.float(), lse, dout.float())
    pad = seg == 0
    rec = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, pad_rows=int(pad.sum()))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - b).abs().max().item()
        tol = 2.0 ** -7 * b.abs().max().item()
        rec[f"{name}_max_abs_err"], rec[f"{name}_tol"] = err, tol
        check(not torch.isnan(a).any().item(), f"{name} NaN at {rec}")
        check(err <= tol, f"{name} disagrees with the plain backward: {rec}")
        check(bool((a[pad] == 0).all().item()), f"{name} pad rows not 0: {rec}")
    print("K2/K3 check", json.dumps(rec), flush=True)
    return rec


def kernel_tile_pairs(fa, seg, D: int) -> dict:
    """(executed, causal-walk) tile pairs per head of K1, K2 and K3 at head
    dim D, each at its own (q, kv) tile sizes (``fa.tile_sizes``): the
    segment-range skip at work."""
    return {name: fa.tile_pairs(seg, seg, True, *blocks)
            for name, blocks in fa.tile_sizes(D).items()}


def bwd_records(fa, B=2, T=1792, Hq=14, Hkv=2, D=64, seed=0) -> dict:
    """Times of K2, K3, the plain backward and SDPA's backward at one shape,
    with each kernel's bound."""
    q, k, v, seg, out, lse, dout = bwd_inputs(fa, B, T, Hq, Hkv, D, seed)
    scale = D ** -0.5
    di = fa.backward_di(out, dout)
    args = (q, k, v, seg, seg, dout, lse, di, True, scale)
    k3_ms = cuda_ms(lambda: fa.launch_bwd_dq(*args), queued=True)
    k2_ms = cuda_ms(lambda: fa.launch_bwd_dkv(*args), queued=True)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, seg, seg, out, lse, dout), iters=5, warmup=1, queued=True)
    keep = kept_mask(seg)
    pairs = Hq * int(keep.sum())  # kept pairs over all q heads
    qkv = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, dO, k, v in bf16
    rows = 4 * 2 * B * Hq * T + 4 * 2 * seg.numel()  # lse, di; segment ids
    k2 = bound(4 * 2 * D * pairs, qkv + rows + 2 * (k.numel() + v.numel()))
    k3 = bound(3 * 2 * D * pairs, qkv + rows + 2 * q.numel())
    # The yardstick: SDPA's backward over the same bool mask (the port never
    # calls it; its fully masked rows are NaN, so it is only timed).
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep[:, None], enable_gqa=True)
    g = dout.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), g, retain_graph=True), queued=True)
    tiles = kernel_tile_pairs(fa, seg, D)
    check(tiles["k3"][0] < tiles["k3"][1],
          f"K3 executes no fewer tile pairs than the causal walk: {tiles}")
    return {"B": B, "T": T, "plain_bwd_ms": plain_ms,
            "sdpa_bwd_ms": library_ms,
            "tile_pairs_executed_vs_causal": tiles,
            "flash_attention_bwd_dkv": dict(kernel_ms=k2_ms, **k2),
            "flash_attention_bwd_dq": dict(kernel_ms=k3_ms, **k3)}


# ---------------- (c) the slice ----------------

def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def check_reply(r: dict, n: int, eos: int, what: str) -> None:
    ids, lps = r["output_ids"], r["output_logprobs"]
    check(len(ids) == len(lps), f"{what}: ids/logprobs lengths differ")
    if r["finished"]:
        check(0 < len(ids) <= n and ids[-1] == eos, f"{what}: bad EOS reply")
    else:
        check(len(ids) == n, f"{what}: {len(ids)} tokens, expected {n}")
    lp = torch.tensor(lps, dtype=torch.float64)
    check(bool(torch.isfinite(lp).all()) and bool((lp <= 0).all()),
          f"{what}: logprobs not finite and <= 0")


def run_slice(fa, cfg, params, eos):
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=128, eos_token_id=eos,
                               pad_token_id=eos, batch_window_ms=20),
        cfg, params,
    )
    url = server.start()
    try:
        gen = torch.Generator().manual_seed(1)
        lens = [100, 231, 377, 456, 598, 640, 777, 900]
        prompts = [torch.randint(0, eos, (n,), generator=gen).tolist()
                   for n in lens]
        gconfigs = [{"greedy": True} if i % 2 == 0 else
                    {"temperature": 0.7 + 0.1 * i, "top_p": 0.9}
                    for i in range(len(prompts))]
        budget, chunk = 192, 128

        fa.reset_launch_count()
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            first = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i], "gconfig": gconfigs[i],
                "max_tokens": budget, "rid": f"r{i}"}), range(len(prompts))))
        for i, r in enumerate(first):
            check_reply(r, chunk, eos, f"request {i}")
        s1 = server.stats()
        check(s1["prefill_calls"] >= 1, "no prefill ran")
        check(fa.launch_count() == cfg.n_layers * s1["prefill_calls"],
              f"K1 launches {fa.launch_count()} != {cfg.n_layers} x "
              f"{s1['prefill_calls']} prefills")
        open_rows = [i for i, r in enumerate(first) if not r["finished"]]
        check(server.kv.count == len(open_rows), "retained states missing")
        print(f"first chunks: {len(first)} replies, {s1['prefill_calls']} "
              f"prefills, K1 launches {fa.launch_count()} = {cfg.n_layers} "
              f"per prefill, {server.kv.count} states retained", flush=True)

        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            cont = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i] + first[i]["output_ids"],
                "gconfig": gconfigs[i], "max_tokens": budget - chunk,
                "rid": f"r{i}", "tokens_done": chunk}), open_rows))
        for i, r in zip(open_rows, cont):
            check_reply(r, budget - chunk, eos, f"continuation {i}")
        s2 = server.stats()
        check(s2["prefill_calls"] == s1["prefill_calls"]
              and s2["prefill_tokens"] == s1["prefill_tokens"],
              "a continuation re-prefilled instead of reusing its KV")
        check(fa.launch_count() == cfg.n_layers * s1["prefill_calls"],
              "K1 launched during continuations")
        print(f"continuations: {len(cont)} replies from retained KV, "
              f"prefills still {s2['prefill_calls']}, K1 launches still "
              f"{fa.launch_count()}", flush=True)

        greedy = {"prompt_ids": prompts[3], "gconfig": {"greedy": True},
                  "max_tokens": 64}
        a, b = post(url, greedy), post(url, greedy)
        check(a["output_ids"] == b["output_ids"],
              "a repeated greedy request gave other tokens")
        wall = time.monotonic() - t0
        stats = server.stats()
        check(fa.launch_count() == cfg.n_layers * stats["prefill_calls"],
              "K1 launches != n_layers per prefill")
        launches = fa.launch_count()
    finally:
        server.stop()
    return stats, launches, wall, prompts


def time_breakdown(genmod, model, toks, lens, S, eos, steps: int = 16) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.ops.sampling import sampling_from_gconfigs

    B, dev = toks.shape[0], toks.device
    state = genmod.prefill_state(model, toks, lens, S)
    prefill_ms = cuda_ms(lambda: genmod.prefill_state(model, toks, lens, S),
                         iters=3, warmup=1)
    sampling = sampling_from_gconfigs(
        [GenerationHyperparameters(temperature=0.9, top_p=0.9)] * B, device=dev)
    done = torch.zeros(B, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def decode():  # on a copy: decode_chunk_rows owns and updates its state
        return genmod.decode_chunk_rows(model, genmod.stack_states([state]),
                                        done, gen, sampling, steps, eos, eos)

    decode_ms = cuda_ms(decode, iters=2, warmup=1) / steps

    def device_events(fn):
        # device activity only, as in trainer_breakdown: an MoE decode's
        # host-side events (~15,000 kernels a step) took ~a minute to
        # collect
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    pre = device_events(lambda: genmod.prefill_state(model, toks, lens, S))
    pre_us = sum(e.device_time for e in pre)
    k1_us = sum(e.device_time for e in pre if "flash_fwd" in e.name)
    dec = device_events(decode)
    dec_ms = sum(e.device_time for e in dec) / 1e3 / steps
    return {
        "B": B, "P": toks.shape[1], "prefill_ms": prefill_ms,
        "prefill_device_ms": pre_us / 1e3, "k1_share_of_prefill": k1_us / pre_us,
        "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": dec_ms,
        "decode_device_idle_share": 1 - dec_ms / decode_ms,
        "decode_kernels_per_step": len(dec) / steps,
    }


# ---------------- (g) the train slice ----------------

def bench_batch(vocab: int):
    """bench.py's PPO batch (bench.py:98-124): 32 trajectories of ~250
    prompt + ~640 generated tokens, drawn in bench.py's order."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.base.testing import bench_trajectory_dist

    n_seq = 32
    rng, plens, glens = bench_trajectory_dist(0, n_seq)
    seqlens = (plens + glens).astype(int)
    total = int(seqlens.sum())
    toks = rng.randint(2, vocab, total).astype(np.int32)
    pmask, lps = [], []
    for p, g in zip(plens, glens):
        pmask.append(np.concatenate([np.ones(p, np.int32), np.zeros(g, np.int32)]))
        lps.append(np.concatenate([np.zeros(p, np.float32),
                                   -rng.rand(g).astype(np.float32)]))
    return SequenceSample.from_default(
        ids=[f"b{i}" for i in range(n_seq)],
        data={
            "packed_input_ids": toks,
            "prompt_mask": np.concatenate(pmask),
            "packed_logprobs": np.concatenate(lps),
            "rewards": rng.rand(n_seq).astype(np.float32),
            "seq_no_eos_mask": np.zeros(n_seq, np.float32),
        },
        seqlens=seqlens.tolist(),
    )


def make_model(name: str, cfg, params, train: bool = True,
               device: str = "cuda", parallel_spec=None):
    """A Model on bench.py's backend settings (bench.py:56-96): bf16
    compute, f32 masters and AdamW lr 1e-5 with bf16 moments when
    training, "dots" remat, log-prob chunks of 512. Without ``train``, an
    inference engine that keeps ``params`` as they are. ``parallel_spec``
    puts the engine on a mesh over the current process group."""
    from areal_tpu_torch.api.model import FinetuneSpec, Model, make_backend
    from areal_tpu_torch.api.train_config import OptimizerConfig
    from areal_tpu_torch.backend import torch_train  # noqa: F401 (registry)

    backend = make_backend(
        "torch_train" if train else "torch_inference",
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.0,
                                  mu_dtype="bfloat16", nu_dtype="bfloat16"),
        device=device, compute_dtype="bfloat16", length_bucket=512,
        rows_bucket=4, seqs_bucket=16, remat="dots", logprob_chunk=512,
        parallel_spec=parallel_spec,
    )
    return backend.initialize(Model(name, (cfg, params)),
                              FinetuneSpec(1, 512, 64))


def build_trainer(cfg, parallel_spec=None, device: str = "cuda",
                  sp: int = 1, pp: int = 1):
    """bench.py's backend and PPO recipe (bench.py:56-96) on the port.
    ``sp`` / ``pp`` above 1 (no mesh): the engine runs a ring of ``sp``
    ranks and a pipeline of ``pp`` stages in this one process, every rank
    and stage on the card (its ``_spec``; no setting selects them)."""
    from areal_tpu_torch.algorithms.ppo import (
        PPOActorInterface,
        PPOHyperparameters,
    )
    from areal_tpu_torch.models.transformer import init_params

    params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    model = make_model("actor", cfg, params, device=device,
                       parallel_spec=parallel_spec)
    del params  # the engine holds f32 masters
    if sp > 1 or pp > 1:
        from areal_tpu_torch.parallel.mesh import ParallelSpec

        model.module._spec = ParallelSpec(sp=sp, pp=pp)
    hp = PPOHyperparameters(ppo_n_minibatches=1, adv_norm=True, kl_ctl=0.0,
                            disable_value=True)
    return model, PPOActorInterface(hp)


def run_train_slice(fa, cfg, model, iface, batch, spec, steps: int = 3) -> dict:
    from areal_tpu_torch.backend import microbatch as mbu

    eng = model.module
    mbs = mbu.split_into_microbatches(
        batch, spec, length_bucket=eng.length_bucket,
        rows_bucket=eng.rows_bucket, seqs_bucket=eng.seqs_bucket)
    n_mbs, shape, fill = len(mbs), mbs[0].layout.shape, mbu.pack_fill(mbs)
    check(n_mbs == 8 and shape == (2, 1792),
          f"packer gave {n_mbs} micro-batches of {shape}, expected 8 of (2, 1792)")
    tokens = int(batch.total_lens().sum())
    # The tile pairs K1-K3 execute on these micro-batches (per head and
    # layer) against the causal walk's.
    tiles = [kernel_tile_pairs(fa, torch.from_numpy(mb.grids["segment_ids"]),
                               cfg.head_dim) for mb in mbs]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = iface.train_step(model, batch, spec)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    watch = ["embedding.weight", "layers.0.wq.weight", "layers.23.w_down.weight"]
    before = {n: eng.params[n].detach().clone() for n in watch}
    eng.time_phases = True
    fa.reset_launch_count()
    stats, phases = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        stats.append(iface.train_step(model, batch, spec))
        phases.append(eng.last_phase_secs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launch_counts()
    eng.time_phases = False
    moved = {n: (eng.params[n].detach() - before[n]).abs().max().item()
             for n in watch}
    per = cfg.n_layers * n_mbs * steps
    rec = {
        "n_mbs": n_mbs, "mb_shape": list(shape), "pack_fill": fill,
        "tile_pairs_executed_vs_causal": {
            kern: [sum(t[kern][0] for t in tiles), sum(t[kern][1] for t in tiles)]
            for kern in tiles[0]},
        "tokens_per_step": tokens, "steps": steps,
        "trained_tokens_per_s": steps * tokens / wall,
        "ms_per_step": 1e3 * wall / steps, "warmup_step_s": warm_s,
        "fwd_bwd_ms": 1e3 * sum(p["fwd_bwd"] for p in phases) / steps,
        "optimizer_ms": 1e3 * sum(p["optimizer"] for p in phases) / steps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "launches_expected_k2_k3": per,
        "loss": [s["actor_loss"] for s in stats],
        "grad_norm": [s["grad_norm"] for s in stats],
        "importance_weight": [s["importance_weight"] for s in stats],
        "warmup_loss": warm["actor_loss"], "param_max_abs_change": moved,
        # (bb)'s plain engine: the mesh engine runs this recipe again
        "baseline": {
            "warm": warm, "stats": stats, "n_mbs": n_mbs,
            "ms_per_step": 1e3 * wall / steps,
            "fwd_bwd_ms": 1e3 * sum(p["fwd_bwd"] for p in phases) / steps,
            "optimizer_ms": 1e3 * sum(p["optimizer"] for p in phases) / steps,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "masters": {n: t.cpu() for n, t in eng.full_params().items()}},
    }
    for s in stats:
        check(math.isfinite(s["actor_loss"]) and math.isfinite(s["grad_norm"])
              and s["grad_norm"] > 0, f"bad train stats {s}")
        check(s["n_ppo_steps"] == 1.0 and s["lr"] == 1e-5,
              f"unexpected step {s}")
    check(all(v > 0 for v in moved.values()), f"parameters did not move: {moved}")
    check(launches["flash_attention_bwd_dkv"] == per
          and launches["flash_attention_bwd_dq"] == per,
          f"K2/K3 launches {launches} != {per} "
          f"({cfg.n_layers} layers x {n_mbs} micro-batches x {steps} steps)")
    check(launches["flash_attention_fwd"] == 2 * per,
          f"K1 launches {launches['flash_attention_fwd']} != 2 x {per} "
          "(forward + the remat recompute)")
    return rec


# ---------------- (h) the backward through K1-K3 vs plain attention ----------------

def compare_grads(eng, ub, loss_fn, mb: int, weight: float, what: str,
                  null_grads=()) -> dict:
    """Micro-batch ``mb``'s loss and per-parameter grad norms through
    K1-K3 against the same micro-batch through the plain attention, on the
    card: loss within 1%, each grad norm within 10%, gradient cosine >=
    0.99 (the plain attention rounds scores and probabilities to bf16, the
    kernels keep scores in f32 and round only P and dS before their
    products, and the layers carry the difference forward and back).
    Parameters whose names end in one of ``null_grads`` have a gradient of
    0 in exact arithmetic, so both runs hold only rounding there: each is
    held to 1e-3 of the whole gradient's norm instead of a ratio."""
    res = {}
    for impl in ("auto", "reference"):
        eng.attn_impl = impl
        loss, stats = eng.accumulate_grads(ub, loss_fn, [mb], [weight])
        res[impl] = (float(loss), stats, {n: p.grad.detach().clone()
                                          for n, p in eng.params.items()})
        for p in eng.params.values():
            p.grad = None
    eng.attn_impl = "auto"
    (l_k, st_k, g_k), (l_r, st_r, g_r) = res["auto"], res["reference"]
    rec = grad_agreement(what, l_k, g_k, l_r, g_r, null_grads)
    rec.update(micro_batch=mb,
               micro_batch_shape=list(ub.mbs[mb].layout.shape),
               stats=(st_k, st_r))
    return rec


def grad_agreement(what: str, l_k: float, g_k: dict, l_r: float, g_r: dict,
                   null_grads=()) -> dict:
    """(h)'s limits on a loss and gradients (``g_k``) against the plain
    attention's (``g_r``): see :func:`compare_grads`."""
    norm = {n: (g_k[n].norm().item(), g_r[n].norm().item()) for n in g_r}
    dot = sum((g_k[n].double() * g_r[n].double()).sum().item() for n in g_r)
    nk = math.sqrt(sum(a * a for a, _ in norm.values()))
    nr = math.sqrt(sum(b * b for _, b in norm.values()))
    null = {n: v for n, v in norm.items() if n.endswith(tuple(null_grads))}
    rel = {n: abs(a - b) / max(b, 1e-30) for n, (a, b) in norm.items()
           if n not in null}
    worst = max(rel, key=rel.get)
    rec = {"loss_kernels": l_k, "loss_plain": l_r,
           "loss_rel_err": abs(l_k - l_r) / max(abs(l_r), 1e-30),
           "grad_norm_kernels": nk, "grad_norm_plain": nr,
           "grad_cosine": dot / max(nk * nr, 1e-300),
           "max_grad_norm_rel_err": rel[worst], "worst_param": worst}
    if null:
        rec["key_bias_grad_norm_max"] = max(max(v) for v in null.values())
    if "pos_embedding.weight" in norm:
        rec["pos_embedding_grad_norm"] = norm["pos_embedding.weight"]
        rec["pos_embedding_grad_norm_rel_err"] = rel["pos_embedding.weight"]
    check(all(math.isfinite(x) for x in (l_k, nk)) and nk > 0,
          f"{what}: non-finite loss or grads, or no gradient at all")
    check(rec["loss_rel_err"] <= 0.01, f"{what}: loss through K1-K3 "
          f"disagrees: {rec}")
    check(rec["max_grad_norm_rel_err"] <= 0.1, f"{what}: a grad norm "
          f"disagrees: {rec}")
    check(rec["grad_cosine"] >= 0.99, f"{what}: grad directions disagree: "
          f"{rec}")
    check(rec.get("key_bias_grad_norm_max", 0.0) <= 1e-3 * nr,
          f"{what}: a key bias has a gradient: {null}")
    return rec


def compare_attention_impls(model, iface, batch, spec) -> dict:
    """(h): :func:`compare_grads` on the PPO micro-batch with the most
    positive-advantage tokens: with random weights every ratio is far
    below 1 - eps_clip, so only tokens with a positive advantage carry a
    gradient."""
    from areal_tpu_torch.algorithms.ppo import _action_token_weight

    eng = model.module
    ub = eng.upload_uniform(batch, spec)
    eng.run_prep(ub, iface._prep_fn, scalars={"kl_coef": 0.0})
    positive = (ub.grids["advantages"] > 0).reshape(ub.n_mbs, -1).sum(-1)
    mb = int(positive.argmax())
    rec = compare_grads(eng, ub, iface._loss_fn, mb,
                        _action_token_weight(ub.mbs[mb]), "(h)")
    st_k, st_r = rec.pop("stats")
    rec.update(positive_advantage_tokens=int(positive[mb]),
               importance_weight_sum_kernels=float(
                   st_k["importance_weight_sum"]),
               importance_weight_sum_plain=float(
                   st_r["importance_weight_sum"]))
    print("train micro-batch K1-K3 vs plain attention", json.dumps(rec),
          flush=True)
    return rec


# ---------------- (i) where the time goes in one train step ----------------

KERNEL_CLASSES = (
    # flash_fwd_kernel (f32) / flash_fwd_mma_kernel; flash_bwd_dkv_kernel
    # (f32) / flash_bwd_dkv_mma_kernel + flash_bwd_dkv_reduce_kernel
    ("K1", ("flash_fwd",)),
    ("K2", ("flash_bwd_dkv",)),
    ("K3", ("flash_bwd_dq",)),
    # cuBLAS's kernels on Hopper: nvjet_* (CUDA 12.8), else *gemm*/cutlass
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
)


def train_breakdown(model, iface, batch, spec, step_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    # device activity only, as in trainer_breakdown: the step's host-side
    # events take longer to collect than the step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iface.train_step(model, batch, spec)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time for e in events)
    shares = dict.fromkeys([c for c, _ in KERNEL_CLASSES] + ["rest"], 0.0)
    launches = dict.fromkeys(shares, 0)
    by_name: dict = {}
    for e in events:
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(key in name for key in keys)), "rest")
        shares[cls] += e.device_time
        launches[cls] += 1
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    device_ms = total_us / 1e3
    for cls in ("K1", "K2", "K3"):
        check(shares[cls] > 0, f"{cls} shows no device time in the profile: "
              f"a kernel name is missing from KERNEL_CLASSES ({top})")
    return {
        "device_ms_per_step": device_ms, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms,
        "device_idle_share": 1 - device_ms / step_ms,
        "kernels_per_step": len(events),
        "shares": {k: v / total_us for k, v in shares.items()},
        "device_ms": {k: v / 1e3 for k, v in shares.items()},
        "launches": launches,
        "top_kernels_ms": [(n, t / 1e3) for n, t in top],
    }


# ---------------- (j)-(l) the trainer's model functions ----------------

KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                "flash_attention_bwd_dq")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Trainer:
    """The five model functions of the async-PPO recipe
    (experiments/ppo_math_exp.py:111 build_dfg with the README's
    ``ppo.use_decoupled_loss=true group_size=16`` and the other
    PPOHyperparameters at their defaults: kl_ctl 0.1, a critic, 4 PPO
    minibatches, advantage whitening) on three engines: the actor and the
    critic (f32 masters, bf16 moments) and the reference policy (bf16, no
    optimizer). Every call goes through ``mfc``, which times it and reads
    K1-K3's launches around it."""

    ORDER = ("ref_inf", "actor_inf", "critic_inf", "actor_train",
             "critic_train")

    def __init__(self, fa, cfg, device="cuda"):
        from areal_tpu_torch.algorithms.ppo import (
            LogprobInterface,
            PPOActorInterface,
            PPOCriticInterface,
            PPOHyperparameters,
        )
        from areal_tpu_torch.models.transformer import init_params

        self.fa, self.device = fa, device
        params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
        # The reference engine keeps these bf16 tensors; the actor copies
        # them into f32 masters.
        self.ref = make_model("ref", cfg, params, train=False, device=device)
        self.actor = make_model("actor", cfg, params, device=device)
        del params
        ccfg = dataclasses.replace(cfg, is_critic=True)
        # The critic's trunk draws the actor's seed-0 numbers, its value
        # head the next ones (init_params draws in module order).
        self.critic = make_model("critic", ccfg, init_params(
            ccfg, seed=0, device=device, dtype=torch.bfloat16), device=device)
        self.hp = PPOHyperparameters(use_decoupled_loss=True, group_size=16)
        self.ref_iface = LogprobInterface()
        self.actor_iface = PPOActorInterface(self.hp)
        self.critic_iface = PPOCriticInterface(self.hp)
        self.group_iface = PPOActorInterface(
            dataclasses.replace(self.hp, group_adv_norm=True))
        self.launches = dict.fromkeys(KERNEL_NAMES, 0)
        # Every optimizer step's stats, in order (train_batch runs through
        # train_uniform).
        self.steps = []
        eng = self.actor.module
        train_uniform = eng.train_uniform
        eng.train_uniform = lambda *a, **k: self.steps.append(
            train_uniform(*a, **k)) or self.steps[-1]

    def mfc(self, fn, *args):
        """(result, seconds, K1-K3 launches) of one call; the launches also
        add up into ``self.launches``, the trainer path's count."""
        self.fa.reset_launch_count()
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        secs = time.perf_counter() - t0
        counts = {k: self.fa.launch_counts()[k] for k in KERNEL_NAMES}
        for k, v in counts.items():
            self.launches[k] += v
        return out, secs, counts

    def step(self, batch, spec):
        """One trainer step in DFG order; (stats, data, seconds and
        launches per MFC)."""
        from areal_tpu_torch.algorithms.ppo import attach_keys

        ref, t_ref, l_ref = self.mfc(self.ref_iface.inference, self.ref,
                                     batch, spec)
        prox, t_prox, l_prox = self.mfc(self.actor_iface.inference,
                                        self.actor, batch, spec)
        vals, t_val, l_val = self.mfc(self.critic_iface.inference,
                                      self.critic, batch, spec)
        data = attach_keys(batch, {**ref.data, **prox.data, **vals.data})
        a, t_a, l_a = self.mfc(self.actor_iface.train_step, self.actor, data,
                               spec)
        c, t_c, l_c = self.mfc(self.critic_iface.train_step, self.critic,
                               data, spec)
        secs = dict(zip(self.ORDER, (t_ref, t_prox, t_val, t_a, t_c)))
        launches = dict(zip(self.ORDER, (l_ref, l_prox, l_val, l_a, l_c)))
        return {"actor": a, "critic": c}, data, secs, launches


def n_micro_batches(eng, sample, spec, k=None) -> int:
    """How many micro-batches the engine packs ``sample`` into; with ``k``,
    summed over the sample's k PPO minibatches (the train_batch path)."""
    from areal_tpu_torch.backend import microbatch as mbu

    parts = sample.split(k=k)[0] if k else [sample]
    return sum(len(mbu.split_into_microbatches(
        p, spec, length_bucket=eng.length_bucket, rows_bucket=eng.rows_bucket,
        seqs_bucket=eng.seqs_bucket, fill_bucket=eng.fill_bucket))
        for p in parts if p.bs)


def trainer_batch(vocab: int):
    """bench_batch's 32 trajectories regrouped as 2 prompts x 16 samples,
    generated at version 0."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    b = bench_batch(vocab)
    return SequenceSample.from_default(
        ids=b.ids, data={**b.data, "version_start": np.zeros(b.bs, np.int32)},
        seqlens=b.total_lens().tolist(),
        metadata={"group": [f"p{i // 16}" for i in range(b.bs)]})


def check_launches(name: str, counts: dict, n_mbs: int, layers: int,
                   train: bool) -> None:
    want = {"flash_attention_fwd": (2 if train else 1) * layers * n_mbs,
            "flash_attention_bwd_dkv": layers * n_mbs if train else 0,
            "flash_attention_bwd_dq": layers * n_mbs if train else 0}
    check(counts == want, f"{name}: K1-K3 launches {counts}, expected {want} "
          f"({layers} layers x {n_mbs} micro-batches)")


def check_train_stats(name: str, st: dict, loss_key: str) -> None:
    check(math.isfinite(st[loss_key]) and math.isfinite(st["grad_norm"])
          and st["grad_norm"] > 0, f"{name}: bad stats {st}")


def recompute_first_minibatch(tr, data, spec) -> dict:
    """The group step's first PPO minibatch (``data.split``, as its
    train_step splits it), its logprobs recomputed by ``engine.forward``,
    which packs it as ``train_batch`` does, with the weights unchanged;
    against actor_inf's prox logprobs, which packed the whole batch, on the
    same action tokens. Returns the largest difference and the importance
    weight the recompute gives."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import _logprob_hook

    mb = data.split(k=min(tr.hp.ppo_n_minibatches, data.bs))[0][0]
    got = np.concatenate(tr.actor.module.forward(mb, spec,
                                                 post_hook=_logprob_hook))
    prox = np.asarray(mb.data["prox_logprobs"])
    lens = mb.total_lens()
    doc_first = np.zeros(len(prox), bool)
    doc_first[np.cumsum(lens) - lens] = True
    action = (np.asarray(mb.data["prompt_mask"]) == 0) & ~doc_first
    d = (got - prox)[action].astype(np.float64)
    return {"sequences": mb.bs, "action_tokens": int(action.sum()),
            "max_abs_diff": float(np.abs(d).max()),
            "tokens_differing": int((d != 0).sum()),
            "importance_weight": float(np.exp(d).mean())}


def run_trainer(fa, cfg, batch, spec, device="cuda", steps: int = 2):
    """(j): one warm-up and ``steps`` timed trainer steps, then one actor
    step with group_adv_norm (the host advantage path through
    train_batch), with the checks of chip_smoke's docstring."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import attach_keys

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(fa, cfg, device)
    build_s = time.perf_counter() - t0
    act, crit, ref = tr.actor.module, tr.critic.module, tr.ref.module
    # Behaviour logprobs := the reference policy's, so the importance
    # ratios start at 1 and the decoupled loss has a real gradient.
    ref_lp, _, _ = tr.mfc(tr.ref_iface.inference, tr.ref, batch, spec)
    batch = attach_keys(batch, {
        "packed_logprobs": ref_lp.data["packed_ref_logprobs"]})
    n_inf = n_micro_batches(ref, batch, spec)
    expect_mbs = {"ref_inf": n_inf, "actor_inf": n_inf, "critic_inf": n_inf,
                  "actor_train": expected_micro_batches(
                      tr.actor, tr.actor_iface, batch, spec, "train_step"),
                  "critic_train": expected_micro_batches(
                      tr.critic, tr.critic_iface, batch, spec, "train_step")}
    watch = ["embedding.weight", "layers.0.wq.weight",
             f"layers.{cfg.n_layers - 1}.w_down.weight"]
    before = {m: {n: e.params[n].detach().clone() for n in watch}
              for m, e in (("actor", act), ("critic", crit))}
    before["critic"]["value_head.weight"] = \
        crit.params["value_head.weight"].detach().clone()

    records = []
    for i in range(1 + steps):
        n_opt = len(tr.steps)
        t0 = time.perf_counter()
        stats, data, secs, launches = tr.step(batch, spec)
        wall = time.perf_counter() - t0
        if i == 0:
            prox = data.data["prox_logprobs"]
            refd = data.data["packed_ref_logprobs"]
            diff = float(np.abs(prox - refd).max())
            print("trainer: prox_logprobs vs packed_ref_logprobs before the "
                  f"first actor_train: max |diff| {diff}", flush=True)
            check(np.array_equal(prox, refd), "prox_logprobs != "
                  "packed_ref_logprobs before any update (same bf16 weights, "
                  "same packing, deterministic kernels)")
            first = tr.steps[n_opt]
            iw = first["importance_weight_sum"] / max(first["n_action_tokens"], 1)
            print(f"trainer: first actor minibatch importance weight {iw}",
                  flush=True)
            check(abs(iw - 1) <= 0.02, f"first importance weight {iw} not "
                  "within 2% of 1")
        check_train_stats("actor_train", stats["actor"], "actor_loss")
        check_train_stats("critic_train", stats["critic"], "critic_loss")
        check(stats["actor"]["n_ppo_steps"] == tr.hp.ppo_n_minibatches,
              f"actor early-stopped: {stats['actor']}")
        check(math.isfinite(stats["critic"]["value_mean"])
              and math.isfinite(stats["critic"]["value_var"]),
              f"critic moments not finite: {stats['critic']}")
        for name in Trainer.ORDER:
            check_launches(name, launches[name], expect_mbs[name],
                           cfg.n_layers, train=name.endswith("train"))
        records.append({"wall_s": wall, "secs": secs, "launches": launches,
                        "actor": stats["actor"], "critic": stats["critic"]})
    moved = {m: {n: (e.params[n].detach() - before[m][n]).abs().max().item()
                 for n in before[m]} for m, e in (("actor", act),
                                                  ("critic", crit))}
    check(all(v > 0 for d in moved.values() for v in d.values()),
          f"parameters did not move: {moved}")

    # The host path: group-normalised advantages, minibatches through
    # train_batch, after a fresh actor_inf (as in the DFG).
    prox, _, _ = tr.mfc(tr.actor_iface.inference, tr.actor, data, spec)
    data = attach_keys(data, prox.data)
    recompute = recompute_first_minibatch(tr, data, spec)
    n_group = n_micro_batches(act, data, spec, k=tr.hp.ppo_n_minibatches)
    before = {n: act.params[n].detach().clone() for n in watch}
    n_opt = len(tr.steps)
    gstats, gsecs, glaunch = tr.mfc(tr.group_iface.train_step, tr.actor, data,
                                    spec)
    check_train_stats("actor_train (group_adv_norm)", gstats, "actor_loss")
    check_launches("actor_train (group_adv_norm)", glaunch, n_group,
                   cfg.n_layers, train=True)
    check(gstats["n_ppo_steps"] == tr.hp.ppo_n_minibatches,
          f"group step early-stopped: {gstats}")
    first = tr.steps[n_opt]
    giw = first["importance_weight_sum"] / max(first["n_action_tokens"], 1)
    recompute["train_step_importance_weight"] = giw
    recompute["train_step_action_tokens"] = first["n_action_tokens"]
    print("group step: prox logprobs of the first minibatch recomputed under "
          "its own packing", json.dumps(recompute), flush=True)
    check(abs(giw - 1) <= 0.02, f"group step: first importance weight {giw}")
    gmoved = {n: (act.params[n].detach() - before[n]).abs().max().item()
              for n in watch}
    check(all(v > 0 for v in gmoved.values()),
          f"group step: parameters did not move: {gmoved}")

    timed = records[1:]
    tokens = int(batch.total_lens().sum())
    step_s = sum(r["wall_s"] for r in timed) / len(timed)
    rec = {
        "tokens_per_step": tokens, "timed_steps": len(timed),
        "build_s": build_s, "warmup_step_s": records[0]["wall_s"],
        "ms_per_step": 1e3 * step_s,
        "trained_tokens_per_s": tokens / step_s,
        "ms_per_mfc": {n: 1e3 * sum(r["secs"][n] for r in timed) / len(timed)
                       for n in Trainer.ORDER},
        "micro_batches_per_mfc": expect_mbs,
        "launches_per_mfc": timed[-1]["launches"],
        "group_adv_norm_step": {"ms": 1e3 * gsecs, "micro_batches": n_group,
                                "launches": glaunch,
                                "actor_loss": gstats["actor_loss"],
                                "grad_norm": gstats["grad_norm"],
                                "first_importance_weight": giw,
                                "prox_recompute": recompute,
                                "param_max_abs_change": gmoved},
        "actor": [{k: r["actor"][k] for k in ("actor_loss", "grad_norm",
                                              "importance_weight", "mean_kl",
                                              "n_ppo_steps")} for r in records],
        "critic": [{k: r["critic"][k] for k in ("critic_loss", "grad_norm",
                                                "value_mean", "value_var")}
                   for r in records],
        "param_max_abs_change": moved,
    }
    if torch.device(device).type == "cuda":
        rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return tr, batch, data, rec


def compare_ref_inf(tr, batch, spec) -> dict:
    """ref_inf's logprobs on the first micro-batch's sequences through K1
    against the same through the plain attention (attn_impl="reference").
    Tolerance 0.3 nats: phase (d) holds the prefill's logits through K1 to
    5% of max |logit| (~3 for these weights, so ~0.15) of the plain
    attention's, and a logprob is a logit minus a logsumexp, each carrying
    that error."""
    import numpy as np

    from areal_tpu_torch.backend import microbatch as mbu

    eng = tr.ref.module
    mb = mbu.split_into_microbatches(
        batch, spec, length_bucket=eng.length_bucket,
        rows_bucket=eng.rows_bucket, seqs_bucket=eng.seqs_bucket)[0]
    sub = batch.select_idx(mb.sample_indices)
    got = tr.ref_iface.inference(tr.ref, sub, spec).data["packed_ref_logprobs"]
    eng.attn_impl = "reference"
    try:
        ref = tr.ref_iface.inference(tr.ref, sub, spec).data[
            "packed_ref_logprobs"]
    finally:
        eng.attn_impl = "auto"
    err = np.abs(got - ref)
    rec = {"sequences": sub.bs, "tokens": int(sub.total_lens().sum()),
           "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "tol": 0.3, "max_abs_ref": float(np.abs(ref).max())}
    print("ref_inf logprobs K1 vs plain attention", json.dumps(rec), flush=True)
    check(np.isfinite(got).all() and got.shape == ref.shape,
          "ref_inf logprobs not finite / wrong shape")
    check(np.array_equal(got == 0, ref == 0), "zero (masked) slots differ")
    check(rec["max_abs_err"] <= rec["tol"],
          "ref_inf through K1 disagrees with the plain attention")
    return rec


def run_checkpoints(tr, cfg, batch, data, spec, tmp: str,
                    device="cuda") -> dict:
    """(k), under ``tmp``: the actor's HF checkpoint into a new inference
    engine (its logprobs equal the saved engine's), and the train state
    into a fresh engine (one actor step on ``data`` on each gives equal
    masters)."""
    import numpy as np

    from areal_tpu_torch.algorithms.ppo import PPOActorInterface
    from areal_tpu_torch.models.hf import load_hf_checkpoint
    from areal_tpu_torch.models.transformer import init_params

    def timed(fn, *args):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        return out, time.perf_counter() - t0

    def du(path: str) -> int:
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    rec = {}
    hf_dir, st_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "train_state")
    _, rec["hf_write_s"] = timed(tr.actor_iface.save, tr.actor, hf_dir)
    rec["hf_bytes"] = du(hf_dir)
    (lcfg, lparams), rec["hf_read_s"] = timed(load_hf_checkpoint, hf_dir,
                                              device)
    check(lcfg == cfg, f"checkpoint config {lcfg} != {cfg}")
    loaded = make_model("loaded", lcfg, lparams, train=False, device=device)
    del lparams
    saved_lp, _, _ = tr.mfc(tr.actor_iface.inference, tr.actor, batch, spec)
    loaded_lp, _, _ = tr.mfc(tr.actor_iface.inference, loaded, batch, spec)
    a, b = saved_lp.data["prox_logprobs"], loaded_lp.data["prox_logprobs"]
    rec["hf_logprobs_max_abs_diff"] = float(np.abs(a - b).max())
    check(np.array_equal(a, b), "the loaded checkpoint's actor_inf logprobs "
          "differ from the saved engine's")
    del loaded

    _, rec["train_state_write_s"] = timed(tr.actor.module.save_train_state,
                                          st_dir)
    rec["train_state_bytes"] = du(st_dir)
    fresh = make_model("fresh", cfg, init_params(
        cfg, seed=1, device=device, dtype=torch.bfloat16), device=device)
    _, rec["train_state_read_s"] = timed(fresh.module.load_train_state, st_dir)
    check(fresh.module.opt_step_count == tr.actor.module.opt_step_count,
          "step count not restored")
    for model in (tr.actor, fresh):
        st, _, _ = tr.mfc(PPOActorInterface(tr.hp).train_step, model, data,
                          spec)
        check_train_stats("train_state step", st, "actor_loss")
    pa, pb = tr.actor.module.params, fresh.module.params
    rec["train_state_masters_max_abs_diff"] = max(
        (pa[n] - pb[n]).abs().max().item() for n in pa)
    check(all(torch.equal(pa[n], pb[n]) for n in pa),
          "masters differ after a train step from a restored train state: "
          f"max |diff| {rec['train_state_masters_max_abs_diff']}")
    print("checkpoints", json.dumps(rec), flush=True)
    return rec


def run_sft(tr, cfg, batch, spec) -> dict:
    """(l): one SFT train_step on the batch through train_batch."""
    from areal_tpu_torch.algorithms.sft import SFTInterface

    n = n_micro_batches(tr.actor.module, batch, spec)
    st, secs, launches = tr.mfc(SFTInterface().train_step, tr.actor, batch,
                                spec)
    check(math.isfinite(st["loss"]) and math.isfinite(st["ppl"])
          and st["grad_norm"] > 0, f"bad SFT stats {st}")
    check_launches("sft", launches, n, cfg.n_layers, train=True)
    rec = {"ms": 1e3 * secs, "micro_batches": n, "launches": launches,
           "loss": st["loss"], "ppl": st["ppl"], "grad_norm": st["grad_norm"]}
    print("sft", json.dumps(rec), flush=True)
    return rec


def trainer_breakdown(tr, batch, spec) -> dict:
    """Device ms, wall ms and the device's idle share of each MFC of one
    trainer step (torch.profiler, device activity only: the host-side
    events of a train MFC, hundreds of thousands, take longer to collect
    than the step)."""
    from torch.profiler import ProfilerActivity, profile

    from areal_tpu_torch.algorithms.ppo import attach_keys

    out, data = {}, batch

    def run(name, fn, *args):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev = sum(e.device_time for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        check(dev > 0, f"{name}: the profiler shows no device time")
        out[name] = {"wall_ms": wall, "device_ms": dev,
                     "device_idle_share": 1 - dev / wall}
        return res

    ref = run("ref_inf", tr.ref_iface.inference, tr.ref, data, spec)
    prox = run("actor_inf", tr.actor_iface.inference, tr.actor, data, spec)
    vals = run("critic_inf", tr.critic_iface.inference, tr.critic, data, spec)
    data = attach_keys(data, {**ref.data, **prox.data, **vals.data})
    run("actor_train", tr.actor_iface.train_step, tr.actor, data, spec)
    run("critic_train", tr.critic_iface.train_step, tr.critic, data, spec)
    wall = sum(v["wall_ms"] for v in out.values())
    dev = sum(v["device_ms"] for v in out.values())
    out["step"] = {"wall_ms": wall, "device_ms": dev,
                   "device_idle_share": 1 - dev / wall}
    return out


# ---------------- (m) weight sync ----------------

def post_json(url: str, path: str, body: dict, timeout: float = 600):
    """(HTTP status, reply) of one POST, error statuses included."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def health(url: str) -> dict:
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        return json.loads(r.read())


def mem_reset(device):
    """Start a peak-memory window; returns the GB allocated now (None off
    the card)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def mem_peak(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def reserved_peak(device):
    """The most this process's caching allocator held, in GiB: what the
    card gives up to it, beside :func:`mem_peak`'s tensors."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_reserved() / 2 ** 30


def stream_publisher(conn, cfg, tmp: str, exp: str, trial: str,
                     version: int, device: str) -> None:
    """(m)'s trainer side of the stream, in a process of its own, so that
    only the server's legs share the server's process: a bf16 inference
    engine on the seed-1 weights behind a TrainerWorker that publishes over
    "stream". On ``conn`` it sends ("ready", None), takes "publish", sends
    ("published", seconds), takes "close" and sends ("closed", stats); on
    a failure it sends ("error", traceback)."""
    import traceback

    try:
        from areal_tpu_torch.api.train_config import WeightSyncConfig
        from areal_tpu_torch.base import name_resolve
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.system.trainer_worker import (
            TrainerWorker,
            TrainerWorkerConfig,
        )

        def expect(what: str) -> None:
            if not conn.poll(600):
                raise TimeoutError(f"no {what!r} from the parent in 600 s")
            got = conn.recv()
            if got != what:
                raise RuntimeError(f"expected {what!r}, got {got!r}")

        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
        src = make_model("stream_src", cfg, init_params(
            cfg, seed=1, device=device, dtype=torch.bfloat16), train=False,
            device=device)
        src.version.global_step = version
        w = TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(transport="stream")))
        w.models["actor"] = src  # setup()-free: the publish half only
        try:
            conn.send(("ready", None))
            expect("publish")
            mem_reset(device)
            t0 = time.perf_counter()
            w.publish_weights("actor")
            conn.send(("published", time.perf_counter() - t0))
            expect("close")
            pub = w._weight_publishers["actor"]
            done = pub.wait_complete(version, timeout=120)
            conn.send(("closed", {
                "gather_s": pub._cache[version].gather_secs if done else None,
                "peak_gb": mem_peak(device)}))
        finally:
            w.close()
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def from_publisher(conn, proc, what: str, timeout: float = 300):
    """The stream publisher's next message, which must be ``what``."""
    deadline = time.monotonic() + timeout
    while not conn.poll(0.5):
        check(proc.is_alive() and time.monotonic() < deadline,
              f"stream publisher: no {what!r} (exit code {proc.exitcode})")
    kind, val = conn.recv()
    check(kind == what, f"stream publisher sent {kind}: {val}")
    return val


def runner_window(timeline, a: float, b: float):
    """The server runner's progress between two perf_counter times, from
    the stats samples inside them: seconds, prefills, decode steps, decode
    ms per step and the share of the window spent in prefill and decode."""
    inside = [x for x in timeline if a <= x[0] <= b]
    if len(inside) < 2:
        return None
    (t0, p0, ps0, d0, ds0), (t1, p1, ps1, d1, ds1) = inside[0], inside[-1]
    return {"s": t1 - t0, "prefills": p1 - p0, "decode_steps": d1 - d0,
            "decode_ms_per_step": (1e3 * (ds1 - ds0) / (d1 - d0)
                                   if d1 > d0 else None),
            "busy": (ps1 - ps0 + ds1 - ds0) / (t1 - t0)}


def run_weight_sync(fa, cfg, actor, eos: int, tmp: str,
                    device="cuda") -> dict:
    """(m): a port server in bf16 on the seed-0 weights swaps to (1) the
    trained actor's weights published over ``disk`` by a TrainerWorker and
    (2) seed-1 weights published over ``stream`` by a TrainerWorker in a
    process of its own, while a client sends one greedy request at a time;
    then (3) an update from a dead endpoint fails. Checks and numbers as in
    the docstring."""
    import multiprocessing

    from areal_tpu_torch.api.train_config import WeightSyncConfig
    from areal_tpu_torch.base import name_resolve, names, network
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )
    from areal_tpu_torch.system.weight_stream import WeightStreamConsumer

    exp, trial = "chip_smoke", "m"
    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    scfg = GenerationServerConfig(chunk_tokens=32, eos_token_id=eos,
                                  pad_token_id=eos, batch_window_ms=2)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, eos, (n,), generator=gen).tolist()
               for n in (37, 150, 301)]
    v1 = actor.version.global_step
    v2 = v1 + 1

    def greedy(url, i):
        return post(url, {"prompt_ids": prompts[i],
                          "gconfig": {"greedy": True}, "max_tokens": 16})

    def same(live, want, what):
        check(set(live) == set(want) and all(
            live[k].dtype == want[k].dtype and torch.equal(live[k], want[k])
            for k in want), f"{what}: live weights != the published ones")

    # The stream's publisher starts first: it builds its engine while this
    # process computes the new version's greedy tokens on the same seed-1
    # weights with a fresh server, before the counts are reset (they are
    # the check's launches).
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=stream_publisher, daemon=True,
                       name="stream-publisher",
                       args=(child_conn, cfg, tmp, exp, trial, v2, device))
    proc.start()
    server = None
    workers = []
    rec: dict = {}
    try:
        src_params = init_params(cfg, seed=1, device=device,
                                 dtype=torch.bfloat16)
        ref_server = GenerationServer(scfg, cfg, src_params, device)
        url = ref_server.start()
        try:
            want_new = [greedy(url, i)["output_ids"]
                        for i in range(len(prompts))]
        finally:
            ref_server.stop()
        del ref_server
        from_publisher(conn, proc, "ready")

        fa.reset_launch_count()
        server = GenerationServer(scfg, cfg, init_params(
            cfg, seed=0, device=device, dtype=torch.bfloat16), device)
        url = server.start()

        def retain_one_state():
            post(url, {"prompt_ids": prompts[1], "gconfig": {"greedy": True},
                       "max_tokens": 64, "rid": "m"})
            check(server.stats()["kv_states"] == 1, "no retained KV state")

        # (1) disk: the trained actor's masters in bf16
        retain_one_state()
        old = server.model.state_dict()  # swapped, never written: no copy
        workers.append(TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(transport="disk"))))
        workers[-1].models["actor"] = actor  # setup()-free: publish only
        path = os.path.join(tmp, "realloc", "actor", str(v1))
        resident = mem_reset(device)
        k1 = fa.launch_count()
        t0 = time.perf_counter()
        workers[-1].publish_weights("actor")
        publish_s = time.perf_counter() - t0
        status, body = post_json(url, "/update_weights",
                                 {"path": path, "version": v1})
        reply_s = time.perf_counter() - t0
        check(status == 200 and body["version"] == v1,
              f"disk update: {status} {body}")
        check(health(url)["version"] == v1, "disk: /health not at the new "
              "version")
        check(server.stats()["kv_states"] == 0, "disk: KV store not cleared")
        live = server.model.state_dict()
        same(live, workers[-1]._compute_dtype_params("actor"), "disk")
        changed = sum(int((live[k] != old[k]).sum()) for k in live)
        check(changed > 0, "disk: no element differs from the old weights")
        want_old = [greedy(url, i)["output_ids"] for i in range(len(prompts))]
        rec["disk"] = {
            "version": v1, "bytes": sum(os.path.getsize(os.path.join(path, f))
                                        for f in os.listdir(path)),
            "publish_s": publish_s, "publish_to_reply_s": reply_s,
            "server_update_s": body["latency_s"],
            "elements_changed": changed,
            "elements": sum(v.numel() for v in live.values()),
            "peak_gb": mem_peak(device), "resident_gb_before": resident,
            "k1_launches": fa.launch_count() - k1}
        del old, live
        print("weight sync disk", json.dumps(rec["disk"]), flush=True)

        # (2) stream, from the other process, under one-at-a-time greedy
        # traffic; a sampler records the runner's cumulative prefill and
        # decode counters every 10 ms
        retain_one_state()
        replies, timeline, stop = [], [], threading.Event()

        def load():
            i = 0
            while not stop.is_set() and i < 1000:
                t = time.perf_counter()
                r = greedy(url, i % len(prompts))
                replies.append((i % len(prompts), r, t, time.perf_counter()))
                i += 1

        def sample():
            while not stop.is_set():
                st = server.stats()
                timeline.append((time.perf_counter(), st["prefill_calls"],
                                 st["prefill_secs"], st["decode_steps"],
                                 st["decode_secs"]))
                time.sleep(0.01)

        k1 = fa.launch_count()
        threads = [threading.Thread(target=f, daemon=True)
                   for f in (load, sample)]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while len(replies) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        resident = mem_reset(device)
        t0 = time.perf_counter()
        conn.send("publish")
        publish_s = from_publisher(conn, proc, "published")
        endpoint = name_resolve.get(names.weight_stream(exp, trial, "actor"))
        t_post = time.perf_counter()
        status, body = post_json(url, "/update_weights",
                                 {"endpoint": endpoint, "version": v2})
        t_reply = time.perf_counter()
        reply_s = t_reply - t0
        n_swap = len(replies)
        deadline = time.monotonic() + 120
        while len(replies) < n_swap + 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads),
              "the load client or the sampler did not stop")
        check(status == 200 and body["version"] == v2,
              f"stream update: {status} {body}")
        versions = [r["version"] for _, r, _, _ in replies]
        check(set(versions) <= {v1, v2} and versions[-1] == v2,
              f"stream: reply versions {versions}")
        want = {v1: want_old, v2: want_new}
        wrong = [(i, r["version"]) for i, r, _, _ in replies
                 if r["output_ids"] != want[r["version"]][i]]
        check(not wrong, f"stream: replies with another version's tokens: "
              f"{wrong}")
        same(server.model.state_dict(), src_params, "stream")
        del src_params
        stats = server.stats()
        check(stats["kv_states"] == 0, "stream: KV store not cleared")
        # What generation felt: the replies that overlapped the update, and
        # the runner's progress before and during it.
        during = [b - a for _, _, a, b in replies if a < t_reply and b > t0]
        before = [b - a for _, _, a, b in replies if b <= t0]
        # The transport alone: a replay of the cached publish from the
        # other process into host memory, with no upload and no load.
        consumer = WeightStreamConsumer(endpoint, timeout_secs=600)
        try:
            t = time.perf_counter()
            consumer.fetch(v2)
            replay_s = time.perf_counter() - t
        finally:
            consumer.close()
        conn.send("close")
        publisher = from_publisher(conn, proc, "closed")
        proc.join(timeout=60)
        check(proc.exitcode == 0, f"stream publisher exit code {proc.exitcode}")
        legs = {k: stats[f"last_stream_{k}"] for k in
                ("wire_wait_secs", "digest_verify_secs", "upload_secs")}
        rec["stream"] = {
            "version": v2, "bytes": stats["last_stream_stream_bytes"],
            "publish_s": publish_s, "publish_to_reply_s": reply_s,
            "server_update_s": body["latency_s"],
            "wire_wait_s": legs["wire_wait_secs"],
            "checksum_s": legs["digest_verify_secs"],
            "upload_s": legs["upload_secs"],
            "other_s": body["latency_s"] - sum(legs.values()),
            "replies_old_new": [versions.count(v1), versions.count(v2)],
            "reply_s_before_max": max(before),
            "replies_during_update": len(during),
            "reply_s_during_max": max(during, default=0.0),
            "runner_before": runner_window(timeline, t_load, t0),
            "runner_during": runner_window(timeline, t_post, t_reply),
            "gather_s": publisher["gather_s"], "replay_fetch_s": replay_s,
            "peak_gb": mem_peak(device), "resident_gb_before": resident,
            "publisher_peak_gb": publisher["peak_gb"],
            "k1_launches": fa.launch_count() - k1}
        print("weight sync stream", json.dumps(rec["stream"]), flush=True)

        # (3) a dead endpoint: 500, the new weights stay live
        dead = f"tcp://127.0.0.1:{network.find_free_port()}"
        status, body = post_json(url, "/update_weights",
                                 {"endpoint": dead, "version": v2 + 1,
                                  "timeout": 2})
        check(status == 500 and body["version"] == v2
              and health(url)["version"] == v2,
              f"dead endpoint: {status} {body}")
        r = greedy(url, 0)
        check(r["version"] == v2 and r["output_ids"] == want_new[0],
              "dead endpoint: the served tokens changed")
        rec["failure"] = {"status": status, "version": body["version"],
                          "error": body["error"]}
        stats = server.stats()
        rec["k1_launches"] = fa.launch_count()
        rec["prefill_calls"] = stats["prefill_calls"]
        check(rec["k1_launches"] == cfg.n_layers * stats["prefill_calls"] > 0,
              f"weight sync: K1 launches {rec['k1_launches']} != "
              f"{cfg.n_layers} x {stats['prefill_calls']} prefills")
    finally:
        if server is not None:
            server.stop()
        for w in workers:
            w.close()
        if proc.is_alive():
            try:
                conn.send("close")
            except OSError:
                pass
            proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        conn.close()
        name_resolve.DEFAULT_REPO = old_repo
    return rec


# ---------------- (n) the sync-PPO loop ----------------

SYNC_MFCS = ("actor_gen", "rew_inf", "ref_inf", "critic_inf", "actor_train",
             "critic_train")


class ByteTokenizer:
    """A byte-level tokenizer for a model of any vocabulary: byte b is id
    b + 2 (0 pads, as in the port's MockTokenizer); decode maps every id
    but pad and eos to a byte, so whatever a random model samples from a
    151,936-token vocabulary decodes. Defined at module level: it travels
    to the spawned trainer by pickle."""

    pad_token_id = 0

    def __init__(self, eos_token_id: int):
        self.eos_token_id = eos_token_id

    def encode(self, text: str) -> list:
        return [b + 2 for b in text.encode()]

    def decode(self, ids) -> str:
        skip = (self.pad_token_id, self.eos_token_id)
        return bytes((int(i) - 2) % 256 for i in ids
                     if int(i) not in skip).decode(errors="replace")


def write_math_prompts(path: str, n: int, seed: int) -> None:
    """``n`` math records from ``seed``: a fixed preamble, 0-24 seeded
    definitions, then a sum whose boxed value is the ground truth. Prompts
    run 100-400 byte tokens."""
    import random

    rng = random.Random(seed)
    preamble = ("Solve the problem below. Think step by step, then put the "
                "final answer in \\boxed{}. ")
    with open(path, "w") as f:
        for i in range(n):
            a, b = rng.randint(0, 999), rng.randint(0, 999)
            defs = " ".join(f"Let x{j} = {rng.randint(0, 99)}."
                            for j in range(rng.randint(0, 24)))
            f.write(json.dumps({
                "query_id": f"q{i}", "task": "math",
                "prompt": f"{preamble}{defs} What is {a}+{b}? ",
                "solutions": [f"\\boxed{{{a + b}}}"]}) + "\n")


def sync_dfg(n_prompts: int, group_size: int, spec):
    """The graph ``experiments/ppo_math_exp.py:111 build_dfg`` gives for the
    README's sync recipe (``ppo.kl_ctl=0.05 group_size=8``, the rest at
    defaults: a critic, no actor_inf, no fused reward/ref): actor_gen ->
    rew_inf, ref_inf, critic_inf -> actor_train (publishing the actor) ->
    critic_train. ``spec`` is the forward and train MFCs' micro-batch
    spec."""
    from areal_tpu_torch.api import dfg
    from areal_tpu_torch.api.data import MicroBatchSpec

    n = n_prompts * group_size

    def node(name, role, kind, impl, inputs, outputs=(), n_seqs=n, **kw):
        return dfg.MFCDef(
            name=name, model_name=role,
            interface_type=getattr(dfg.MFCInterfaceType, kind),
            interface_impl=dfg.ModelInterfaceAbstraction(impl),
            input_keys=tuple(inputs), output_keys=tuple(outputs),
            n_seqs=n_seqs, **{"mb_spec": spec, **kw})

    traj = ("packed_input_ids", "prompt_mask", "packed_logprobs",
            "seq_no_eos_mask", "task_ids", "version_start", "version_end")
    train_in = ("packed_input_ids", "prompt_mask", "packed_logprobs",
                "rewards", "seq_no_eos_mask", "packed_ref_logprobs", "values")
    return dfg.build_graph([
        node("actor_gen", "actor", "GENERATE", "ppo_actor",
             ("packed_prompts", "task_ids"), traj, n_seqs=n_prompts,
             mb_spec=MicroBatchSpec()),
        node("rew_inf", "rew", "INFERENCE", "rw_math_code",
             ("packed_input_ids", "prompt_mask"), ("rewards",)),
        node("ref_inf", "ref", "INFERENCE", "ref_logprob",
             ("packed_input_ids",), ("packed_ref_logprobs",)),
        node("critic_inf", "critic", "INFERENCE", "ppo_critic",
             ("packed_input_ids",), ("values",)),
        node("actor_train", "actor", "TRAIN_STEP", "ppo_actor", train_in,
             post_hooks=[dfg.WeightUpdateHook(role="actor")]),
        node("critic_train", "critic", "TRAIN_STEP", "ppo_critic", train_in),
    ])


def sync_trainer_config(exp: str, trial: str, hf_dir: str, data_path: str,
                        n_records: int, realloc_dir: str, tok, hp, n_prompts,
                        device: str):
    """The TrainerWorkerConfig of the sync recipe: actor and critic on
    bench.py's backend (f32 masters, bf16 compute and moments, "dots"
    remat), the critic with a value head over the actor's trunk, a bf16
    reference engine without optimizer, a tokenizer-only reward role, the
    "math_code_prompt" dataset; weights published over disk."""
    from areal_tpu_torch.api.model import FinetuneSpec
    from areal_tpu_torch.api.train_config import (
        OptimizerConfig,
        WeightSyncConfig,
    )
    from areal_tpu_torch.system.trainer_worker import (
        MFCRuntimeConfig,
        ModelRoleConfig,
        TrainerWorkerConfig,
    )

    args = dict(
        optimizer=OptimizerConfig(lr=1e-5, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.0,
                                  mu_dtype="bfloat16", nu_dtype="bfloat16"),
        compute_dtype="bfloat16", length_bucket=512, rows_bucket=4,
        seqs_bucket=16, remat="dots", logprob_chunk=512)
    models = {
        "actor": ModelRoleConfig(init={"hf_dir": hf_dir}, backend_args=args),
        # The reference loads an hf_dir without a value head whatever the
        # role (ROADMAP.md Queue 3); "is_critic" asks for one.
        "critic": ModelRoleConfig(init={"hf_dir": hf_dir, "is_critic": True},
                                  backend_args=args),
        "ref": ModelRoleConfig(init={"hf_dir": hf_dir}, train=False,
                               backend_args=args),
        "rew": ModelRoleConfig(init={"null": True}, backend="null"),
    }
    ppo = {"interface_args": {"hp": hp}}
    mfcs = {
        "actor_gen": MFCRuntimeConfig("ppo_actor", model_name="actor", **ppo),
        "rew_inf": MFCRuntimeConfig(
            "rw_math_code", model_name="rew",
            interface_args={"dataset_path": data_path,
                            "group_size": hp.group_size}),
        "ref_inf": MFCRuntimeConfig("ref_logprob", model_name="ref"),
        "critic_inf": MFCRuntimeConfig("ppo_critic", model_name="critic",
                                       **ppo),
        "actor_train": MFCRuntimeConfig("ppo_actor", model_name="actor",
                                        **ppo),
        "critic_train": MFCRuntimeConfig("ppo_critic", model_name="critic",
                                         **ppo),
    }
    return TrainerWorkerConfig(
        experiment=exp, trial=trial, models=models, mfcs=mfcs,
        dataset="math_code_prompt", dataset_args={"dataset_path": data_path},
        batch_size=n_prompts,
        ft_spec=FinetuneSpec(1, n_records, n_prompts), tokenizer=tok,
        realloc_dir=realloc_dir,
        weight_sync=WeightSyncConfig(transport="disk"), device=device)


def expected_micro_batches(model, iface, batch, spec, method: str):
    """How many micro-batches an MFC packs: an inference packs the batch; the
    actor's train step (no group_adv_norm) at least ppo_n_minibatches of
    the whole batch; the critic's packs each of its minibatches; generate
    runs one prefill (None here)."""
    import dataclasses as dc

    from areal_tpu_torch.algorithms.ppo import PPOCriticInterface

    if method == "generate" or model.module is None:
        return None
    eng = model.module
    if method != "train_step" or not hasattr(iface, "hp"):  # SFT: one pass
        return n_micro_batches(eng, batch, spec)
    k = iface.hp.ppo_n_minibatches
    if isinstance(iface, PPOCriticInterface):
        return n_micro_batches(eng, batch, spec, k=k)
    return n_micro_batches(eng, batch, dc.replace(
        spec, n_mbs=max(spec.n_mbs or 1, k)))


def sync_loop_trainer(conn, tcfg, nr_root: str) -> None:
    """(n)'s trainer, in a spawned process: ``TrainerWorker(tcfg).run()``,
    with each MFC's K1-K3 launches, prefills, wall and CUDA-event ms, tokens
    and micro-batches recorded, and each publish timed. After ``run()``
    returns it sends ("done", record) with the peak memory, the reward
    verdicts, whether sympy imports and a SHA-256 of each compute-dtype
    actor parameter; on a failure ("error", traceback)."""
    import hashlib
    import traceback

    try:
        import numpy as np

        from areal_tpu_torch.api.data import MicroBatchSpec
        from areal_tpu_torch.base import name_resolve
        from areal_tpu_torch.models import generate as genmod
        from areal_tpu_torch.ops import flash_attention as fa
        from areal_tpu_torch.rewards import client as reward_client
        from areal_tpu_torch.system.trainer_worker import TrainerWorker

        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="nfs", nfs_record_root=nr_root))
        cuda = tcfg.device is None or str(tcfg.device).startswith("cuda")
        # the libraries phase (a) built, found by their source hash
        prebuilt = all(fa._lib_path(n).exists() for n in fa._SOURCES)
        prefills = [0]
        prefill = genmod._prefill

        def counted_prefill(*a, **k):
            prefills[0] += 1
            return prefill(*a, **k)

        genmod._prefill = counted_prefill
        records, publishes = [], []

        class Timed(TrainerWorker):
            def publish_weights(self, role):
                t0 = time.perf_counter()
                super().publish_weights(role)
                publishes.append(time.perf_counter() - t0)

            def _handle_mfc(self, p):
                req = p.data
                if req.get("method") == "noop":
                    return super()._handle_mfc(p)
                name = req["mfc"]
                mc = self._mfc_cfg[name]
                model, iface = self.models[mc.model_name], self.interfaces[name]
                batch = self._gather_input(req["ids"], req.get("input_keys"),
                                           req.get("input_remap"))
                spec = p.mb_spec or MicroBatchSpec()
                method = req.get("method", mc.method)
                rec = {"mfc": name, "tokens": int(batch.total_lens().sum()),
                       "micro_batches": expected_micro_batches(
                           model, iface, batch, spec, method)}
                fa.reset_launch_count()
                prefills[0] = 0
                n_pub = len(publishes)
                if cuda:
                    torch.cuda.synchronize()
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                t0 = time.perf_counter()
                out = super()._handle_mfc(p)
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize()
                    rec["device_ms"] = ev[0].elapsed_time(ev[1])
                rec["wall_s"] = time.perf_counter() - t0
                rec["launches"] = fa.launch_counts()
                rec["prefills"] = prefills[0]
                rec["publish_s"] = sum(publishes[n_pub:])
                if name == "actor_gen":
                    rec["generated_tokens"] = int(sum(
                        (np.asarray(self.store[i].data["prompt_mask"]) == 0
                         ).sum() for i in out["meta"].ids))
                elif name == "rew_inf":
                    rec["rewards"] = [float(np.asarray(
                        self.store[i].data["rewards"]).reshape(-1)[0])
                        for i in out["meta"].ids]
                elif method == "train_step":
                    rec["stats"] = out["stats"]
                records.append(rec)
                return out

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        w = Timed(tcfg)
        w.run()
        digests = {
            n: hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                              .cpu().numpy().tobytes()).hexdigest()
            for n, t in w._compute_dtype_params("actor").items()}
        try:
            import sympy  # noqa: F401
            has_sympy = True
        except ImportError:
            has_sympy = False
        conn.send(("done", {
            "records": records, "publish_s": publishes, "digests": digests,
            "kernels_prebuilt": prebuilt,
            "peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if cuda else None),
            "verdicts": dict(reward_client.verdict_counts),
            "sympy": has_sympy}))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_sync_loop(cfg, tmp: str, device: str = "cuda", steps: int = 3,
                  n_prompts: int = 4, group_size: int = 8,
                  max_new_tokens: int = 256, eos: int = 151643,
                  max_tokens_per_mb: int = 4096,
                  timeout: float = 600.0) -> dict:
    """(n): the README's sync-PPO recipe through the port's MasterWorker
    (here, in a thread joined within ``timeout``) and a TrainerWorker in a
    spawned process, over the port's request stream, for ``steps`` steps
    (the first a warm-up) from seed-0 weights written once as an HF
    checkpoint under ``tmp``. The checks of the module docstring; the
    launch checks only on the card (on the CPU no kernel launches)."""
    import hashlib
    import multiprocessing

    import numpy as np

    from areal_tpu_torch.algorithms.ppo import PPOHyperparameters
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.api.train_config import ExperimentSaveEvalControl
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.master_worker import (
        MasterWorker,
        MasterWorkerConfig,
    )

    exp, trial = "chip_smoke", "n"
    cuda = torch.device(device).type == "cuda"
    t_setup = time.monotonic()
    # One HF checkpoint serves every role: the critic's seed-0 parameters,
    # whose trunk draws the actor's seed-0 numbers and whose value head
    # (score.weight) the next ones. The actor and the reference read the
    # trunk and the tied LM head, the critic ("is_critic") the value head
    # as well: a zero head would predict the zero returns of unrewarded
    # samples exactly, and the critic would get no gradient.
    check(cfg.tie_word_embeddings, "sync loop: one checkpoint serves actor "
          "and critic only with tied embeddings")
    hf_dir = os.path.join(tmp, "init_hf")
    init = init_params(dataclasses.replace(cfg, is_critic=True), seed=0,
                       device=device, dtype=torch.bfloat16)
    hf.save_hf_checkpoint(init, dataclasses.replace(cfg, is_critic=True),
                          hf_dir)
    init = {k: v.cpu() for k, v in init.items()}
    data_path = os.path.join(tmp, "math.jsonl")
    n_records = 4 * n_prompts * steps
    write_math_prompts(data_path, n_records, seed=0)
    hp = PPOHyperparameters(
        gen=GenerationHyperparameters(max_new_tokens=max_new_tokens),
        kl_ctl=0.05, group_size=group_size)
    nr_root = os.path.join(tmp, "name_resolve")
    realloc = os.path.join(tmp, "realloc")
    tcfg = sync_trainer_config(exp, trial, hf_dir, data_path, n_records,
                               realloc, ByteTokenizer(eos), hp, n_prompts,
                               device)
    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=nr_root))
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=sync_loop_trainer, daemon=True,
                       name="sync-trainer", args=(child_conn, tcfg, nr_root))
    proc.start()
    child_conn.close()
    box: dict = {}
    master = MasterWorker(MasterWorkerConfig(
        experiment=exp, trial=trial, train_batch_size=n_prompts,
        exp_ctrl=ExperimentSaveEvalControl(benchmark_steps=steps),
        save_dir=os.path.join(tmp, "save")),
        sync_dfg(n_prompts, group_size,
                 MicroBatchSpec(max_tokens_per_mb=max_tokens_per_mb)))

    def run_master():
        try:
            box["result"] = master.run()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    try:
        t0 = time.monotonic()
        thread = threading.Thread(target=run_master, daemon=True,
                                  name="sync-master")
        thread.start()
        thread.join(timeout)
        loop_s = time.monotonic() - t0
        check(not thread.is_alive(), f"sync loop: the master did not finish "
              f"within {timeout:.0f} s (trainer exit code {proc.exitcode})")
        if "error" in box:
            raise box["error"]
        result = box["result"]
        deadline = time.monotonic() + 120
        while not conn.poll(0.5):
            check(proc.is_alive() and time.monotonic() < deadline,
                  f"sync loop: no record from the trainer (exit code "
                  f"{proc.exitcode})")
        kind, got = conn.recv()
        check(kind == "done", f"sync loop trainer failed:\n{got}")
        proc.join(60)
        check(proc.exitcode == 0,
              f"sync loop: trainer exit code {proc.exitcode}")
        version = int(name_resolve.get(names.model_version(exp, trial,
                                                           "actor")))
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
        conn.close()
        name_resolve.DEFAULT_REPO = old_repo

    # the loop's own stats, step by step
    check(result["steps"] == steps, f"sync loop: {result['steps']} steps, "
          f"expected {steps}")
    stats = result["stats"]
    for i, st in enumerate(stats):
        for k in ("actor_train/actor_loss", "critic_train/critic_loss",
                  "actor_train/grad_norm", "critic_train/grad_norm"):
            check(k in st and math.isfinite(st[k]),
                  f"sync loop step {i}: {k} = {st.get(k)}")
        check(st["actor_train/n_action_tokens"] > 0,
              f"sync loop step {i}: no action tokens")
        check(st["actor_train/grad_norm"] > 0
              and st["critic_train/grad_norm"] > 0,
              f"sync loop step {i}: zero grad norm {st}")
    check(version >= steps, f"sync loop: model_version {version} < {steps}")

    # the last published checkpoint: the trainer's actor, bit for bit
    path = os.path.join(realloc, "actor", str(version))
    for f in ("model.safetensors", "areal_tpu_native.json"):
        check(os.path.exists(os.path.join(path, f)),
              f"sync loop: {path} has no {f}")
    _, pub = hf.load_native_checkpoint(path, device="cpu")
    digests = {n: hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                                 .numpy().tobytes()).hexdigest()
               for n, t in pub.items()}
    check(digests == got["digests"], "sync loop: the published checkpoint "
          "differs from the trainer's actor")
    changed = sum(int((pub[n] != init[n].to(pub[n].dtype)).sum()) for n in pub)
    numel = sum(t.numel() for t in pub.values())
    check(changed > 0, "sync loop: the published actor equals the initial "
          "weights")

    recs = got["records"]
    # every step runs each MFC once, actor_gen first (the three inferences
    # and the two train steps reach the trainer in the order they became
    # ready)
    order = [r["mfc"] for r in recs]
    n = len(SYNC_MFCS)
    check(len(order) == n * steps and all(
        order[i] == "actor_gen" and sorted(order[i:i + n]) == sorted(SYNC_MFCS)
        for i in range(0, len(order), n)), f"sync loop: MFC order {order}")
    if cuda:
        check(got["kernels_prebuilt"], "sync loop: the trainer process did "
              "not find the kernels phase (a) built")
        for r in recs:
            # actor_gen: one K1 pass per prefill; rew_inf: none
            if r["mfc"] == "actor_gen":
                check(r["prefills"] >= 1, "sync loop: actor_gen ran no "
                      "prefill")
                passes = r["prefills"]
            else:
                passes = r["micro_batches"] or 0
            check_launches(f"sync loop {r['mfc']}", r["launches"], passes,
                           cfg.n_layers, train=r["mfc"].endswith("_train"))

    timed = recs[n:]
    per_mfc = {}
    for name in SYNC_MFCS:
        rs = [r for r in timed if r["mfc"] == name]
        per_mfc[name] = {
            "ms": 1e3 * np.mean([st[f"timeperf/{name}"]
                                 for st in stats[1:]]),
            "trainer_wall_ms": 1e3 * np.mean([r["wall_s"] for r in rs]),
            "device_ms": (float(np.mean([r["device_ms"] for r in rs]))
                          if cuda else None),
            "micro_batches": rs[-1]["micro_batches"],
            "launches": rs[-1]["launches"],
        }
    gen = [r for r in timed if r["mfc"] == "actor_gen"]
    train_tokens = [r["tokens"] for r in timed if r["mfc"] == "actor_train"]
    step_s = [st["timeperf/e2e"] for st in stats[1:]]
    rewards = [x for r in recs if r["mfc"] == "rew_inf" for x in r["rewards"]]
    return {
        "steps": result["steps"], "timed_steps": len(step_s),
        "ms_per_step": 1e3 * float(np.mean(step_s)),
        "warmup_step_ms": 1e3 * stats[0]["timeperf/e2e"],
        "per_mfc": per_mfc,
        "generated_tokens_per_s": float(
            sum(r["generated_tokens"] for r in gen)
            / sum(r["wall_s"] for r in gen)),
        "generated_tokens_per_step": gen[-1]["generated_tokens"],
        "trained_tokens_per_s": float(np.mean(train_tokens)
                                      / np.mean(step_s)),
        "trained_tokens_per_step": train_tokens[-1],
        "publish_s": got["publish_s"],
        "trainer_peak_gb": got["peak_gb"],
        "mfu": [st.get("timeperf/mfu") for st in stats],
        "reward_mean": float(np.mean(rewards)),
        "reward_verdicts": got["verdicts"],
        "sympy_imports": got["sympy"],
        "model_version": version,
        "published_changed_fraction": changed / numel,
        "actor": [{k: st[f"actor_train/{k}"] for k in (
            "actor_loss", "grad_norm", "n_action_tokens")} for st in stats],
        "critic": [{k: st[f"critic_train/{k}"] for k in (
            "critic_loss", "grad_norm")} for st in stats],
        "launches_total": {k: sum(r["launches"][k] for r in recs)
                           for k in KERNEL_NAMES},
        "loop_s": loop_s, "setup_s": t0 - t_setup,
    }


# ---------------- (o) the async-PPO loop ----------------

ASYNC_MFCS = ("ref_inf", "actor_inf", "critic_inf", "actor_train",
              "critic_train")


def sha256_digests(params: dict) -> dict:
    import hashlib

    return {n: hashlib.sha256(t.detach().contiguous().reshape(-1)
                              .view(torch.uint8).cpu().numpy().tobytes())
            .hexdigest() for n, t in params.items()}


def async_trainer_probe(conn, worker, digest_dir=None):
    """(o)'s trainer probe, called by the launcher in the trainer's process
    with the TrainerWorker before its run: per MFC the K1-K3 launches, the
    micro-batches it packs, the wall and CUDA-event ms, its tokens and its
    wall-clock window; for actor_train the batch's version_start /
    version_end and the actor's version; per publish its version and
    seconds. Each publish's own compute-dtype tensors are copied to the
    host as the publish makes them (no extra device memory) and hashed in
    a thread of the probe's, so only the digests outlive the publish.
    After the run it sends ("done", record) with the SHA-256 per tensor of
    every published version and the peak memory. With ``digest_dir`` each
    version's digests also go to ``trainer_<pid>_v<version>.json`` there as
    soon as they are hashed ((s): a killed trainer sends no record), and
    ``ids_<pid>.txt`` there gets a line per sample as it happens: "trained
    <version> <id>" at each actor_train, "ingest <id>" as the durable
    ingest takes a spooled sample, "settled <id>" as it acks one, "stale
    <id>" as it drops a replay; the record then also carries the ingest's
    verdict counts."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.ops import flash_attention as fa

    prebuilt = all(fa._lib_path(n).exists() for n in fa._SOURCES)
    records, publishes, digests = [], [], {}
    handle, publish = worker._handle_mfc, worker.publish_weights
    cast = worker._compute_dtype_params
    hasher = ThreadPoolExecutor(1, thread_name_prefix="probe-sha256")

    def cuda() -> bool:
        return worker.device is not None and worker.device.type == "cuda"

    def timed(p):
        req = p.data
        if req.get("method") == "noop":
            return handle(p)
        name = req["mfc"]
        mc = worker._mfc_cfg[name]
        model, iface = worker.models[mc.model_name], worker.interfaces[name]
        batch = worker._gather_input(req["ids"], req.get("input_keys"),
                                     req.get("input_remap"))
        spec = p.mb_spec or MicroBatchSpec()
        method = req.get("method", mc.method)
        rec = {"mfc": name, "tokens": int(batch.total_lens().sum()),
               "micro_batches": expected_micro_batches(model, iface, batch,
                                                       spec, method)}
        if name == "actor_train":
            rec["version"] = model.version.global_step
            rec["ids"] = [str(i) for i in req["ids"]]
            for k in ("version_start", "version_end"):
                rec[k] = np.asarray(batch.data[k]).reshape(-1).tolist()
        fa.reset_launch_count()
        if cuda():
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        rec["t0"], t0 = time.time(), time.perf_counter()
        out = handle(p)
        if cuda():
            ev[1].record()
            torch.cuda.synchronize()
            rec["device_ms"] = ev[0].elapsed_time(ev[1])
        rec["wall_s"], rec["t1"] = time.perf_counter() - t0, time.time()
        rec["launches"] = fa.launch_counts()
        if method == "train_step":
            rec["stats"] = out["stats"]
        records.append(rec)
        return out

    def published(role):
        host, copy_s = {}, [0.0]

        def cast_and_copy(r):
            out = cast(r)
            t = time.perf_counter()
            host.update((n, x.cpu()) for n, x in out.items())
            copy_s[0] += time.perf_counter() - t
            return out

        worker._compute_dtype_params = cast_and_copy
        t0 = time.perf_counter()
        try:
            publish(role)
        finally:
            worker._compute_dtype_params = cast
        v = worker.models[role].version.global_step

        def digest(host=host, v=v):
            d = sha256_digests(host)
            if digest_dir is not None:
                path = os.path.join(digest_dir,
                                    f"trainer_{os.getpid()}_v{v}.json")
                with open(path + ".tmp", "w") as f:
                    json.dump(d, f)
                os.replace(path + ".tmp", path)
            return d

        digests[v] = hasher.submit(digest)
        # publish_s includes the probe's d2h copy, reported beside it.
        publishes.append({"version": v,
                          "publish_s": time.perf_counter() - t0,
                          "probe_copy_s": copy_s[0]})

    worker._handle_mfc = timed
    worker.publish_weights = published
    if digest_dir is not None:
        log_sample_ids(worker, records,
                       os.path.join(digest_dir, f"ids_{os.getpid()}.txt"))
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()

    def done():
        peak = mem_peak(worker.device)
        hashed = {v: f.result() for v, f in digests.items()}
        hasher.shutdown()
        conn.send(("done", {
            "records": records, "publishes": publishes, "digests": hashed,
            "kernels_prebuilt": prebuilt, "peak_gb": peak,
            "reserved_peak_gb": reserved_peak(worker.device),
            "peak_bytes": (torch.cuda.max_memory_allocated() if cuda()
                           else None),
            "ingest": (dict(worker._ingest.counts)
                       if worker._ingest is not None else None),
            # (p): the goodput ledger, flushed by the worker's close
            **ledger_record(worker._ledger, worker._mfu)}))
        conn.close()
    return done


def log_sample_ids(worker, records, path: str) -> None:
    """(s): append each trained, settled (acked) and stale-dropped sample id
    to ``path`` as it happens (see :func:`async_trainer_probe`)."""
    from areal_tpu_torch.system import sample_spool

    def write(lines):
        with open(path, "a") as f:
            f.write("".join(ln + "\n" for ln in lines))

    handle = worker._handle_mfc

    def logged(p):
        n = len(records)
        out = handle(p)
        write(f"trained {r['version']} {i}" for r in records[n:]
              if r["mfc"] == "actor_train" for i in r["ids"])
        return out

    pop, observe = (sample_spool.SpoolIngest.pop_settled,
                    sample_spool.SpoolIngest.observe)

    def pop_settled(ing, sample_ids):
        with ing._lock:
            settled = [s for s in sample_ids if s in ing._pending]
        out = pop(ing, sample_ids)
        write(f"settled {i}" for i in settled)
        return out

    def observing(ing, sample_id, meta, cur, ver):
        verdict = observe(ing, sample_id, meta, cur, ver)
        if verdict[0] in ("stale", "ingest"):
            write([f"{verdict[0]} {sample_id}"])
        return verdict

    worker._handle_mfc = logged
    sample_spool.SpoolIngest.pop_settled = pop_settled
    sample_spool.SpoolIngest.observe = observing


def ledger_record(ledger, mfu) -> dict:
    """(p): a wall-partition ledger's state totals, what it exported and
    its wall (from its origin to its last transition), and the peak its
    MFU gauge divides by; {} while goodput is off."""
    if not ledger.enabled:
        return {}
    with ledger._lock:
        wall = ledger._t_cur - ledger.t_start
        exported = dict(ledger._exported)
    return {"ledger": {"totals": ledger.totals(), "exported": exported,
                       "wall": wall},
            "mfu_peak": mfu.peak if mfu is not None else None}


def proc_start_wall() -> float:
    """This process's start, in wall-clock seconds (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def record_server(srv, first_digest: bool) -> dict:
    """Hook a generation server (in its own process) for the probes, before
    it serves: K1's launches per prefill, every batch timed, the process's
    start, the probe's call ("ready": the model built) and the first
    accepted weight update in wall-clock seconds, and (``first_digest``)
    the SHA-256 of its weights as its first batch at a version > 0 starts.
    Returns the containers the hooks fill."""
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.ops import flash_attention as fa

    prefill_k1, failed_k1, batches = [], [], []
    prefill, decode = genmod._prefill, srv._decode_batch
    times = {"proc_start": proc_start_wall(), "ready": time.time(),
             "first_update": None}
    first = {}
    update = srv.handle_update_weights

    def timed_update(body):
        out = update(body)
        if out[0] == 200 and times["first_update"] is None:
            times["first_update"] = time.time()
        return out

    srv.handle_update_weights = timed_update

    def counted_prefill(*a, **k):
        before = fa.launch_counts()["flash_attention_fwd"]
        try:
            out = prefill(*a, **k)
        except BaseException:
            # the server answers 500 and the client fails over; the K1
            # launches before the error are this call's
            failed_k1.append(fa.launch_counts()["flash_attention_fwd"]
                             - before)
            raise
        prefill_k1.append(fa.launch_counts()["flash_attention_fwd"] - before)
        return out

    def timed_batch(batch):
        if first_digest and not first and srv.version > 0:
            first.update(version=srv.version, t=time.time(),
                         digests=sha256_digests(srv.model.state_dict()))
        t0, d0, s0 = time.time(), srv._decode_secs, srv._decode_steps
        p0 = srv._prefill_secs
        out = decode(batch)
        batches.append({
            "t0": t0, "t1": time.time(), "rows": len(batch),
            "fresh": sum(p.tokens_done == 0 for p in batch),
            "decode_s": srv._decode_secs - d0,
            "decode_steps": srv._decode_steps - s0,
            "prefill_s": srv._prefill_secs - p0,
            "tokens": sum(len(r["output_ids"]) for r in out)})
        return out

    genmod._prefill = counted_prefill
    srv._decode_batch = timed_batch
    fa.reset_launch_count()
    if srv.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return {"prefill_k1": prefill_k1, "failed_prefill_k1": failed_k1,
            "batches": batches, "times": times,
            "first_versioned_batch": first}


def dyn_server_probe(conn, srv):
    """(t)'s probe of a dynamic generation server (the autoscaler's spawn),
    in its process once the server is built: :func:`record_server` with the
    first versioned batch's digests; after its commanded exit it sends
    ("done", record) with them, K1's launches, its version, stats and peak
    memory."""
    from areal_tpu_torch.ops import flash_attention as fa

    prebuilt = all(fa._lib_path(n).exists() for n in fa._SOURCES)
    rec = record_server(srv, first_digest=True)

    def done():
        stats = srv.stats()
        stats.pop("shapes", None)
        conn.send(("done", {
            **rec, "k1": fa.launch_counts()["flash_attention_fwd"],
            "server_id": srv.cfg.server_id,
            "server_version": srv.version, "stats": stats,
            "kernels_prebuilt": prebuilt, "peak_gb": mem_peak(srv.device),
            "reserved_peak_gb": reserved_peak(srv.device)}))
        conn.close()
    return done


def async_fleet_probe(conn, servers, mgr, first_digest: bool = False):
    """(o)'s fleet probe, in the generation fleet's process once the server
    and the manager run: counts K1's launches and the server's prefills
    (and K1's launches inside each), times every batch; on SIGTERM (the
    launcher's teardown) it sends ("done", record) with them, the server's
    stats, version and live weights' SHA-256 per tensor, the manager's
    version, quota and weight-sync history, and exits. Also the process's
    start, the probe's call (the model built, server and manager up) and
    the first accepted weight update, in wall-clock seconds; with
    ``first_digest`` ((r): a respawned fleet) the SHA-256 of the server's
    weights as it starts its first batch at a version > 0, before that
    batch runs."""
    import signal
    import traceback

    from areal_tpu_torch.ops import flash_attention as fa

    srv = servers[0]
    prebuilt = all(fa._lib_path(n).exists() for n in fa._SOURCES)
    rec = record_server(srv, first_digest)
    prefill_k1, batches = rec["prefill_k1"], rec["batches"]
    times, first = rec["times"], rec["first_versioned_batch"]
    # (p): telemetry's flight-dump hook, run after the record is sent
    prev_term = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        try:
            stats = srv.stats()
            stats.pop("shapes", None)
            srv.ledger.flush()
            hbm = {}
            if srv.memwatch.enabled:
                srv.memwatch.sample(force=True)
                hbm = {k: v for k, v in srv.telemetry.snapshot()[
                    "gauges"].items() if k.startswith("hbm/")}
            conn.send(("done", {
                **ledger_record(srv.ledger, srv._mfu), "hbm": hbm,
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if srv.device.type == "cuda" else None),
                "k1": fa.launch_counts()["flash_attention_fwd"],
                "prefill_k1": prefill_k1, "batches": batches,
                "failed_prefill_k1": rec["failed_prefill_k1"],
                "stats": stats, "server_version": srv.version,
                "manager_version": mgr.version,
                "running_rollouts": mgr.running_rollouts,
                "accepted_rollouts": mgr.accepted_rollouts,
                "sync_history": mgr.sync_history,
                "digests": sha256_digests(srv.model.state_dict()),
                "times": times, "first_versioned_batch": first,
                "kernels_prebuilt": prebuilt,
                "peak_gb": mem_peak(srv.device),
                "reserved_peak_gb": reserved_peak(srv.device)}))
        except BaseException:  # noqa: BLE001 — reported to the script
            conn.send(("error", traceback.format_exc()))
        finally:
            conn.close()
            if callable(prev_term):
                prev_term(signum, frame)  # dumps the flight rings, exits
            os._exit(0)

    signal.signal(signal.SIGTERM, on_term)


def async_rollout_probe(conn, worker, log_dir=None):
    """(o)'s rollout-worker probe: after its run, the denials by reason, the
    pushed and abandoned rollouts, the ms of each grading call (the
    environment's step: one group's rewards), the verdicts of the grades
    this process ran itself, and whether it initialised CUDA. With
    ``log_dir`` ((r)) every event of the reward-fleet client (remote,
    retries, local_fallback, ...) and every task it POSTs to a reward
    worker ("attempt") is appended to ``client_<pid>.log`` there as it
    happens, so a killed incarnation's count survives it. With the durable
    spool on ((s)): every append's wall time, its ms (the record's write
    and fsync) and the spool's depth and bytes after it, and the sender's
    delivery counters."""
    from areal_tpu_torch.rewards import client as reward_client
    from areal_tpu_torch.system import sample_spool

    appends = []
    append = sample_spool.SampleSpool.append_framed

    def timed_append(spool, frame, ts=None):
        t0, w0 = time.perf_counter(), time.time()
        out = append(spool, frame, ts)
        ms = 1e3 * (time.perf_counter() - t0)
        st = spool.stats()
        appends.append((w0, ms, st.depth, st.bytes))
        return out

    sample_spool.SampleSpool.append_framed = timed_append

    grade_ms = []
    step = worker.env.step

    async def timed_step(action):
        t0 = time.perf_counter()
        out = await step(action)
        grade_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    worker.env.step = timed_step
    svc = reward_client.service_client()
    if log_dir is not None and svc is not None:
        count, use = svc._count, svc.use_session
        path = os.path.join(log_dir, f"client_{os.getpid()}.log")

        def log(what):
            with open(path, "a") as f:
                f.write(what + "\n")

        def logged(what):
            count(what)
            log(what)

        def attach(session):
            # every POST of a task to a reward worker: an "attempt"
            post = session.post

            async def logged_post(url, body, *a, **k):
                if url.endswith(("/math_verify", "/code_verify")):
                    log("attempt")
                return await post(url, body, *a, **k)

            session.post = logged_post
            use(session)

        svc._count, svc.use_session = logged, attach

    def done():
        conn.send(("done", {
            "denials": worker.denials, "pushed": worker._pushed,
            "abandoned": worker._abandoned,
            "failovers": worker.client.n_failovers,
            "grade_ms": grade_ms,
            "local_verdicts": dict(reward_client.verdict_counts),
            "client": dict(svc.counts) if svc is not None else None,
            "spool_appends": appends,
            "spool_counts": (dict(worker._sender.counts)
                             if worker._sender is not None else None),
            "cuda_initialized": torch.cuda.is_initialized()}))
        conn.close()
    return done


def reward_probe(log_dir, worker):
    """(r)'s reward-worker probe: every grade's kind and verdict is
    appended to ``reward_<pid>.log`` as it is answered; after the run
    ``reward_<pid>.json`` holds the process's peak RSS (resident pages,
    sampled every 0.5 s), whether it imported torch or initialised CUDA,
    the cards it was shown and its incarnation."""
    from areal_tpu_torch.system.worker_base import env_incarnation

    grade = worker.service.grade
    path = os.path.join(log_dir, f"reward_{os.getpid()}")

    def logged(task):
        out = grade(task)
        with open(path + ".log", "a") as f:
            f.write(f"{task.get('task', 'math')} {out['verdict']}\n")
        return out

    worker.service.grade = logged
    # Peak RSS, sampled: /proc/self/status does not carry VmHWM on every
    # kernel, and getrusage counts the forked image a spawned child
    # starts from.
    peak, stop = [0], threading.Event()

    def sample():
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0], int(f.read().split()[1]) * page)
            if stop.wait(0.5):
                return

    threading.Thread(target=sample, daemon=True).start()

    def done():
        stop.set()
        with open(path + ".json", "w") as f:
            json.dump({"pid": os.getpid(), "peak_rss_mb": peak[0] / 2 ** 20,
                       "incarnation": env_incarnation(),
                       "graded": worker.service._graded,
                       "torch_imported": "torch" in sys.modules,
                       "cuda_initialized": "torch" in sys.modules
                       and sys.modules["torch"].cuda.is_initialized(),
                       "cuda_visible_devices":
                       os.environ.get("CUDA_VISIBLE_DEVICES")}, f)
    return done


class LoopRun:
    """A launch on a thread of its own, with the launcher's probes' pipes
    read while it runs (a record larger than a pipe's buffer blocks its
    sender until it is read): ``records[kind]`` gathers every record a
    kind's processes send (a respawned or relaunched child sends again)."""

    def __init__(self, fn, pipes, what: str):
        self.box, self.records = {}, {k: [] for k in pipes}
        self.pipes, self.what = pipes, what

        def target():
            try:
                self.box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in join
                self.box["error"] = e

        def read(kind, recv):
            while True:
                try:
                    self.records[kind].append(recv.recv())
                except (EOFError, OSError):
                    return

        self.readers = [threading.Thread(target=read, args=(k, recv),
                                         daemon=True)
                        for k, (recv, _) in pipes.items()]
        for r in self.readers:
            r.start()
        self.thread = threading.Thread(target=target, daemon=True,
                                       name=what)
        self.thread.start()

    def join(self, secs: float) -> dict:
        try:
            self.thread.join(secs)
            check(not self.thread.is_alive(),
                  f"{self.what}: did not return within {secs:.0f} s")
            for _, send in self.pipes.values():
                send.close()  # EOF once every child's end is closed too
            for r in self.readers:
                r.join(60)
        finally:
            for recv, send in self.pipes.values():
                recv.close()
                send.close()
        if "error" in self.box:
            raise self.box["error"]
        check(not phase_children(), f"{self.what}: children outlived the "
              f"teardown: {phase_children()}")
        return self.box["result"]

    def done(self, kind: str) -> list:
        """Every ("done", record) of ``kind``; fails on an ("error", ...)."""
        out = []
        for status, rec in self.records[kind]:
            check(status == "done", f"{self.what} {kind} failed:\n{rec}")
            out.append(rec)
        return out


def loop_checkpoint(cfg, path: str, device: str) -> str:
    """One HF checkpoint for every role of the async loops: the critic's
    seed-0 parameters (the actor's trunk and a seeded value head, as in
    (n)), written once to ``path``."""
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.transformer import init_params

    check(cfg.tie_word_embeddings, "async loop: one checkpoint serves actor "
          "and critic only with tied embeddings")
    critic_cfg = dataclasses.replace(cfg, is_critic=True)
    hf.save_hf_checkpoint(init_params(critic_cfg, seed=0, device=device,
                                      dtype=torch.bfloat16), critic_cfg, path)
    return path


def async_loop_config(cfg, tmp: str, trial: str, device: str, steps: int,
                      n_prompts: int, group_size: int, chunk_tokens: int,
                      max_new_tokens: int, extra=(), mixed: bool = False,
                      hf_dir=None):
    """The README's async recipe at (o)'s cuts, as an AsyncPPOMATHConfig
    under ``tmp``: every role from ``hf_dir`` (written under ``tmp`` by
    :func:`loop_checkpoint` when None), seeded math records (``mixed``:
    half math, half python code), then ``extra`` overrides."""
    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.experiments.async_ppo_math_exp import (
        AsyncPPOMATHConfig,
    )
    if hf_dir is None:
        hf_dir = loop_checkpoint(cfg, os.path.join(tmp, "init_hf"), device)
    data_path = os.path.join(tmp, "prompts.jsonl")
    if mixed:
        write_mixed_prompts(data_path, 128, seed=1)
    else:
        write_math_prompts(data_path, 128, seed=1)
    exp = AsyncPPOMATHConfig(
        experiment_name="chip_smoke", trial_name=trial,
        backend="cuda" if torch.device(device).type == "cuda" else "cpu")
    CA.apply_overrides(exp, [
        f"cluster.fileroot={tmp}", f"dataset.path={data_path}",
        f"actor.path={hf_dir}", f"ref.path={hf_dir}", "mock_tokenizer=true",
        # the README's async recipe; the rest at its defaults
        f"group_size={group_size}", "max_head_offpolicyness=4",
        "ppo.use_decoupled_loss=true",
        # the cuts
        f"dataset.train_bs_n_seqs={n_prompts}",
        f"new_tokens_per_chunk={chunk_tokens}",
        f"exp_ctrl.benchmark_steps={steps}",
        f"ppo.gen.max_new_tokens={max_new_tokens}", *extra])
    return exp


def write_mixed_prompts(path: str, n: int, seed: int) -> None:
    """``n`` seeded records, half math (as :func:`write_math_prompts`) and
    half python code: a program that reads an integer and prints a seeded
    function of it, with 2-4 stdin/stdout cases."""
    import random

    write_math_prompts(path, n - n // 2, seed)
    rng = random.Random(seed + 1)
    with open(path, "a") as f:
        for i in range(n // 2):
            k, m = rng.randint(1, 9), rng.randint(2, 5)
            xs = [rng.randint(0, 99) for _ in range(rng.randint(2, 4))]
            f.write(json.dumps({
                "query_id": f"c{i}", "task": "code", "solutions": [],
                "prompt": (f"Write a python program that reads an integer x "
                           f"from stdin and prints {m}*x+{k}. Put the "
                           "program in a ```python block. "),
                "input_output": json.dumps({
                    "inputs": [f"{x}\n" for x in xs],
                    "outputs": [f"{m * x + k}\n" for x in xs]})}) + "\n")


def run_async_loop(cfg, tmp: str, device: str = "cuda", steps: int = 4,
                   n_prompts: int = 4, group_size: int = 16,
                   chunk_tokens: int = 128, max_new_tokens: int = 256,
                   timeout: float = 600.0, extra=(),
                   observe: bool = False, interactive: bool = False,
                   hf_dir=None) -> dict:
    """(o): the README's async recipe through the port's ``run_experiment``
    (what ``python -m areal_tpu_torch.training.main_async_ppo`` calls), with
    the launcher's probes recording each process's counters. The checks of
    the module docstring; the launch checks only on the card. With every
    observability switch off, it also checks that no telemetry endpoint is
    advertised and no telemetry thread runs here. ``observe=True`` is (p):
    the same loop with telemetry, goodput, compile_watch and the sentinel
    on, checked by :func:`check_observability`. ``interactive=True`` is
    (q3)'s probe: three interactive requests through the manager while the
    loop runs, at least one answered."""
    import collections
    import functools
    import multiprocessing

    import numpy as np

    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve

    cuda = torch.device(device).type == "cuda"
    t_setup = time.monotonic()
    obs = {}
    if observe:
        from areal_tpu_torch.base.network import find_free_port

        obs = {"prof_dir": os.path.join(tmp, "profile"),
               "flight_dir": os.path.join(tmp, "flight")}
        extra = (*extra, *observability_overrides(find_free_port(),
                                                  obs["flight_dir"]))
    exp = async_loop_config(cfg, tmp, "p" if observe else "o", device, steps,
                            n_prompts, group_size, chunk_tokens,
                            max_new_tokens, extra, hf_dir=hf_dir)
    ctx = multiprocessing.get_context("spawn")
    pipes = {k: ctx.Pipe(duplex=False) for k in ("trainer", "gen_fleet",
                                                  "rollout")}
    probes = {"trainer": functools.partial(async_trainer_probe,
                                           pipes["trainer"][1]),
              "gen_fleet": functools.partial(async_fleet_probe,
                                             pipes["gen_fleet"][1]),
              "rollout": functools.partial(async_rollout_probe,
                                           pipes["rollout"][1])}
    old_repo = name_resolve.DEFAULT_REPO
    restore = (observe_master(exp, obs) if observe
               else watch_disabled(exp, obs))
    t0 = time.monotonic()
    probed, stop_probe = [], threading.Event()
    try:
        run = LoopRun(lambda: run_experiment(exp, probes=probes), pipes,
                      "async loop")
        if interactive:
            threading.Thread(target=interactive_probe, daemon=True,
                             args=(exp, probed, stop_probe)).start()
        # the steps' bound, the loads before them and the bounded teardown
        result = run.join(timeout + 300)
        loop_s = time.monotonic() - t0
        got = {}
        for kind in pipes:
            recs = run.done(kind)
            check(len(recs) == 1, f"async loop: {len(recs)} records from "
                  f"the {kind}")
            got[kind] = recs[0]
    finally:
        stop_probe.set()
        restore()
        name_resolve.DEFAULT_REPO = old_repo
    tr, fleet, roll = got["trainer"], got["gen_fleet"], got["rollout"]
    if not observe:
        check(not obs["violations"], "async loop with every observability "
              f"switch off: {obs['violations'][:5]}")

    # the loop's stats, step by step
    check(result["steps"] == steps, f"async loop: {result['steps']} steps, "
          f"expected {steps}")
    stats = result["stats"]
    steps_s = sum(st["timeperf/e2e"] for st in stats)
    check(steps_s <= timeout, f"async loop: {steps} steps took "
          f"{steps_s:.1f} s > {timeout:.0f} s")
    for i, st in enumerate(stats):
        for k in ("actor_train/actor_loss", "critic_train/critic_loss",
                  "actor_train/grad_norm", "critic_train/grad_norm"):
            check(k in st and math.isfinite(st[k]),
                  f"async loop step {i}: {k} = {st.get(k)}")
        check(st["actor_train/grad_norm"] > 0
              and st["critic_train/grad_norm"] > 0,
              f"async loop step {i}: zero grad norm")
    recs = tr["records"]
    counts = collections.Counter(r["mfc"] for r in recs)
    check(counts == {m: steps for m in ASYNC_MFCS},
          f"async loop: MFCs per run {dict(counts)}")

    # versions: every trained trajectory version_start <= version_end <=
    # the trainer's version at its train step; the fleet at one version
    lags, spans = [], 0
    for r in recs:
        if r["mfc"] != "actor_train":
            continue
        for vs, ve in zip(r["version_start"], r["version_end"]):
            check(vs <= ve <= r["version"], f"async loop: trajectory "
                  f"versions {vs}..{ve} trained at version {r['version']}")
            lags.append(r["version"] - vs)
            spans += ve > vs
    check(fleet["manager_version"] == fleet["server_version"] >= steps - 1,
          f"async loop: manager v{fleet['manager_version']}, server "
          f"v{fleet['server_version']} (want equal and >= {steps - 1})")
    check(fleet["running_rollouts"] == 0, "async loop: running_rollouts "
          f"{fleet['running_rollouts']} after the master stopped")
    sv = fleet["server_version"]
    check(sv in tr["digests"] and fleet["digests"] == tr["digests"][sv],
          f"async loop: the server's weights at v{sv} differ from the "
          "actor the trainer published as that version")
    check(not roll["cuda_initialized"], "async loop: the rollout worker "
          "initialised CUDA")
    answered = [r for r in probed if r.get("status") == 200]
    if interactive:
        check(answered and all(r["class"] == "interactive"
                               and r["output_ids"] for r in answered),
              f"async loop: no interactive reply: {probed}")
    check(roll["pushed"] >= steps * n_prompts * group_size,
          f"async loop: {roll['pushed']} trajectories pushed")
    if cuda:
        check(tr["kernels_prebuilt"] and fleet["kernels_prebuilt"],
              "async loop: a child did not find the kernels phase (a) built")
        check(fleet["prefill_k1"] and all(
            k == cfg.n_layers for k in fleet["prefill_k1"])
            and fleet["k1"] == cfg.n_layers * len(fleet["prefill_k1"]),
            f"async loop: K1 launched {fleet['k1']} times in the fleet over "
            f"{len(fleet['prefill_k1'])} prefills")
        for r in recs:
            check_launches(f"async loop {r['mfc']}", r["launches"],
                           r["micro_batches"], cfg.n_layers,
                           train=r["mfc"].endswith("_train"))

    # what the script prints
    per_mfc = {}
    for name in ASYNC_MFCS:
        rs = [r for r in recs if r["mfc"] == name][1:]  # after the warm-up
        per_mfc[name] = {
            "master_ms": 1e3 * float(np.mean([st[f"timeperf/{name}"]
                                              for st in stats[1:]])),
            "trainer_wall_ms": 1e3 * float(np.mean([r["wall_s"]
                                                    for r in rs])),
            "device_ms": (float(np.mean([r["device_ms"] for r in rs]))
                          if cuda else None),
            "micro_batches": rs[-1]["micro_batches"],
            "launches": rs[-1]["launches"]}
    windows = [(r["t0"], r["t1"]) for r in recs]

    def busy(b):
        mid = (b["t0"] + b["t1"]) / 2
        return any(a <= mid <= z for a, z in windows)

    def decode_ms(bs):
        steps_ = sum(b["decode_steps"] for b in bs)
        return 1e3 * sum(b["decode_s"] for b in bs) / steps_ if steps_ else None

    bt = fleet["batches"]
    step_s = [st["timeperf/e2e"] for st in stats[1:]]
    train_tokens = [r["tokens"] for r in recs if r["mfc"] == "actor_train"]
    launches = {k: sum(r["launches"][k] for r in recs) for k in KERNEL_NAMES}
    launches["flash_attention_fwd"] += fleet["k1"]
    return {
        "steps": result["steps"], "timed_steps": len(step_s),
        "ms_per_step": 1e3 * float(np.mean(step_s)),
        "step_ms": [1e3 * st["timeperf/e2e"] for st in stats],
        "per_mfc": per_mfc,
        "trained_tokens_per_step": train_tokens[-1],
        "trained_tokens_per_s": float(np.mean(train_tokens[1:])
                                      / np.mean(step_s)),
        "fleet_generated_tokens": sum(b["tokens"] for b in bt),
        "fleet_generated_tokens_per_s": sum(b["tokens"] for b in bt) / max(
            bt[-1]["t1"] - bt[0]["t0"], 1e-9),
        "weight_sync": [{"version": v, "fanout_s": f, "publish_to_swap_s": e}
                        for v, f, e in fleet["sync_history"]],
        "trainer_publish_s": {p["version"]: p["publish_s"]
                              for p in tr["publishes"]},
        "probe_copy_s": sum(p["probe_copy_s"] for p in tr["publishes"]),
        "staleness_hist": dict(sorted(collections.Counter(lags).items())),
        "share_version_end_after_start": spans / max(len(lags), 1),
        "denials": roll["denials"], "pushed": roll["pushed"],
        "abandoned": roll["abandoned"], "failovers": roll["failovers"],
        "grade_ms_mean": float(np.mean(roll["grade_ms"])),
        "server_batch_rows": dict(sorted(collections.Counter(
            b["rows"] for b in bt).items())),
        "server_prefills": len(fleet["prefill_k1"]),
        "decode_ms_per_step_during_training": decode_ms(
            [b for b in bt if busy(b)]),
        "decode_ms_per_step_outside_training": decode_ms(
            [b for b in bt if not busy(b)]),
        "batches_during_training": sum(busy(b) for b in bt),
        "batches": len(bt),
        "trainer_peak_gb": tr["peak_gb"], "server_peak_gb": fleet["peak_gb"],
        "final_version": sv,
        "actor": [{k: st[f"actor_train/{k}"] for k in (
            "actor_loss", "grad_norm", "n_action_tokens")} for st in stats],
        "critic": [{k: st[f"critic_train/{k}"] for k in (
            "critic_loss", "grad_norm")} for st in stats],
        "launches_total": launches,
        # the server's prefill work and its serving counters
        "server": {k: fleet["stats"][k] for k in (
            "prefill_tokens", "prefill_calls", "extend_calls",
            "serving/prefix_hits", "serving/prefix_tokens_saved",
            "reprefilled_continuations", "kv_peak_bytes",
            "dummy_row_steps", "decode_row_steps")},
        "prefill_tokens_per_step": fleet["stats"]["prefill_tokens"] / steps,
        "interactive": [{k: r.get(k) for k in ("status", "ms", "version",
                                               "error")} for r in probed],
        "loop_s": loop_s, "setup_s": t0 - t_setup,
        **({"observability": check_observability(
            cfg, exp, obs, result, tr, fleet, cuda)} if observe else {}),
    }


# ---------------- (p) the async-PPO loop with observability on ----------------

OP_RULE = {"id": "op_step_secs", "metric": "master/step_secs",
           "kind": "threshold", "op": "gt", "value": 0, "for": 1,
           "severity": "warn",
           "description": "operator rule of the smoke run: must fire"}
WORKERS = ("master", "trainer", "generation_server", "gserver_manager",
           "rollout")


def observability_overrides(http_port: int, flight_dir: str) -> list:
    """(p)'s switches: every observability block on, the merged /metrics on
    a free port, flight dumps on SIGTERM, memory sampled every serve-loop
    iteration, the default rules plus :data:`OP_RULE`."""
    return [
        "telemetry.enabled=true", f"telemetry.http_port={http_port}",
        f"telemetry.flight_dir={flight_dir}",
        "telemetry.flush_interval_secs=1", "telemetry.stitch_grace_secs=3",
        "goodput.enabled=true", "compile_watch.enabled=true",
        "compile_watch.mem_sample_interval_secs=0", "sentinel.enabled=true",
        f"sentinel.rules={json.dumps([OP_RULE])}"]


_NO_PROXY = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_text(url: str) -> str:
    with _NO_PROXY.open(url, timeout=60) as r:
        return r.read().decode()


def prom_samples(text: str) -> list:
    """Prometheus exposition text -> [(name, {label: value}, value)]."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([A-Za-z_:][\w:]*)(?:\{(.*)\})? (\S+)$", line)
        check(m is not None, f"malformed exposition line {line!r}")
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                 m.group(2) or ""))
        out.append((m.group(1), labels, float(m.group(3))))
    return out


def observe_master(exp, obs: dict):
    """(p)'s hooks in this process, where the launcher runs the master:
    once step 2's batch is in (its ref_inf passes the buffer's gate), a
    profiler capture of ~3 s is requested from the trainer; just before the aggregator closes, the master's merged
    /metrics (found through names.telemetry_http), the server's /metrics
    and /metrics.json and the manager's /metrics are scraped. Returns the
    function that removes the hooks."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.base import telemetry as T
    from areal_tpu_torch.system.master_worker import MasterWorker

    e, t = exp.experiment_name, exp.trial_name
    close, count = T.TelemetryAggregator.close, MasterWorker._count_mfc_flops

    def scraping_close(agg):
        try:
            obs["merged"] = http_text(
                name_resolve.get(names.telemetry_http(e, t)) + "/metrics")
            (srv,) = name_resolve.get_subtree(names.gen_server_root(e, t))
            obs["server_json"] = json.loads(http_text(srv + "/metrics.json"))
            obs["server"] = http_text(srv + "/metrics")
            obs["manager"] = http_text(
                name_resolve.get(names.gen_server_manager(e, t)) + "/metrics")
        except Exception as err:  # noqa: BLE001 — a failed check below
            obs["scrape_error"] = repr(err)
        finally:
            close(agg)

    def profiled_step(master, node, metas):
        # step 2's first MFC has its batch: the trainer's MFCs follow
        # (the trainer polls the request between requests)
        if master.step == 1 and node.name == "ref_inf":
            T.request_profiler_capture(e, t, obs["prof_dir"], secs=3.0)
        return count(master, node, metas)

    T.TelemetryAggregator.close = scraping_close
    MasterWorker._count_mfc_flops = profiled_step

    def restore():
        T.TelemetryAggregator.close = close
        MasterWorker._count_mfc_flops = count
    return restore


def watch_disabled(exp, obs: dict):
    """(o)'s disabled contract, watched every 0.2 s while the loop runs: no
    telemetry endpoint advertised, no telemetry thread in this process.
    Returns the function that stops the watch."""
    from areal_tpu_torch.base import name_resolve, names

    e, t = exp.experiment_name, exp.trial_name
    stop = threading.Event()
    obs["violations"] = []

    def watch():
        while not stop.wait(0.2):
            for key in (names.telemetry_aggregator(e, t),
                        names.telemetry_http(e, t)):
                try:
                    name_resolve.get(key)
                    obs["violations"].append(f"{key} advertised")
                except name_resolve.NameEntryNotFoundError:
                    pass
            obs["violations"] += [
                f"thread {th.name}" for th in threading.enumerate()
                if th.name.startswith("telemetry")]

    th = threading.Thread(target=watch, daemon=True, name="disabled-watch")
    th.start()

    def restore():
        stop.set()
        th.join(5)
    return restore


def device_profile(prof_dir: str) -> dict:
    """K1-K3's device time and launches in the trainer's capture, and the
    device's busy share over the capture's window (the union of kernel,
    memcpy and memset intervals)."""
    import collections
    import glob

    files = glob.glob(os.path.join(prof_dir, "trace_*.json"))
    check(len(files) == 1, f"profiler capture: trace files {files}")
    with open(files[0]) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X" and "dur" in ev]
    gpu = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                 for ev in events if ev.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    cats = dict(collections.Counter(str(ev.get("cat")) for ev in events))
    check(gpu, f"profiler capture: no device events (categories {cats})")
    window = (max(b for _, b in gpu) - min(a for a, _ in gpu)) / 1e3
    busy, end = 0.0, -math.inf
    for a, b in gpu:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = {}
    for prefix in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        ks = [ev for ev in events if ev.get("cat") == "kernel"
              and prefix in ev["name"]]
        kernels[prefix] = {"launches": len(ks),
                           "device_ms": sum(ev["dur"] for ev in ks) / 1e3}
        check(kernels[prefix]["device_ms"] > 0,
              f"profiler capture: no device time for {prefix}")
    return {"file_mb": os.path.getsize(files[0]) / 2 ** 20,
            "window_ms": window, "busy_share": busy / 1e3 / window,
            "device_events": len(gpu), "kernels": kernels}


def check_observability(cfg, exp, obs, result, tr, fleet, cuda) -> dict:
    """(p)'s checks of the module docstring, and what it prints."""
    import collections
    import glob

    from areal_tpu_torch.base import monitor
    from areal_tpu_torch.experiments import common as C

    check("scrape_error" not in obs, f"(p) scrape: {obs.get('scrape_error')}")
    merged = prom_samples(obs["merged"])
    kinds = {lab.get("worker_kind") for _, lab, _ in merged}
    check(set(WORKERS) <= kinds, f"(p) merged scrape: workers {kinds}")

    def value(name, **want):
        vals = [v for n, lab, v in merged if n == name
                and all(lab.get(k) == w for k, w in want.items())]
        check(vals, f"(p) merged scrape: no {name} {want}")
        return vals[-1]

    # goodput: each partition-owning ledger sums to its wall; fleet sides
    states = {}
    for who, rec in (("trainer", tr), ("generation_server", fleet)):
        led = rec["ledger"]
        total = sum(led["totals"].values())
        check(abs(total - led["wall"]) <= 0.01 * led["wall"]
              and abs(sum(led["exported"].values()) - total) <= 0.01 * total,
              f"(p) {who} ledger: states {led['totals']} sum to {total}, "
              f"exported {sum(led['exported'].values())}, wall {led['wall']}")
        states[who] = led["totals"]
    fleet_goodput = {side: value("areal_fleet_goodput", side=side)
                     for side in ("trainer", "generation")}
    check(all(0 < v <= 1 for v in fleet_goodput.values()),
          f"(p) fleet goodput {fleet_goodput}")
    scraped_states = collections.defaultdict(dict)
    for n, lab, v in merged:
        if n == "areal_goodput_secs_total":
            scraped_states[lab["worker_kind"]][lab["state"]] = v
    # live MFU against the peak from the card's name
    mfu = {"trainer": value("areal_train_mfu"),
           "generation_server": value("areal_genserver_decode_mfu")}
    check(all(0 < v < 1 for v in mfu.values()), f"(p) live MFU {mfu}")
    if cuda:
        peak = monitor.device_peak_flops(torch.cuda.get_device_name())
        check(peak is not None and tr["mfu_peak"] == fleet["mfu_peak"] == peak,
              f"(p) MFU peaks {tr['mfu_peak']} / {fleet['mfu_peak']}, the "
              f"card's {peak}")
    # device memory: each process's peak gauge against its allocator's
    hbm = {}
    if cuda:
        dev = torch.cuda.current_device()
        hbm["trainer"] = value("areal_hbm_peak_bytes", worker_kind="trainer")
        hbm["generation_server"] = fleet["hbm"][
            f"hbm/peak_bytes{{device={dev}}}"]
        for who, rec in (("trainer", tr), ("generation_server", fleet)):
            check(abs(hbm[who] - rec["peak_bytes"]) <= 0.01 * rec["peak_bytes"],
                  f"(p) {who} hbm/peak_bytes {hbm[who]} vs "
                  f"max_memory_allocated {rec['peak_bytes']}")
    # traces: one per trained trajectory of the timed steps, each joining a
    # rollout, a server and a trainer span
    log = C.experiment_paths(exp)["log"]
    with open(os.path.join(log, "traces.jsonl")) as f:
        traces = {}
        for line in f:
            d = json.loads(line)
            traces[d["sample_id"]] = {sp["name"] for sp in d["spans"]}
    timed = [i for r in [r for r in tr["records"]
                         if r["mfc"] == "actor_train"][1:] for i in r["ids"]]
    for sid in timed:
        names_ = traces.get(sid)
        check(names_ is not None, f"(p) no stitched trace for {sid}")
        check(any(n.startswith("rollout/") for n in names_)
              and any(n.startswith("genserver/") for n in names_)
              and "trainer/train_sample" in names_,
              f"(p) trace of {sid} joins only {sorted(names_)}")
    # the sentinel: the operator rule fired with its evidence
    with open(os.path.join(log, "alerts.jsonl")) as f:
        alerts = [json.loads(line) for line in f]
    fired = [a for a in alerts if a["event"] == "firing"]
    op = [a for a in fired if a["rule"] == OP_RULE["id"]]
    check(op and op[0].get("evidence_dir"), f"(p) alerts: {alerts}")
    check(value("areal_alerts_total", rule=OP_RULE["id"]) >= 1,
          "(p) areal_alerts_total misses the operator rule")
    ev_dir = op[0]["evidence_dir"]
    dumps = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ev_dir, "flight_*.jsonl")))
    want = {"flight_master0.jsonl", "flight_trainer0.jsonl",
            "flight_generation_server0.jsonl",
            "flight_gserver_manager0.jsonl", "flight_rollout0.jsonl"}
    check(want <= set(dumps), f"(p) evidence {ev_dir} holds {dumps}")
    # the teardown's SIGTERM dumps parse, each ending in its marker
    term = {}
    for path in glob.glob(os.path.join(obs["flight_dir"], "flight_*.jsonl")):
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        check(recs and recs[-1]["kind"] == "dump"
              and recs[-1]["reason"] == "sigterm",
              f"(p) flight dump {path} ends {recs[-1:]}")
        term[os.path.basename(path)] = len(recs)
    check({"flight_generation_server0.jsonl",
           "flight_gserver_manager0.jsonl"} <= set(term),
          f"(p) SIGTERM flight dumps {sorted(term)}")
    prof = device_profile(obs["prof_dir"]) if cuda else None
    server = {n: v for n, lab, v in prom_samples(obs["server"])}
    # read after the JSON: a weight update may land between the two
    check(server.get("areal_genserver_weight_version", -1) >=
          obs["server_json"]["version"] >= 1, "(p) server /metrics vs .json")

    def hist(name, kind):
        return {"count": value(f"{name}_count", worker_kind=kind),
                "sum_s": value(f"{name}_sum", worker_kind=kind)}

    return {
        "fleet_goodput": fleet_goodput, "ledger_states_s": states,
        "scraped_goodput_s": dict(scraped_states), "live_mfu": mfu,
        "master_mfu": [st.get("timeperf/mfu") for st in result["stats"]],
        "peak_bytes": hbm, "peak_bytes_sum": sum(hbm.values()),
        "trainer_spans": {k: hist(f"areal_train_{k}_secs", "trainer")
                          for k in ("split_pack", "fwd_bwd", "optimizer")},
        "decode_chunk_spans": hist("areal_genserver_decode_chunk_secs",
                                   "generation_server"),
        "traces": len(traces), "traced_samples_checked": len(timed),
        "alerts_fired": [{"rule": a["rule"], "value": a["value"]}
                         for a in fired],
        "evidence_dumps": dumps, "sigterm_dumps": term,
        "compile_secs": {lab.get("fn"): v for n, lab, v in merged
                         if n == "areal_compile_secs_total" and "fn" in lab},
        "profile": prof,
        "merged_families": len({n for n, _, _ in merged}),
    }


# ---------------- (q) the serving engine ----------------


def http_post(url: str, path: str, body: dict, timeout: float = 600):
    """(HTTP status, reply, headers) of one POST, error statuses included."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def kv_digest(state: dict) -> str:
    """SHA-256 of a decode state's K and V bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in ("kv_k", "kv_v"):
        h.update(state[k].contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def record_prefills(genmod):
    """Wrap ``prefill_state`` and ``extend_state``: each call's tokens,
    lengths, KV capacity and last logits (f32, on the host) are recorded.
    Returns the records and a restore function."""
    calls = {"prefill": [], "extend": []}
    orig = {"prefill": genmod.prefill_state, "extend": genmod.extend_state}

    def wrap(kind):
        def fn(model, st_or_prompts, *args, **kw):
            out = orig[kind](model, st_or_prompts, *args, **kw)
            if kind == "prefill":
                toks, lens = st_or_prompts, args[0]
            else:
                toks, lens = args[0], args[1]
            calls[kind].append((toks.cpu(), lens.cpu(), out["kv_k"].shape[2],
                                out["last_logits"].float().cpu()))
            return out
        return fn

    genmod.prefill_state, genmod.extend_state = wrap("prefill"), wrap("extend")

    def restore():
        genmod.prefill_state = orig["prefill"]
        genmod.extend_state = orig["extend"]
    return calls, restore


def row_of(calls, kind: str, seq):
    """The recorded row whose real tokens are ``seq``: (its padded tokens
    [1, T], its length [1], the KV capacity, its last logits)."""
    seq = torch.tensor(seq)
    for toks, lens, S, logits in calls[kind]:
        for i in range(len(lens)):
            n = int(lens[i])
            if n == len(seq) and torch.equal(toks[i, :n].long(), seq):
                return toks[i:i + 1], lens[i:i + 1], S, logits[i]
    raise SmokeFailure(f"(q1) no {kind} row of {len(seq)} tokens recorded")


# (q1): a seeded row's first logits against the same suffix extend redone
# outside the server on a fresh clone of the donor, at the server's own
# shapes, as a share of max|logit| of K1's full prefill.
SEED_TOL = 1e-4


def seed_readings(model, donor: dict, other: dict, n_shared: int, prompt,
                  tokens, lens, S: int) -> dict:
    """The last logits of ``prompt`` (the donor's first ``n_shared`` tokens
    + a suffix) computed four ways outside the server, at B=1 and through
    the plain attention only (no K1 launch). ``seed``: the suffix
    ``tokens`` / ``lens`` (padded as the server padded them) extended on a
    clone of the donor at ``n_shared`` and capacity ``S``, as the server
    seeds it; ``short``: the same on a clone one token short (a wrong
    length); ``other``: the same on ``other``, a state of another prompt of
    ``n_shared`` tokens (a wrong donor); ``plain``: a full prefill."""
    from areal_tpu_torch.models import generate as genmod

    with torch.inference_mode():
        dev = donor["kv_k"].device
        tokens, lens = tokens.to(dev), lens.to(dev)

        def extend(st, n):
            st = genmod.grow_state(genmod.clone_prefix(st, n), S)
            return genmod.extend_state(model, st, tokens, lens)[
                "last_logits"][0].cpu()
        full = torch.tensor([prompt], device=dev)
        plain = genmod.prefill_state(model, full, torch.tensor(
            [len(prompt)], device=dev), max(S, len(prompt)),
            attn_impl="reference")
        return {"seed": extend(donor, n_shared),
                "short": extend(donor, n_shared - 1),
                "other": extend(other, n_shared),
                "plain": plain["last_logits"][0].cpu()}


def serving_server(cfg, params, eos, server_id: str, device="cuda",
                   server_kw=None, **serving):
    """A (q) server with ``serving.enabled=true`` and the ``serving`` fields
    given; ``server_kw`` sets other fields of its config."""
    from areal_tpu_torch.api.train_config import ServingConfig
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    return GenerationServer(GenerationServerConfig(
        experiment="chip_q", trial="q", server_id=server_id,
        eos_token_id=eos, pad_token_id=eos, batch_window_ms=20,
        serving=ServingConfig(enabled=True, **serving), **(server_kw or {})),
        cfg, params, device=device)


def run_prefix_reuse(fa, cfg, params, eos, device="cuda") -> dict:
    """(q1): a donor request, eight requests sharing its 768-token preamble,
    a pure clone, a rid continuation and a short overlap, on a server with
    prefix reuse and on one without (the full K1 prefills). The launch
    checks run only on the card."""
    from areal_tpu_torch.models import generate as genmod

    cuda = torch.device(device).type == "cuda"
    on = serving_server(cfg, params, eos, "q1on", device)
    off = serving_server(cfg, params, eos, "q1off", device,
                         prefix_reuse=False)
    urls = {"on": on.start(), "off": off.start()}
    gen = torch.Generator().manual_seed(7)

    def toks(n):
        return torch.randint(0, eos, (n,), generator=gen).tolist()

    preamble, s0 = toks(768), toks(32)
    firsts, suffixes = {s0[0]}, []
    for n in (16, 22, 28, 34, 40, 46, 52, 64):
        s = toks(n)
        while s[0] in firsts:  # the shared prefix is the preamble alone
            s[0] = (s[0] + 1) % eos
        firsts.add(s[0])
        suffixes.append(s)
    calls, restore = record_prefills(genmod)
    fa.reset_launch_count()
    try:
        donor_body = {"prompt_ids": preamble + s0, "max_tokens": 128,
                      "gconfig": {"greedy": True}, "rid": "donor"}
        donor = {k: post(u, donor_body) for k, u in urls.items()}
        check_reply(donor["on"], 128, eos, "(q1) donor")
        check(not donor["on"]["finished"], "(q1) the donor ended at EOS")
        check(donor["on"]["output_ids"] == donor["off"]["output_ids"],
              "(q1) the donor's greedy tokens differ between the servers")
        donor_st = on.kv.get("donor")
        check(donor_st is not None, "(q1) the donor's state was not kept")
        h0 = kv_digest(donor_st.state)

        prompts = [preamble + s for s in suffixes]
        bodies = [{"prompt_ids": p, "max_tokens": 32, "rid": f"q1-{i}",
                   "gconfig": {"greedy": True}}
                  for i, p in enumerate(prompts)]
        s1 = {"on": on.stats(), "off": off.stats()}
        k1 = fa.launch_count()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            seeded = list(pool.map(lambda b: post(urls["on"], b), bodies))
        s2_on, k1_seeded = on.stats(), fa.launch_count() - k1
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            plain = list(pool.map(lambda b: post(urls["off"], b), bodies))
        s2_off = off.stats()
        for i, r in enumerate(seeded):
            check_reply(r, 32, eos, f"(q1) seeded request {i}")

        def delta(key, a=s1["on"], b=s2_on):
            return b[key] - a[key]
        check(delta("serving/prefix_hits") == 8,
              f"(q1) prefix hits rose by {delta('serving/prefix_hits')}")
        check(delta("serving/prefix_tokens_saved") == 8 * 768,
              "(q1) prefix tokens saved rose by "
              f"{delta('serving/prefix_tokens_saved')}, not 8 x 768")
        check(delta("prefill_tokens") == sum(map(len, suffixes)),
              f"(q1) prefill tokens rose by {delta('prefill_tokens')}, not "
              f"the suffixes' {sum(map(len, suffixes))}")
        check(delta("prefill_calls") == 0 and (k1_seeded == 0 or not cuda),
              f"(q1) the seeded requests ran {delta('prefill_calls')} "
              f"batched prefills and {k1_seeded} K1 launches")
        check(delta("extend_calls") == 8, "(q1) extends "
              f"{delta('extend_calls')}")
        check(kv_digest(donor_st.state) == h0,
              "(q1) the seeded requests changed the donor's KV")
        errs = []
        for p, s in zip(prompts, suffixes):
            ref = row_of(calls, "prefill", p)[3]
            got = row_of(calls, "extend", s)[3]
            check(bool(torch.isfinite(got).all()), "(q1) seeded logits")
            err = (got - ref).abs().max().item()
            tol = 0.05 * ref.abs().max().item()
            check(err <= tol, f"(q1) seeded first logits off by {err} > "
                  f"{tol} from the full K1 prefill")
            errs.append(err / ref.abs().max().item())
        same = sum(a["output_ids"] == b["output_ids"]
                   for a, b in zip(seeded, plain))

        # a pure clone: the donor's whole sequence, no prefill at all
        seq = preamble + s0 + donor["on"]["output_ids"]
        s3 = on.stats()
        clone = post(urls["on"], {"prompt_ids": seq, "max_tokens": 32,
                                  "rid": "clone",
                                  "gconfig": {"greedy": True}})
        s4 = on.stats()
        check(delta("prefill_tokens", s3, s4) == 0
              and delta("extend_calls", s3, s4) == 0
              and delta("prefill_calls", s3, s4) == 0,
              "(q1) the exact-match clone prefilled")
        check(delta("serving/prefix_hits", s3, s4) == 1
              and delta("serving/prefix_tokens_saved", s3, s4) == len(seq),
              "(q1) the clone was not counted as a full hit")
        cont = post(urls["on"], {"prompt_ids": seq, "max_tokens": 32,
                                 "rid": "donor", "tokens_done": 128,
                                 "gconfig": {"greedy": True}})
        check(delta("prefill_calls", s4, on.stats()) == 0,
              "(q1) the donor's rid continuation prefilled")
        check(clone["output_ids"] == cont["output_ids"]
              and clone["output_logprobs"] == cont["output_logprobs"],
              "(q1) the pure clone's tokens differ from the donor's rid "
              "continuation")
        check(kv_digest(donor_st.state) == h0,
              "(q1) the clone changed the donor's KV")

        # a short overlap: seeding would not narrow the prefill
        s5 = on.stats()
        short = post(urls["on"], {"prompt_ids": preamble[:100] + toks(20),
                                  "max_tokens": 8, "rid": "short",
                                  "gconfig": {"greedy": True}})
        check_reply(short, 8, eos, "(q1) short overlap")
        check(delta("serving/prefix_skipped_no_savings", s5, on.stats())
              == 1, "(q1) the short overlap did not count as skipped")
        launches = fa.launch_count()
        n_prefills = on.stats()["prefill_calls"] + off.stats()["prefill_calls"]
        check(launches == cfg.n_layers * n_prefills or not cuda,
              f"(q1) K1 launched {launches} times over {n_prefills} "
              "batched prefills")

        # Controls: a seed one token short and a seed of another preamble
        # must fail the 5% limit above (on the card: on a tiny model the
        # last token's own logit dominates and the limit separates
        # nothing). The tight check redoes each seeded extend outside the
        # server on a fresh clone of the donor at the server's shapes; the
        # right clone must agree within SEED_TOL of max|logit| and both
        # wrong ones must not.
        dev = donor_st.state["kv_k"].device
        other = torch.randint(0, eos, (1, len(preamble)),
                              generator=torch.Generator().manual_seed(8))
        with torch.inference_mode():
            other = genmod.prefill_state(
                on.model, other.to(dev),
                torch.tensor([len(preamble)], device=dev),
                donor_st.state["kv_k"].shape[2], attn_impl="reference")
        rel = {k: [] for k in ("seed", "short_seed", "other_seed", "plain",
                               "k1_plain", "short_k1", "other_k1")}
        own = 0
        for p, s in zip(prompts, suffixes):
            ref = row_of(calls, "prefill", p)[3]
            tokens, lens, S, got = row_of(calls, "extend", s)
            r = seed_readings(on.model, donor_st.state, other, len(preamble),
                              p, tokens, lens, S)
            scale = ref.abs().max().item()
            own += int(ref.argmax()) == p[-1]
            for key, (x, y) in {
                    "seed": (got, r["seed"]),
                    "short_seed": (r["short"], r["seed"]),
                    "other_seed": (r["other"], r["seed"]),
                    "plain": (got, r["plain"]), "k1_plain": (ref, r["plain"]),
                    "short_k1": (r["short"], ref),
                    "other_k1": (r["other"], ref)}.items():
                rel[key].append((x - y).abs().max().item() / scale)
        check(min(rel["short_k1"] + rel["other_k1"]) > 0.05 or not cuda,
              "(q1) a wrong seed is within 5% of max|logit| of K1's full "
              f"prefill: one token short {rel['short_k1']}, another "
              f"preamble {rel['other_k1']}")
        check(max(rel["seed"]) <= SEED_TOL,
              f"(q1) seeded first logits off by {rel['seed']} of max|logit| "
              f"> {SEED_TOL} from the extend redone on the donor's clone")
        check(min(rel["short_seed"] + rel["other_seed"]) > SEED_TOL,
              f"(q1) a wrong seed is within {SEED_TOL} of the right one: "
              f"one token short {rel['short_seed']}, another preamble "
              f"{rel['other_seed']}")
    finally:
        restore()
        on.stop()
        off.stop()
    return {
        "k1_launches": launches, "batched_prefills": n_prefills,
        "prefix_hits": delta("serving/prefix_hits"),
        "prefix_tokens_saved": delta("serving/prefix_tokens_saved"),
        "seeded_prefill_tokens": delta("prefill_tokens"),
        "unseeded_prefill_tokens": s2_off["prefill_tokens"]
        - s1["off"]["prefill_tokens"],
        "seeded_extend_ms_each": 1e3 * delta("extend_secs") / 8,
        "seeded_extend_ms_total": 1e3 * delta("extend_secs"),
        "unseeded_prefill_ms_total": 1e3 * (s2_off["prefill_secs"]
                                            - s1["off"]["prefill_secs"]),
        "unseeded_prefill_calls": s2_off["prefill_calls"]
        - s1["off"]["prefill_calls"],
        "seeded_logit_err_rel_max": max(errs),
        "logit_err_rel_max": {k: max(v) for k, v in rel.items()},
        "control_err_rel_min": {k: min(rel[k]) for k in (
            "short_seed", "other_seed", "short_k1", "other_k1")},
        "seed_tol_rel": SEED_TOL,
        "rows_whose_own_token_has_max_logit": f"{own}/8",
        "greedy_continuations_equal_to_reuse_off": f"{same}/8",
        "kv_bytes_after": on.stats()["kv_bytes"],
    }


def hist_mean(snap: dict, name: str):
    h = snap["hists"].get(name)
    return h["sum"] / h["count"] if h and h["count"] else None


def run_classes(fa, cfg, params, eos, device="cuda") -> dict:
    """(q2): 64 rollouts of 160 tokens in flight through the manager, a
    burst of 16 interactive requests at an interactive queue limit of 4, a
    16,400-token prompt, the scrapes, then ``perf_probe decode-bench``."""
    from areal_tpu_torch.api.train_config import TelemetryConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.gserver_manager import (
        GserverManager,
        GserverManagerConfig,
    )
    from areal_tpu_torch.tools import perf_probe

    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.DEFAULT_REPO = name_resolve.MemoryNameRecordRepo()
    tel = TelemetryConfig(enabled=True, flush_interval_secs=3600)
    cuda = torch.device(device).type == "cuda"
    srv = serving_server(cfg, params, eos, "gen0", device,
                         server_kw={"max_batch_size": 16, "telemetry": tel},
                         queue_limit_interactive=4)
    mgr = GserverManager(GserverManagerConfig(
        experiment="chip_q", trial="q", n_servers=1, telemetry=tel,
        health_check_interval_secs=1.0))
    gen = torch.Generator().manual_seed(11)
    fa.reset_launch_count()
    url = srv.start()
    try:
        murl = mgr.start()

        def request(cls, prompt, rid, budget, gconfig):
            """One generation through the manager, chunk by chunk: (status
            of each chunk, reply, headers, seconds)."""
            _, route = post_json(murl, "/schedule_request", {"class": cls})
            acc, statuses, t0 = [], [], time.monotonic()
            out, hdrs = {}, {}
            while len(acc) < budget:
                left = budget - len(acc)
                s, out, hdrs = http_post(route["url"], "/generate", {
                    "prompt_ids": prompt + acc, "rid": rid, "class": cls,
                    "tokens_done": len(acc), "max_tokens": left,
                    "budget_total": left, "gconfig": gconfig})
                statuses.append(s)
                if s != 200:
                    break
                acc += out["output_ids"]
                if out["finished"]:
                    break
            post_json(murl, "/release", {"lease_id": route["lease_id"]})
            return statuses, out, hdrs, time.monotonic() - t0, len(acc)

        def toks(n):
            return torch.randint(0, eos, (n,), generator=gen).tolist()

        rollout_prompts = [toks(64 + 2 * i) for i in range(64)]
        inter_prompts = [toks(48) for _ in range(16)]
        pool = concurrent.futures.ThreadPoolExecutor(96)
        t0 = time.monotonic()
        rollouts = [pool.submit(request, "rollout", p, f"ro{i}", 160,
                                {"temperature": 1.0})
                    for i, p in enumerate(rollout_prompts)]
        deadline = time.monotonic() + 120
        while srv._inflight < 64 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(srv._inflight == 64, f"(q2) {srv._inflight} rollouts in flight")
        inter = [pool.submit(request, "interactive", p, f"in{i}", 32,
                             {"greedy": True})
                 for i, p in enumerate(inter_prompts)]
        too_long = pool.submit(http_post, url, "/generate", {
            "prompt_ids": toks(16400), "rid": "long", "class": "rollout",
            "max_tokens": 16, "gconfig": {"greedy": True}})
        inter = [f.result(timeout=600) for f in inter]
        too_long = too_long.result(timeout=600)
        rollouts = [f.result(timeout=900) for f in rollouts]
        wall = time.monotonic() - t0
        pool.shutdown()

        rejected = [r for r in inter if r[0][0] == 429]
        admitted = [r for r in inter if r[0] == [200]]
        check(rejected and admitted and len(rejected) + len(admitted) == 16,
              f"(q2) interactive statuses {[r[0] for r in inter]}")
        for statuses, body, hdrs, _, _ in rejected:
            check(hdrs.get("Retry-After") == "1" and body == {
                "ok": False, "reason": "admission", "class": "interactive",
                "queue_depth": 4, "retry_after": 0.5},
                f"(q2) 429 reply {body} Retry-After {hdrs.get('Retry-After')}")
        for r in admitted:
            check_reply(r[1], 32, eos, "(q2) interactive reply")
        check(all(set(r[0]) == {200} and (r[4] == 160 or r[1]["finished"])
                  for r in rollouts),
              f"(q2) a rollout failed: {[r[0] for r in rollouts]}")
        s, body, _ = too_long
        check(s == 413 and body.get("reason") == "prompt_too_long"
              and body["needed_slots"] > body["max_slots"],
              f"(q2) 16,400-token prompt: {s} {body}")
        snap = srv.telemetry.snapshot(reset=False)
        waits = {c: hist_mean(snap, f"serving/{c}/queue_wait_secs")
                 for c in ("interactive", "rollout")}
        check(waits["interactive"] < waits["rollout"],
              f"(q2) mean queue wait {waits}: interactive not below rollout")
        prom = http_text(url + "/metrics")
        mgr._update_fleet_gauges()
        mprom = http_text(murl + "/metrics")
        for fam in ("areal_serving_interactive_rejected_total",
                    "areal_serving_rollout_admitted_total",
                    "areal_serving_rollout_too_long_total",
                    "areal_serving_compiled_shapes",
                    "areal_serving_interactive_queue_wait_secs_bucket"):
            check(fam in prom, f"(q2) {fam} missing from the server's "
                  "/metrics")
        for c in ("interactive", "eval", "rollout"):
            check(f"areal_gsmgr_inflight_{c}" in mprom,
                  f"(q2) areal_gsmgr_inflight_{c} missing from the "
                  "manager's /metrics")
        bench = perf_probe.decode_bench(url, n_requests=24, max_tokens=32)
        bad = [e for e in bench["non_200"]
               if not e.endswith(("http429", "http413"))]
        check(not bad, f"(q2) decode-bench non-200 replies {bad}")
        st, launches = srv.stats(), fa.launch_count()
        check(launches == cfg.n_layers * st["prefill_calls"] or not cuda,
              f"(q2) K1 launched {launches} times over {st['prefill_calls']} "
              "prefills, the decode-bench's included")
    finally:
        mgr.stop()
        srv.stop()
        name_resolve.DEFAULT_REPO = old_repo
    ms = sorted(1e3 * r[3] for r in admitted)
    rl = sorted(1e3 * r[3] for r in rollouts)
    return {
        "wall_s": wall, "k1_launches": launches,
        "prefills": st["prefill_calls"],
        "interactive_429": len(rejected), "interactive_200": len(admitted),
        "too_long_413": too_long[1],
        "interactive_ms_mean": sum(ms) / len(ms),
        "rollout_160_tokens_ms_mean": sum(rl) / len(rl),
        "queue_wait_ms_mean": {c: 1e3 * v for c, v in waits.items()},
        "ttfc_ms_mean": {c: 1e3 * (hist_mean(
            snap, f"serving/{c}/ttfc_secs") or 0.0)
            for c in ("interactive", "rollout")},
        "dummy_row_share": st["dummy_row_steps"] / max(
            st["decode_row_steps"], 1),
        "compiled_shapes": len(st["shapes"]),
        "kv_peak_bytes": st["kv_peak_bytes"],
        "decode_bench": {k: bench[k] for k in (
            "requests", "non_200", "tokens", "wall_s", "tokens_per_s",
            "per_class")},
    }


def interactive_probe(exp, results: list, stop) -> None:
    """(q3): three interactive requests through the manager's class-aware
    schedule while the loop runs (the reference's e2e probe)."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.experiments import common as C

    repo = name_resolve.NfsNameRecordRepo(
        C.experiment_paths(exp)["name_resolve"])
    try:
        murl = repo.wait(names.gen_server_manager(exp.experiment_name,
                                                  exp.trial_name), timeout=600)
    except Exception as e:  # noqa: BLE001 — checked by the caller
        results.append({"error": repr(e)})
        return
    for i in range(3):
        if stop.is_set():
            return
        try:
            _, route = post_json(murl, "/schedule_request",
                                 {"class": "interactive"})
            if not route.get("url"):
                time.sleep(0.5)
                continue
            t0 = time.monotonic()
            s, out, _ = http_post(route["url"], "/generate", {
                "prompt_ids": [7, 8, 9, 10 + i], "class": "interactive",
                "rid": f"interactive{i}", "max_tokens": 16,
                "gconfig": {"greedy": True}})
            post_json(murl, "/release", {"lease_id": route.get("lease_id")})
            results.append({"status": s, "class": route.get("class"),
                            "ms": 1e3 * (time.monotonic() - t0), **out})
        except Exception as e:  # noqa: BLE001 — checked by the caller
            results.append({"error": repr(e)})
        time.sleep(1.0)


# ---------------- (r) the reward fleet and respawns ----------------

# (r): the worker killed after each step
REWARD_KILLS = ((1, "reward0"), (1, "rollout0"), (2, "gen_fleet"))


def nr_json(name_resolve, key):
    try:
        return json.loads(name_resolve.get(key))
    except (name_resolve.NameEntryNotFoundError, ValueError):
        return None


def nr_value(name_resolve, key):
    try:
        return name_resolve.get(key)
    except name_resolve.NameEntryNotFoundError:
        return None


def wait_master_step(exp, n: int, deadline: float, run: LoopRun) -> int:
    """Poll the master's control status until its step reaches ``n``. It
    answers between steps only, one message a step, so a request waits up
    to a minute for its answer: one abandoned every few seconds would pile
    up unanswered ahead of the next."""
    from areal_tpu_torch.system.worker_base import WorkerControlPanel

    panel = WorkerControlPanel(exp.experiment_name, exp.trial_name,
                               timeout=60.0)
    try:
        while time.monotonic() < deadline:
            check(run.thread.is_alive(), f"supervised loop ended before "
                  f"step {n}: {run.box.get('error')!r}")
            try:
                st = panel.status("master")
                if st.get("step", 0) >= n:
                    return st["step"]
            except TimeoutError:
                pass
            time.sleep(0.2)
    finally:
        panel.close()
    raise SmokeFailure(f"the master never reached step {n}")


def wait_trained_version(exp, n: int, deadline: float, run: LoopRun) -> int:
    """Poll the actor's version in name_resolve, which the trainer bumps as
    it publishes each train step's weights, until it reaches ``n``. It reads
    while the master is inside a step (in (r), one the trainer holds),
    where the master's control status answers only between steps."""
    from areal_tpu_torch.base import name_resolve, names

    key = names.model_version(exp.experiment_name, exp.trial_name, "actor")
    while time.monotonic() < deadline:
        check(run.thread.is_alive(), f"supervised loop ended before "
              f"version {n}: {run.box.get('error')!r}")
        v = nr_value(name_resolve, key)
        if v is not None and int(v) >= n:
            return int(v)
        time.sleep(0.05)
    raise SmokeFailure(f"the trainer never published version {n}")


def kill_and_respawn(sup, exp, name: str, deadline: float,
                     run: LoopRun) -> dict:
    """SIGKILL ``name``'s process and wait for its next incarnation's
    registration in name_resolve: a reward worker's heartbeat and URL, a
    rollout worker's heartbeat, the fleet's server and manager (the
    manager registers last). Seconds from the kill."""
    import signal

    from areal_tpu_torch.base import name_resolve, names

    e, E, T = sup.entry(name), exp.experiment_name, exp.trial_name
    hb = {"reward0": "reward0", "rollout0": "rollout0",
          "gen_fleet": "gserver_manager"}[name]
    keys = [names.worker_heartbeat(E, T, hb)]
    if name == "reward0":
        keys.append(names.reward_worker(E, T, "rw0"))
    if name == "gen_fleet":
        keys += [names.gen_servers(E, T, "gen0"),
                 names.gen_server_manager(E, T)]
    inc, pid = e.incarnation, e.proc.pid
    t_kill = time.time()
    os.kill(pid, signal.SIGKILL)
    while time.monotonic() < deadline:
        check(run.thread.is_alive(), f"supervised loop ended before {name} "
              f"registered again: {run.box.get('error')!r}")
        beat = nr_json(name_resolve, keys[0])
        if (e.incarnation == inc + 1 and beat is not None
                and beat.get("incarnation") == inc + 1
                and all(nr_value(name_resolve, k) for k in keys[1:])):
            break
        time.sleep(0.05)
    else:
        raise SmokeFailure(f"{name}: no new incarnation registered")
    t_reg = time.time()
    return {"name": name, "kind": e.spec.kind, "killed_pid": pid,
            "new_pid": e.proc.pid, "t_kill": t_kill,
            "respawned_s": sup.respawn_times[name][-1] - t_kill,
            "registered_s": t_reg - t_kill}


def opens_card(pid: int) -> bool:
    """Whether the process holds a descriptor of a /dev/nvidia* node (a
    CUDA context does)."""
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def torch_import_rss_mb() -> float:
    """The resident set of a fresh interpreter that imports torch and sees
    no card, as a reward worker would pay if it imported torch."""
    code = ("import os, torch; print(int(open('/proc/self/statm').read()"
            ".split()[1]) * os.sysconf('SC_PAGE_SIZE'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return int(out.stdout.split()[-1]) / 2 ** 20


def card_contexts(sup) -> dict:
    """(r): whether the reward workers hold a descriptor of a /dev/nvidia*
    node, with the trainer and the fleet as the control (they must). This
    stands in for ``nvidia-smi --query-compute-apps=pid``, which lists no
    pid of a process in the card machine's sandbox, the trainer's neither."""
    pids = {n: sup.entry(n).proc.pid
            for n in ("reward0", "reward1", "trainer", "gen_fleet")}
    out = {n: {"pid": p, "opens_card": opens_card(p)}
           for n, p in pids.items()}
    for n in ("trainer", "gen_fleet"):
        check(out[n]["opens_card"], f"(r) control: {n} holds no "
              f"/dev/nvidia descriptor: {out}")
    for n in ("reward0", "reward1"):
        check(not out[n]["opens_card"],
              f"(r): reward worker {n} holds a CUDA context: {out}")
    return out


def count_lines(paths) -> "collections.Counter":
    import collections

    c = collections.Counter()
    for path in paths:
        with open(path) as f:
            c.update(ln.strip() for ln in f if ln.strip())
    return c


def check_loop_stats(stats, what: str) -> None:
    for i, st in enumerate(stats):
        for k in ("actor_train/actor_loss", "critic_train/critic_loss",
                  "actor_train/grad_norm", "critic_train/grad_norm"):
            check(k in st and math.isfinite(st[k]),
                  f"{what} step {i}: {k} = {st.get(k)}")


def run_reward_fleet(cfg, tmp: str, device: str = "cuda", steps: int = 3,
                     n_prompts: int = 4, group_size: int = 16,
                     chunk_tokens: int = 128, max_new_tokens: int = 256,
                     timeout: float = 600.0, extra=(), hf_dir=None) -> dict:
    """(r): (o)'s loop with the reward fleet on (two reward workers) on a
    seeded half-math half-code dataset, through the launcher's
    supervisor, killing a reward worker and then the rollout worker after
    step 1 and the generation fleet after step 2. The trainer holds the step
    after the last kill until that kill's respawn has registered, so that
    fast steps cannot end the loop first. The checks of the module
    docstring; the launch checks only on the card."""
    import functools
    import glob
    import multiprocessing

    import numpy as np

    from areal_tpu_torch.api.cli_args import validate_config
    from areal_tpu_torch.apps.launcher import LocalLauncher
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system.http import request_json
    from areal_tpu_torch.system.reward_worker import resolve_fleet
    from areal_tpu_torch.tools import perf_probe

    cuda = torch.device(device).type == "cuda"
    t_setup = time.monotonic()
    # a bare ``import torch``'s resident set, measured while the loop runs
    rss_pool = concurrent.futures.ThreadPoolExecutor(1)
    bare_rss = rss_pool.submit(torch_import_rss_mb)
    rss_pool.shutdown(wait=False)
    exp = async_loop_config(cfg, tmp, "r", device, steps, n_prompts,
                            group_size, chunk_tokens, max_new_tokens,
                            ("reward_service.enabled=true",
                             "reward_service.n_workers=2", *extra),
                            mixed=True, hf_dir=hf_dir)
    validate_config(exp)
    log_dir = os.path.join(tmp, "probe")
    os.makedirs(log_dir)
    ctx = multiprocessing.get_context("spawn")
    pipes = {k: ctx.Pipe(duplex=False)
             for k in ("trainer", "gen_fleet", "rollout")}
    last_kill = REWARD_KILLS[-1][0]
    check(steps > last_kill, f"(r): {steps} steps leave no step after the "
          f"kill after step {last_kill}")
    respawned = os.path.join(tmp, "last_respawn_registered")
    # the held MFCs are a step's inference ones: they run before its train
    # MFCs, so the critic_train of the step whose actor_train moved the
    # version to last_kill goes on, and the step after it waits
    probes = {
        "trainer": functools.partial(
            gated_trainer_probe, pipes["trainer"][1], respawned, last_kill,
            role="actor", mfcs=("ref_inf", "actor_inf", "critic_inf")),
        "gen_fleet": functools.partial(async_fleet_probe,
                                       pipes["gen_fleet"][1],
                                       first_digest=True),
        "rollout": functools.partial(async_rollout_probe,
                                     pipes["rollout"][1], log_dir=log_dir),
        "reward": functools.partial(reward_probe, log_dir)}
    old_repo = name_resolve.DEFAULT_REPO
    C.setup_name_resolve(exp)
    launcher = LocalLauncher(exp, probes=probes)
    t0 = time.monotonic()
    deadline = t0 + timeout + 300
    run = LoopRun(launcher.run, pipes, "(r)")
    try:
        kills = []
        for after, name in REWARD_KILLS:
            step = wait_trained_version(exp, after, deadline, run)
            kills.append({**kill_and_respawn(launcher.supervisor, exp, name,
                                             deadline, run),
                          "killed_after_step": step})
        open(respawned, "w").close()  # the held step goes on
        # while the loop runs: CUDA contexts, the fleet's counters, and a
        # reward-bench burst at the live fleet
        contexts = card_contexts(launcher.supervisor) if cuda else None
        fleet_json = {u: request_json(f"{u}/metrics.json")[1]
                      for u in resolve_fleet(exp.experiment_name, "r")}
        bench = perf_probe.reward_bench(exp.experiment_name, "r", 32)
        result = run.join(max(deadline - time.monotonic(), 1))
    finally:
        open(respawned, "w").close()
        if run.thread.is_alive():
            launcher.request_drain()
            run.thread.join(120)
        name_resolve.DEFAULT_REPO = old_repo
    loop_s = time.monotonic() - t0
    (tr,), (fleet,), (roll,) = (run.done(k) for k in
                                ("trainer", "gen_fleet", "rollout"))
    rewards = []
    for path in sorted(glob.glob(os.path.join(log_dir, "reward_*.json"))):
        with open(path) as f:
            rewards.append(json.load(f))
    verdicts = count_lines(glob.glob(os.path.join(log_dir, "reward_*.log")))
    client = count_lines(glob.glob(os.path.join(log_dir, "client_*.log")))

    check(result["steps"] == steps, f"(r): {result['steps']} steps")
    stats = result["stats"]
    check_loop_stats(stats, "(r)")
    check(launcher.supervisor.restart_counts == {
        "reward": 1, "rollout": 1, "gen_fleet": 1},
        f"(r): restarts {launcher.supervisor.restart_counts}")
    fleet_graded = sum(verdicts.values())
    trained = steps * n_prompts * group_size
    check(client["local_fallback"] == 0 and not roll["local_verdicts"],
          f"(r): local grading in the rollout process: {dict(client)}, "
          f"{roll['local_verdicts']}")
    check(client["remote"] >= trained, f"(r): {client['remote']} remote "
          f"grades for {trained} trained trajectories")
    # Every answered task is a fleet grade, and every fleet grade answers
    # a task a client sent: a grade whose worker or client was killed
    # before the answer landed is the difference.
    # (reward-bench's tasks are graded by the same fleet)
    bench_sent = bench["client"].get("remote", 0) + bench["client"].get(
        "retries", 0)
    check(client["remote"] + bench["client"].get("remote", 0)
          <= fleet_graded <= client["attempt"] + bench_sent,
          f"(r): the fleet graded {fleet_graded}; the rollout clients sent "
          f"{client['attempt']} tasks and got {client['remote']} answers, "
          f"reward-bench {bench['client']}")
    check(len(rewards) == 2 and all(
        not r["cuda_initialized"] and r["cuda_visible_devices"] == ""
        for r in rewards), f"(r): reward workers {rewards}")
    if cuda:  # this script is the main module of the spawned workers
        check(not any(r["torch_imported"] for r in rewards),
              f"(r): a reward worker imported torch: {rewards}")
    first = fleet["first_versioned_batch"]
    check(first and first["version"] in tr["digests"]
          and first["digests"] == tr["digests"][first["version"]],
          "(r): the respawned server's first batch at "
          f"v{first.get('version')} ran on weights other than the actor "
          "the trainer published as that version")
    check(fleet["running_rollouts"] == 0, "(r): running_rollouts "
          f"{fleet['running_rollouts']} after the master stopped")
    check(not roll["cuda_initialized"], "(r): the rollout worker "
          "initialised CUDA")
    recs = tr["records"]
    if cuda:
        check(fleet["prefill_k1"] and fleet["k1"]
              == cfg.n_layers * len(fleet["prefill_k1"]),
              f"(r): K1 launched {fleet['k1']} times in the respawned "
              f"fleet over {len(fleet['prefill_k1'])} prefills")
        for r in recs:
            check_launches(f"(r) {r['mfc']}", r["launches"],
                           r["micro_batches"], cfg.n_layers,
                           train=r["mfc"].endswith("_train"))
    launches = {k: sum(r["launches"][k] for r in recs) for k in KERNEL_NAMES}
    launches["flash_attention_fwd"] += fleet["k1"]
    times = fleet["times"]
    respawn = next(k for k in kills if k["name"] == "gen_fleet")
    t_spawn = respawn["t_kill"] + respawn["respawned_s"]
    return {
        "steps": result["steps"],
        "ms_per_step": 1e3 * float(np.mean([st["timeperf/e2e"]
                                            for st in stats[1:]])),
        "step_ms": [1e3 * st["timeperf/e2e"] for st in stats],
        "kills": [{**{k: v for k, v in kill.items() if k != "t_kill"},
                   "next_step_ms": 1e3 * stats[kill["killed_after_step"]][
                       "timeperf/e2e"]
                   if kill["killed_after_step"] < len(stats) else None}
                  for kill in kills],
        "fleet_respawn_split_s": {
            "kill_to_spawn": respawn["respawned_s"],
            "spawn_to_process_start": times["proc_start"] - t_spawn,
            "model_build_and_start": times["ready"] - times["proc_start"],
            "to_first_weight_update": (times["first_update"] - times["ready"]
                                       if times["first_update"] else None),
            "kill_to_registered": respawn["registered_s"]},
        "first_versioned_batch": {"version": first["version"],
                                  "s_after_ready": first["t"]
                                  - times["ready"]},
        "client": dict(client), "fleet_verdicts": dict(verdicts),
        "fleet_graded": fleet_graded, "fleet_metrics_json": fleet_json,
        "grade_ms_mean": float(np.mean(roll["grade_ms"])),
        "grade_calls": len(roll["grade_ms"]),
        "reward_workers": rewards, "card_contexts": contexts,
        "torch_import_rss_mb": bare_rss.result(timeout=300),
        "reward_bench": bench,
        "trainer_peak_gb": tr["peak_gb"], "server_peak_gb": fleet["peak_gb"],
        "launches_total": launches, "loop_s": loop_s,
        "setup_s": t0 - t_setup,
    }


# ---------------- (s) relaunch and drain ----------------


def gpu_memory_used_mb() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.split()[0])


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def percentile(xs, q: float):
    import numpy as np

    return float(np.percentile(xs, q)) if len(xs) else None


def unacked_at_trainer(path: str) -> int:
    """(s): spooled samples a trainer ingested and has not acked, from its
    ``ids_<pid>.txt``."""
    try:
        with open(path) as f:
            kinds = [line.split(" ", 1)[0] for line in f]
    except FileNotFoundError:
        return 0
    return kinds.count("ingest") - kinds.count("settled")


def check_spool(recover_dir: str, ids_dir: str, rollouts: list,
                killed_pid: int, ckpt_step: int, group_size: int,
                ckpts: list, t_kill: float) -> dict:
    """(s): no sample lost. On disk, ``appended == acked watermark + depth``;
    every sample of every prompt in the consumed log was settled by a
    trainer (acked: trained in a committed step) or dropped as a stale
    replay, or is still in the spool for the next incarnation; no prompt
    consumed twice; the relaunched worker replayed. Returns the spool's
    numbers: the delivery counters of both incarnations, the peak depth
    and bytes, append ms p50/p99 (all, and during a checkpoint's write),
    and the samples the relaunched trainer trained again (trained by the
    killed one in a committed step, their ack lost with it)."""
    import glob

    from areal_tpu_torch.system.sample_spool import SampleSpool
    from areal_tpu_torch.system.streams import unpack

    spool = SampleSpool(os.path.join(recover_dir, "spool_0"))
    st = spool.stats()
    pending = {unpack(raw)["ids"][0] for _, _, raw in spool.pending()}
    spool.close()
    appended = st.next_seqno - 1
    check(appended == st.acked_watermark + st.depth and appended > 0,
          f"(s): spool appended {appended} != acked {st.acked_watermark} + "
          f"depth {st.depth}")
    settled, stale, trained = set(), set(), {}
    for path in glob.glob(os.path.join(ids_dir, "ids_*.txt")):
        pid = int(os.path.basename(path)[4:-4])
        with open(path) as f:
            for line in f:
                kind, *rest = line.split()
                if kind == "settled":
                    settled.add(rest[0])
                elif kind == "stale":
                    stale.add(rest[0])
                elif kind == "trained":
                    trained.setdefault(pid, []).append((int(rest[0]),
                                                        rest[1]))
    with open(os.path.join(recover_dir, "rollout_consumed_0.log")) as f:
        consumed = [ln.strip() for ln in f if ln.strip()]
    check(consumed and len(consumed) == len(set(consumed)),
          "(s): a prompt consumed twice, or none consumed")
    lost = [f"{u}@{j}" for u in consumed for j in range(group_size)
            if f"{u}@{j}" not in settled | stale | pending]
    check(not lost, f"(s): {len(lost)} consumed samples neither settled, "
          f"dropped as stale nor spooled: {lost[:8]}")
    counts = [r["spool_counts"] or {} for r in rollouts]
    check(len(rollouts) == 2 and sum(c.get("replayed", 0) for c in counts)
          > 0, f"(s): rollout incarnations' spool counters {counts}")
    check(sum(c.get("appended", 0) for c in counts) == appended,
          f"(s): the incarnations appended {counts}, the spool {appended}")
    relaunched = [p for p in trained if p != killed_pid]
    committed = {i for v, i in trained.get(killed_pid, []) if v < ckpt_step}
    again = {i for p in relaunched for _, i in trained[p]} & committed
    appends = [a for r in rollouts for a in r["spool_appends"]]
    windows = [(c["t"] - c["write_s"], c["t"]) for c in ckpts]
    in_ckpt = [ms for w, ms, _, _ in appends
               if any(a <= w <= b for a, b in windows)]
    all_ms = [ms for _, ms, _, _ in appends]
    total = {k: sum(c.get(k, 0) for c in counts) for k in (
        "appended", "acked", "replayed", "resent", "backpressure_waits")}
    return {
        "appended": appended, "acked_watermark": st.acked_watermark,
        "depth_at_end": st.depth, "consumed_prompts": len(consumed),
        "settled": len(settled), "stale_dropped": len(stale),
        "spooled_at_end": len(pending & {f"{u}@{j}" for u in consumed
                                         for j in range(group_size)}),
        "counters": total, "by_incarnation": counts,
        "trained_again": len(again),
        "peak_depth": max((d for _, _, d, _ in appends), default=0),
        "peak_bytes": max((b for _, _, _, b in appends), default=0),
        "append_ms_p50": percentile(all_ms, 50),
        "append_ms_p99": percentile(all_ms, 99),
        "append_ms_max": max(all_ms, default=None),
        "appends_during_ckpt": len(in_ckpt),
        "append_ms_p50_during_ckpt": percentile(in_ckpt, 50),
        "append_ms_p99_during_ckpt": percentile(in_ckpt, 99),
        "kill_wall": t_kill}


def run_relaunch_drain(cfg, tmp: str, device: str = "cuda", steps: int = 4,
                       n_prompts: int = 4, group_size: int = 16,
                       chunk_tokens: int = 128, max_new_tokens: int = 256,
                       timeout: float = 600.0, kill_after: int = 1,
                       extra=(), hf_dir=None) -> dict:
    """(s): (o)'s loop with ``recover_mode=auto``, a recover checkpoint
    every step and the durable spool, through ``run_experiment``: the
    trainer SIGKILLed once step ``kill_after``'s checkpoint and publish are
    in; the relaunch resumes and replays the spool; after its first step,
    ``request_drain()`` (the SIGTERM handler's path). The checks of the
    module docstring."""
    import functools
    import glob
    import multiprocessing
    import signal

    import numpy as np

    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.base import name_resolve, recover
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.system import master_worker as MW

    cuda = torch.device(device).type == "cuda"
    t_setup = time.monotonic()
    exp = async_loop_config(cfg, tmp, "s", device, steps, n_prompts,
                            group_size, chunk_tokens, max_new_tokens,
                            ("recover_mode=auto", "exp_ctrl.ckpt_freq_steps=1",
                             "durability.enabled=true", *extra),
                            hf_dir=hf_dir)
    digest_dir = os.path.join(tmp, "digests")
    os.makedirs(digest_dir)
    recover_dir = C.experiment_paths(exp)["recover"]
    ctx = multiprocessing.get_context("spawn")
    pipes = {k: ctx.Pipe(duplex=False)
             for k in ("trainer", "gen_fleet", "rollout")}
    probes = {
        "trainer": functools.partial(async_trainer_probe,
                                     pipes["trainer"][1],
                                     digest_dir=digest_dir),
        "gen_fleet": functools.partial(async_fleet_probe,
                                       pipes["gen_fleet"][1]),
        "rollout": functools.partial(async_rollout_probe,
                                     pipes["rollout"][1])}
    launches, ckpts = [], []
    base, do_ckpt = L.LocalLauncher, MW.MasterWorker._do_ckpt

    class Recorded(base):
        """Each launch, when it started and failed, and (for a relaunch)
        the earlier launch's live children and the card's memory in use
        as it starts, before its trainer allocates."""

        def run(self):
            rec = {"launcher": self, "t_start": time.time()}
            if launches:
                rec["alive_before"] = [p.name for p in launches[-1][
                    "launcher"].procs if p.is_alive()]
                if cuda:
                    free, total = torch.cuda.mem_get_info()
                    rec["card_used_mb_smi"] = gpu_memory_used_mb()
                    rec["card_used_mb_torch"] = (total - free) / 2 ** 20
            launches.append(rec)
            try:
                return super().run()
            except BaseException as e:
                rec["t_fail"], rec["error"] = time.time(), repr(e)
                raise

    def timed_ckpt(master):
        t = time.perf_counter()
        out = do_ckpt(master)
        ckpts.append({"step": master.step, "dir": out, "t": time.time(),
                      "write_s": time.perf_counter() - t,
                      "step_ms": [1e3 * st["timeperf/e2e"]
                                  for st in master._stats_history]})
        return out

    old_repo = name_resolve.DEFAULT_REPO
    # the repository run_experiment sets up, here before the first status
    # poll (a poll on another repository waits out its timeout)
    C.setup_name_resolve(exp)
    L.LocalLauncher, MW.MasterWorker._do_ckpt = Recorded, timed_ckpt
    t0 = time.monotonic()
    deadline = t0 + 2 * timeout + 300
    run = LoopRun(lambda: L.run_experiment(exp, probes=probes), pipes, "(s)")
    try:
        wait_master_step(exp, kill_after, deadline, run)
        sup = launches[0]["launcher"].supervisor
        trainer_pid = sup.entry("trainer").proc.pid
        digest_v = os.path.join(digest_dir,
                                f"trainer_{trainer_pid}_v{kill_after}.json")
        while not (os.path.exists(digest_v) and any(
                c["step"] >= kill_after for c in ckpts)):
            check(time.monotonic() < deadline, "(s): step "
                  f"{kill_after}'s checkpoint or publish never landed")
            time.sleep(0.1)
        # and once the trainer holds a group of spooled samples it has not
        # acked, so that the relaunch has something to replay
        ids_path = os.path.join(digest_dir, f"ids_{trainer_pid}.txt")
        while unacked_at_trainer(ids_path) < group_size:
            check(time.monotonic() < deadline, "(s): the trainer never held "
                  f"{group_size} unacked spooled samples")
            time.sleep(0.05)
        t_kill = time.time()
        os.kill(trainer_pid, signal.SIGKILL)
        while len(launches) < 2:
            check(time.monotonic() < deadline and run.thread.is_alive(),
                  f"(s): no relaunch: {run.box.get('error')!r}")
            time.sleep(0.1)
        # The relaunched master answers once restored, between steps; its
        # first step starts then, and the drain's pause lands after it.
        wait_master_step(exp, kill_after, deadline, run)
        t_drain = time.monotonic()
        launches[1]["launcher"].request_drain()
        result = run.join(max(deadline - time.monotonic(), 1))
        drain_s = time.monotonic() - t_drain
    finally:
        L.LocalLauncher, MW.MasterWorker._do_ckpt = base, do_ckpt
        if run.thread.is_alive() and len(launches) > 1:
            launches[-1]["launcher"].request_drain()
            run.thread.join(120)
        name_resolve.DEFAULT_REPO = old_repo
    loop_s = time.monotonic() - t0
    first, second = launches
    check(len(launches) == 2 and "stateful worker trainer died" in
          first.get("error", ""), f"(s): launches {launches}")
    check(not second["alive_before"], "(s): the relaunch started with the "
          f"first launch's {second['alive_before']} alive")
    ckpt_step = max(c["step"] for c in ckpts if c["t"] <= t_kill)
    trs = run.done("trainer")
    check(len(trs) == 1, f"(s): {len(trs)} trainer records")
    tr = trs[0]
    recs = tr["records"]
    trained = [r for r in recs if r["mfc"] == "actor_train"]
    check(trained and trained[0]["version"] == ckpt_step, "(s): the "
          f"relaunched trainer's first step at actor v"
          f"{trained[0]['version'] if trained else None}, the checkpoint "
          f"holds v{ckpt_step}")
    check(ckpt_step < result["steps"] < steps
          and len(result["stats"]) == result["steps"] - ckpt_step,
          f"(s): resumed at step {ckpt_step}, drained at {result['steps']} "
          f"of {steps} with {len(result['stats'])} steps of stats")
    # the relaunched run's first step ends as its checkpoint starts
    first_ck = next(c for c in ckpts if c["t"] > t_kill)
    t_first = first_ck["t"] - first_ck["write_s"]
    check_loop_stats(result["stats"], "(s)")
    by_pid = {}
    for path in glob.glob(os.path.join(digest_dir, "trainer_*_v*.json")):
        pid, v = os.path.basename(path)[8:-5].split("_v")
        with open(path) as f:
            by_pid.setdefault(int(pid), {})[int(v)] = json.load(f)
    relaunched = [p for p in by_pid if p != trainer_pid]
    check(len(relaunched) == 1 and min(by_pid[relaunched[0]]) == ckpt_step
          and by_pid[relaunched[0]][ckpt_step]
          == by_pid[trainer_pid][ckpt_step],
          "(s): the relaunched actor's first publish is not the "
          f"checkpoint's v{ckpt_step} bit for bit")
    procs = {p.name: p.exitcode for p in second["launcher"].procs}
    check(procs.get("trainer") == 0 and procs.get("rollout0") == 0,
          f"(s): exit codes after the drain {procs}")
    info = recover.load(recover_dir)
    ck = recover.discover_ckpt(recover_dir)
    check(info is not None and info.last_step_info.global_step
          == result["steps"] and ck is not None
          and recover.ckpt_is_complete(ck),
          f"(s): no complete recover checkpoint at step {result['steps']}")
    fleets = run.done("gen_fleet")
    if cuda:
        for r in recs:
            check_launches(f"(s) {r['mfc']}", r["launches"],
                           r["micro_batches"], cfg.n_layers,
                           train=r["mfc"].endswith("_train"))
    launches_total = {k: sum(r["launches"][k] for r in recs)
                      for k in KERNEL_NAMES}
    launches_total["flash_attention_fwd"] += sum(f["k1"] for f in fleets)
    spool = check_spool(recover_dir, digest_dir, run.done("rollout"),
                        trainer_pid, ckpt_step, group_size, ckpts, t_kill)
    spool["ingest_relaunched"] = tr["ingest"]
    return {
        "steps": result["steps"], "resumed_at": ckpt_step,
        "spool": spool,
        "step_ms_before_kill": next(
            (c["step_ms"] for c in ckpts if c["step"] == ckpt_step
             and c["t"] <= t_kill), None),
        "step_ms": [1e3 * st["timeperf/e2e"] for st in result["stats"]],
        "kill_to_escalation_s": first["t_fail"] - t_kill,
        "escalation_to_relaunch_s": second["t_start"] - first["t_fail"],
        "escalation_to_first_step_s": t_first - first["t_fail"],
        "card_used_mb_at_relaunch_smi": second.get("card_used_mb_smi"),
        "card_used_mb_at_relaunch_torch": second.get("card_used_mb_torch"),
        "drain_s": drain_s,
        "recover_ckpt_bytes": dir_bytes(ck),
        "recover_ckpt_write_s": [[c["step"], c["write_s"]] for c in ckpts],
        "exit_codes": procs,
        "trainer_peak_gb": tr["peak_gb"],
        "launches_total": launches_total, "loop_s": loop_s,
        "setup_s": t0 - t_setup,
    }


# ---------------- (t) the elastic fleet ----------------


def get_json(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def window_rate(batches: list, a: float, b: float) -> dict:
    """A server's batches that started in [a, b): decode ms per step and
    generated tokens per second of the window."""
    bs = [x for x in batches if a <= x["t0"] < b]
    steps = sum(x["decode_steps"] for x in bs)
    return {"batches": len(bs),
            "decode_ms_per_step": (1e3 * sum(x["decode_s"] for x in bs)
                                   / steps if steps else None),
            "generated_tokens_per_s": (sum(x["tokens"] for x in bs)
                                       / (b - a) if b > a else None),
            "window_s": b - a}


def elastic_sequence(exp, launcher, run, deadline: float,
                     two_server_secs: float) -> dict:
    """(t)'s operator side, while the loop runs: wait for the plan to ask
    for a dynamic server, its spawn, registration and admission; keep two
    servers for ``two_server_secs``; cordon the
    baseline server with ``perf_probe cordon`` (a preemption notice) and
    follow its drain on the manager's fleet map (its outstanding leases may
    only fall: no new lease); ``perf_probe uncordon`` it and wait for its
    re-admission through the health gate. Wall-clock times of each stage,
    the fleet map at each and the manager's plan."""
    from areal_tpu_torch.base import name_resolve, names
    from areal_tpu_torch.system.autoscaler import read_plan
    from areal_tpu_torch.tools import perf_probe

    E, T = exp.experiment_name, exp.trial_name
    out = {}

    def wait(cond, what):
        while True:
            check(run.thread.is_alive(), f"(t): the loop ended before "
                  f"{what}: {run.box.get('error')!r}")
            check(time.monotonic() < deadline, f"(t): no {what}")
            got = cond()
            if got:
                return got
            time.sleep(0.1)

    mgr = wait(lambda: nr_value(name_resolve, names.gen_server_manager(E, T)),
               "manager")
    fleet = lambda: get_json(f"{mgr}/metrics.json")  # noqa: E731

    def server(sid):
        m = fleet()
        return next(((u, st, m) for u, st in m["fleet"].items()
                     if st["server_id"] == sid), (None, None, m))

    out["plan"] = wait(lambda: (read_plan(E, T) or {}).get("dynamic", 0) >= 1
                       and read_plan(E, T), "plan for a dynamic server")
    out["t_plan"] = time.time()
    m = fleet()
    out["at_plan"] = {"running_rollouts": m["running_rollouts"],
                      "autoscale": m["autoscale"],
                      "healthy_servers": m["healthy_servers"]}
    wait(lambda: launcher._scaler is not None and launcher._scaler.spawned,
         "dynamic spawn")
    out["t_spawn"] = time.time()
    wait(lambda: nr_value(name_resolve, names.gen_servers(E, T, "dyn1")),
         "dynamic server's registration")
    out["t_registered"] = time.time()

    def admitted(sid):
        u, st, m = server(sid)
        return (u and st["routable"] and st["acked_version"] == m["version"]
                and (u, m["version"]))

    dyn_url, out["version_at_admission"] = wait(lambda: admitted("dyn1"),
                                                "dynamic server's admission")
    out["t_routable"] = time.time()
    # a rollout stays on its server for all its chunks: dyn1's share of the
    # load starts with the next rollouts the gate admits
    wait(lambda: get_json(f"{dyn_url}/metrics.json")["generated_tokens"] > 0,
         "dyn1's first generated tokens")
    out["t_serving"] = time.time()
    print("(t) fleet-status with two servers:", flush=True)
    perf_probe.fleet_status(E, T)
    t_end = time.monotonic() + two_server_secs
    while time.monotonic() < t_end:
        check(run.thread.is_alive(), "(t): the loop ended with two servers")
        time.sleep(0.2)
    base_url, _, _ = server("gen0")
    check(base_url is not None, "(t): no baseline server gen0")
    out["t_cordon"] = time.time()
    reply = perf_probe.cordon(E, T, "gen0", "preemption notice")
    check(reply.get("ok") and reply.get("url") == base_url,
          f"(t): cordon gen0 answered {reply}")
    drains = [reply.get("draining", 0)]

    def drained():
        _, st, _ = server("gen0")
        check(st is not None and st["cordoned"] and not st["routable"],
              f"(t): gen0 while draining: {st}")
        drains.append(st["draining"])
        return st["draining"] == 0

    wait(drained, "drain of the cordoned gen0")
    out["t_drained"] = time.time()
    check(all(b <= a for a, b in zip(drains, drains[1:])), "(t): the "
          f"cordoned gen0 got a new lease: outstanding leases {drains}")
    out["drain_leases"] = drains[0]
    res = perf_probe.cordon(E, T, "gen0", un=True)
    check(res.get("ok"), f"(t): uncordon gen0 answered {res}")
    out["t_uncordon"] = time.time()
    _, out["version_at_readmission"] = wait(lambda: admitted("gen0"),
                                            "gen0's re-admission")
    out["t_readmitted"] = time.time()
    out["servers"] = {"gen0": base_url, "dyn1": dyn_url}
    return out


def run_elastic_fleet(cfg, tmp: str, device: str = "cuda", steps: int = 5,
                      n_prompts: int = 4, group_size: int = 16,
                      chunk_tokens: int = 128, max_new_tokens: int = 256,
                      timeout: float = 600.0, two_server_secs: float = 10.0,
                      extra=(), hf_dir=None) -> dict:
    """(t): (o)'s loop with ``autoscale.enabled=true min_servers=1
    max_servers=2`` through the launcher, and :func:`elastic_sequence`
    while it runs. The checks of the module docstring; the launch checks
    only on the card."""
    import functools
    import multiprocessing

    import numpy as np

    from areal_tpu_torch.api.cli_args import validate_config
    from areal_tpu_torch.apps.launcher import LocalLauncher
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.experiments import common as C

    cuda = torch.device(device).type == "cuda"
    script_reserved = (torch.cuda.memory_reserved() / 2 ** 30 if cuda
                       else None)
    t_setup = time.monotonic()
    exp = async_loop_config(cfg, tmp, "t", device, steps, n_prompts,
                            group_size, chunk_tokens, max_new_tokens,
                            ("autoscale.enabled=true",
                             "autoscale.min_servers=1",
                             "autoscale.max_servers=2",
                             # the one cut: a tick a second, so that the
                             # replacement a cordoned gen0 draws is scaled
                             # down as soon as it is admitted (a third
                             # server's memory on one card)
                             "autoscale.interval_secs=1", *extra),
                            hf_dir=hf_dir)
    validate_config(exp)
    ctx = multiprocessing.get_context("spawn")
    pipes = {k: ctx.Pipe(duplex=False)
             for k in ("trainer", "gen_fleet", "gen_server", "rollout")}
    probes = {
        "trainer": functools.partial(async_trainer_probe,
                                     pipes["trainer"][1]),
        "gen_fleet": functools.partial(async_fleet_probe,
                                       pipes["gen_fleet"][1]),
        "gen_server": functools.partial(dyn_server_probe,
                                        pipes["gen_server"][1]),
        "rollout": functools.partial(async_rollout_probe,
                                     pipes["rollout"][1])}
    old_repo = name_resolve.DEFAULT_REPO
    C.setup_name_resolve(exp)
    launcher = LocalLauncher(exp, probes=probes)
    mem, stop_mem = [], threading.Event()

    def sample_mem():  # the card's memory in use, every second
        while not stop_mem.wait(1.0):
            mem.append((time.time(), gpu_memory_used_mb()))

    if cuda:
        threading.Thread(target=sample_mem, daemon=True).start()
    t0 = time.monotonic()
    deadline = t0 + timeout + 300
    run = LoopRun(launcher.run, pipes, "(t)")
    try:
        ev = elastic_sequence(exp, launcher, run, deadline, two_server_secs)
        result = run.join(max(deadline - time.monotonic(), 1))
    finally:
        stop_mem.set()
        if run.thread.is_alive():
            launcher.request_drain()
            run.thread.join(120)
        name_resolve.DEFAULT_REPO = old_repo
    loop_s = time.monotonic() - t0
    (tr,), (fleet,), (roll,) = (run.done(k) for k in
                                ("trainer", "gen_fleet", "rollout"))
    dyns = {d["server_id"]: d for d in run.done("gen_server")}
    check(result["steps"] == steps, f"(t): {result['steps']} steps")
    stats = result["stats"]
    check_loop_stats(stats, "(t)")
    # The cordoned gen0 leaves one routable server under a target of 2, so
    # the plan may ask for a replacement (dyn2); gen0's re-admission then
    # puts the fleet over its target and the loop scales a dynamic server
    # down (cordon, drain, commanded exit). Every dynamic server must exit
    # 0, by that command or at the shutdown, and send its record.
    spawned = launcher._scaler.spawned
    check(ev["plan"]["target"] == 2 and spawned[:1] == ["dyn1"]
          and sorted(dyns) == sorted(spawned),
          f"(t): plan {ev['plan']}, spawned {spawned}, records "
          f"{sorted(dyns)}")
    exits = {sid: launcher.supervisor.entry(f"genserver_{sid}").proc.exitcode
             for sid in spawned}
    check(all(code == 0 for code in exits.values()),
          f"(t): dynamic servers' exit codes {exits}")
    dyn = dyns["dyn1"]
    first = dyn["first_versioned_batch"]
    for sid, d in dyns.items():
        f = d["first_versioned_batch"]
        check(sid != "dyn1" or f, "(t): dyn1 served no batch at a version "
              "> 0")
        check(not f or (f["version"] in tr["digests"]
                        and f["digests"] == tr["digests"][f["version"]]),
              f"(t): {sid}'s first batch at v{f.get('version')} ran on "
              "weights other than the actor the trainer published as that "
              "version")
    check(roll["abandoned"] == 0 and fleet["running_rollouts"] == 0,
          f"(t): {roll['abandoned']} rollouts abandoned, "
          f"{fleet['running_rollouts']} samples of quota held at the end")
    check(roll["pushed"] >= steps * n_prompts * group_size,
          f"(t): {roll['pushed']} trajectories pushed")
    recs = tr["records"]
    if cuda:
        for who, f in (("gen0", fleet), *dyns.items()):
            check(f["kernels_prebuilt"] and f["k1"]
                  == cfg.n_layers * len(f["prefill_k1"])
                  + sum(f["failed_prefill_k1"])
                  and (f["prefill_k1"] or who not in ("gen0", "dyn1")),
                  f"(t): K1 launched {f['k1']} times in {who} over "
                  f"{len(f['prefill_k1'])} prefills and "
                  f"{len(f['failed_prefill_k1'])} failed ones "
                  f"({f['failed_prefill_k1']} launches)")
        for r in recs:
            check_launches(f"(t) {r['mfc']}", r["launches"],
                           r["micro_batches"], cfg.n_layers,
                           train=r["mfc"].endswith("_train"))
    launches = {k: sum(r["launches"][k] for r in recs) for k in KERNEL_NAMES}
    launches["flash_attention_fwd"] += fleet["k1"] + sum(
        d["k1"] for d in dyns.values())
    # the step ends (the last MFC of each step) split at the admission
    ends = [max(r["t1"] for r in recs[i:i + len(ASYNC_MFCS)])
            for i in range(0, len(recs), len(ASYNC_MFCS))]
    starts = [None] + ends[:-1]
    step_ms = [1e3 * st["timeperf/e2e"] for st in stats]
    before = [ms for ms, e in zip(step_ms[1:], ends[1:])
              if e <= ev["t_routable"]]
    after = [ms for ms, a in zip(step_ms, starts)
             if a is not None and a >= ev["t_routable"]]
    t_first = fleet["batches"][0]["t0"] if fleet["batches"] else t0
    one = {"gen0": window_rate(fleet["batches"], t_first, ev["t_routable"])}
    two = {"gen0": window_rate(fleet["batches"], ev["t_serving"],
                               ev["t_cordon"]),
           "dyn1": window_rate(dyn["batches"], ev["t_serving"],
                               ev["t_cordon"])}
    cordoned = {"dyn1": window_rate(dyn["batches"], ev["t_cordon"],
                                    ev["t_drained"])}
    times = dyn["times"]
    return {
        "steps": result["steps"], "step_ms": step_ms,
        "ms_per_step_before_scale_up": (float(np.mean(before))
                                        if before else None),
        "ms_per_step_after_scale_up": float(np.mean(after)) if after else None,
        "plan": ev["plan"], "at_plan": ev["at_plan"],
        "plan_to_spawn_s": ev["t_spawn"] - ev["t_plan"],
        "plan_to_process_start_s": times["proc_start"] - ev["t_plan"],
        "plan_to_model_built_s": times["ready"] - ev["t_plan"],
        "plan_to_registered_s": ev["t_registered"] - ev["t_plan"],
        "plan_to_routable_s": ev["t_routable"] - ev["t_plan"],
        "routable_to_first_tokens_s": ev["t_serving"] - ev["t_routable"],
        "version_at_admission": ev["version_at_admission"],
        "first_versioned_batch": {"version": first["version"],
                                  "s_after_ready": first["t"]
                                  - times["ready"]},
        "one_server": one, "two_servers": two,
        "two_servers_tokens_per_s": sum(
            w["generated_tokens_per_s"] or 0.0 for w in two.values()),
        "while_gen0_drains": cordoned,
        "cordon_to_drained_s": ev["t_drained"] - ev["t_cordon"],
        "leases_draining_at_cordon": ev["drain_leases"],
        "uncordon_to_readmitted_s": ev["t_readmitted"] - ev["t_uncordon"],
        "version_at_readmission": ev["version_at_readmission"],
        "card_used_mb_two_servers": max(
            (mb for t, mb in mem if ev["t_serving"] <= t < ev["t_cordon"]),
            default=None),
        "card_used_mb_max": max((mb for _, mb in mem), default=None),
        "card_used_mb_max_after_plan_s": (max(mem, key=lambda x: x[1])[0]
                                          - ev["t_plan"] if mem else None),
        "peak_gb": {"trainer": tr["peak_gb"], "gen0": fleet["peak_gb"],
                    "dyn1": dyn["peak_gb"]},
        # what each process's allocator held at most, and this process's
        # own as the phase starts
        "reserved_peak_gb": {"trainer": tr["reserved_peak_gb"],
                             "gen0": fleet["reserved_peak_gb"],
                             **{sid: d["reserved_peak_gb"]
                                for sid, d in dyns.items()}},
        "script_reserved_gb": script_reserved,
        "failovers": roll["failovers"], "denials": roll["denials"],
        "failed_prefills": {who: len(f["failed_prefill_k1"])
                            for who, f in (("gen0", fleet), *dyns.items())},
        "dynamic_servers": {sid: {
            "batches": len(d["batches"]), "exit_code": exits[sid],
            "prefills": len(d["prefill_k1"]),
            "proc_start_after_plan_s": d["times"]["proc_start"]
            - ev["t_plan"],
            "ready_after_plan_s": d["times"]["ready"] - ev["t_plan"],
            "first_versioned_batch": (d["first_versioned_batch"] or {}).get(
                "version"), "peak_gb": d["peak_gb"]}
            for sid, d in dyns.items()},
        "launches_total": launches, "loop_s": loop_s,
        "setup_s": t0 - t_setup,
    }


# ---------------- (u)-(x): SFT with automatic evaluation, reward-model
# training, the fused node, the multi-turn agent ----------------

def seeded_text(rng, lo: int, hi: int) -> str:
    """Seeded lower-case words, ``lo``-``hi`` characters (byte tokens)."""
    n = rng.randint(lo, hi)
    words, size = [], 0
    while size < n:
        w = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                    for _ in range(rng.randint(1, 9)))
        words.append(w)
        size += len(w) + 1
    return " ".join(words)[:n]


def write_sft_records(path: str, n: int, seed: int) -> None:
    """``n`` prompt-answer records from ``seed``: prompts of 64-512 and
    answers of 128-768 byte tokens."""
    import random

    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"query_id": f"s{i}",
                                "prompt": seeded_text(rng, 64, 512),
                                "answer": seeded_text(rng, 128, 768)})
                    + "\n")


def eval_processes(under: str) -> list:
    """The pids of live eval subprocesses (``apps.eval_ckpt``) whose
    command line names a path under ``under`` (one phase's directory)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().split(")")[-1].split()[0]
        except OSError:
            continue
        if (b"areal_tpu_torch.apps.eval_ckpt" in cmd and state != "Z"
                and any(a.startswith(under.encode()) for a in cmd)):
            out.append(int(pid))
    return out


EVAL_KEYS = ("pass@1", "pass@4", "pass^4")


def check_scores(step: int, scores: dict, cfg, n_records: int, k: int,
                 batch: int, cuda: bool) -> None:
    """An evaluation's scores: pass@1, pass@k and pass^k overall and per
    task kind, in [0, 1]; on the card, the eval child generated in bf16
    and launched K1 n_layers x its prefills (k draws x its batches)."""
    for kind in ("", "math/", "code/"):
        for key in EVAL_KEYS:
            v = scores.get(kind + key)
            check(v is not None and 0.0 <= v <= 1.0,
                  f"(u) eval of step {step}: {kind + key} = {v}")
    check(scores["n"] == n_records and scores["k"] == k,
          f"(u) eval of step {step}: n {scores['n']}, k {scores['k']}")
    dev = scores["device"]
    if cuda:
        want = cfg.n_layers * k * math.ceil(n_records / batch)
        check(dev["type"] == "cuda" and dev["dtype"] == "bfloat16"
              and dev["flash_attention_fwd_launches"] == want,
              f"(u) eval of step {step}: the child launched K1 "
              f"{dev['flash_attention_fwd_launches']} times on "
              f"{dev['type']} in {dev['dtype']}, expected {want} in "
              "bfloat16")


def gated_trainer_probe(conn, flag: str, hold_from: int, worker,
                        role: str = "default", mfcs=None):
    """(u)'s and (r)'s trainer probe: :func:`async_trainer_probe`, and every
    MFC (of ``mfcs`` when given) from ``role``'s global step ``hold_from``
    on held, outside its timing, until ``flag`` exists (at most 600 s): in
    (u) so that the launcher's evaluator scores the save of step
    ``hold_from`` while the run lasts, in (r) so that the loop outlasts its
    last kill's respawn."""
    done = async_trainer_probe(conn, worker)
    handle = worker._handle_mfc

    def gated(p):
        if (p.data.get("method") != "noop"
                and (mfcs is None or p.data.get("mfc") in mfcs)
                and worker.models[role].version.global_step
                >= hold_from):
            deadline = time.monotonic() + 600
            while not os.path.exists(flag) and time.monotonic() < deadline:
                time.sleep(0.1)
        return handle(p)

    worker._handle_mfc = gated
    return done


def eval_prefill_shapes(path: str, batch: int) -> list:
    """The [B, P] of each prefill the eval child runs on ``path``'s
    records: its byte tokens, padded per batch as ``eval_ckpt`` pads."""
    from areal_tpu_torch.base.testing import ByteTokenizer as PortTokenizer
    from areal_tpu_torch.datasets.jsonl import load_jsonl
    from areal_tpu_torch.models import generate as G

    tok, recs = PortTokenizer(), load_jsonl(path)
    return sorted({G.pad_prompts([list(map(int, tok.encode(r["prompt"])))
                                  for r in recs[i:i + batch]], 0)[0].shape
                   for i in range(0, len(recs), batch)})


def run_sft_auto_eval(cfg, tmp: str, hf_dir: str, device: str = "cuda",
                      steps: int = 4, n_seqs: int = 64, max_seqlen: int = 1024,
                      mb_tokens: int = 4096, n_eval: int = 32, eval_k: int = 4,
                      max_gen_tokens: int = 128, timeout: float = 600.0,
                      fa=None) -> dict:
    """(u): SFT through ``run_experiment`` on the port's SFTConfig (what
    ``python -m areal_tpu_torch.training.main_sft`` builds) from
    ``hf_dir``, with ``auto_eval=true``: the launcher's evaluator scores
    each saved ``default/step*`` in an eval subprocess on the same device
    while the trainer runs. The trainer holds step 3 until the launcher's
    evaluator has scored step 2's save; the last save's evaluation is
    stopped with the run, and an evaluator of the phase's own on the same
    save directory scores it after the run. On the card, K1 is first
    checked against its plain version at the eval's prefill shapes."""
    import functools
    import multiprocessing

    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.apps import launcher as L
    from areal_tpu_torch.apps.evaluator import AutomaticEvaluator
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.experiments import common as C
    from areal_tpu_torch.experiments.sft_exp import SFTConfig

    cuda = torch.device(device).type == "cuda"
    data = os.path.join(tmp, "sft.jsonl")
    write_sft_records(data, steps * n_seqs, seed=5)
    eval_data = os.path.join(tmp, "eval.jsonl")
    write_mixed_prompts(eval_data, n_eval, seed=6)
    eval_shapes = eval_prefill_shapes(eval_data, 16)
    k1_eval_checks = ([check_k1(fa, B, P, cfg.n_q_heads, cfg.n_kv_heads,
                                cfg.head_dim, seed=13 + i)
                       for i, (B, P) in enumerate(eval_shapes)]
                      if cuda else [])
    exp = SFTConfig(experiment_name="chip_smoke", trial_name="u",
                    backend="cuda" if cuda else "cpu")
    CA.apply_overrides(exp, [
        f"cluster.fileroot={tmp}", f"dataset.path={data}",
        f"model.path={hf_dir}", "mock_tokenizer=true",
        f"dataset.max_seqlen={max_seqlen}",
        f"dataset.train_bs_n_seqs={n_seqs}",
        f"allocation.mb_spec.max_tokens_per_mb={mb_tokens}",
        f"exp_ctrl.benchmark_steps={steps}", "exp_ctrl.save_freq_steps=2",
        "auto_eval=true", f"auto_eval_config.data_names={eval_data}",
        f"auto_eval_config.max_gen_tokens={max_gen_tokens}",
        f"auto_eval_config.eval_k={eval_k}"])
    CA.validate_config(exp)
    ctx = multiprocessing.get_context("spawn")
    hold = 2  # the first save; the trainer holds step 3 until it is scored
    flag = os.path.join(tmp, f"step{hold}_scored")
    pipes = {"trainer": ctx.Pipe(duplex=False)}
    probes = {"trainer": functools.partial(gated_trainer_probe,
                                           pipes["trainer"][1], flag, hold)}
    samples, stop = [], threading.Event()

    def sample_card():  # the card's memory, and whether an eval runs
        while not stop.is_set():
            if cuda:
                samples.append((time.monotonic(), gpu_memory_used_mb(),
                                bool(eval_processes(tmp))))
            stop.wait(1.0)

    # the launcher's own evaluator, kept to be read (nothing else changes)
    built, build = [], L.LocalLauncher._build_evaluator

    def keep_evaluator(self, *a):
        built.append(build(self, *a))
        return built[-1]

    old_repo = name_resolve.DEFAULT_REPO
    sampler = threading.Thread(target=sample_card, daemon=True)
    sampler.start()
    L.LocalLauncher._build_evaluator = keep_evaluator
    t0 = time.monotonic()
    t_scored = None
    try:
        run = LoopRun(lambda: run_experiment(exp, probes=probes), pipes,
                      "(u) sft")
        deadline = t0 + timeout
        while run.thread.is_alive() and time.monotonic() < deadline:
            if built and any(s.step == hold and s.status in ("done", "failed")
                             for s in built[0].steps):
                t_scored = time.monotonic() - t0
                break
            time.sleep(0.2)
        open(flag, "w").close()
        result = run.join(timeout + 300)
        run_s = time.monotonic() - t0
        (tr,) = run.done("trainer")
    finally:
        open(flag, "w").close()
        L.LocalLauncher._build_evaluator = build
        stop.set()
        sampler.join(10)
        name_resolve.DEFAULT_REPO = old_repo
    check(not eval_processes(tmp), f"(u): eval subprocesses outlived the "
          f"run: {eval_processes(tmp)}")
    check(len(built) == 1 and built[0].role == "default",
          f"(u): the launcher's evaluators {[e.role for e in built]}")

    # the trainer, step by step
    check(result["steps"] == steps, f"(u): {result['steps']} steps")
    for i, st in enumerate(result["stats"]):
        for k in ("trainDefault/loss", "trainDefault/ppl"):
            check(k in st and math.isfinite(st[k]), f"(u) step {i}: {k} = "
                  f"{st.get(k)}")
    recs = tr["records"]
    check(len(recs) == steps and all(r["mfc"] == "trainDefault"
                                     for r in recs), f"(u): MFCs {recs}")
    for i, r in enumerate(recs):
        check(math.isfinite(r["stats"]["loss"])
              and math.isfinite(r["stats"]["ppl"])
              and r["stats"]["grad_norm"] > 0, f"(u) step {i}: {r['stats']}")
        if cuda:
            check_launches(f"(u) step {i}", r["launches"],
                           r["micro_batches"], cfg.n_layers, train=True)

    # every saved step scored: during the run, then here
    save = os.path.join(C.experiment_paths(exp)["save"], "default")
    saved = sorted(int(d[4:]) for d in os.listdir(save))
    check(saved == list(range(2, steps + 1, 2)), f"(u): saved {saved}")
    # the launcher's evaluator scored step 2 while the trainer held step 3
    during = {e["step"]: e["scores"] for e in result["auto_eval"]
              if e["status"] == "done"}
    check(hold in during and t_scored is not None
          and next(e for e in result["auto_eval"] if e["step"] == hold)
          ["ckpt_dir"] == os.path.join(save, f"step{hold}"),
          f"(u): the launcher's evaluator did not score step {hold} while "
          f"the run lasted: {result['auto_eval']}")
    # the saves left, evaluated side by side on the card
    ev = AutomaticEvaluator(
        dataclasses.replace(exp.auto_eval_config,
                            max_concurrent_jobs=len(saved)),
        save_dir=os.path.dirname(save), dataset_path=eval_data,
        role="default", mock_tokenizer=True, device=device)
    ev._seen = {f"step{s}" for s in during}
    after, eval_walls = {}, []
    deadline = time.monotonic() + timeout
    while (set(during) | set(after)) != set(saved) \
            and time.monotonic() < deadline:
        t = time.monotonic()
        if ev.poll_once():
            eval_walls.append(time.monotonic() - t)
        after = {s.step: s.scores for s in ev.steps if s.status == "done"}
        check(not any(s.status == "failed" for s in ev.steps),
              f"(u): an evaluation failed: {ev.steps}")
    ev.stop()
    scores = {**during, **after}
    check(sorted(scores) == saved, f"(u): scored {sorted(scores)} of {saved}")
    for s, sc in scores.items():
        check_scores(s, sc, cfg, n_eval, eval_k, 16, cuda)
    check(not eval_processes(tmp),
          "(u): an eval subprocess outlived the phase")
    check(not phase_children(), f"(u): children left: {phase_children()}")

    tokens = [r["tokens"] for r in recs]
    timed = recs[1:]  # the first step is a warm-up
    both = [mb for _, mb, ev_on in samples if ev_on]
    k1_eval = sum(sc["device"]["flash_attention_fwd_launches"]
                  for sc in scores.values())
    launches = {k: sum(r["launches"][k] for r in recs) for k in KERNEL_NAMES}
    launches["flash_attention_fwd"] += k1_eval
    rec = {
        "steps": steps, "run_s": run_s,
        "tokens_per_step": tokens, "micro_batches": [r["micro_batches"]
                                                    for r in recs],
        "ms_per_step": 1e3 * sum(r["wall_s"] for r in timed) / len(timed),
        "device_ms_per_step": (sum(r["device_ms"] for r in timed) / len(timed)
                               if cuda else None),
        "trained_tokens_per_s": sum(r["tokens"] for r in timed)
        / sum(r["wall_s"] for r in timed),
        "loss": [r["stats"]["loss"] for r in recs],
        "ppl": [r["stats"]["ppl"] for r in recs],
        "trainer_peak_gb": tr["peak_gb"],
        "scored_while_training": sorted(during),
        "step2_scored_after_s": t_scored,
        "launcher_auto_eval": {e["step"]: e["status"]
                               for e in result["auto_eval"]},
        "held_s": (recs[hold]["t0"] - recs[hold - 1]["t1"]
                   if len(recs) > hold else None),
        "scored_after": sorted(after),
        "eval_secs": {s: sc["eval_secs"] for s, sc in scores.items()},
        "eval_wall_s_after": eval_walls,
        "eval_child_peak_gb": {s: (sc["device"]["peak_memory_bytes"] or 0)
                               / 2 ** 30 for s, sc in scores.items()},
        "eval_child_k1": {s: sc["device"]["flash_attention_fwd_launches"]
                          for s, sc in scores.items()},
        "eval_child_dtype": {s: sc["device"]["dtype"]
                             for s, sc in scores.items()},
        "k1_eval_shape_checks": k1_eval_checks,
        "scores": {s: {k: v for k, v in sc.items()
                       if k.split("/")[-1] in EVAL_KEYS}
                   for s, sc in scores.items()},
        "card_mb_max": max((mb for _, mb, _ in samples), default=None),
        "card_mb_max_with_eval": max(both, default=None),
        "launches": launches,
    }
    print("(u) sft with automatic evaluation", json.dumps(rec), flush=True)
    return rec


def write_paired_records(path: str, n: int, seed: int) -> None:
    """``n`` paired records from ``seed``, 2 pairs each: prompts of 32-64
    and answers of 64-256 byte tokens."""
    import random

    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "query_id": f"p{i}",
                "prompt": f"Question {i}: {seeded_text(rng, 20, 52)} ",
                "pos_answers": [seeded_text(rng, 64, 256) for _ in range(2)],
                "neg_answers": [seeded_text(rng, 64, 256) for _ in range(2)],
            }) + "\n")


def timed_call(fa, device, fn, *args):
    """(result, seconds, K1-K3 launches) of one call."""
    fa.reset_launch_count()
    sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(device)
    secs = time.perf_counter() - t0
    return out, secs, {k: fa.launch_counts()[k] for k in KERNEL_NAMES}


def run_reward_model(fa, hf_dir: str, tmp: str, device: str = "cuda",
                     steps: int = 3, n_records: int = 16) -> dict:
    """(v): a critic-headed engine from ``hf_dir`` takes ``steps``
    ``RewardModelingInterface.train_step``s on the paired records, then
    scores the flattened pairs; one micro-batch's loss through K1-K3
    against the plain attention."""
    import numpy as np

    from areal_tpu_torch.algorithms.rw import (
        RewardModelingInterface,
        _loss_weight,
        _pairwise_loss,
        flatten_pairs,
    )
    from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.base.testing import ByteTokenizer
    from areal_tpu_torch.datasets.jsonl import RewardModelingPairedDataset
    from areal_tpu_torch.models import hf

    cuda = torch.device(device).type == "cuda"
    path = os.path.join(tmp, "paired.jsonl")
    write_paired_records(path, n_records, seed=7)
    ds = RewardModelingPairedDataset(dataset_path=path,
                                     tokenizer=ByteTokenizer())
    batch = SequenceSample.gather([ds[i] for i in range(len(ds))])
    ccfg, params = hf.load_hf_model(hf_dir, is_critic=True, device=device)
    model = make_model("rw", ccfg, params, device=device)
    del params
    eng = model.module
    flat = flatten_pairs(batch)
    # every pair inside one micro-batch: orphans would skip pairs
    spec = MicroBatchSpec(max_tokens_per_mb=32768)
    n = n_micro_batches(eng, flat, spec)
    iface = RewardModelingInterface()
    mem_reset(device)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    step_s, stats = [], []
    for i in range(steps):
        st, secs, counts = timed_call(fa, device, iface.train_step, model,
                                      batch, spec)
        check(math.isfinite(st["loss"]) and st["grad_norm"] > 0
              and st["orphan_pairs"] == 0.0
              and st["n_pairs"] == 2 * n_records, f"(v) step {i}: {st}")
        if cuda:
            check_launches(f"(v) step {i}", counts, n, ccfg.n_layers,
                           train=True)
        for k in KERNEL_NAMES:
            launches[k] += counts[k]
        step_s.append(secs)
        stats.append(st)
    out, inf_s, counts = timed_call(fa, device, iface.inference, model, flat,
                                    spec)
    scores = out.data["scores"]
    check(scores.shape == (flat.bs,) and bool(np.isfinite(scores).all()),
          f"(v): scores {scores}")
    if cuda:
        check_launches("(v) inference", counts, n, ccfg.n_layers,
                       train=False)
    for k in KERNEL_NAMES:
        launches[k] += counts[k]
    peak = mem_peak(device)

    # one micro-batch through K1-K3 against the plain attention
    ub = eng.upload_uniform(flat, spec)
    weight = _loss_weight(ub.mbs[0])
    loss = {}
    for impl in ("auto", "reference"):
        eng.attn_impl = impl
        loss[impl], _ = eng.accumulate_grads(ub, _pairwise_loss, [0],
                                             [weight])
        loss[impl] = float(loss[impl])
        for p in eng.params.values():
            p.grad = None
    eng.attn_impl = "auto"
    rel = abs(loss["auto"] - loss["reference"]) / max(
        abs(loss["reference"]), 1e-30)
    check(math.isfinite(loss["auto"]) and rel <= 0.01,
          f"(v): loss through K1-K3 {loss['auto']} against the plain "
          f"attention's {loss['reference']}")
    timed = step_s[1:]  # the first step is a warm-up
    rec = {
        "pairs": 2 * n_records, "sequences": flat.bs,
        "tokens": int(flat.total_lens().sum()), "micro_batches": n,
        "ms_per_step": 1e3 * sum(timed) / len(timed),
        "step_ms": [1e3 * s for s in step_s], "inference_ms": 1e3 * inf_s,
        "loss": [st["loss"] for st in stats],
        "pairwise_accuracy": [st["pairwise_accuracy"] for st in stats],
        "pos_minus_neg": [st["pos_minus_neg"] for st in stats],
        "orphan_pairs": [st["orphan_pairs"] for st in stats],
        "peak_gb": peak, "loss_kernels": loss["auto"],
        "loss_plain": loss["reference"], "loss_rel_err": rel,
        "launches": launches,
    }
    print("(v) reward-model training", json.dumps(rec), flush=True)
    del model, eng, ub
    return rec


def fused_batch(path: str, n_prompts: int, group: int, new_tokens: int,
                seed: int):
    """``n_prompts`` x ``group`` math trajectories of (o)'s shape: a seeded
    prompt (100-400 byte tokens) and ``new_tokens`` generated tokens, the
    first of each group ending in its boxed ground truth; ids "qid@k"."""
    import random

    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.base.testing import ByteTokenizer

    tok, rng = ByteTokenizer(), random.Random(seed)
    write_math_prompts(path, n_prompts, seed)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    samples = []
    for r in records:
        p = tok.encode(r["prompt"])
        for k in range(group):
            tail = tok.encode(f" {r['solutions'][0]}" if k == 0 else "")
            a = [rng.randint(2, 257) for _ in range(new_tokens - len(tail))]
            a += tail
            samples.append(SequenceSample.from_default(
                ids=[f"{r['query_id']}@{k}"],
                data={"packed_input_ids": np.asarray(p + a, np.int32),
                      "prompt_mask": np.asarray([1] * len(p) + [0] * len(a),
                                                np.int32)},
                seqlens=[len(p) + len(a)]))
    return SequenceSample.gather(samples)


def run_fused(fa, hf_dir: str, tmp: str, device: str = "cuda",
              n_prompts: int = 16, group: int = 4,
              new_tokens: int = 256) -> dict:
    """(w): the sync recipe's ``fused_rew_ref_inf`` node
    (``FusedForwardInterface`` with ref_inf and rew_inf) on a bf16
    reference engine from ``hf_dir``, against its two children run alone on
    the same batch."""
    import numpy as np

    import areal_tpu_torch.algorithms.ppo  # noqa: F401 (registers)
    import areal_tpu_torch.algorithms.reward  # noqa: F401 (registers)
    from areal_tpu_torch.algorithms.fused import FusedForwardInterface
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.api.model import make_interface
    from areal_tpu_torch.base.testing import ByteTokenizer
    from areal_tpu_torch.models import hf

    cuda = torch.device(device).type == "cuda"
    path = os.path.join(tmp, "fused_math.jsonl")
    batch = fused_batch(path, n_prompts, group, new_tokens, seed=8)
    lcfg, params = hf.load_hf_model(hf_dir, device=device)
    ref = make_model("ref", lcfg, {k: v.to(torch.bfloat16)
                                   for k, v in params.items()},
                     train=False, device=device)
    del params
    ref.tokenizer = ByteTokenizer()
    eng = ref.module
    kids = {"rew": ("rw_math_code", {"dataset_path": path,
                                     "group_size": group}),
            "ref": ("ref_logprob", {})}
    spec = MicroBatchSpec(max_tokens_per_mb=4096)
    n = n_micro_batches(eng, batch, spec)
    lone = {k: make_interface(name, **kw) for k, (name, kw) in kids.items()}
    fused = FusedForwardInterface(interfaces=kids)
    # warm-ups: the pool thread's first GEMMs allocate its cuBLAS workspace
    lone["ref"].inference(ref, batch, spec)
    fused.inference(ref, batch, spec)
    ref_out, ref_s, _ = timed_call(fa, device, lone["ref"].inference, ref,
                                   batch, spec)
    rew_out, rew_s, _ = timed_call(fa, device, lone["rew"].inference, ref,
                                   batch, spec)
    # grad mode inside the pool thread, read where the forward runs
    seen, fwd = [], eng._forward_token_logprobs

    def recording(*a, **k):
        out = fwd(*a, **k)
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.is_grad_enabled(), out.requires_grad))
        return out

    eng._forward_token_logprobs = recording
    before = torch.cuda.memory_allocated() if cuda else 0
    try:
        out, fused_s, launches = timed_call(fa, device, fused.inference, ref,
                                            batch, spec)
    finally:
        eng._forward_token_logprobs = fwd
    after = torch.cuda.memory_allocated() if cuda else 0
    check(out.ids == batch.ids
          and out.keys == {"rewards", "packed_ref_logprobs"},
          f"(w): fused output {out.keys}")
    check(np.array_equal(out.data["packed_ref_logprobs"],
                         ref_out.data["packed_ref_logprobs"]),
          "(w): fused ref logprobs differ from ref_inf's alone")
    check(np.array_equal(out.data["rewards"], rew_out.data["rewards"]),
          "(w): fused rewards differ from rew_inf's alone")
    rewards = out.data["rewards"].reshape(n_prompts, group)
    check(bool((rewards[:, 0] > 0).all()) and bool((rewards[:, 1:] == 0)
                                                  .all()),
          f"(w): rewards {rewards.tolist()}")
    check(seen and all(s == (False, False, False) for s in seen),
          f"(w): the pool thread's forward ran with grad state: {seen}")
    check(after == before, f"(w): {after - before} bytes kept by a fused "
          "call after the first")
    check(all(not p.requires_grad for p in eng.params.values()),
          "(w): the reference engine's weights require grad")
    if cuda:
        check_launches("(w) fused", launches, n, lcfg.n_layers, train=False)
    rec = {"trajectories": batch.bs, "tokens": int(batch.total_lens().sum()),
           "micro_batches": n, "fused_ms": 1e3 * fused_s,
           "ref_inf_ms": 1e3 * ref_s, "rew_inf_ms": 1e3 * rew_s,
           "serial_ms": 1e3 * (ref_s + rew_s),
           "fused_over_serial": fused_s / (ref_s + rew_s),
           "reward_mean": float(out.data["rewards"].mean()),
           "launches": launches}
    print("(w) fused reference + reward node", json.dumps(rec), flush=True)
    del ref, eng
    return rec


def run_multi_turn(fa, cfg, eos: int, tmp: str, device: str = "cuda",
                   n_prompts: int = 8, num_turns: int = 2,
                   turn_tokens: int = 128, discount: float = 0.9) -> dict:
    """(x): ``MathMultiTurnAgent`` on ``n_prompts`` seeded math prompts,
    its observations answered by a port ``GenerationServer`` on the seed-0
    weights (``cfg``'s depth) over HTTP, its answers graded by the math
    environment."""
    import asyncio

    import numpy as np

    from areal_tpu_torch.agents.math_multi_turn import MathMultiTurnAgent
    from areal_tpu_torch.agents.math_single_step import MathCodeSingleStepEnv
    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.base.testing import ByteTokenizer
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    path = os.path.join(tmp, "multi_turn.jsonl")
    write_math_prompts(path, n_prompts, seed=9)
    with open(path) as f:
        records = {r["query_id"]: r for r in map(json.loads, f)}
    tok = ByteTokenizer()
    params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=turn_tokens, eos_token_id=eos,
                               pad_token_id=eos, batch_window_ms=20),
        cfg, params, device=device)
    del params

    class Env(MathCodeSingleStepEnv):
        def __init__(self, id2info):
            super().__init__(id2info)
            self.verdicts = []

        async def step(self, action):
            out = await super().step(action)
            self.verdicts.append(float(np.asarray(out[1]).reshape(-1)[0]))
            return out

    async def episode(url, agent, qid, env):
        ids = tok.encode(records[qid]["prompt"])
        prompt = SequenceSample.from_default(
            ids=[qid], data={"packed_prompts": np.asarray(ids, np.int32)},
            seqlens=[len(ids)])
        obs_q, act_q = asyncio.Queue(), asyncio.Queue()
        task = asyncio.create_task(agent.collect_trajectory(prompt, env,
                                                            obs_q, act_q))
        seen = []
        while True:
            get = asyncio.create_task(obs_q.get())
            done, _ = await asyncio.wait({task, get},
                                         return_when=asyncio.FIRST_COMPLETED)
            if get not in done:
                get.cancel()
                return await task, seen
            _, token_ids, gconfig = get.result()
            seen.append(list(token_ids))
            r = await asyncio.to_thread(post, url, {
                "prompt_ids": list(token_ids),
                "gconfig": dataclasses.asdict(gconfig),
                "max_tokens": gconfig.max_new_tokens})
            p, g = np.asarray(token_ids, np.int32), np.asarray(
                r["output_ids"], np.int32)
            await act_q.put([SequenceSample.from_default(
                ids=[f"{qid}@t{len(seen) - 1}"],
                data={"packed_input_ids": np.concatenate([p, g]),
                      "prompt_mask": np.concatenate(
                          [np.ones(len(p), np.int32),
                           np.zeros(len(g), np.int32)]),
                      "packed_logprobs": np.concatenate(
                          [np.zeros(len(p), np.float32),
                           np.asarray(r["output_logprobs"], np.float32)]),
                      "seq_no_eos_mask": np.asarray(
                          [0.0 if r["finished"] else 1.0], np.float32),
                      "version_start": np.asarray([0], np.int32),
                      "version_end": np.asarray([0], np.int32)},
                seqlens=[len(p) + len(g)])])

    agent = MathMultiTurnAgent(tokenizer=tok, num_turns=num_turns,
                               turn_level_discount=discount,
                               max_new_tokens_per_turn=turn_tokens)
    envs = {qid: Env(records) for qid in records}

    async def all_episodes(url):
        return await asyncio.gather(*[episode(url, agent, q, envs[q])
                                      for q in records])

    url = server.start()
    try:
        fa.reset_launch_count()
        t0 = time.monotonic()
        results = asyncio.run(all_episodes(url))
        wall = time.monotonic() - t0
        k1 = fa.launch_count()
        stats = server.stats()
    finally:
        server.stop()
    turns = 0
    for (samples, seen), (qid, env) in zip(results, envs.items()):
        v = env.verdicts
        check(len(samples) == len(seen) == len(v) >= 1
              and (len(v) == num_turns or v[-1] > 0),
              f"(x) {qid}: {len(samples)} samples, {len(seen)} observations, "
              f"verdicts {v}")
        for t in range(1, len(samples)):
            want = (list(map(int, samples[t - 1].data["packed_input_ids"]))
                    + agent._feedback_ids(v[t - 1] > 0))
            check(seen[t] == want, f"(x) {qid}: turn {t + 1}'s prompt is not "
                  f"turn {t}'s context plus the feedback")
        raw = [(float(x > 0) - 0.5) * 2 for x in v]
        want = [sum(raw[j] * discount ** (j - i) for j in range(i, len(raw)))
                for i in range(len(raw))]
        got = [float(s.data["rewards"][0]) for s in samples]
        check(all(abs(a - b) <= 1e-5 for a, b in zip(got, want)),
              f"(x) {qid}: rewards {got}, the discount gives {want}")
        turns += len(samples)
    if torch.device(device).type == "cuda":
        check(k1 == cfg.n_layers * stats["prefill_calls"],
              f"(x): K1 launches {k1} != {cfg.n_layers} x "
              f"{stats['prefill_calls']} prefills")
    rec = {"prompts": n_prompts, "turns": turns, "wall_s": wall,
           "prefill_calls": stats["prefill_calls"],
           "generated_tokens": stats["generated_tokens"],
           "solved": sum(any(x > 0 for x in e.verdicts)
                         for e in envs.values()),
           "k1_launches": k1}
    print("(x) multi-turn agent", json.dumps(rec), flush=True)
    return rec


# ---------------- (y), (z): the GPT-2 and Gemma families ----------------

def byte_sft_batch(n_seqs: int, seed: int, max_seqlen: int = 1024):
    """``n_seqs`` SFT records of byte tokens from ``seed``: prompts of
    64-512 and answers of 128-768 tokens, each cut to ``max_seqlen``
    (``prompt_mask`` 1 on the prompt)."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    rng = np.random.RandomState(seed)
    toks, masks, lens = [], [], []
    for _ in range(n_seqs):
        p, a = rng.randint(64, 513), rng.randint(128, 769)
        n = min(p + a, max_seqlen)
        toks.append(rng.randint(0, 256, n).astype(np.int32))
        masks.append((np.arange(n) < p).astype(np.int32))
        lens.append(n)
    return SequenceSample.from_default(
        ids=[f"f{i}" for i in range(n_seqs)],
        data={"packed_input_ids": np.concatenate(toks),
              "prompt_mask": np.concatenate(masks)},
        seqlens=lens)


def compare_sft_micro_batch(model, batch, spec, what: str) -> dict:
    """:func:`compare_grads` on the first SFT micro-batch of ``batch``."""
    from areal_tpu_torch.algorithms import sft

    eng = model.module
    ub = eng.upload_uniform(sft._attach_loss_mask(batch), spec)
    # a key bias shifts every score of a query row by the same amount: its
    # gradient is 0 in exact arithmetic
    rec = compare_grads(eng, ub, sft.sft_loss, 0,
                        sft._loss_weight(ub.mbs[0]), what,
                        null_grads=("wk.bias",))
    rec.pop("stats")
    print(f"{what} micro-batch K1-K3 vs plain attention", json.dumps(rec),
          flush=True)
    return rec


def http_status(url: str, path: str, body: dict) -> tuple:
    """(status, JSON body) of one POST, error statuses included."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


FAMILY_LENS = (100, 231, 377, 456, 598, 640, 777, 900)


def family_prompts(lens=FAMILY_LENS) -> list:
    """The family phases' byte-token prompts, from seed 7."""
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, 256, (n,), generator=gen).tolist() for n in lens]


def serve_family(fa, cfg, params, eos: int, device: str = "cuda",
                 lens=FAMILY_LENS,
                 new_tokens=(64, 72, 80, 88, 96, 104, 112, 120),
                 check_413: bool = False,
                 compare_prefill: bool = True,
                 greedy_tokens: int = 64) -> dict:
    """A family's serving checks: 8 concurrent requests of byte-token
    prompts behind a ``GenerationServer`` (greedy and sampled mixed, each
    its own budget in one chunk); with ``check_413`` one more request whose
    prompt plus budget passes the learned table answers 413 before any
    prefill and the server stays healthy; with ``compare_prefill`` the
    batch's last prefill logits through K1 against the plain attention (5%
    of max|logit|); a greedy request of ``greedy_tokens`` twice gives the
    same tokens; K1 launched n_layers x the prefills."""
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    cuda = torch.device(device).type == "cuda"
    server = GenerationServer(
        GenerationServerConfig(chunk_tokens=128, eos_token_id=eos,
                               pad_token_id=eos, batch_window_ms=20),
        cfg, params, device=device)
    url = server.start()
    prompts = family_prompts(lens)
    gconfigs = [{"greedy": True} if i % 2 == 0 else
                {"temperature": 0.7 + 0.1 * i, "top_p": 0.9}
                for i in range(len(prompts))]
    rec = {}
    try:
        fa.reset_launch_count()
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            replies = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i], "gconfig": gconfigs[i],
                "max_tokens": new_tokens[i]}), range(len(prompts))))
        rec["wall_s"] = time.monotonic() - t0
        for i, r in enumerate(replies):
            check_reply(r, new_tokens[i], eos, f"{cfg.hf_family} request {i}")
        rec["last_position"] = max(a + b - 1 for a, b in zip(lens, new_tokens))
        if check_413:
            limit = cfg.max_position_embeddings
            calls = server.stats()["prefill_calls"]
            code, body = http_status(url, "/generate", {
                "prompt_ids": [5] * (limit - 24), "max_tokens": 64,
                "gconfig": {"greedy": True}})
            check(code == 413 and body == {
                "ok": False, "reason": "prompt_too_long",
                "needed_slots": limit + 40, "max_slots": limit},
                f"{cfg.hf_family}: past the table {code} {body}")
            check(server.stats()["prefill_calls"] == calls,
                  f"{cfg.hf_family}: the refused request prefilled")
            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                check(json.loads(r.read())["ok"], "unhealthy after a 413")
            rec["past_table"] = {"status": code, **body}
        greedy = {"prompt_ids": prompts[3], "gconfig": {"greedy": True},
                  "max_tokens": greedy_tokens}
        a, b = post(url, greedy), post(url, greedy)
        check(a["output_ids"] == b["output_ids"],
              f"{cfg.hf_family}: a repeated greedy request gave other tokens")
        stats = server.stats()
        k1 = fa.launch_count()
        if cuda:
            check(k1 == cfg.n_layers * stats["prefill_calls"],
                  f"{cfg.hf_family}: K1 launches {k1} != {cfg.n_layers} x "
                  f"{stats['prefill_calls']} prefills")
        rec.update(prefill_calls=stats["prefill_calls"],
                   prefill_ms_per_call=1e3 * stats["prefill_secs"]
                   / stats["prefill_calls"],
                   decode_ms_per_step=1e3 * stats["decode_secs"]
                   / stats["decode_steps"],
                   generated_tokens=stats["generated_tokens"], k1_launches=k1)
    finally:
        server.stop()
    if not compare_prefill:
        return rec
    # the batch's prefill through K1 against the plain attention
    model = Transformer.from_params(cfg, params)
    padded, plens = genmod.pad_prompts(prompts, eos, bucket=128)
    toks = torch.from_numpy(padded).to(device)
    lens_t = torch.from_numpy(plens).to(device)
    S = padded.shape[1] + 128
    got = genmod.prefill_state(model, toks, lens_t, S)["last_logits"]
    ref = genmod.prefill_state(model, toks, lens_t, S,
                               attn_impl="reference")["last_logits"]
    diff = (got - ref).abs().max().item()
    tol = 0.05 * ref.abs().max().item()
    rec["prefill_k1_vs_plain"] = {
        "max_abs_err": diff, "tol": tol, "shape": list(padded.shape),
        "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean()
        .item()}
    check(bool(torch.isfinite(got).all())
          and tuple(got.shape) == (len(prompts), cfg.vocab_size),
          f"{cfg.hf_family}: prefill logits not finite / wrong shape")
    check(diff <= tol, f"{cfg.hf_family}: prefill through K1 disagrees with "
          f"the plain attention: {rec['prefill_k1_vs_plain']}")
    return rec


def run_gpt2(fa, tmp: str, device: str = "cuda", cfg=None, steps: int = 3,
             n_seqs: int = 24, mb_tokens: int = 4096) -> dict:
    """(y): GPT-2 small at full width and depth from a seeded HF directory
    in GPT-2's own layout, through ``load_hf_model``: served
    (:func:`serve_family`, with the 413 past the table), then three SFT
    ``train_step``s on packed byte-token records and one micro-batch
    through K1-K3 against the plain attention."""
    import numpy as np

    from areal_tpu_torch.algorithms.sft import SFTInterface
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.base import safetensors_io as sio
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.config import gpt2_small
    from areal_tpu_torch.models.transformer import init_params

    cuda = torch.device(device).type == "cuda"
    cfg = cfg or gpt2_small(dtype="float32")
    hf_dir = os.path.join(tmp, "gpt2_hf")
    t0 = time.monotonic()
    written = init_params(cfg, seed=0, device=device)
    hf.save_hf_checkpoint(written, cfg, hf_dir)
    names = set(sio.load_file(os.path.join(hf_dir, "model.safetensors")))
    check("transformer.h.0.attn.c_attn.weight" in names
          and "transformer.wpe.weight" in names and "lm_head.weight"
          not in names, f"(y): not GPT-2's layout: {sorted(names)[:6]}")
    lcfg, params = hf.load_hf_model(hf_dir, device=device)
    check(dataclasses.replace(lcfg, dtype=cfg.dtype) == cfg,
          f"(y): config read back as {lcfg}")
    check(all(torch.equal(params[k], v) for k, v in written.items()),
          "(y): weights read back differ")
    del written
    rec = {"write_load_s": time.monotonic() - t0}
    eos = 50256  # GPT-2's <|endoftext|>
    bf16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    rec["serve"] = serve_family(fa, lcfg, bf16, eos, device, check_413=True)
    del bf16
    # SFT on the loaded f32 masters, bf16 compute
    model = make_model("default", lcfg, params, device=device)
    del params
    spec = MicroBatchSpec(max_tokens_per_mb=mb_tokens)
    iface = SFTInterface()
    batches = [byte_sft_batch(n_seqs, seed=20 + i) for i in range(steps)]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    walls, stats = [], []
    for b in batches:
        n = n_micro_batches(model.module, b, spec)
        fa.reset_launch_count()
        t = time.perf_counter()
        st = iface.train_step(model, b, spec)
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        stats.append({"loss": st["loss"], "grad_norm": st["grad_norm"],
                      "micro_batches": n, "launches": fa.launch_counts()})
        check(math.isfinite(st["loss"]) and st["grad_norm"] > 0,
              f"(y) sft: {st}")
        if cuda:
            check_launches("(y) sft", fa.launch_counts(), n, lcfg.n_layers,
                           train=True)
    tokens = [int(b.total_lens().sum()) for b in batches]
    rec["sft"] = {"steps": stats, "tokens_per_step": tokens,
                  "ms_per_step": 1e3 * float(np.mean(walls[1:])),
                  "trained_tokens_per_s": sum(tokens[1:]) / sum(walls[1:]),
                  "peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                              if cuda else None)}
    rec["compare"] = compare_sft_micro_batch(model, batches[0], spec, "(y)")
    check("pos_embedding_grad_norm" in rec["compare"],
          "(y): no gradient reached the learned position table")
    launches = {k: sum(s["launches"][k] for s in stats) for k in KERNEL_NAMES}
    launches["flash_attention_fwd"] += rec["serve"]["k1_launches"]
    rec["launches"] = launches
    del model
    if cuda:
        torch.cuda.empty_cache()
    return rec


def run_sft_entry(cfg, tmp: str, hf_dir: str, device: str = "cuda",
                  steps: int = 3, n_seqs: int = 24, max_seqlen: int = 1024,
                  mb_tokens: int = 4096, timeout: float = 600.0) -> dict:
    """SFT through ``run_experiment`` on the port's SFTConfig (what
    ``python -m areal_tpu_torch.training.main_sft`` builds; the launcher
    spawns the trainer) from ``hf_dir``: bf16 compute, f32 masters, bf16
    Adam moments, no save. Per step: ms, tokens, micro-batches and K1-K3
    launches (n_layers x micro-batches, K1 twice that under the remat);
    finite loss, grad norm > 0."""
    import functools
    import multiprocessing

    from areal_tpu_torch.api import cli_args as CA
    from areal_tpu_torch.apps.launcher import run_experiment
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.experiments.sft_exp import SFTConfig

    cuda = torch.device(device).type == "cuda"
    data = os.path.join(tmp, "sft.jsonl")
    write_sft_records(data, steps * n_seqs, seed=9)
    exp = SFTConfig(experiment_name="chip_smoke", trial_name="z",
                    backend="cuda" if cuda else "cpu")
    CA.apply_overrides(exp, [
        f"cluster.fileroot={tmp}", f"dataset.path={data}",
        f"model.path={hf_dir}", "mock_tokenizer=true",
        "model.optimizer.mu_dtype=bfloat16",
        "model.optimizer.nu_dtype=bfloat16",
        f"dataset.max_seqlen={max_seqlen}",
        f"dataset.train_bs_n_seqs={n_seqs}",
        f"allocation.mb_spec.max_tokens_per_mb={mb_tokens}",
        f"exp_ctrl.benchmark_steps={steps}"])
    CA.validate_config(exp)
    ctx = multiprocessing.get_context("spawn")
    pipes = {"trainer": ctx.Pipe(duplex=False)}
    probes = {"trainer": functools.partial(async_trainer_probe,
                                           pipes["trainer"][1])}
    old_repo = name_resolve.DEFAULT_REPO
    t0 = time.monotonic()
    try:
        run = LoopRun(lambda: run_experiment(exp, probes=probes), pipes,
                      "sft entry")
        result = run.join(timeout)
        (tr,) = run.done("trainer")
    finally:
        name_resolve.DEFAULT_REPO = old_repo
    check(result["steps"] == steps, f"sft entry: {result['steps']} steps")
    recs = tr["records"]
    check(len(recs) == steps, f"sft entry: {len(recs)} MFC records")
    for i, r in enumerate(recs):
        check(math.isfinite(r["stats"]["loss"])
              and r["stats"]["grad_norm"] > 0, f"sft entry step {i}: "
              f"{r['stats']}")
        if cuda:
            check_launches(f"sft entry step {i}", r["launches"],
                           r["micro_batches"], cfg.n_layers, train=True)
    timed = recs[1:]  # the first step is a warm-up
    return {
        "run_s": time.monotonic() - t0, "steps": steps,
        "tokens_per_step": [r["tokens"] for r in recs],
        "micro_batches": [r["micro_batches"] for r in recs],
        "ms_per_step": 1e3 * sum(r["wall_s"] for r in timed) / len(timed),
        "trained_tokens_per_s": sum(r["tokens"] for r in timed)
        / sum(r["wall_s"] for r in timed),
        "loss": [r["stats"]["loss"] for r in recs],
        "grad_norm": [r["stats"]["grad_norm"] for r in recs],
        "launches_per_step": [r["launches"] for r in recs],
        "peak_gb": tr["peak_gb"],
        "launches": {k: sum(r["launches"][k] for r in recs)
                     for k in KERNEL_NAMES},
    }


def run_gemma(fa, tmp: str, device: str = "cuda", cfg=None, steps: int = 3,
              n_seqs: int = 24, mb_tokens: int = 4096) -> dict:
    """(z): Gemma-2B (``cfg``, default ``GEMMA_LAYERS`` of its layers at
    full width) from a seeded HF directory in
    Gemma's layout (bf16, norm scales stored as w - 1): served in process
    (:func:`serve_family`), the server freed; SFT through the entry point's
    launcher (:func:`run_sft_entry`); then one micro-batch through K1-K3
    against the plain attention on a fresh engine of the same weights."""
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.base import safetensors_io as sio
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.config import gemma_2b
    from areal_tpu_torch.models.transformer import init_params

    cuda = torch.device(device).type == "cuda"
    cfg = cfg or dataclasses.replace(gemma_2b(), n_layers=GEMMA_LAYERS)
    hf_dir = os.path.join(tmp, "gemma_hf")
    t0 = time.monotonic()
    hf.save_hf_checkpoint(init_params(cfg, seed=0, device=device,
                                      dtype=torch.bfloat16), cfg, hf_dir)
    sd = hf.load_hf_state_dict(hf_dir)
    norm = sd["model.layers.0.input_layernorm.weight"]
    check(norm.dtype == torch.bfloat16 and not norm.any()
          and "lm_head.weight" not in sd,
          "(z): not Gemma's bf16 layout with (w - 1) norm scales")
    del sd
    lcfg, params = hf.load_hf_model(hf_dir, device=device)
    check(dataclasses.replace(lcfg, dtype=cfg.dtype) == cfg,
          f"(z): config read back as {lcfg}")
    rec = {"write_load_s": time.monotonic() - t0,
           "hf_dir_bytes": dir_bytes(hf_dir)}
    eos = 1  # Gemma's <eos>
    bf16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    del params
    rec["serve"] = serve_family(fa, lcfg, bf16, eos, device)
    del bf16
    if cuda:
        torch.cuda.empty_cache()
    rec["sft"] = run_sft_entry(lcfg, tmp, hf_dir, device, steps=steps,
                               n_seqs=n_seqs, mb_tokens=mb_tokens)
    print("(z) sft", json.dumps(rec["sft"]), flush=True)
    _, params = hf.load_hf_model(hf_dir, device=device)
    model = make_model("default", lcfg, params, device=device)
    del params
    rec["compare"] = compare_sft_micro_batch(
        model, byte_sft_batch(8, seed=30), MicroBatchSpec(
            max_tokens_per_mb=mb_tokens), "(z)")
    rec["compare_layers"] = lcfg.n_layers
    del model
    launches = dict(rec["sft"]["launches"])
    launches["flash_attention_fwd"] += rec["serve"]["k1_launches"]
    rec["launches"] = launches
    if cuda:
        torch.cuda.empty_cache()
    return rec


# ---------------- (aa) Mixture-of-Experts: Qwen3-30B-A3B ----------------

def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


class RoutingRecorder:
    """While on, every MoE layer call's top-k choices, its token count T and
    its drop fraction (``models/moe.py``'s ``_routing`` and ``moe_mlp``
    wrapped; both are looked up at call time), and every packed attention
    call's K1 output against the plain attention on the same q, k, v (the
    layer's own input hidden states): ``attention`` holds (max |err|, one
    bf16 ulp at max |plain|, pad rows exactly 0, 2**-8 * max |plain|) per
    layer. The ulp is the exact one, 2**(floor(log2 max) - 7): (b)'s
    2**-8 * max is half of it when the maximum sits just above a power of
    two, where K1's output rounding to bf16 alone can take half an ulp.
    With ``side_k1``, every packed layer also runs once more on the same
    input hidden state with K1's attention (``attn_impl="flash"``), its
    output dropped: its routing goes to ``side_calls``, so each layer's
    choices under the two attentions compare on one input, apart from the
    drift that earlier layers carry."""

    def __init__(self, fa, compare_attention: bool = False,
                 side_k1: bool = False):
        from areal_tpu_torch.models import moe as moemod
        from areal_tpu_torch.models import transformer as tmod

        self.fa, self.moemod, self.tmod = fa, moemod, tmod
        self.compare_attention, self.side_k1 = compare_attention, side_k1
        self.calls, self.attention, self.side_calls = [], [], []
        self._in_side = False

    def __enter__(self):
        mm, tm, fa = self.moemod, self.tmod, self.fa
        self._saved = (mm._routing, mm.moe_mlp, tm.packed_attention,
                       tm.Block.forward)
        routing, mlp, attention, block = self._saved

        def rec_routing(*a, **kw):
            out = routing(*a, **kw)
            (self.side_calls if self._in_side else self.calls).append(
                {"top_i": out[1]})
            return out

        def rec_mlp(x, *a, **kw):
            y, aux = mlp(x, *a, **kw)
            (self.side_calls if self._in_side else self.calls)[-1].update(
                T=x.shape[1], dropped=aux["dropped_frac"])
            return y, aux

        def rec_block(layer, h, cos, sin, seg, pos, cache, *rest):
            if cache is None:  # packed: the side run on the same input
                self._in_side = True
                try:
                    with torch.no_grad():
                        block(layer, h, cos, sin, seg, pos, cache, None,
                              None, "flash")
                finally:
                    self._in_side = False
            return block(layer, h, cos, sin, seg, pos, cache, *rest)

        def rec_attention(q, k, v, qs, ks, **kw):
            out = attention(q, k, v, qs, ks, **kw)
            ref, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                              qs, ks)
            top = ref.abs().max().item()
            self.attention.append((
                (out.float() - ref).abs().max().item(), bf16_ulp(top),
                bool((out[qs == 0] == 0).all().item()), 2.0 ** -8 * top))
            return out

        mm._routing, mm.moe_mlp = rec_routing, rec_mlp
        if self.compare_attention:
            tm.packed_attention = rec_attention
        if self.side_k1:
            tm.Block.forward = rec_block
        return self

    def __exit__(self, *exc):
        mm, tm = self.moemod, self.tmod
        (mm._routing, mm.moe_mlp, tm.packed_attention,
         tm.Block.forward) = self._saved

    def dropped(self, decode: bool) -> float:
        d = [c["dropped"] for c in self.calls if (c["T"] == 1) == decode]
        return float(torch.stack(d).float().mean()) if d else float("nan")


def device_busy_ms(fn, attempts: int = 3) -> dict:
    """Device ms of one call of ``fn`` and how it was taken, as ``{"ms",
    "source"}``: the sum of its kernels' device time (torch.profiler,
    source "profiler"), launch gaps left out. A first profiled call warms the
    profiler (CUPTI's buffers and callbacks; a cold session can miss a
    call's kernels) and is dropped; a session that still sees no device
    event is run again, up to ``attempts`` times. Where none sees one (on
    the card, a lone K1 launch through ``ctypes`` is missed in some runs
    and not in others), the call is timed between CUDA events behind a
    device-side sleep instead (``cuda_ms(queued=True)``: its kernels run
    back to back, so the events time the device, not the host's launches,
    source "cuda_events"), and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return {"ms": sum(dev) / 1e3, "source": "profiler"}
    ms = cuda_ms(fn, iters=1, warmup=0, queued=True)
    print(f"device_busy_ms: the profiler saw no device event in {attempts} "
          f"sessions; CUDA events behind a device sleep: {ms:.4f} ms",
          flush=True)
    return {"ms": ms, "source": "cuda_events"}


def moe_layer_inputs(E: int, k: int, F: int, D: int, N: int, seed: int,
                     device: str, cf: float = 2.0):
    """One MoE layer in bf16 from ``seed`` (router and experts N(0, 0.02),
    x N(0, 1) [1, N, D] with its last eighth padding) and its MoEConfig."""
    from areal_tpu_torch.models.config import MoEConfig

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(
            torch.bfloat16)

    lp = {"router": rnd(E, D), "e_gate": rnd(E, D, F), "e_up": rnd(E, D, F),
          "e_down": rnd(E, F, D)}
    x = rnd(1, N, D, scale=1.0)
    mask = (torch.arange(N, device=device) < N - N // 8)[None]
    dy = rnd(1, N, D, scale=1.0)
    moe = MoEConfig(num_experts=E, top_k=k, routed_intermediate_dim=F,
                    capacity_factor=cf, aux_loss_coeff=1e-3)
    return moe, lp, x, mask, dy


def check_moe_layer(name: str, E: int, k: int, F: int, D: int, N: int,
                    seed: int, device: str = "cuda", cf: float = 2.0) -> dict:
    """The grouped dispatch against the einsum oracle on one layer, forward
    and backward (cotangent ``dy`` on the output plus ``aux_total``):
    output and every gradient within two bf16 ulps at the oracle's largest
    magnitude (2**-7 * max|ref|), keep masks and drop fractions equal, pad
    rows of the output and of dx exactly 0 (no shared expert)."""
    from areal_tpu_torch.models import moe as moemod

    moe, lp, x, mask, dy = moe_layer_inputs(E, k, F, D, N, seed, device, cf)
    res = {}
    for dispatch in ("grouped", "einsum"):
        leaves = {"x": x.clone().requires_grad_(),
                  **{key: t.clone().requires_grad_() for key, t in lp.items()}}
        y, aux, keep = moemod.moe_mlp(
            leaves["x"], {key: leaves[key] for key in lp}, moe, mask=mask,
            dispatch=dispatch, return_keep=True)
        loss = (y.float() * dy.float()).sum() + aux["aux_total"]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        res[dispatch] = (y.detach(), dict(zip(leaves, grads)), keep,
                         float(aux["dropped_frac"]))
    (gy, gg, gkeep, gdrop), (ey, eg, ekeep, edrop) = (res["grouped"],
                                                      res["einsum"])
    pad = ~mask[0]
    rec = {"case": name, "E": E, "top_k": k, "F": F, "D": D, "tokens": N,
           "pad_tokens": int(pad.sum()), "capacity": moemod.capacity(N, moe),
           "dropped_frac": gdrop}
    errs = {"y": ((gy.float() - ey.float()).abs().max().item(),
                  2.0 ** -7 * ey.float().abs().max().item())}
    for key in gg:
        errs["d" + key] = ((gg[key].float() - eg[key].float()).abs().max()
                           .item(), 2.0 ** -7 * eg[key].float().abs().max()
                           .item())
    rec["max_abs_err_and_tol"] = errs
    print(f"(aa) MoE layer {name}, grouped vs einsum", json.dumps(rec),
          flush=True)
    for key, (err, tol) in errs.items():
        check(math.isfinite(err) and err <= tol,
              f"(aa) {name}: grouped {key} disagrees with the einsum oracle: "
              f"{rec}")
    check(torch.equal(gkeep, ekeep) and gdrop == edrop,
          f"(aa) {name}: keep masks or drop fractions differ: {rec}")
    check(bool((gy[0][pad] == 0).all().item())
          and bool((gg["x"][0][pad] == 0).all().item()),
          f"(aa) {name}: pad rows of the output or of dx are not 0")
    return rec


def moe_layer_times(E: int, k: int, F: int, D: int, N: int, seed: int,
                    decode_rows: int = 8) -> dict:
    """Where one layer's forward time goes at ``N`` tokens (CUDA events
    around each stage of the grouped dispatch, the host's launches and its
    one read of the segment sizes included): router and top-k, the sort
    (with the host read), the permute, the three grouped GEMMs, the
    combine; the whole layer both ways. Then the segment loop's expert MLP
    against ``torch._grouped_mm`` (a yardstick the port never calls) on the
    same segments, at N tokens and at ``decode_rows`` rows, with the MLP's
    device busy ms and its bound."""
    from areal_tpu_torch.models import moe as moemod

    moe, lp, x, mask, _ = moe_layer_inputs(E, k, F, D, N, seed, "cuda")
    xf = x[0]
    valid = mask[0].float()
    C = moemod.capacity(N, moe)
    rec = {"E": E, "top_k": k, "F": F, "D": D, "tokens": N}
    with torch.no_grad():
        top_p, top_i, _, _ = moemod._routing(xf, lp, moe, None, valid)
        order, inv, sizes, keep = moemod.sort_entries(top_i, valid, E, C)
        xs = moemod.permute_entries(xf, order, k)
        ys = moemod.expert_mlp_grouped(xs, lp, sizes)
        gate = top_p.reshape(-1)[order] * keep
        rec["stages_ms"] = {
            "router_topk": cuda_ms(lambda: moemod._routing(
                xf, lp, moe, None, valid), iters=10),
            "sort_and_host_read": cuda_ms(lambda: moemod.sort_entries(
                top_i, valid, E, C), iters=10),
            "permute": cuda_ms(lambda: moemod.permute_entries(xf, order, k),
                               iters=10),
            "grouped_gemms": cuda_ms(lambda: moemod.expert_mlp_grouped(
                xs, lp, sizes), iters=10),
            "combine": cuda_ms(lambda: moemod.combine_entries(
                ys, gate, inv, k), iters=10),
        }
        rec["layer_ms"] = {d: cuda_ms(lambda d=d: moemod.moe_mlp(
            x, lp, moe, mask=mask, dispatch=d), iters=5) for d in
            ("grouped", "einsum")}
        rec["yardstick"] = {"prefill": grouped_mm_yardstick(
            moemod, lp, xs, sizes)}
        # the decode shape: the first rows routed alone, every row valid
        rows = xf[:decode_rows]
        d_p, d_i, _, _ = moemod._routing(
            rows, lp, moe, None, torch.ones(decode_rows, device="cuda"))
        d_order, _, d_sizes, _ = moemod.sort_entries(
            d_i, torch.ones(decode_rows, device="cuda"), E,
            moemod.capacity(decode_rows, moe))
        rec["yardstick"]["decode"] = grouped_mm_yardstick(
            moemod, lp, moemod.permute_entries(rows, d_order, k), d_sizes)
    return rec


def grouped_mm_yardstick(moemod, lp, xs, sizes) -> dict:
    """The segment loop's three-GEMM expert MLP against the same MLP through
    ``torch._grouped_mm`` (2-D x 3-D with ``offs``; the weights laid out
    column-major, the rows past the last segment left out) on the same
    segments: ms of each (CUDA events, launches included), the loop's device
    busy ms, the bound of the work (the used rows' FLOPs at the bf16 peak,
    the non-empty experts' weights plus rows in and out over the memory
    rate) and the outputs' largest difference. A library error is
    reported, not raised: the port does not call it."""
    used = sum(sizes)
    D, F = lp["e_gate"].shape[1:]
    active = sum(1 for n in sizes if n)
    flops = 2 * used * D * F * 3
    nbytes = 2 * (3 * active * D * F + 2 * used * D + 2 * used * F)
    rec = {"rows": used, "segments": active,
           "loop_ms": cuda_ms(lambda: moemod.expert_mlp_grouped(xs, lp, sizes),
                              iters=10),
           "loop_device_ms": device_busy_ms(
               lambda: moemod.expert_mlp_grouped(xs, lp, sizes)),
           **bound(flops, nbytes)}
    try:
        offs = torch.cumsum(torch.tensor(sizes, device=xs.device), 0).to(
            torch.int32)
        cm = {key: lp[key].transpose(1, 2).contiguous().transpose(1, 2)
              for key in ("e_gate", "e_up", "e_down")}
        xu = xs[:used]

        def lib():
            h = torch.nn.functional.silu(torch._grouped_mm(
                xu, cm["e_gate"], offs=offs)) * torch._grouped_mm(
                xu, cm["e_up"], offs=offs)
            return torch._grouped_mm(h, cm["e_down"], offs=offs)

        rec["library_ms"] = cuda_ms(lib, iters=10)
        rec["library_device_ms"] = device_busy_ms(lib)
        rec["library_max_abs_diff"] = (
            lib().float() - moemod.expert_mlp_grouped(xs, lp, sizes)[:used]
            .float()).abs().max().item()
    except (RuntimeError, AttributeError, TypeError) as e:
        rec["library_ms"] = None
        rec["library_error"] = f"{type(e).__name__}: {e}"[:300]
    return rec


def serve_moe(fa, cfg, params, eos: int, device: str = "cuda") -> dict:
    """(aa) 1-2: the family's serving checks (:func:`serve_family`, no
    whole-prefill gate), then on the same model the batch's prefill with
    each layer's K1 against the plain attention on that layer's own q, k, v
    (one bf16 ulp at max|plain|, pad rows 0), the same prefill through the
    plain attention (the last logits' difference and the share of top-k
    expert choices the two runs agree on, reported, not gated: near-tied
    router probabilities flip under bf16 noise), the prefill's and the
    decode's drop fractions (the reference's capacity rule; decode routes
    every row of the batch), and where the time goes (prefill, decode
    steps and the decode's device-idle share)."""
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # the repeated greedy request is 16 tokens and the eight requests ask
    # for 24-38 (not (y)'s 64-120): decode runs ~0.24-0.36 s a step here
    # (PERF.md), and every check shows in a short budget as in a long one;
    # the cut makes room for (bb)
    rec = {"serve": serve_family(fa, cfg, params, eos, device,
                                 new_tokens=tuple(range(24, 40, 2)),
                                 compare_prefill=False, greedy_tokens=16)}
    if cuda:
        rec["serve"]["server_peak_gb"] = (
            torch.cuda.max_memory_allocated() / 2 ** 30)
    model = Transformer.from_params(cfg, params)
    padded, plens = genmod.pad_prompts(family_prompts(), eos, bucket=128)
    toks = torch.from_numpy(padded).to(device)
    lens = torch.from_numpy(plens).to(device)
    S = padded.shape[1] + 128
    with RoutingRecorder(fa, compare_attention=True) as k1:
        got = genmod.prefill_state(model, toks, lens, S)
    # the plain prefill, each layer also run on its own input through K1
    with RoutingRecorder(fa, side_k1=True) as plain:
        ref = genmod.prefill_state(model, toks, lens, S,
                                   attn_impl="reference")["last_logits"]
    errs = k1.attention
    worst = max(range(len(errs)), key=lambda i: errs[i][0] / errs[i][1])
    agree = [(a["top_i"] == b["top_i"]).float().mean().item()
             for a, b in zip(k1.calls, plain.calls)]
    # one layer's K1-vs-plain error alone: the same input, either attention
    one = [(a["top_i"] == b["top_i"]).float().mean().item()
           for a, b in zip(plain.side_calls, plain.calls)]
    check(len(one) == len(agree) == cfg.n_layers,
          f"(aa): {len(one)} side and {len(agree)} routed layers")
    last = got["last_logits"]
    diff = (last - ref).abs().max().item()
    rec["k1_by_layer"] = {
        "layers": len(errs), "shape": list(padded.shape),
        "worst_layer": worst, "worst_max_abs_err": errs[worst][0],
        "worst_tol_ulp": errs[worst][1],
        "max_err_over_ulp": errs[worst][0] / errs[worst][1],
        "max_err_over_2e-8_max": max(e[0] / e[3] for e in errs)}
    rec["prefill_k1_vs_plain"] = {
        "last_logits_max_abs_err": diff,
        "max_abs_ref": ref.abs().max().item(),
        "argmax_agree": (last.argmax(-1) == ref.argmax(-1)).float().mean()
        .item(),
        "top_i_agree_mean": sum(agree) / len(agree),
        "top_i_agree_min_layer": min(agree),
        "top_i_agree_by_layer": agree,
        "top_i_agree_one_layer_by_layer": one,
        "top_i_agree_one_layer_mean": sum(one) / len(one),
        "top_i_agree_one_layer_min": min(one)}
    print("(aa) K1 layer by layer and the whole prefill", json.dumps(
        {k: rec[k] for k in ("k1_by_layer", "prefill_k1_vs_plain")}),
        flush=True)
    check(len(errs) == cfg.n_layers, f"(aa): {len(errs)} layers compared")
    check(all(e[2] for e in errs), "(aa): K1 pad rows not 0")
    if cuda:  # on the CPU the layers run the bf16 reference attention
        check(all(e[0] <= e[1] for e in errs),
              f"(aa): K1 disagrees with the plain attention at layer {worst}: "
              f"{rec['k1_by_layer']}")
    check(bool(torch.isfinite(last).all())
          and tuple(last.shape) == (len(plens), cfg.vocab_size),
          "(aa): prefill logits not finite / wrong shape")
    del got, ref, last
    rec["prefill_dropped_frac"] = k1.dropped(decode=False)
    from areal_tpu_torch.api.model import GenerationHyperparameters
    from areal_tpu_torch.ops.sampling import sampling_from_gconfigs

    state = genmod.prefill_state(model, toks, lens, S)
    with RoutingRecorder(fa) as dec:
        genmod.decode_chunk_rows(
            model, state, torch.zeros(len(plens), dtype=torch.int32,
                                      device=device),
            torch.Generator(device=device).manual_seed(0),
            sampling_from_gconfigs([GenerationHyperparameters(greedy=True)]
                                   * len(plens), device=device),
            4, eos, eos)
    del state
    rec["decode_dropped_frac"] = dec.dropped(decode=True)
    rec["decode_capacity"] = math.ceil(
        cfg.moe.top_k * len(plens) * cfg.moe.capacity_factor
        / cfg.moe.num_experts)
    if cuda:
        rec["breakdown"] = time_breakdown(genmod, model, toks, lens, S, eos,
                                          steps=4)
    return rec


def run_moe_train(fa, cfg, device: str = "cuda", steps: int = 3,
                  batch=None, spec=None) -> dict:
    """(aa) 4: PPO actor train steps as in (g) (bench.py's backend and
    recipe) on ``cfg``: one warm-up step and ``steps`` timed ones. Checks
    finite losses with ``moe_aux_total`` finite and > 0, grad norms > 0, the
    router moved, finite ``moe_*`` stats, the expert-load shares of each
    step summing to 1, the ``train/moe_*`` gauges set (``moe_ep_engaged``
    0), K2 and K3 launched layers x micro-batches x steps and K1 twice
    that; then one micro-batch through K1-K3 against the plain attention
    (:func:`compare_attention_impls`)."""
    from areal_tpu_torch.algorithms.ppo import (
        PPOActorInterface,
        PPOHyperparameters,
    )
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.base import telemetry
    from areal_tpu_torch.models.transformer import init_params

    cuda = torch.device(device).type == "cuda"
    batch = batch or bench_batch(cfg.vocab_size)
    spec = spec or MicroBatchSpec(max_tokens_per_mb=4096)
    params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    model = make_model("actor", cfg, params, device=device)
    del params
    iface = PPOActorInterface(PPOHyperparameters(
        ppo_n_minibatches=1, adv_norm=True, kl_ctl=0.0, disable_value=True))
    eng = model.module
    n_mbs = n_micro_batches(eng, batch, spec)
    gauges, shares = {}, []
    saved = telemetry.set_gauge, telemetry.observe

    def set_gauge(name, v):
        gauges[name] = v
        saved[0](name, v)

    def observe(name, v, buckets=None):
        if name == "train/moe_expert_load_dist":
            shares.append(v)
        saved[1](name, v, buckets)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    telemetry.set_gauge, telemetry.observe = set_gauge, observe
    try:
        t0 = time.perf_counter()
        warm = iface.train_step(model, batch, spec)
        if cuda:
            torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        router = "layers.0.router.weight"
        before = eng.params[router].detach().clone()
        shares.clear()
        fa.reset_launch_count()
        stats = []
        t0 = time.perf_counter()
        for _ in range(steps):
            stats.append(iface.train_step(model, batch, spec))
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.launch_counts()
    finally:
        telemetry.set_gauge, telemetry.observe = saved
    tokens = int(batch.total_lens().sum())
    moe_keys = ("moe_aux_total", "moe_load_balance_loss", "moe_z_loss",
                "moe_dropped_frac", "moe_expert_load_ratio")
    rec = {"n_layers": cfg.n_layers, "n_mbs": n_mbs, "steps": steps,
           "tokens_per_step": tokens, "warmup_step_s": warm_s,
           "ms_per_step": 1e3 * wall / steps,
           "trained_tokens_per_s": steps * tokens / wall,
           "peak_gb": (torch.cuda.max_memory_allocated() / 2 ** 30
                       if cuda else None),
           "loss": [s["actor_loss"] for s in stats],
           "grad_norm": [s["grad_norm"] for s in stats],
           "moe": [{k: s[k] for k in moe_keys} for s in stats],
           "warmup_loss": warm["actor_loss"],
           "router_max_abs_change": (eng.params[router].detach()
                                     - before).abs().max().item(),
           "expert_load_share_sums": [
               sum(shares[i * cfg.moe.num_experts:(i + 1)
                          * cfg.moe.num_experts]) for i in range(steps)],
           "gauges": {k: v for k, v in gauges.items()
                      if k.startswith("train/moe_")},
           "launches": launches}
    for s in stats:
        check(math.isfinite(s["actor_loss"]) and math.isfinite(s["grad_norm"])
              and s["grad_norm"] > 0, f"(aa) train: bad stats {s}")
        check(all(math.isfinite(s[k]) for k in moe_keys)
              and s["moe_aux_total"] > 0, f"(aa) train: moe stats {s}")
    check(rec["router_max_abs_change"] > 0,
          "(aa) train: the router did not move")
    check(len(shares) == steps * cfg.moe.num_experts
          and all(abs(x - 1) < 1e-3 for x in rec["expert_load_share_sums"]),
          f"(aa) train: expert-load shares {rec['expert_load_share_sums']}")
    check(gauges.get("train/moe_ep_engaged") == 0.0
          and "train/moe_dropped_frac" in gauges
          and "train/moe_expert_load_ratio" in gauges,
          f"(aa) train: gauges {gauges}")
    if cuda:
        check_launches("(aa) train", launches, n_mbs * steps, cfg.n_layers,
                       train=True)
    rec["compare"] = compare_attention_impls(model, iface, batch, spec)
    del model, eng
    if cuda:
        torch.cuda.empty_cache()
    return rec


def safetensors_names(hf_dir: str) -> set:
    """The tensor names of an HF safetensors directory, from the index or
    the single file's header (8-byte length, then its JSON)."""
    index = os.path.join(hf_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return set(json.load(f)["weight_map"])
    with open(os.path.join(hf_dir, "model.safetensors"), "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return set(json.loads(f.read(n))) - {"__metadata__"}


def run_moe_hf(cfg, tmp: str, device: str = "cuda") -> dict:
    """(aa) 5: an HF directory of ``cfg`` in Qwen3MoeForCausalLM's layout
    (per-expert ``mlp.experts.{e}.*_proj`` weights, the ``mlp.gate``
    router; bf16) from seed 0, read back through ``load_hf_model``: the
    config as written and every weight equal."""
    from areal_tpu_torch.models import hf
    from areal_tpu_torch.models.transformer import init_params

    hf_dir = os.path.join(tmp, "qwen3_moe_hf")
    t0 = time.monotonic()
    written = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    nbytes = hf.save_hf_checkpoint(written, cfg, hf_dir)
    t_write = time.monotonic() - t0
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    last = cfg.moe.num_experts - 1
    names = safetensors_names(hf_dir)
    check(hf_cfg["architectures"] == ["Qwen3MoeForCausalLM"]
          and all(f"model.layers.{i}.mlp.experts.{last}.down_proj.weight"
                  in names and f"model.layers.{i}.mlp.gate.weight" in names
                  and f"model.layers.{i}.mlp.gate_proj.weight" not in names
                  for i in range(cfg.n_layers)),
          f"(aa): not Qwen3-MoE's layout: {sorted(names)[:6]}")
    t0 = time.monotonic()
    lcfg, params = hf.load_hf_model(hf_dir, device=device)
    t_read = time.monotonic() - t0
    check(dataclasses.replace(lcfg, dtype=cfg.dtype) == cfg,
          f"(aa): config read back as {lcfg}")
    check(set(params) == set(written)
          and all(torch.equal(params[k], v.float())
                  for k, v in written.items()),
          "(aa): weights read back differ")
    return {"bytes": nbytes, "tensors": len(names), "write_s": t_write,
            "read_s": t_read}


def run_moe(fa, tmp: str, device: str = "cuda", cfg=None,
            train_layers: int = 2, layer_tokens: int = 4096,
            train_batch=None, train_spec=None, eos: int = 151645,
            serve_layers: int = MOE_SERVE_LAYERS) -> dict:
    """(aa): Qwen3-30B-A3B (``cfg``, default the full published geometry)
    served at full width and ``serve_layers`` of its layers with weights
    from seed 0 in bf16 (:func:`serve_moe`); the MoE layer's grouped dispatch against its einsum
    oracle at Qwen3-30B-A3B's and Mixtral-8x7B's widths (and a dropping
    capacity factor) with the layer's time split and the
    ``torch._grouped_mm`` yardstick; PPO actor steps at full width and
    ``train_layers`` layers (:func:`run_moe_train`); the HF round trip of
    that model (:func:`run_moe_hf`)."""
    from areal_tpu_torch.models.config import qwen3_30b_a3b
    from areal_tpu_torch.models.transformer import init_params

    cuda = torch.device(device).type == "cuda"
    cfg = cfg or qwen3_30b_a3b()  # eos: Qwen3's <|im_end|>
    serve_cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                      serve_layers))
    rec = {"config": {"n_layers": cfg.n_layers,
                      "serve_layers": serve_cfg.n_layers,
                      "hidden": cfg.hidden_dim,
                      "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                      "expert_ffn": cfg.moe.routed_intermediate_dim}}
    if cuda:
        free, total = torch.cuda.mem_get_info()
        rec["card_free_gb_before_build"] = free / 2 ** 30
        print(f"(aa) card memory before the build: {free / 2 ** 30:.2f} of "
              f"{total / 2 ** 30:.2f} GiB free", flush=True)
    t0 = time.monotonic()
    params = init_params(serve_cfg, seed=0, device=device,
                         dtype=torch.bfloat16)
    if cuda:
        torch.cuda.synchronize()
    rec["build_s"] = time.monotonic() - t0
    stage_s = rec["stage_s"] = {}
    rec["weights_gib"] = sum(t.numel() * t.element_size()
                             for t in params.values()) / 2 ** 30
    rec["serve"] = serve_moe(fa, serve_cfg, params, eos, device)
    stage_s["serve"] = time.monotonic() - t0
    del params
    if cuda:
        torch.cuda.empty_cache()
    print("(aa) serve", json.dumps(rec["serve"]), flush=True)
    moe = cfg.moe
    F = moe.routed_intermediate_dim or cfg.intermediate_dim
    layers = [("qwen3_30b_a3b", moe.num_experts, moe.top_k, F, cfg.hidden_dim,
               2.0), ("mixtral_8x7b", 8, 2, 14336, 4096, 2.0),
              ("qwen3_30b_a3b_drops", moe.num_experts, moe.top_k, F,
               cfg.hidden_dim, 0.5)]
    t0 = time.monotonic()
    if not cuda:  # the rehearsal: the same checks at the config's width
        layers = [(n, E, k, F, cfg.hidden_dim, cf)
                  for n, E, k, _, _, cf in layers[::2]]
    rec["layer_checks"] = [
        check_moe_layer(n, E, k, f, d, layer_tokens, seed=40 + i,
                        device=device, cf=cf)
        for i, (n, E, k, f, d, cf) in enumerate(layers)]
    check(rec["layer_checks"][-1]["dropped_frac"] > 0,
          "(aa): the dropping case dropped nothing")
    if cuda:
        rec["layer_times"] = [moe_layer_times(E, k, f, d, layer_tokens,
                                              seed=40 + i)
                              for i, (_, E, k, f, d, _) in
                              enumerate(layers[:2])]
        print("(aa) MoE layer times", json.dumps(rec["layer_times"]),
              flush=True)
        torch.cuda.empty_cache()
    stage_s["layer"] = time.monotonic() - t0
    t0 = time.monotonic()
    train_cfg = dataclasses.replace(cfg, n_layers=train_layers)
    # 2 timed steps, cut from 3 to make room for (cc)
    rec["train"] = run_moe_train(fa, train_cfg, device, steps=2,
                                 batch=train_batch, spec=train_spec)
    print("(aa) train", json.dumps(rec["train"]), flush=True)
    stage_s["train"] = time.monotonic() - t0
    t0 = time.monotonic()
    rec["hf"] = run_moe_hf(train_cfg, tmp, device)
    stage_s["hf"] = time.monotonic() - t0
    launches = dict(rec["train"]["launches"])
    launches["flash_attention_fwd"] += rec["serve"]["serve"]["k1_launches"]
    rec["launches"] = launches
    return rec


# ---------------- (bb) multi-GPU parallelism, part one ----------------

def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def mesh_train_steps(fa, model, iface, batch, spec, steps: int,
                     device="cuda") -> dict:
    """One warm-up and ``steps`` timed PPO steps of ``model``, timed as (g)
    times them (the engine's phase timing on): the stats, ms per step and
    per phase, peak memory, K1-K3 launches of each timed step, and the
    masters after the last step (on the host)."""
    eng = model.module
    mem_reset(device)
    warm = iface.train_step(model, batch, spec)
    sync(device)
    eng.time_phases = True
    stats, launches, phases = [], [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        fa.reset_launch_count()
        stats.append(iface.train_step(model, batch, spec))
        launches.append(fa.launch_counts())
        phases.append(eng.last_phase_secs)
    sync(device)
    wall = time.perf_counter() - t0
    eng.time_phases = False
    return {"warm": warm, "stats": stats, "launches": launches,
            "ms_per_step": 1e3 * wall / steps,
            "fwd_bwd_ms": 1e3 * sum(p["fwd_bwd"] for p in phases) / steps,
            "optimizer_ms": 1e3 * sum(p["optimizer"] for p in phases) / steps,
            "peak_gb": mem_peak(device),
            "n_mbs": len(eng._split(batch, spec)),
            "masters": {n: t.cpu() for n, t in eng.full_params().items()}}


def compare_mesh_run(name: str, got: dict, want: dict, n_layers: int,
                     n_mbs: int, rel: float = 1e-5, atol: float = 1e-6,
                     device: str = "cuda") -> dict:
    """``got``'s steps against ``want``'s: loss and pre-clip grad norm
    within ``rel``, every master within ``atol``, and in each of ``got``'s
    timed steps K2/K3 launched n_layers x ``n_mbs`` (the micro-batches the
    rank ran) and K1 twice that (on the card: the CPU launches none)."""
    rows = []
    for a, b in zip([got["warm"]] + got["stats"],
                    [want["warm"]] + want["stats"]):
        rows.append({k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                     for k in ("actor_loss", "grad_norm")})
    worst = {k: max(r[k] for r in rows) for k in rows[0]}
    gm, wm = got["masters"], want["masters"]
    check(set(gm) == set(wm), f"{name}: master names differ")
    diffs = {n: (gm[n].float() - wm[n].float()).abs().max().item()
             for n in wm}
    worst_master = max(diffs.values())
    check(worst["actor_loss"] <= rel and worst["grad_norm"] <= rel,
          f"{name}: loss / grad norm off the plain engine's by {worst} "
          f"(limit {rel} relative)")
    check(worst_master <= atol,
          f"{name}: a master {max(diffs, key=diffs.get)} differs by "
          f"{worst_master} (limit {atol})")
    per = n_layers * n_mbs
    want_l = {"flash_attention_fwd": 2 * per,
              "flash_attention_bwd_dkv": per, "flash_attention_bwd_dq": per}
    for i, l in enumerate(got["launches"] if device == "cuda" else ()):
        check(l == want_l, f"{name} step {i}: K1-K3 launches {l}, expected "
              f"{want_l} ({n_layers} layers x {n_mbs} micro-batches)")
    return {"loss_rel_max": worst["actor_loss"],
            "grad_norm_rel_max": worst["grad_norm"],
            "master_abs_max": worst_master}


def run_mesh_step(fa, cfg, batch, spec, tmp: str, plain=None,
                  steps: int = 3, device: str = "cuda") -> dict:
    """(bb1): the engine on a one-rank NCCL mesh against the plain engine
    from the same weights. ``plain`` is (g)'s run of the plain engine
    (``run_train_slice``'s ``baseline``: the same recipe, weights, batch
    and steps); None runs the plain engine here first (the CPU's
    rehearsal). Checks and numbers as in the docstring."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.parallel import distributed as dist

    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    rec: dict = {}
    runs = {} if plain is None else {"plain": plain}
    try:
        check(dist.initialize("chip_smoke", "bb", 0, 1, device=device,
                              force=True), "no one-rank process group")
        check(torch.distributed.get_backend()
              == ("nccl" if device == "cuda" else "gloo"),
              "the one-rank group is not on NCCL")
        for label, pspec in (("plain", None), ("mesh", "d1")):
            if label in runs:
                continue
            model, iface = build_trainer(cfg, parallel_spec=pspec,
                                         device=device)
            eng = model.module
            if pspec is not None:
                check(eng.mesh is not None and eng.mesh.size() == 1
                      and type(eng.params["layers.0.wq.weight"]).__name__
                      == "DTensor", "the mesh engine's masters are not "
                      "DTensors on a one-rank mesh")
            runs[label] = mesh_train_steps(fa, model, iface, batch, spec,
                                           steps, device)
            del model, iface, eng
            empty_cache(device)
        check(len(runs["plain"]["stats"]) == steps,
              f"the plain run took {len(runs['plain']['stats'])} timed "
              f"steps, the mesh run {steps}")
        cmp = compare_mesh_run("mesh d1", runs["mesh"], runs["plain"],
                               cfg.n_layers, runs["mesh"]["n_mbs"],
                               device=device)
        rec["d1"] = {
            "layers": cfg.n_layers, "n_mbs": runs["mesh"]["n_mbs"],
            "steps": steps,
            **{f"{k}{sfx}": runs[run][k] for k in (
                "ms_per_step", "fwd_bwd_ms", "optimizer_ms", "peak_gb")
               for run, sfx in (("mesh", ""), ("plain", "_plain"))},
            "loss": [s["actor_loss"] for s in runs["mesh"]["stats"]],
            "grad_norm": [s["grad_norm"] for s in runs["mesh"]["stats"]],
            "launches": runs["mesh"]["launches"], **cmp}
        mesh_launches = {k: sum(l[k] for l in runs["mesh"]["launches"])
                         for k in KERNEL_NAMES}
        runs.clear()
        empty_cache(device)
    finally:
        dist.shutdown()
        name_resolve.DEFAULT_REPO = old_repo
    print("(bb) mesh step d1", json.dumps(rec["d1"]), flush=True)
    rec["launches"] = mesh_launches
    return rec


def device_publisher(conn, cfg, tmp: str, exp: str, trial: str,
                     device: str) -> None:
    """(bb2)'s trainer side, in a process of its own: a bf16 engine on the
    seed-1 weights behind a TrainerWorker. On ``conn`` it sends ("ready",
    card GB in use), then serves ("publish", transport, version) with
    ("published", record) until "close"; on a failure it sends ("error",
    traceback)."""
    import traceback

    try:
        from areal_tpu_torch.api.train_config import WeightSyncConfig
        from areal_tpu_torch.base import name_resolve
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.system.trainer_worker import (
            TrainerWorker,
            TrainerWorkerConfig,
        )

        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
        src = make_model("device_src", cfg, init_params(
            cfg, seed=1, device=device, dtype=torch.bfloat16), train=False,
            device=device)
        w = TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial, device=device,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(transport="device")))
        w.models["actor"] = src  # setup()-free: the publish half only
        try:
            conn.send(("ready", mem_reset(device)))
            while True:
                if not conn.poll(600):
                    raise TimeoutError("no command from the parent in 600 s")
                msg = conn.recv()
                if msg == "close":
                    break
                _, transport, version = msg
                w.cfg.weight_sync.transport = transport
                src.version.global_step = version
                if device == "cuda":  # IPC buffers whose consumer is done
                    torch.cuda.ipc_collect()
                before = mem_reset(device)
                t0 = time.perf_counter()
                w.publish_weights("actor")
                publish_s = time.perf_counter() - t0
                conn.send(("published", {
                    "publish_s": publish_s, "peak_gb": mem_peak(device),
                    "allocated_gb_before": before,
                    "allocated_gb_after": mem_reset(device)}))
        finally:
            w.close()
        conn.send(("closed", None))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise


def run_device_sync(fa, cfg, eos: int, tmp: str, device="cuda") -> dict:
    """(bb2): the device transport at full depth, then disk and stream
    from the same publisher in the same run, then the three gates. Checks
    and numbers as in the docstring."""
    import multiprocessing
    import types

    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.parallel import reshard as rsh
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )
    from areal_tpu_torch.system.gserver_manager import GserverManager

    exp, trial = "chip_smoke", "bb"
    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    scfg = GenerationServerConfig(experiment=exp, trial=trial,
                                  chunk_tokens=32, eos_token_id=eos,
                                  pad_token_id=eos, batch_window_ms=2)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, eos, (n,), generator=gen).tolist()
               for n in (41, 190, 333)]
    manager = types.SimpleNamespace(cfg=types.SimpleNamespace(
        experiment=exp, trial=trial, model_role="actor"))

    def payload(v):  # what the manager's fanout would send for version v
        return GserverManager._update_payload(
            manager, v, os.path.join(tmp, "realloc", "actor", str(v)))

    def greedy(url, i):
        return post(url, {"prompt_ids": prompts[i],
                          "gconfig": {"greedy": True}, "max_tokens": 16})

    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=device_publisher, daemon=True,
                       name="device-publisher",
                       args=(child_conn, cfg, tmp, exp, trial, device))
    proc.start()
    server = None
    rec: dict = {}
    try:
        src_params = init_params(cfg, seed=1, device=device,
                                 dtype=torch.bfloat16)
        ref_server = GenerationServer(scfg, cfg, src_params, device)
        url = ref_server.start()
        try:
            want_new = [greedy(url, i)["output_ids"]
                        for i in range(len(prompts))]
        finally:
            ref_server.stop()
        del ref_server
        rec["publisher_ready_gb"] = from_publisher(conn, proc, "ready")
        server = GenerationServer(scfg, cfg, init_params(
            cfg, seed=0, device=device, dtype=torch.bfloat16), device)
        url = server.start()
        post(url, {"prompt_ids": prompts[1], "gconfig": {"greedy": True},
                   "max_tokens": 64, "rid": "bb"})
        check(server.stats()["kv_states"] == 1, "no retained KV state")

        def swap(transport, v):
            resident = mem_reset(device)
            t0 = time.perf_counter()
            conn.send(("publish", transport, v))
            pub = from_publisher(conn, proc, "published")
            body = payload(v)
            status, reply = post_json(url, "/update_weights", body)
            out = {"publish_s": pub["publish_s"],
                   "publish_to_reply_s": time.perf_counter() - t0,
                   "server_update_s": reply.get("latency_s"),
                   "trainer_peak_gb": pub["peak_gb"],
                   "trainer_gb_before": pub["allocated_gb_before"],
                   "trainer_gb_after": pub["allocated_gb_after"],
                   "server_peak_gb": mem_peak(device),
                   "server_gb_before": resident,
                   "payload": sorted(body)}
            return status, reply, body, out

        # (1) device
        status, reply, body, out = swap("device", 1)
        check(body.get("device") is True and body["version"] == 1,
              f"the manager's payload for a device publication: {body}")
        check(status == 200 and reply["version"] == 1,
              f"device update: {status} {reply}")
        check(health(url)["version"] == 1, "device: /health not at v1")
        check(server.stats()["kv_states"] == 0, "device: KV store not cleared")
        live = server.model.state_dict()
        check(set(live) == set(src_params) and all(
            live[k].dtype == src_params[k].dtype
            and torch.equal(live[k], src_params[k]) for k in src_params),
            "device: the live weights are not the published ones bit for bit")
        del live
        out["consume_open_ms"] = 1e3 * rsh.LAST_CONSUME["open_s"]
        out["consume_copy_ms"] = 1e3 * rsh.LAST_CONSUME["copy_s"]
        out["bytes"] = rsh.LAST_CONSUME["nbytes"]
        p0 = server.stats()["prefill_calls"]
        fa.reset_launch_count()
        got = [greedy(url, i)["output_ids"] for i in range(len(prompts))]
        k1 = fa.launch_count()
        prefills = server.stats()["prefill_calls"] - p0
        check(got == want_new, "device: greedy tokens differ from a fresh "
              "server's on the seed-1 weights")
        check(device != "cuda" or k1 == cfg.n_layers * prefills > 0,
              f"device: K1 launches {k1} != {cfg.n_layers} x {prefills} "
              "prefills after the swap")
        out.update(k1_launches=k1, prefills=prefills)
        rec["device"] = out
        print("(bb) device transport", json.dumps(out), flush=True)

        # (2) disk and stream, the same publisher at the same depth
        for transport, v in (("disk", 2), ("stream", 3)):
            status, reply, body, out = swap(transport, v)
            check(status == 200 and reply["version"] == v,
                  f"{transport} update: {status} {reply}")
            check(("path" if transport == "disk" else "endpoint") in body,
                  f"the manager's payload for {transport}: {body}")
            rec[transport] = out
            print(f"(bb) {transport} transport", json.dumps(out), flush=True)
        check([greedy(url, i)["output_ids"] for i in range(len(prompts))]
              == want_new, "stream: greedy tokens changed")

        # (3) the gates: a new device publication (v4), then a wrong
        # digest, a skewed version and a killed publisher
        conn.send(("publish", "device", 4))
        rec["republish"] = from_publisher(conn, proc, "published")
        digest = payload(4)["digest"]
        gates = {}
        for gate, bad in (("digest", {"digest": "0" * 8, "version": 4}),
                          ("version", {"digest": digest, "version": 5})):
            status, reply = post_json(url, "/update_weights",
                                      {"device": True, "role": "actor",
                                       **bad})
            gates[gate] = (status, reply.get("error", ""))
        # v4 was never opened: replacing it must free it too (the
        # publisher gives back the count of every share no consumer took)
        conn.send(("publish", "device", 5))
        rec["republish_unconsumed"] = from_publisher(conn, proc, "published")
        if device == "cuda":
            held = {k: rec[k]["allocated_gb_after"]
                    for k in ("republish", "republish_unconsumed")}
            check(abs(rec["disk"]["trainer_gb_after"]
                      - rec["device"]["trainer_gb_before"]) < 0.05,
                  f"the consumed v1 buffer was not freed by the next "
                  f"publish: {rec['device']} -> {rec['disk']}")
            check(abs(held["republish_unconsumed"] - held["republish"])
                  < 0.05, f"the unopened v4 buffer was not freed when v5 "
                  f"replaced it: the trainer holds {held} GiB")
        digest = payload(5)["digest"]
        proc.kill()
        proc.join(timeout=30)
        status, reply = post_json(url, "/update_weights", {
            "device": True, "role": "actor", "digest": digest, "version": 5})
        gates["dead_publisher"] = (status, reply.get("error", ""))
        for gate, want_text in (("digest", "digest mismatch"),
                                ("version", "version skew"),
                                ("dead_publisher", "is gone")):
            status, err = gates[gate]
            check(status == 500 and want_text in err,
                  f"device gate {gate}: {status} {err}")
        check(health(url)["version"] == 3, "a failed gate moved the version")
        check([greedy(url, i)["output_ids"] for i in range(len(prompts))]
              == want_new, "a failed gate changed the served tokens")
        rec["gates"] = {g: e[:160] for g, (_, e) in gates.items()}
        rec["k1_launches"] = rec["device"]["k1_launches"]
    finally:
        if server is not None:
            server.stop()
        if proc.is_alive():
            try:
                conn.send("close")
            except OSError:
                pass
            proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        conn.close()
        name_resolve.DEFAULT_REPO = old_repo
    return rec


# ---------------- (cc) multi-GPU parallelism, part two ----------------

# (cc): the ring's ranks and the pipeline's stages, all in this process on
# the one card (two NCCL ranks cannot share a device)
RING_N = 4
PP_STAGES = 4


def ring_record(fa, schedule: str, B: int = 2, T: int = 7168, Hq: int = 14,
                Hkv: int = 2, D: int = 64, seed: int = 7,
                device: str = "cuda", n: int = RING_N,
                timed: bool = True) -> dict:
    """(cc1): ring attention alone at Qwen2.5-0.5B's heads, a one-process
    ring of ``n`` ranks over packed rows of several seeded documents:
    forward and backward against one K1 call and one K2/K3 call over the
    whole rows (2^-8 and 2^-7 of max|ref|), pad rows 0, no NaN; K1-K3
    launches and the ring's counters; with ``timed``, the ring's ms summed
    and its slowest rank's against one K1 call."""
    from areal_tpu_torch.parallel import ring as ring_mod

    cuda = device == "cuda"
    (q, k, v), seg = packed_inputs(B, T, Hq, Hkv, D, seed, device)
    scale = D ** -0.5
    ctx = ring_mod.RingCtx(n=n, schedule=schedule)
    lay = [ring_mod.shard_sequence(x, ctx).contiguous() for x in (q, k, v)]
    lseg = ring_mod.shard_sequence(seg, ctx).contiguous()
    ref, ref_lse = fa.flash_attention(q, k, v, seg, seg, return_lse=True)
    gen = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
    ref_grads = fa.flash_attention_bwd(q, k, v, seg, seg, ref, ref_lse, dout)
    sync(device)
    fa.reset_launch_count()
    ring_mod.reset_ring_counters()
    out_l, lse_l = ring_mod._ring_fwd(*lay, lseg, ctx, True, scale)
    sync(device)
    fwd_launches = fa.launch_counts()
    counters = ring_mod.ring_counters()
    fa.reset_launch_count()
    grads_l = ring_mod._ring_bwd(*lay, lseg, out_l, lse_l,
                                 ring_mod.shard_sequence(dout, ctx)
                                 .contiguous(), ctx, True, scale)
    sync(device)
    bwd_launches = fa.launch_counts()
    out = ring_mod.unshard_sequence(out_l, ctx)
    lse = ring_mod.unshard_sequence(lse_l.transpose(1, 2), ctx).transpose(1, 2)
    pad = seg == 0
    rec = dict(schedule=schedule, B=B, T=T, n=n,
               pad_rows=int(pad.sum()), skip_ratio=ring_mod.ring_skip_ratio(),
               counters=counters, fwd_launches=fwd_launches,
               bwd_launches=bwd_launches)
    err = (out.float() - ref.float()).abs().max().item()
    rec.update(max_abs_err=err, tol=2.0 ** -8 * ref.float().abs().max().item())
    fin = torch.isfinite(ref_lse)
    rec["lse_max_abs_err"] = (lse[fin] - ref_lse[fin]).abs().max().item()
    check(not torch.isnan(out).any().item(), f"(cc1) ring NaN: {rec}")
    check(err <= rec["tol"], f"(cc1) ring disagrees with one K1 call: {rec}")
    check(bool((out[pad] == 0).all().item()), f"(cc1) pad rows not 0: {rec}")
    check(torch.equal(torch.isfinite(lse), fin)
          and rec["lse_max_abs_err"] <= 1e-3,
          f"(cc1) the merged logsumexp disagrees: {rec}")
    for name, a_l, b in zip(("dq", "dk", "dv"), grads_l, ref_grads):
        a = ring_mod.unshard_sequence(a_l, ctx)
        e = (a.float() - b.float()).abs().max().item()
        tol = 2.0 ** -7 * b.float().abs().max().item()
        rec[f"{name}_max_abs_err"], rec[f"{name}_tol"] = e, tol
        check(not torch.isnan(a).any().item(), f"(cc1) {name} NaN: {rec}")
        check(e <= tol, f"(cc1) ring {name} disagrees with K2/K3: {rec}")
        check(bool((a[pad] == 0).all().item()),
              f"(cc1) {name} pad rows not 0: {rec}")
    want = n + 2 * n * (n - 1) if schedule == "zigzag" else \
        n + n * (n - 1) // 2
    check(counters["block_calls"] == want, f"(cc1) {counters}: expected "
          f"{want} blocks")
    check(not cuda or (fwd_launches["flash_attention_fwd"] == want
                       and bwd_launches["flash_attention_bwd_dq"] == want
                       and bwd_launches["flash_attention_bwd_dkv"] == want
                       and bwd_launches["flash_attention_fwd"] == 0
                       and fwd_launches["flash_attention_bwd_dq"] == 0),
          f"(cc1) K1-K3 launches {fwd_launches} / {bwd_launches}, "
          f"expected {want} a pass")
    check(abs(rec["skip_ratio"] - (n + 1) / (2 * n)) < 1e-9,
          f"(cc1) skip ratio {rec['skip_ratio']} != (n+1)/2n")
    if not (cuda and timed):  # the CPU's rehearsal: no device times
        print("(cc1) ring attention", json.dumps(rec), flush=True)
        return rec
    # times: the whole ring, each rank's body, one K1 call; the backward
    qs, ks, vs, segs = ([t.contiguous() for t in x.chunk(n, dim=1)]
                        for x in (*lay, lseg))
    blocks = list(zip(ks, vs, segs))
    ranks = [cuda_ms(lambda r=r: ring_mod._fwd_rank(
        qs[r], segs[r], ring_mod._LocalRing(blocks, r), n, r, schedule,
        True, scale), queued=True) for r in range(n)]
    rec.update(
        ring_fwd_ms=cuda_ms(lambda: ring_mod._ring_fwd(
            *lay, lseg, ctx, True, scale), queued=True),
        rank_fwd_ms=ranks, rank_fwd_ms_sum=sum(ranks),
        rank_fwd_ms_max=max(ranks),
        k1_whole_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, seg, seg),
                            queued=True),
        ring_bwd_ms=cuda_ms(lambda: ring_mod._ring_bwd(
            *lay, lseg, out_l, lse_l, ring_mod.shard_sequence(dout, ctx)
            .contiguous(), ctx, True, scale), iters=5, queued=True),
        k2_k3_whole_ms=cuda_ms(lambda: fa.flash_attention_bwd(
            q, k, v, seg, seg, ref, ref_lse, dout), iters=5, queued=True))
    # The ring's host work (K1 launches, merges, copies) outlasts a queued
    # batch's head start: its kernels' own device time, beside
    rec.update(
        ring_fwd_device_ms=device_busy_ms(lambda: ring_mod._ring_fwd(
            *lay, lseg, ctx, True, scale)),
        ring_bwd_device_ms=device_busy_ms(lambda: ring_mod._ring_bwd(
            *lay, lseg, out_l, lse_l, ring_mod.shard_sequence(dout, ctx)
            .contiguous(), ctx, True, scale)),
        k1_whole_device_ms=device_busy_ms(
            lambda: fa.flash_attention(q, k, v, seg, seg)))
    print("(cc1) ring attention", json.dumps(rec), flush=True)
    return rec


def ring_model_batch(vocab: int, lens=(5000, 4000, 2100, 3000)):
    """Seeded trajectories (by default 5000, 4000, 2100 and 3000 tokens,
    256 of prompt each, which the packer lays out as one micro-batch [2,
    7168])."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    lens = list(lens)
    plens = [min(256, n // 4) for n in lens]
    rng = np.random.RandomState(11)
    total = sum(lens)
    return SequenceSample.from_default(
        ids=[f"r{i}" for i in range(len(lens))],
        data={
            "packed_input_ids": rng.randint(2, vocab, total).astype(np.int32),
            "prompt_mask": np.concatenate([np.r_[np.ones(p, np.int32),
                                                 np.zeros(n - p, np.int32)]
                                           for n, p in zip(lens, plens)]),
            "packed_logprobs": np.concatenate([np.r_[
                np.zeros(p, np.float32), -rng.rand(n - p).astype(
                    np.float32)] for n, p in zip(lens, plens)]),
            "rewards": rng.rand(len(lens)).astype(np.float32),
            "seq_no_eos_mask": np.zeros(len(lens), np.float32),
        }, seqlens=lens)


def ring_model_record(fa, cfg, device: str = "cuda",
                      lens=(5000, 4000, 2100, 3000),
                      shape=(2, 7168)) -> dict:
    """(cc2): one forward and backward of the PPO loss on a [2, 7168]
    micro-batch, attention through the one-process ring of ``RING_N``
    ranks, against the same micro-batch through one K1
    per layer: (h)'s limits; the values, ms and peak memory of each."""
    from areal_tpu_torch.algorithms.ppo import _action_token_weight
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.parallel import ring as ring_mod

    batch = ring_model_batch(cfg.vocab_size, lens)
    spec = MicroBatchSpec(max_tokens_per_mb=shape[0] * shape[1])
    res, rec = {}, {}
    for label, kw in (("plain", {}), ("ring", {"sp": RING_N})):
        model, iface = build_trainer(cfg, device=device, **kw)
        eng = model.module
        ub = eng.upload_uniform(batch, spec)
        check(ub.n_mbs == 1 and (ub.R, ub.L) == tuple(shape),
              f"(cc2) packer gave {ub.n_mbs} x {(ub.R, ub.L)}")
        eng.run_prep(ub, iface._prep_fn, scalars={"kl_coef": 0.0})
        w = _action_token_weight(ub.mbs[0])
        eng.accumulate_grads(ub, iface._loss_fn, [0], [w])  # warm-up
        sync(device)
        mem_reset(device)
        fa.reset_launch_count()
        ring_mod.reset_ring_counters()
        t0 = time.perf_counter()
        loss, _ = eng.accumulate_grads(ub, iface._loss_fn, [0], [w])
        sync(device)
        rec[label] = {"fwd_bwd_ms": 1e3 * (time.perf_counter() - t0),
                      "peak_gb": mem_peak(device),
                      "launches": fa.launch_counts(),
                      "ring_counters": ring_mod.ring_counters()}
        res[label] = (float(loss), {n: p.grad.detach().clone()
                                    for n, p in eng.params.items()})
        del model, iface, eng, ub
        empty_cache(device)
    agree = grad_agreement("(cc2)", res["ring"][0], res["ring"][1],
                           res["plain"][0], res["plain"][1])
    L = cfg.n_layers
    n = RING_N
    per = n + 2 * n * (n - 1)
    got = rec["ring"]["launches"]
    check(device != "cuda" or got["flash_attention_fwd"] == 2 * L * per
          and got["flash_attention_bwd_dq"] == L * per
          and got["flash_attention_bwd_dkv"] == L * per,
          f"(cc2) ring launches {got}, expected {2 * L * per} K1 (forward "
          f"and the remat recompute) and {L * per} K2/K3: {L} layers x "
          f"{per} blocks")
    rec.update(agree, layers=L, n=n, mb_shape=list(shape))
    print("(cc2) the model through the ring", json.dumps(rec), flush=True)
    return rec


# (cc3)'s limits on the pipelined step against the plain one, each set
# between the sound readings (NVIDIA H100 80GB HBM3, 700 W: loss equal,
# grad norm within 2.5e-6, masters within 7.5e-9) and the faults of
# pipeline_fault (grad norm 21-48% off, masters 6.8e-7 to 9.1e-7 apart;
# the loss of a first PPO step reads no gradient, so it stays equal).
# Adam's first step moves an element by lr g / (|g| + eps): with
# gradients far below eps = 1e-5 here, masters part linearly in g.
PP_LIMITS = {"loss_rel_err": 1e-4, "grad_norm_rel_err": 1e-4,
             "master_abs_max": 1e-7}


@contextlib.contextmanager
def pipeline_fault(kind: str | None):
    """Break the pipeline for (cc3)'s fault runs, undone on exit:
    ``"stage0_grads_zeroed"`` drops stage 0's layer gradients;
    ``"microbatch_bwd_left_out"`` drops the cotangent of the pipeline
    micro-batch that carries the largest (the PPO loss clips every row of
    a negative advantage here, whose cotangent is 0 anyway), so its
    backward adds nothing."""
    from areal_tpu_torch.parallel import pipeline as ppl

    backward = ppl._Schedule.backward

    def faulty_backward(self, d_out, d_aux):
        if kind == "microbatch_bwd_left_out":
            d_out = d_out.clone()
            chunks = d_out.chunk(self.n_micro)
            max(chunks, key=lambda c: c.float().norm().item()).zero_()
        d_h, grads = backward(self, d_out, d_aux)
        if kind == "stage0_grads_zeroed":
            for layer in grads.get(0, []):
                for g in layer.values():
                    g.zero_()
        return d_h, grads

    if kind is not None:
        ppl._Schedule.backward = faulty_backward
    try:
        yield
    finally:
        ppl._Schedule.backward = backward


def pipeline_record(fa, cfg, device: str = "cuda", T: int = 1792) -> dict:
    """(cc3): a PPO train step on one [8, 1792] micro-batch, through
    ``PP_STAGES`` one-process stages that ``pick_pp_microbatches`` splits
    8 ways, with 1F1B and with GPipe, against the plain engine from the
    same weights: the step's loss, grad norm and masters within
    ``PP_LIMITS``; then one timed step each (ms, peak memory, K1-K3
    launches). Two broken 1F1B runs (``pipeline_fault``) must each break
    a limit: their readings show where the limits sit."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.parallel import mesh as pmesh
    from areal_tpu_torch.parallel import pipeline as ppl

    rng = np.random.RandomState(13)
    lens = [T] * 8
    total = sum(lens)
    batch = SequenceSample.from_default(
        ids=[f"p{i}" for i in range(8)],
        data={"packed_input_ids": rng.randint(2, cfg.vocab_size, total)
              .astype(np.int32),
              "prompt_mask": np.concatenate([np.r_[np.ones(256, np.int32),
                                                   np.zeros(T - 256, np.int32)]
                                             for _ in lens]),
              "packed_logprobs": np.concatenate([np.r_[
                  np.zeros(256, np.float32), -rng.rand(T - 256).astype(
                      np.float32)] for _ in lens]),
              "rewards": rng.rand(8).astype(np.float32),
              "seq_no_eos_mask": np.zeros(8, np.float32)},
        seqlens=lens)
    spec = MicroBatchSpec(max_tokens_per_mb=total)
    n_micro = ppl.pick_pp_microbatches(pmesh.ParallelSpec(pp=PP_STAGES), cfg,
                                       8, seq_len=T)
    check(n_micro == 8, f"(cc3) the gate gave {n_micro} micro-batches")
    L = cfg.n_layers
    lr = 1e-5  # make_model's
    # K1 per layer and micro-batch: "dots" remat runs it twice (forward,
    # recompute); 1F1B's backward recomputes each stage once more
    k1_per = {"plain": 2, "gpipe": 2 * n_micro, "1f1b": 3 * n_micro}
    k23_per = {"plain": 1, "gpipe": n_micro, "1f1b": n_micro}
    runs, faults, want = {}, {}, None
    old = os.environ.get("AREAL_PP_SCHEDULE")
    for label, stages, fault in (
            ("plain", 1, None), ("1f1b", PP_STAGES, None),
            ("gpipe", PP_STAGES, None),
            ("1f1b", PP_STAGES, "stage0_grads_zeroed"),
            ("1f1b", PP_STAGES, "microbatch_bwd_left_out")):
        # the schedule is read where the pipeline runs
        os.environ["AREAL_PP_SCHEDULE"] = "gpipe" if label == "gpipe" \
            else "1f1b"
        model, iface = build_trainer(cfg, device=device, pp=stages)
        eng = model.module
        fa.reset_launch_count()
        with pipeline_fault(fault):
            first = iface.train_step(model, batch, spec)
        sync(device)
        launches = fa.launch_counts()
        # on the host: ~2 GB at 0.5B, kept out of the timed step's peak
        masters = {n: p.detach().to("cpu", copy=True)
                   for n, p in eng.params.items()}
        r = {"loss": first["actor_loss"], "grad_norm": first["grad_norm"]}
        if want is None:
            want = (first, masters)
        else:
            d = {n: (masters[n] - want[1][n]).abs() for n in masters}
            r.update(
                loss_rel_err=abs(r["loss"] - want[0]["actor_loss"])
                / abs(want[0]["actor_loss"]),
                grad_norm_rel_err=abs(r["grad_norm"] - want[0]["grad_norm"])
                / want[0]["grad_norm"],
                master_abs_max=max(x.max().item() for x in d.values()),
                # the share of elements more than 1e-3 lr apart
                master_moved_frac=sum(int((x > 1e-3 * lr).sum())
                                      for x in d.values())
                / sum(x.numel() for x in d.values()))
            del d
            broken = [k for k, lim in PP_LIMITS.items() if r[k] > lim]
            if fault is None:  # the limits are the card's (the CPU's
                # plain bf16 attention parts the masters by ~1.2e-7)
                check(device != "cuda" or not broken,
                      f"(cc3) {label} disagrees with the plain engine on "
                      f"{broken} (limits {PP_LIMITS}): {r}")
            else:
                check(bool(broken), f"(cc3) the limits {PP_LIMITS} miss the "
                      f"fault {fault}: {r}")
                faults[fault] = r
                del model, iface, eng, masters
                empty_cache(device)
                continue
        mem_reset(device)
        t0 = time.perf_counter()
        iface.train_step(model, batch, spec)
        sync(device)
        r.update(ms_per_step=1e3 * (time.perf_counter() - t0),
                 peak_gb=mem_peak(device), launches=launches)
        check(device != "cuda"
              or launches["flash_attention_fwd"] == k1_per[label] * L
              and launches["flash_attention_bwd_dq"] == k23_per[label] * L
              and launches["flash_attention_bwd_dkv"] == k23_per[label] * L,
              f"(cc3) {label} launches {launches}, expected K1 "
              f"{k1_per[label] * L}, K2/K3 {k23_per[label] * L}")
        check(math.isfinite(r["loss"]) and r["grad_norm"] > 0,
              f"(cc3) {label} bad stats {first}")
        runs[label] = r
        del model, iface, eng, masters
        empty_cache(device)
    if old is None:
        os.environ.pop("AREAL_PP_SCHEDULE")
    else:
        os.environ["AREAL_PP_SCHEDULE"] = old
    check(device != "cuda" or runs["1f1b"]["peak_gb"]
          < runs["gpipe"]["peak_gb"],
          f"(cc3) 1F1B's peak is not below GPipe's: {runs}")
    rec = {"stages": PP_STAGES, "n_micro": n_micro, "layers": L,
           "mb_shape": [8, T], "limits": PP_LIMITS, "faults": faults, **runs}
    print("(cc3) the pipeline", json.dumps(rec), flush=True)
    return rec


def run_ring_and_pipeline(fa, cfg, device: str = "cuda") -> dict:
    """(cc): (cc1) for both ring schedules, (cc2), (cc3)."""
    rec = {f"ring_{s}": ring_record(fa, s, device=device)
           for s in ("zigzag", "naive")}
    # a ring of 8 at the same limits: each block's output and dk/dv
    # collect 2n-1 = 15 tiles, each rounded to bf16 by K1 / K2 before the
    # f32 merge or sum
    rec["ring_zigzag_n8"] = ring_record(fa, "zigzag", device=device, n=8,
                                        timed=False)
    empty_cache(device)
    rec["ring_model"] = ring_model_record(fa, cfg, device)
    rec["pipeline"] = pipeline_record(fa, cfg, device)
    return rec


# ---------------- (dd) expert parallelism ----------------

EP_DEGREES = (4, 8)
EP_TRAIN = 4  # (dd2)'s one-process ep
# (dd2)'s limits on the EP engine's loss and gradients against the plain
# engine's (one-process EP, no drops), set between the sound readings and
# a misrouted exchange's on the card (NVIDIA H100 80GB HBM3, 700 W): sound
# loss 0 apart, grad norms within 6.4e-8, 1 - cosine 4.6e-9; two sources
# swapped: loss 1.07e-5 apart, a grad norm 18.1% off, cosine 0.9623
EP_LIMITS = {"loss_rel_err": 1e-6, "max_grad_norm_rel_err": 1e-4,
             "grad_cosine_min": 1 - 1e-5}


def ep_layer_inputs(E: int, k: int, F: int, D: int, B: int, T: int,
                    seed: int, device: str):
    """(dd1)'s layer in bf16 from ``seed`` (router and experts N(0, 0.02),
    x N(0, 1) [B, T, D], the last eighth of each row padding): weights,
    x and mask."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(
            torch.bfloat16)

    lp = {"router": rnd(E, D), "e_gate": rnd(E, D, F), "e_up": rnd(E, D, F),
          "e_down": rnd(E, F, D)}
    mask = (torch.arange(T, device=device) < T - T // 8)[None].expand(B, T)
    return lp, rnd(B, T, D, scale=1.0), mask


def ep_layer_record(cfg, device: str = "cuda", B: int = 8, T: int = 512,
                    seed: int = 60) -> dict:
    """(dd1): the MoE layer of ``cfg`` at B x T tokens through one-process
    EP (``ExpertCtx(ep)``, each ``B/ep`` rows a source) at each of
    ``EP_DEGREES``. No drops (capacity factor E/k, so C = N_source):
    output within 2 bf16 ulps of the grouped dispatch's largest magnitude,
    drop fraction 0. At the model's capacity factor and at 0.5 (which must
    drop): keep masks and drop fraction exactly those of a plain
    per-source version (the einsum oracle on each source's rows with
    capacity(N_source)), outputs within 2 ulps of it. Wall ms (CUDA events) and device ms of the EP and the
    grouped layers, and the exchange's share of the EP layer's wall."""
    from areal_tpu_torch.models import moe as moemod

    moe = cfg.moe
    E, k, D = moe.num_experts, moe.top_k, cfg.hidden_dim
    F = moe.routed_intermediate_dim or cfg.intermediate_dim
    lp, x, mask = ep_layer_inputs(E, k, F, D, B, T, seed, device)
    nodrop = dataclasses.replace(moe, capacity_factor=E / k)
    cuda = torch.device(device).type == "cuda"
    rec = {"E": E, "top_k": k, "F": F, "D": D, "shape": [B, T],
           "pad_tokens": int((~mask).sum()),
           "capacity_factor_model": moe.capacity_factor, "ep": {}}
    with torch.no_grad():
        g_y, g_aux = moemod.moe_mlp(x, lp, nodrop, mask=mask)
        top = g_y.float().abs().max().item()
        if cuda:
            rec["grouped_ms"] = cuda_ms(lambda: moemod.moe_mlp(
                x, lp, nodrop, mask=mask), iters=5)
            rec["grouped_device_ms"] = device_busy_ms(lambda: moemod.moe_mlp(
                x, lp, nodrop, mask=mask))
        for ep in EP_DEGREES:
            ctx = moemod.ExpertCtx(ep=ep)
            rows = B // ep
            y, aux = moemod.moe_mlp(x, lp, nodrop, mask=mask, ep=ctx)
            r = {"source_tokens": rows * T,
                 "capacity_nodrop": moemod.capacity(rows * T, nodrop),
                 "capacity_model": moemod.capacity(rows * T, moe),
                 "nodrop_max_abs_err": (y.float() - g_y.float()).abs().max()
                 .item(), "nodrop_tol": 2 * bf16_ulp(top),
                 "nodrop_dropped_frac": float(aux["dropped_frac"])}
            check(r["nodrop_max_abs_err"] <= r["nodrop_tol"]
                  and r["nodrop_dropped_frac"] == 0.0,
                  f"(dd1) ep={ep}: EP disagrees with the grouped dispatch "
                  f"without drops: {r}")
            # the model's capacity factor, and 0.5, which must drop
            for tag, m in (("", moe), ("_cf05", dataclasses.replace(
                    moe, capacity_factor=0.5))):
                y2, aux2, keep2 = moemod.moe_mlp(x, lp, m, mask=mask, ep=ctx,
                                                 return_keep=True)
                parts = [moemod.moe_mlp(x[i * rows:(i + 1) * rows], lp, m,
                                        mask=mask[i * rows:(i + 1) * rows],
                                        dispatch="einsum", return_keep=True)
                         for i in range(ep)]
                y_or = torch.cat([p[0] for p in parts])
                keep_or = torch.cat([p[2] for p in parts])
                n_valid = mask.reshape(-1).float().sum().clamp_min(1.0)
                drop_or = 1.0 - keep_or.float().sum() / (
                    n_valid * k).clamp_min(1.0)
                r.update({
                    f"dropped_frac{tag}": float(aux2["dropped_frac"]),
                    f"dropped_frac_plain{tag}": float(drop_or),
                    f"max_abs_err_plain{tag}": (y2.float() - y_or.float())
                    .abs().max().item(),
                    f"tol_plain{tag}": 2 * bf16_ulp(
                        y_or.float().abs().max().item())})
                check(torch.equal(keep2, keep_or)
                      and r[f"dropped_frac{tag}"]
                      == r[f"dropped_frac_plain{tag}"],
                      f"(dd1) ep={ep}: drops differ from the per-source "
                      f"version: {r}")
                check(r[f"max_abs_err_plain{tag}"] <= r[f"tol_plain{tag}"],
                      f"(dd1) ep={ep}: EP disagrees with the per-source "
                      f"version: {r}")
            check(r["dropped_frac_cf05"] > 0,
                  f"(dd1) ep={ep}: capacity factor 0.5 dropped nothing: {r}")
            if cuda:
                r["ep_ms"] = cuda_ms(lambda: moemod.moe_mlp(
                    x, lp, nodrop, mask=mask, ep=ctx), iters=5)
                r["ep_device_ms"] = device_busy_ms(lambda: moemod.moe_mlp(
                    x, lp, nodrop, mask=mask, ep=ctx))
                C = r["capacity_nodrop"]
                # both re-indexings of the layer's [ep, E, C, D] buffers
                xe = torch.zeros(ep, E, C, D, dtype=x.dtype, device=device)
                r["exchange_ms"] = cuda_ms(lambda: moemod.exchange_back(
                    moemod.exchange(xe, ctx), ctx, ep).contiguous(), iters=5)
                r["exchange_share"] = r["exchange_ms"] / r["ep_ms"]
                del xe
            rec["ep"][ep] = r
    print("(dd1) the MoE layer through one-process EP", json.dumps(rec),
          flush=True)
    return rec


def ep_batch(vocab: int, n: int = 16, T: int = 1024, prompt: int = 256):
    """(dd2)'s PPO batch: ``n`` trajectories of ``T`` tokens (``prompt``
    prompt tokens), seeded: 4096 tokens a micro-batch make [4, 1024] rows,
    which split into ``EP_TRAIN`` sources of a row."""
    import numpy as np

    from areal_tpu_torch.api.data import SequenceSample

    rng = np.random.RandomState(17)
    total = n * T
    return SequenceSample.from_default(
        ids=[f"e{i}" for i in range(n)],
        data={"packed_input_ids": rng.randint(2, vocab, total)
              .astype(np.int32),
              "prompt_mask": np.tile(np.r_[np.ones(prompt, np.int32),
                                           np.zeros(T - prompt, np.int32)],
                                     n),
              "packed_logprobs": np.concatenate([np.r_[
                  np.zeros(prompt, np.float32),
                  -rng.rand(T - prompt).astype(np.float32)]
                  for _ in range(n)]),
              "rewards": rng.rand(n).astype(np.float32),
              "seq_no_eos_mask": np.zeros(n, np.float32)},
        seqlens=[T] * n)


@contextlib.contextmanager
def exchange_fault(kind: str | None):
    """Break the one-process exchange for (dd2)'s fault run, undone on
    exit: ``"source_rows_misrouted"`` hands source 0's buffers to the
    owners as source 1's and source 1's as source 0's, so those sources'
    tokens come back with each other's expert rows."""
    from areal_tpu_torch.models import moe as moemod

    exchange = moemod.exchange

    def misrouted(xe, ctx, caps=None):
        if ctx.one_process:
            order = list(range(xe.shape[0]))
            order[0], order[1] = 1, 0
            xe = xe[order]
        return exchange(xe, ctx, caps)

    if kind is not None:
        moemod.exchange = misrouted
    try:
        yield
    finally:
        moemod.exchange = exchange


def ep_grads(eng, ub, loss_fn, weights, ep: int) -> tuple:
    """Every micro-batch's loss and gradients summed (no optimizer step),
    with the engine's ``_spec.ep`` at ``ep`` (1: the plain engine)."""
    from areal_tpu_torch.parallel.mesh import ParallelSpec

    eng._spec = ParallelSpec(ep=ep)
    loss, stats = eng.accumulate_grads(ub, loss_fn, list(range(ub.n_mbs)),
                                       weights)
    grads = {n: p.grad for n, p in eng.params.items()}
    for p in eng.params.values():
        p.grad = None
    return float(loss), {k: float(v.sum()) for k, v in stats.items()}, grads


def ep_agreement(loss, grads, loss_ref, grads_ref) -> dict:
    """Loss, per-parameter grad norms and the whole gradient's cosine of
    one run against the plain engine's."""
    norm = {n: (grads[n].norm().item(), grads_ref[n].norm().item())
            for n in grads_ref}
    dot = sum((grads[n].double() * grads_ref[n].double()).sum().item()
              for n in grads_ref)
    na = math.sqrt(sum(a * a for a, _ in norm.values()))
    nb = math.sqrt(sum(b * b for _, b in norm.values()))
    rel = {n: abs(a - b) / max(b, 1e-30) for n, (a, b) in norm.items()}
    worst = max(rel, key=rel.get)
    return {"loss": loss, "loss_rel_err": abs(loss - loss_ref)
            / max(abs(loss_ref), 1e-30), "grad_norm": na,
            "grad_cosine": dot / max(na * nb, 1e-300),
            "max_grad_norm_rel_err": rel[worst], "worst_param": worst}


def ep_broken(r: dict) -> list:
    return [k for k in ("loss_rel_err", "max_grad_norm_rel_err")
            if r[k] > EP_LIMITS[k]] + (
        ["grad_cosine"] if r["grad_cosine"] < EP_LIMITS["grad_cosine_min"]
        else [])


def ep_train_record(fa, cfg, device: str = "cuda", steps: int = 2,
                    batch=None, spec=None) -> dict:
    """(dd2): PPO steps of ``cfg`` with the capacity factor E/k (no drops)
    through one engine, its ``_spec.ep`` at ``EP_TRAIN`` (one-process EP:
    each micro-batch's rows split into sources, every owner here) and at
    1 (the plain grouped engine). From the same weights: every
    micro-batch's loss and gradients, EP's within ``EP_LIMITS`` of plain's
    and a misrouted exchange's (:func:`exchange_fault`) outside them;
    ``train/moe_ep_engaged`` 1 under EP, 0 plain; then ``steps`` timed EP
    steps (K2/K3 launched layers x micro-batches x steps times, K1 twice
    that; the drop fraction 0) and ``steps`` plain ones: ms per step and
    peak memory of each."""
    from areal_tpu_torch.algorithms.ppo import _action_token_weight
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.base import telemetry
    from areal_tpu_torch.parallel.mesh import ParallelSpec

    cuda = torch.device(device).type == "cuda"
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    batch = batch or ep_batch(cfg.vocab_size)
    spec = spec or MicroBatchSpec(max_tokens_per_mb=4096)
    t0 = time.monotonic()
    model, iface = build_trainer(cfg, device=device)
    eng = model.module
    rec = {"layers": cfg.n_layers, "ep": EP_TRAIN,
           "capacity_factor": cfg.moe.capacity_factor,
           "build_s": time.monotonic() - t0, "limits": EP_LIMITS}
    gauges = {}
    set_gauge = telemetry.set_gauge

    def record_gauge(name, v):
        gauges[name] = v
        set_gauge(name, v)

    telemetry.set_gauge = record_gauge
    try:
        # the gradient runs below warm both dispatches for the timed steps
        ub = eng.upload_uniform(batch, spec)
        eng.run_prep(ub, iface._prep_fn, scalars={"kl_coef": 0.0})
        rec["mb_shape"], rec["n_mbs"] = [ub.R, ub.L], ub.n_mbs
        check(ub.R % EP_TRAIN == 0, f"(dd2) rows {ub.R} do not split into "
              f"{EP_TRAIN} sources")
        weights = [float(_action_token_weight(mb)) for mb in ub.mbs]
        loss_p, stats_p, grads_p = ep_grads(eng, ub, iface._loss_fn,
                                            weights, 1)
        runs = {}
        for label, fault in (("ep", None),
                             ("misrouted", "source_rows_misrouted")):
            with exchange_fault(fault):
                loss, stats, grads = ep_grads(eng, ub, iface._loss_fn,
                                              weights, EP_TRAIN)
            r = ep_agreement(loss, grads, loss_p, grads_p)
            r["dropped_frac"] = stats.get("moe_dropped_frac")
            del grads
            runs[label] = r
            broken = ep_broken(r)
            if fault is None:
                check(not broken and math.isfinite(loss),
                      f"(dd2) EP disagrees with the plain engine on "
                      f"{broken} (limits {EP_LIMITS}): {r}")
            else:
                check(bool(broken), f"(dd2) the limits {EP_LIMITS} miss "
                      f"the fault {fault}: {r}")
        del grads_p
        rec.update(loss_plain=loss_p, dropped_frac_plain=stats_p.get(
            "moe_dropped_frac"), **runs)
        check(runs["ep"]["dropped_frac"] == 0.0
              and rec["dropped_frac_plain"] == 0.0,
              f"(dd2) tokens dropped at capacity factor E/k: {rec}")
        for label, ep in (("ep", EP_TRAIN), ("plain", 1)):
            eng._spec = ParallelSpec(ep=ep)
            gauges.pop("train/moe_ep_engaged", None)
            empty_cache(device)
            mem_reset(device)
            fa.reset_launch_count()
            t0 = time.perf_counter()
            stats = [iface.train_step(model, batch, spec)
                     for _ in range(steps)]
            sync(device)
            rec[f"ms_per_step_{label}"] = 1e3 * (time.perf_counter()
                                                 - t0) / steps
            rec[f"peak_gb_{label}"] = mem_peak(device)
            rec[f"gauge_{label}"] = gauges.get("train/moe_ep_engaged")
            rec[f"loss_{label}"] = [s["actor_loss"] for s in stats]
            rec[f"launches_{label}"] = fa.launch_counts()
            for st in stats:
                check(math.isfinite(st["actor_loss"])
                      and st["grad_norm"] > 0
                      and st["moe_dropped_frac"] == 0.0,
                      f"(dd2) {label} bad stats {st}")
    finally:
        telemetry.set_gauge = set_gauge
        eng._spec = ParallelSpec()
    check(rec["gauge_ep"] == 1.0 and rec["gauge_plain"] == 0.0,
          f"(dd2) train/moe_ep_engaged read {rec['gauge_ep']} under EP and "
          f"{rec['gauge_plain']} plain")
    if cuda:
        for label in ("ep", "plain"):
            check_launches(f"(dd2) {label}", rec[f"launches_{label}"],
                           rec["n_mbs"] * steps, cfg.n_layers, train=True)
    rec["launches"] = rec["launches_ep"]
    print("(dd2) PPO steps through one-process EP", json.dumps(rec),
          flush=True)
    del model, iface, eng
    empty_cache(device)
    return rec


def run_ep(fa, device: str = "cuda", cfg=None, train_layers: int = 2,
           layer_shape=(8, 512), train_batch=None, train_spec=None) -> dict:
    """(dd): (dd1) at Qwen3-30B-A3B's width (``cfg``), then (dd2) at
    ``train_layers`` of its layers."""
    from areal_tpu_torch.models.config import qwen3_30b_a3b

    cfg = cfg or qwen3_30b_a3b()
    t0 = time.monotonic()
    layer = ep_layer_record(cfg, device, *layer_shape)
    empty_cache(device)
    t1 = time.monotonic()
    train = ep_train_record(fa, dataclasses.replace(cfg,
                                                    n_layers=train_layers),
                            device, batch=train_batch, spec=train_spec)
    return {"layer": layer, "train": train, "layer_s": t1 - t0,
            "train_s": time.monotonic() - t1}


# ---------------- (ee) the decoupled generation fleet ----------------

# (ee): a tp=2 meshed server of Qwen2.5-0.5B; (ff): an f2p2 one. Their
# ranks are processes on the one card joined over gloo, whose collectives
# stage the CUDA tensors through the host (two NCCL ranks cannot share a
# device; the pipeline's sends go through host memory explicitly); the
# arithmetic is the Block, stage and server code a multi-GPU server runs.
GEN_SPECS = {"ee": "t2", "ff": "f2p2"}
GEN_GROUP_MB = 16


def count_plain_in_prefill(genmod, counts: dict) -> None:
    """Count into ``counts``, in this process, the prefills and the plain
    attention's calls made inside one (a decode step's attention is the
    plain one by design)."""
    from areal_tpu_torch.ops import attention

    counts.update(plain_in_prefill=0, prefills=0)
    inside = threading.local()
    orig_ref, orig_prefill = attention.attention_reference, \
        genmod.prefill_state

    def ref(*a, **k):
        if getattr(inside, "on", False):
            counts["plain_in_prefill"] += 1
        return orig_ref(*a, **k)

    def prefill(*a, **k):
        counts["prefills"] += 1
        inside.on = True
        try:
            return orig_prefill(*a, **k)
        finally:
            inside.on = False

    attention.attention_reference, genmod.prefill_state = ref, prefill


_RANK_COUNTS: dict = {}


def rank_reset(server) -> None:
    from areal_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_count()
    for k in _RANK_COUNTS:
        _RANK_COUNTS[k] = 0


def rank_counts(server) -> dict:
    from areal_tpu_torch.ops import flash_attention as fa

    chain = server.mesh_ctl.chain
    gather = chain.gather.stats if chain and chain.gather else None
    return {"k1": fa.launch_count(), **_RANK_COUNTS,
            "fsdp_gather": dict(gather) if gather else None}


def rank_kv_bytes(server, sid: int) -> int:
    st = server.mesh_ctl.state(sid)
    return st["kv_k"].numel() * st["kv_k"].element_size() * 2


def rank_param_bytes(server) -> dict:
    """This rank's live parameter bytes against what its layout's cuts
    imply (``serving_slices`` at the served dtype's size), and what it
    would hold at ``fsdp`` 1 (its cuts without the fsdp one)."""
    from areal_tpu_torch.models.transformer import Transformer
    from areal_tpu_torch.parallel import sharding as psh

    live = server._live_params()
    whole = Transformer(server.model_cfg, device="meta").state_dict()
    cuts = psh.serving_slices(server.model_cfg, server.spec)[server.rank]
    fdims = psh.fsdp_dims(server.model_cfg, server.spec)
    size = next(iter(live.values())).element_size()

    def nbytes(shape, cut):
        return size * math.prod(psh.cut_shape(shape, cut))

    return {"rank": server.rank, "bytes": sum(
        t.numel() * t.element_size() for t in live.values()),
        "layout_bytes": sum(nbytes(whole[n].shape, c)
                            for n, c in cuts.items()),
        "fsdp1_bytes": sum(nbytes(whole[n].shape, tuple(
            x for x in c if n not in fdims or x[0] != fdims[n]))
            for n, c in cuts.items()),
        "params": sum(t.numel() for t in live.values())}


def rank_mem_reset(server):
    """Start this rank's peak-memory window; its bytes allocated now (None
    off the card)."""
    if torch.device(server.device).type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def rank_mem_peak(server):
    """The most this rank held since :func:`rank_mem_reset`, in bytes."""
    if torch.device(server.device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def rank_weights(server, cfg, seed: int) -> dict:
    """How many of this rank's live tensors are bit for bit its part of
    the seed's bf16 weights."""
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.parallel import sharding as psh

    want = psh.serving_shards(
        init_params(cfg, seed=seed, device=server.device,
                    dtype=torch.bfloat16),
        cfg, server.spec, server.rank)
    live = server._live_params()
    bad = [n for n in live if not (live[n].dtype == want[n].dtype
                                   and torch.equal(live[n], want[n]))]
    return {"n": len(live), "n_want": len(want), "n_bad": len(bad),
            "bad": bad[:3], "rank": server.rank}


def gen_mesh_command(srv, cmd):
    """The leader's side of one (ee) / (ff) command from the script."""
    kind = cmd[0]
    if kind == "reset":
        srv.mesh_ctl.gather(rank_reset)
        return None
    if kind == "counts":
        return {"ranks": srv.mesh_ctl.gather(rank_counts),
                "stats": {k: v for k, v in srv.stats().items()
                          if not isinstance(v, (list, dict))}}
    if kind == "prefill":
        # the greedy prompts' prefill, then a greedy decode of n_decode
        # steps on its state; each rank's bytes at rest, before the
        # decode (the prefill's state held too) and its peak in each of
        # the two calls
        from areal_tpu_torch.api.model import GenerationHyperparameters
        from areal_tpu_torch.ops.sampling import sampling_from_gconfigs

        _, padded, plens, S, n_decode = cmd
        mesh, dev, B = srv.mesh_ctl, srv.device, padded.shape[0]
        with mesh.lock, torch.inference_mode():
            rest = mesh.gather(rank_mem_reset)
            st = srv._ops.prefill_state(
                srv.model, torch.from_numpy(padded).to(dev),
                torch.from_numpy(plens).to(dev), S)
            prefill_peak = mesh.gather(rank_mem_peak)
            out = {"last_logits": st["last_logits"].float().cpu().numpy(),
                   "kv_bytes": mesh.gather(rank_kv_bytes, st.sid)}
            decode_start = mesh.gather(rank_mem_reset)
            srv._ops.decode_chunk_rows(
                srv.model, st, torch.zeros(B, dtype=torch.int32, device=dev),
                srv._generator, sampling_from_gconfigs(
                    [GenerationHyperparameters(greedy=True)] * B, dev),
                n_decode, srv.cfg.eos_token_id, srv.cfg.pad_token_id)
            out["memory"] = {"rest": rest, "prefill_peak": prefill_peak,
                             "decode_start": decode_start,
                             "decode_peak": mesh.gather(rank_mem_peak),
                             "decode_steps": n_decode, "rows": B}
            return out
    if kind == "weights":
        return srv.mesh_ctl.gather(rank_weights, cmd[1], cmd[2])
    if kind == "param_bytes":
        return srv.mesh_ctl.gather(rank_param_bytes)
    raise ValueError(f"unknown (ee) / (ff) command {kind!r}")


def gen_mesh_rank(rank, world, cfg, eos, tmp, urlq, ctl, replies,
                  device: str, spec: str = "t2", phase: str = "ee") -> dict:
    """(ee) / (ff): one rank of the meshed server of ``spec`` on the card.
    The leader serves HTTP, puts its URL on ``urlq`` and answers the
    script's commands (``ctl`` -> ``replies``) until ("stop",); a
    follower replays its device calls until the leader stops."""
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.parallel.mesh import ParallelSpec, make_mesh
    from areal_tpu_torch.system.generation_server import (
        GenerationServer,
        GenerationServerConfig,
    )

    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    count_plain_in_prefill(genmod, _RANK_COUNTS)
    mesh = make_mesh(ParallelSpec.parse(spec))
    # A window the 8 concurrent requests all land in on a slow host too: a
    # second batch runs its own 128 steps after the first's, and on a host
    # whose requests spread past 20 ms the traffic took ~3x one batch's.
    srv = GenerationServer(
        GenerationServerConfig(experiment="chip_smoke", trial=phase,
                               chunk_tokens=128, eos_token_id=eos,
                               pad_token_id=eos, batch_window_ms=250,
                               spec=spec),
        cfg, init_params(cfg, seed=0, device=device, dtype=torch.bfloat16),
        device=device, mesh=mesh)
    if rank > 0:
        srv.follow()
        return {"rank": rank, **_RANK_COUNTS}
    urlq.put(srv.start())
    try:
        while True:
            cmd = ctl.get(timeout=900)
            if cmd[0] == "stop":
                break
            replies.put(gen_mesh_command(srv, cmd))
    finally:
        srv.stop()
    return {"rank": 0}


def queue_get(q, what: str, alive, timeout: float):
    """The next item of ``q`` within ``timeout``, while ``alive()``."""
    import queue as queue_mod

    deadline = time.monotonic() + timeout
    while True:
        try:
            return q.get(timeout=1.0)
        except queue_mod.Empty:
            check(alive() and time.monotonic() < deadline,
                  f"no {what} within {timeout} s from the meshed server's "
                  f"ranks (alive: {alive()})")


def run_gen_mesh(fa, cfg, eos: int, tmp: str, prompts, served: dict,
                 device_sync_s, device: str = "cuda",
                 phase: str = "ee") -> dict:
    """(ee) / (ff): the meshed server's traffic (its spec
    ``GEN_SPECS[phase]``), its prefill against the unsharded server's, its
    KV and parameter bytes, then a device publication into its layout and
    the gates. Checks and numbers as in the module docstring."""
    import multiprocessing
    import types

    from areal_tpu_torch.api.train_config import WeightSyncConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer, init_params
    from areal_tpu_torch.parallel import distributed as dist_mod
    from areal_tpu_torch.parallel import reshard as rsh
    from areal_tpu_torch.parallel import sharding as psh
    from areal_tpu_torch.parallel.mesh import ParallelSpec
    from areal_tpu_torch.system.gserver_manager import GserverManager
    from areal_tpu_torch.system.trainer_worker import (
        TrainerWorker,
        TrainerWorkerConfig,
    )

    exp, trial = "chip_smoke", phase
    spec = ParallelSpec.parse(GEN_SPECS[phase])
    world = spec.world_size
    tag = f"({phase})"
    # each rank's layers and kv heads (its KV and its K1 launches)
    rank_cfgs = [psh.rank_config(cfg, spec, r) for r in range(world)]
    old_repo = name_resolve.DEFAULT_REPO
    name_resolve.reconfigure(name_resolve.NameResolveConfig(
        type="nfs", nfs_record_root=os.path.join(tmp, "name_resolve")))
    ctx = multiprocessing.get_context("spawn")
    urlq, ctl, replies = ctx.Queue(), ctx.Queue(), ctx.Queue()
    ranks: dict = {}

    def run():
        try:
            ranks["out"] = dist_mod.run_ranks(
                gen_mesh_rank, world, cfg, eos, tmp, urlq, ctl, replies,
                device, str(spec), phase, timeout=900,
                device=f"{device}:0" if device == "cuda" else device)
        except BaseException as e:  # noqa: BLE001 — raised below
            ranks["error"] = e

    th = threading.Thread(target=run, daemon=True, name=f"{phase}-ranks")
    th.start()

    def alive():
        return th.is_alive()

    def ask(*cmd, timeout: float = 300):
        ctl.put(cmd)
        return queue_get(replies, cmd[0], alive, timeout)

    rec: dict = {"spec": str(spec), "tp": spec.tp, "legs_s": {}}
    trainer = None
    t_start = time.monotonic()
    try:
        url = queue_get(urlq, "server URL", alive, 300)
        rec["legs_s"]["ranks_up"] = time.monotonic() - t_start
        gconfigs = [{"greedy": True} if i % 2 == 0 else
                    {"temperature": 0.7 + 0.1 * i, "top_p": 0.9}
                    for i in range(len(prompts))]
        budget, chunk = 192, 128
        ask("reset")
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            first = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i], "gconfig": gconfigs[i],
                "max_tokens": budget, "rid": f"e{i}"}), range(len(prompts))))
        for i, r in enumerate(first):
            check_reply(r, chunk, eos, f"{tag} request {i}")
        c1 = ask("counts")
        prefills = c1["stats"]["prefill_calls"]
        k1 = [r["k1"] for r in c1["ranks"]]
        want_k1 = [c.n_layers * prefills for c in rank_cfgs]
        check(prefills >= 1, f"{tag}: no prefill ran")
        check(device != "cuda" or k1 == want_k1,
              f"{tag}: K1 launches per rank {k1} != each rank's layers x "
              f"{prefills} prefills {want_k1}")
        check(all(r["plain_in_prefill"] == 0 and r["prefills"] == prefills
                  for r in c1["ranks"]) or device != "cuda",
              f"{tag}: the plain attention ran in a prefill, or the ranks "
              f"prefilled apart: {c1['ranks']}")
        open_rows = [i for i, r in enumerate(first) if not r["finished"]]
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            cont = list(pool.map(lambda i: post(url, {
                "prompt_ids": prompts[i] + first[i]["output_ids"],
                "gconfig": gconfigs[i], "max_tokens": budget - chunk,
                "rid": f"e{i}", "tokens_done": chunk}), open_rows))
        for i, r in zip(open_rows, cont):
            check_reply(r, budget - chunk, eos, f"{tag} continuation {i}")
        wall = time.monotonic() - t0
        rec["legs_s"]["traffic"] = wall
        c2 = ask("counts")
        st = c2["stats"]
        check(st["prefill_calls"] == prefills
              and [r["k1"] for r in c2["ranks"]] == k1,
              f"{tag}: a continuation prefilled: {c1} -> {c2}")
        rec.update(
            prefills=prefills, k1_launches=sum(k1), k1_per_rank=k1,
            k1_per_rank_per_prefill=[k // prefills for k in k1],
            plain_in_prefill=[r["plain_in_prefill"] for r in c2["ranks"]],
            continuations=len(cont), wall_s=wall,
            prefill_ms_per_call=1e3 * st["prefill_secs"] / prefills,
            decode_ms_per_step=1e3 * st["decode_secs"] / st["decode_steps"],
            generated_tokens=st["generated_tokens"],
            # each rank's fsdp gathers (count, bytes in, host s): after the
            # first batch (a prefill and a decode call), then in all
            fsdp_gather_first=[r["fsdp_gather"] for r in c1["ranks"]],
            fsdp_gather=[r["fsdp_gather"] for r in c2["ranks"]],
            unsharded=served)
        print(f"({phase}1) traffic", json.dumps(rec), flush=True)

        # the greedy requests' prefill against the unsharded server's
        greedy = [i for i in range(len(prompts)) if i % 2 == 0]
        padded, plens = genmod.pad_prompts([prompts[i] for i in greedy], eos,
                                           bucket=128)
        S = padded.shape[1] + 128
        got = ask("prefill", padded, plens, S, 32)
        model = Transformer.from_params(cfg, init_params(
            cfg, seed=0, device=device, dtype=torch.bfloat16))
        ref_st = genmod.prefill_state(model, torch.from_numpy(padded).to(
            device), torch.from_numpy(plens).to(device), S)
        ref = ref_st["last_logits"].float().cpu()
        whole_kv = 2 * ref_st["kv_k"].numel() * ref_st["kv_k"].element_size()
        del model, ref_st
        mine = torch.from_numpy(got["last_logits"])
        diff = (mine - ref).abs().max().item()
        # tp splits the sums (partial products added over the ranks);
        # fsdp and pp alone move no arithmetic (exact gathers, the same
        # GEMMs on the same inputs, an exact hand-off): bit-equal
        tol = 0.05 * ref.abs().max().item() if spec.tp > 1 else 0.0
        firsts = [first[i]["output_ids"][0] for i in greedy]
        rec["logits"] = {
            "max_abs_err": diff, "tol": tol,
            "argmax_agree": (mine.argmax(-1) == ref.argmax(-1)).float()
            .mean().item(),
            "first_tokens": firsts, "ref_argmax": ref.argmax(-1).tolist()}
        check(bool(torch.isfinite(mine).all())
              and tuple(mine.shape) == (len(greedy), cfg.vocab_size),
              f"{tag}: prefill logits not finite / wrong shape")
        check(diff <= tol, f"{tag}: the meshed prefill's logits are "
              f"{diff} from the unsharded server's (limit {tol})")
        check(firsts == ref.argmax(-1).tolist(),
              f"{tag}: first greedy tokens {firsts} != the unsharded "
              f"prefill's {ref.argmax(-1).tolist()}")
        # a rank's KV: its stage's layers, its kv heads, the whole batch
        # (fsdp splits no KV)
        want_kv = [whole_kv * c.n_layers * c.n_kv_heads
                   // (cfg.n_layers * cfg.n_kv_heads) for c in rank_cfgs]
        rec["kv_bytes"] = {"ranks": got["kv_bytes"], "unsharded": whole_kv,
                           "layout": want_kv}
        check(got["kv_bytes"] == want_kv,
              f"{tag}: rank KV bytes {got['kv_bytes']} are not the "
              f"layout's {want_kv} (unsharded {whole_kv})")
        pb = ask("param_bytes")
        rec["param_bytes"] = pb
        check(all(r["bytes"] == r["layout_bytes"] for r in pb),
              f"{tag}: a rank's parameter bytes differ from its layout's: "
              f"{pb}")
        print(f"({phase}) rank parameter bytes", json.dumps(pb), flush=True)
        # each rank's device memory: at rest (parameters, retained
        # states), its peak above that in the greedy prefill, and its
        # peak in the decode call after it above what it held as the
        # call began (under fsdp the call holds the stage's gathered
        # layers, the embedding and the head)
        mem = got["memory"]

        def above(peaks, starts):
            return [None if p is None else p - r
                    for p, r in zip(peaks, starts)]

        rec["memory"] = {
            **mem,
            "prefill_above_rest": above(mem["prefill_peak"], mem["rest"]),
            "decode_above_start": above(mem["decode_peak"],
                                        mem["decode_start"])}
        print(f"({phase}) rank memory", json.dumps(rec["memory"]),
              flush=True)

        # ({phase}2) a device publication in the server's layout, group
        # 16 MiB, from a trainer in this process (the ranks open its
        # buffers)
        t_pub = time.monotonic()
        src = make_model("ee_src", cfg, init_params(
            cfg, seed=1, device=device, dtype=torch.bfloat16), train=False,
            device=device)
        src.version.global_step = 1
        trainer = TrainerWorker(TrainerWorkerConfig(
            experiment=exp, trial=trial, device=device,
            realloc_dir=os.path.join(tmp, "realloc"),
            weight_sync=WeightSyncConfig(
                transport="device", gen_parallel_spec=str(spec),
                transfer_group_mb=GEN_GROUP_MB)))
        trainer.models["actor"] = src  # setup()-free: the publish half
        manager = types.SimpleNamespace(cfg=types.SimpleNamespace(
            experiment=exp, trial=trial, model_role="actor"))
        before = mem_reset(device)
        t0 = time.perf_counter()
        trainer.publish_weights("actor")
        rec["publish_s"] = time.perf_counter() - t0
        peak = mem_peak(device)
        body = GserverManager._update_payload(manager, 1, "")
        status, reply = post_json(url, "/update_weights", body)
        rec["publish_to_reply_s"] = time.perf_counter() - t0
        rec["server_update_s"] = reply.get("latency_s")
        rec["unsharded_publish_to_reply_s"] = device_sync_s
        check(status == 200 and reply.get("version") == 1,
              f"({phase}2) device update: {status} {reply}")
        pub = rsh._REGISTRY[(exp, trial, "actor")]
        buffers = sum(p.buffer.numel() for p in pub.parts)
        extra = (peak - before) * 2 ** 30 if peak is not None else 0.0
        bound = buffers + (GEN_GROUP_MB << 20)
        rec["publish_memory"] = {
            "extra_bytes": extra, "buffer_bytes": buffers,
            "group_bytes": GEN_GROUP_MB << 20, "bound_bytes": bound,
            "slack_bytes": bound - extra, "ranks": len(pub.parts),
            "groups": len(pub.plan.groups)}
        check(len(pub.parts) == world,
              f"({phase}2): {len(pub.parts)} rank buffers for {world} ranks")
        check(extra <= bound, f"({phase}2): the publish took {extra} B "
              f"beyond its buffers + one group ({bound} B)")
        rec_pub = rsh.lookup_publication(exp, trial, "actor")
        uuids = {s.get("uuid") for p in rsh.record_parts(rec_pub)
                 for s in p["shares"]}
        rec["uuid"] = sorted(map(str, uuids))
        check(device != "cuda" or uuids == {rsh.device_uuid(0)},
              f"({phase}3): the record names {uuids}, the card is "
              f"{rsh.device_uuid(0) if device == 'cuda' else None}")
        w = ask("weights", cfg, 1)
        check(all(r["n_bad"] == 0 and r["n"] == r["n_want"] for r in w),
              f"({phase}2): swapped weights differ from their parts: {w}")
        gates = {}
        for gate, bad, text in (
                ("digest", {"digest": "0" * 8, "version": 1},
                 "digest mismatch"),
                ("version", {"digest": body["digest"], "version": 2},
                 "version skew")):
            status, reply = post_json(url, "/update_weights",
                                      {"device": True, "role": "actor",
                                       **bad})
            gates[gate] = (status, reply.get("error", "")[:200])
            check(status == 500 and text in reply.get("error", ""),
                  f"({phase}2) gate {gate}: {status} {reply}")
        check(health(url)["version"] == 1,
              f"({phase}2): a gate moved the version")
        w = ask("weights", cfg, 1)
        check(all(r["n_bad"] == 0 for r in w),
              f"({phase}2): a failed gate changed the weights: {w}")
        rec["gates"] = gates
        rec["legs_s"]["publication"] = time.monotonic() - t_pub
        print(f"({phase}2) device publication", json.dumps({
            k: rec[k] for k in ("publish_to_reply_s", "publish_s",
                                "server_update_s",
                                "unsharded_publish_to_reply_s",
                                "publish_memory", "uuid", "gates")}),
            flush=True)
        trainer.close()
        trainer = None
    finally:
        if trainer is not None:
            trainer.close()  # withdraws the publication
        t_stop = time.monotonic()
        ctl.put(("stop",))
        th.join(timeout=120)
        rec["legs_s"]["stop"] = time.monotonic() - t_stop
        name_resolve.DEFAULT_REPO = old_repo
    check(not th.is_alive(), f"{tag}: the ranks did not end within 120 s")
    if "error" in ranks:
        raise ranks["error"]
    return rec


def optional_modules() -> dict:
    """Which of the modules the reference uses and the port does not need
    import on this machine (their versions), for the record only."""
    import importlib

    out = {}
    for name in ("zmq", "aiohttp", "msgpack", "yaml", "ml_dtypes"):
        try:
            mod = importlib.import_module(name)
        except ImportError:
            out[name] = None
        else:
            out[name] = str(getattr(mod, "__version__", True))
    return out


@contextlib.contextmanager
def native_forced():
    """Every packer call inside takes the native path whatever its size
    (the thresholds ``datapack.NATIVE_MIN_ITEMS`` and
    ``packing.NATIVE_MIN_SEQS`` at 0), so that it can be timed below
    them."""
    from areal_tpu_torch.base import datapack
    from areal_tpu_torch.models import packing

    old = datapack.NATIVE_MIN_ITEMS, packing.NATIVE_MIN_SEQS
    datapack.NATIVE_MIN_ITEMS = packing.NATIVE_MIN_SEQS = 0
    try:
        yield
    finally:
        datapack.NATIVE_MIN_ITEMS, packing.NATIVE_MIN_SEQS = old


def best_ms(fn, reps: int):
    """The last result of ``reps`` calls of ``fn`` and the least host ms."""
    out, ms = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, min(ms)


def native_sweep(counts=(8, 16, 32, 64, 96, 128, 192, 256, 512, 1024, 4096),
                 reps: int = 7) -> dict:
    """Where the native host ops start to win: first-fit-decreasing
    (``ffd_allocate`` at capacity 16384) and the grid scatter
    (``batch_from_packed`` of an int64 key) over ``counts`` sequences of
    64-2047 tokens (seeded), each timed through the native path (forced)
    and the NumPy path (``native.disabled``), results asserted equal. The
    crossover of each is the least count from which the native path wins
    at every larger count; ``NATIVE_MIN_ITEMS`` and ``NATIVE_MIN_SEQS``
    are set from it, and the record says which side each count falls."""
    import numpy as np

    from areal_tpu_torch.base import datapack
    from areal_tpu_torch.models import packing
    from areal_tpu_torch.ops import native

    rng = np.random.default_rng(7)
    rows = []
    for n in counts:
        sizes = rng.integers(64, 2048, n).tolist()
        layout = packing.plan_packing(sizes, length_bucket=128)
        flat = rng.integers(0, 1 << 20, sum(sizes)).astype(np.int64)
        with native_forced():
            bins_n, ffd_n = best_ms(
                lambda: datapack.ffd_allocate(sizes, 16384), reps)
            grid_n, sc_n = best_ms(
                lambda: packing.batch_from_packed(flat, layout), reps)
        with native.disabled():
            bins_p, ffd_p = best_ms(
                lambda: datapack.ffd_allocate(sizes, 16384), reps)
            grid_p, sc_p = best_ms(
                lambda: packing.batch_from_packed(flat, layout), reps)
        check(bins_n == bins_p and np.array_equal(grid_n, grid_p),
              f"(g) the native and NumPy packers disagree at {n} sequences")
        rows.append({"n": n, "ffd_ms_native": ffd_n, "ffd_ms_numpy": ffd_p,
                     "scatter_ms_native": sc_n, "scatter_ms_numpy": sc_p})

    def crossover(nat, plain):
        wins = [r[nat] < r[plain] for r in rows]
        for i in range(len(rows)):
            if all(wins[i:]):
                return rows[i]["n"]
        return None

    return {"rows": rows,
            "ffd_crossover": crossover("ffd_ms_native", "ffd_ms_numpy"),
            "scatter_crossover": crossover("scatter_ms_native",
                                           "scatter_ms_numpy"),
            "NATIVE_MIN_ITEMS": datapack.NATIVE_MIN_ITEMS,
            "NATIVE_MIN_SEQS": packing.NATIVE_MIN_SEQS}


def packer_record(eng, batch, spec, reps: int = 5) -> dict:
    """(g): the packer (``backend/microbatch.py`` through the engine's
    split: first-fit-decreasing bins and the grid scatter of every key)
    on (g)'s batch as the engine runs it (below the native thresholds:
    the NumPy path), forced through the native host ops, and through the
    NumPy path (``ops/native.py disabled``): the host ms of a step's split
    (best of ``reps``), the micro-batches equal (layouts and grids); the
    same for ``ffd_allocate`` alone on the batch's lengths; then
    :func:`native_sweep`. Asserts the native library built and loaded
    here."""
    import numpy as np

    from areal_tpu_torch.base import datapack
    from areal_tpu_torch.ops import native

    check(native.available(), "(g) the native host ops did not build or "
          "load on this machine")
    lens = [int(n) for n in batch.total_lens()]
    cap = spec.max_tokens_per_mb

    mbs_e, ms_e = best_ms(lambda: eng._split(batch, spec), reps)
    with native_forced():
        mbs_n, ms_n = best_ms(lambda: eng._split(batch, spec), reps)
        bins_n, ffd_n = best_ms(lambda: datapack.ffd_allocate(lens, cap),
                                reps)
    with native.disabled():
        mbs_p, ms_p = best_ms(lambda: eng._split(batch, spec), reps)
        bins_p, ffd_p = best_ms(lambda: datapack.ffd_allocate(lens, cap),
                                reps)
    same = all(len(m) == len(mbs_p) and all(
        a.layout.placements == b.layout.placements
        and a.layout.seqlens == b.layout.seqlens
        and a.grids.keys() == b.grids.keys()
        and all(np.array_equal(a.grids[k], b.grids[k]) for k in a.grids)
        for a, b in zip(m, mbs_p)) for m in (mbs_e, mbs_n))
    check(same and bins_n == bins_p, "(g) the native and NumPy packers "
          "disagree")
    rec = {"native": True, "split_ms_engine": ms_e,
           "split_ms_native": ms_n, "split_ms_numpy": ms_p,
           "ffd_ms_native": ffd_n, "ffd_ms_numpy": ffd_p,
           "micro_batches": len(mbs_n), "sequences": len(lens),
           "bins": len(bins_n), "sweep": native_sweep()}
    print("(g) packer, native vs NumPy", json.dumps(rec), flush=True)
    return rec


# ---------------- the two lanes ----------------

LOOP_LANE = "loop_lane"
# a phase of either lane starts once the card has this many GiB free
# (``wait_for_room``): the lanes share the card, and the loops' processes,
# (cc) and (z) each hold tens of GiB
LANE_ROOM_GB = {"loop": 40.0, "cc": 40.0, "z": 48.0}


def phase_children() -> list:
    """This process's live multiprocessing children other than the loop
    lane's process: what a phase's teardown must have ended."""
    import multiprocessing

    return [p for p in multiprocessing.active_children()
            if p.name != LOOP_LANE]


def wait_for_room(gb: float, timeout: float = 300.0) -> float:
    """Wait (at most ``timeout`` s) until the card has ``gb`` GiB free, this
    process's cached blocks handed back first; the seconds waited. A phase
    that finds no room in time starts all the same: an allocation that
    then fails fails the phase."""
    if not torch.cuda.is_available():  # the rehearsal
        return 0.0
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    while (torch.cuda.mem_get_info()[0] < gb * 2 ** 30
           and time.monotonic() - t0 < timeout):
        time.sleep(0.5)
    return time.monotonic() - t0


def run_loop_lane(cut, cut_hf: str, card: str, t_start: float,
                  device: str = "cuda", loop_kw=None) -> dict:
    """The loop lane: (o), (q3) with (p), (r) and (s) one after another,
    each printing its lines (``script_s`` from the main process's start,
    ``t_start`` on the same monotonic clock); what the main process needs
    of them. ``loop_kw``: the rehearsal's cuts, passed to every loop."""
    out, waits, secs = {}, {}, {}
    kw = {"device": device, "hf_dir": cut_hf, **(loop_kw or {})}

    def phase(name, fn):
        waits[name] = wait_for_room(LANE_ROOM_GB["loop"])
        t0 = time.monotonic()
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        try:
            return fn(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            secs[name] = time.monotonic() - t0

    # (o) the async-PPO loop: run_experiment spawns the trainer, the
    # generation fleet and a rollout worker; the master runs here
    async_loop = phase("o", lambda tmp: run_async_loop(cut, tmp, steps=4,
                                                       **kw))
    print("async loop", json.dumps({
        **async_loop, "phase_o_s": secs["o"],
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)

    # (q3) the loop of (o) with the serving engine on and, as (p), every
    # observability switch
    served = phase("q3", lambda tmp: run_async_loop(
        cut, tmp, steps=3, observe=True, interactive=True, **{
            **kw, "extra": ("serving.enabled=true", *kw.get("extra", ()))}))
    print("(p) observed async loop", json.dumps({
        "ms_per_step": served["ms_per_step"],
        "ms_per_step_o": async_loop["ms_per_step"],
        "step_ms": served["step_ms"], "per_mfc": served["per_mfc"],
        "trainer_peak_gb": served["trainer_peak_gb"],
        "server_peak_gb": served["server_peak_gb"],
        **served["observability"]}), f"({card})", flush=True)
    print("(q3) async loop with serving", json.dumps({
        "ms_per_step": served["ms_per_step"],
        "ms_per_step_o": async_loop["ms_per_step"],
        "step_ms": served["step_ms"],
        "prefill_tokens_per_step": served["prefill_tokens_per_step"],
        "prefill_tokens_per_step_o": async_loop["prefill_tokens_per_step"],
        "server": served["server"], "server_o": async_loop["server"],
        "interactive": served["interactive"],
        "server_peak_gb": served["server_peak_gb"],
        "trainer_peak_gb": served["trainer_peak_gb"],
        "weight_sync": served["weight_sync"],
        "phase_q3_p_s": secs["q3"],
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)

    # (r) the reward fleet and respawns, at the cut depth
    fleet = phase("r", lambda tmp: run_reward_fleet(cut, tmp, **kw))
    print("(r) reward fleet and respawns", json.dumps({
        **fleet, "ms_per_step_o": async_loop["ms_per_step"],
        "grade_ms_mean_o": async_loop["grade_ms_mean"],
        "phase_r_s": secs["r"],
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)

    # (s) relaunch and drain, at the cut depth
    relaunch = phase("s", lambda tmp: run_relaunch_drain(cut, tmp, **kw))
    print("(s) relaunch and drain with the durable spool", json.dumps({
        **relaunch, "ms_per_step_o": async_loop["ms_per_step"],
        "step_ms_o": async_loop["step_ms"],
        "escalation_to_first_step_s_pr11": 53.37,
        "phase_s_s": secs["s"],
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    for name, res in (("o", async_loop), ("q3", served), ("r", fleet),
                      ("s", relaunch)):
        out[name] = {"launches_total": res["launches_total"]}
    out["o"]["ms_per_step"] = async_loop["ms_per_step"]
    out["seconds"], out["room_waits_s"] = secs, waits
    return out


def loop_lane(conn, card: str, t_start: float, device: str,
              loop_kw) -> None:
    """The loop lane's process (spawned by :class:`LoopLane` while the
    main process runs (g)-(i)): waits for ``(cut, cut_hf)``, then sends
    ``("done", run_loop_lane(...))`` or ``("error", traceback)``. SIGTERM
    (the main process stopping it) raises here, so that a running phase's
    teardown ends its children."""
    import signal
    import traceback

    os.setsid()  # a group of its own: stop() can end every descendant
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        cut, cut_hf = conn.recv()
    except EOFError:  # the main process ended before the lane's start
        return
    try:
        conn.send(("done", run_loop_lane(cut, cut_hf, card, t_start, device,
                                         loop_kw)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


class LoopLane:
    """The loop lane in a spawned process of its own (its phases' launches
    set this process's name-resolve repository and patch the launcher
    while they run), beside the phases the main process runs meanwhile.
    The process starts (imports) at construction; :meth:`go` starts its
    phases."""

    def __init__(self, card: str, t_start: float, device: str = "cuda",
                 loop_kw=None):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=loop_lane, name=LOOP_LANE,
                                args=(child, card, t_start, device, loop_kw))
        self.proc.start()
        child.close()
        self.t0 = None

    def go(self, cut, cut_hf: str) -> None:
        self.t0 = time.monotonic()
        self.conn.send((cut, cut_hf))

    def join(self, timeout: float) -> dict:
        """The lane's results, or a failure naming its traceback."""
        got = self.conn.poll(timeout)
        check(got, f"the loop lane did not finish within {timeout:.0f} s")
        try:
            status, res = self.conn.recv()
        except EOFError:
            status, res = "error", "it exited without a result"
        self.proc.join(60)
        check(status == "done", f"the loop lane failed:\n{res}")
        check(self.proc.exitcode == 0,
              f"the loop lane exited {self.proc.exitcode}")
        res["lane_s"] = time.monotonic() - self.t0
        return res

    def stop(self) -> None:
        """End the lane and whatever of its phase's processes outlive it."""
        import signal

        if self.proc.is_alive():
            self.proc.terminate()  # its phase's teardown runs
            self.proc.join(120)
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.join(10)
        self.conn.close()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    try:
        import areal_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: the areal_tpu_torch package is not beside "
                 f"this script ({e}); run it from the repository's root")
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.models.config import qwen2_5_0_5b
    from areal_tpu_torch.models import generate as genmod
    from areal_tpu_torch.models.transformer import Transformer, init_params
    from areal_tpu_torch.ops import flash_attention as fa

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print("optional modules", json.dumps(optional_modules()), flush=True)
    print("python start", json.dumps({
        "import_torch_s": IMPORT_TORCH_S,
        "torch_ships_bytecode": _torch_ships_bytecode(),
        "bytecode_cache": sys.pycache_prefix}), flush=True)

    # (a) build, one nvcc per source, together
    t0 = time.monotonic()
    libs = fa.build_libraries()
    ptxas = [rec for lib in libs.values()
             for rec in ptxas_report((lib.parent / "build.log").read_text())]
    print(f"built {', '.join(os.path.relpath(p) for p in libs.values())} in "
          f"{time.monotonic() - t0:.1f}s; ptxas (kernel, type, head_dim, "
          "spill-store bytes, registers):", json.dumps(ptxas), flush=True)
    # at head_dim 64, 128 and 256: K1 3 scalar f32 + 6 tensor-core; K2 3 + 6
    # + 2 reductions; K3 3 + 6
    check(len(ptxas) == 29, f"expected 29 kernel instances, ptxas shows {ptxas}")
    for kern in ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel",
                 "flash_bwd_dq_mma_kernel"):
        check(sorted((r[1], r[2]) for r in ptxas if r[0] == kern)
              == [(t, d) for t in ("bf16", "fp16") for d in fa.HEAD_DIMS],
              f"{kern}'s tensor-core instances missing from {ptxas}")
    print("head_dim 256 instances (kernel, type, spill-store bytes, "
          "registers):", json.dumps([(r[0], r[1], r[3], r[4]) for r in ptxas
                                     if r[2] == 256]), flush=True)
    spills = [r for r in ptxas if r[1] != "f32" and r[3] > 0]
    check(not spills, f"tensor-core instances spill: {spills}")

    # (b) K1 against its plain version
    check_k1(fa, 8, 512, 14, 2, 64, seed=0)
    check_k1(fa, 2, 512, 28, 4, 128, seed=1)
    check_k1(fa, 3, 200, 14, 2, 64, seed=2)
    k1_train_check = check_k1(fa, 2, 1792, 14, 2, 64, seed=3)
    # Gemma's heads: 256 wide, 8 q heads over one kv head
    k1_256_check = check_k1(fa, 8, 512, 8, 1, 256, seed=4)
    check_k1(fa, 3, 200, 8, 1, 256, seed=5)
    timing = k1_record(fa, 8, 512)
    timing_train = k1_record(fa, 2, 1792)
    timing_256 = k1_record(fa, 8, 512, Hq=8, Hkv=1, D=256)
    print("K1 timing", json.dumps([timing, timing_train, timing_256]),
          f"({card})", flush=True)

    # (c) the serving slice, through the server's HTTP entry point
    cfg = qwen2_5_0_5b()
    eos = 151643  # Qwen2.5's <|endoftext|>
    params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    stats, serve_launches, wall, prompts = run_slice(fa, cfg, params, eos)
    prefill_ms = 1e3 * stats["prefill_secs"] / stats["prefill_calls"]
    decode_ms = 1e3 * stats["decode_secs"] / stats["decode_steps"]
    tok_s = stats["generated_tokens"] / (stats["prefill_secs"]
                                         + stats["decode_secs"])
    print("slice", json.dumps({
        "prefill_calls": stats["prefill_calls"],
        "prefill_tokens": stats["prefill_tokens"],
        "prefill_ms_per_call": prefill_ms,
        "decode_ms_per_step": decode_ms,
        "generated_tokens": stats["generated_tokens"],
        "tokens_per_s": tok_s, "wall_s": wall, "k1_launches": serve_launches,
        "shapes": stats["shapes"]}), f"({card})", flush=True)

    # (d) prefill through K1 against the plain attention, same weights
    model = Transformer.from_params(cfg, params)
    padded, plens = genmod.pad_prompts(prompts, eos, bucket=128)
    toks = torch.from_numpy(padded).cuda()
    lens = torch.from_numpy(plens).cuda()
    S = padded.shape[1] + 128
    got = genmod.prefill_state(model, toks, lens, S)["last_logits"]
    ref = genmod.prefill_state(model, toks, lens, S,
                               attn_impl="reference")["last_logits"]
    diff = (got - ref).abs().max().item()
    tol = 0.05 * ref.abs().max().item()
    print("prefill last_logits K1 vs reference", json.dumps({
        "max_abs_err": diff, "tol": tol, "max_abs_ref": ref.abs().max().item(),
        "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
    }), flush=True)
    check(bool(torch.isfinite(got).all()) and got.shape == (8, cfg.vocab_size),
          "prefill logits not finite / wrong shape")
    check(diff <= tol, "prefill through K1 disagrees with the plain attention")

    # (e) where the time goes in serving
    print("breakdown", json.dumps(time_breakdown(genmod, model, toks, lens, S,
                                                 eos)), f"({card})", flush=True)
    del model, params, got, ref
    torch.cuda.empty_cache()

    # (f) K2 and K3 against their plain version
    bwd_train_check = check_bwd(fa, 2, 1792, 14, 2, 64, seed=0)
    check_bwd(fa, 2, 512, 28, 4, 128, seed=1)
    check_bwd(fa, 3, 200, 14, 2, 64, seed=2)
    # Gemma's train micro-batch, [1, 4096], 8 q heads over one kv head
    bwd_256_check = check_bwd(fa, 1, 4096, 8, 1, 256, seed=3)
    check_bwd(fa, 3, 200, 8, 1, 256, seed=4)
    bwd_timing = bwd_records(fa)
    bwd_timing_256 = bwd_records(fa, B=1, T=4096, Hq=8, Hkv=1, D=256)
    print("K2/K3 timing", json.dumps([bwd_timing, bwd_timing_256]),
          f"({card})", flush=True)
    torch.cuda.empty_cache()

    # the loop lane's process starts (and imports) while (g)-(i) run; its
    # phases start after (i)
    lane = LoopLane(card, t_start)
    atexit.register(lane.stop)  # whatever phase fails, before it starts

    # (g) the train slice, through PPOActorInterface.train_step
    model, iface = build_trainer(cfg)
    batch = bench_batch(cfg.vocab_size)
    spec = MicroBatchSpec(max_tokens_per_mb=4096)
    train = run_train_slice(fa, cfg, model, iface, batch, spec)
    plain_run = train.pop("baseline")  # (bb)'s plain engine
    train["packer"] = packer_record(model.module, batch, spec)
    print("train slice", json.dumps(train), f"({card})", flush=True)

    # (h) one micro-batch through K1-K3 against the plain attention
    compare_attention_impls(model, iface, batch, spec)

    # (i) where the time goes in one train step
    print("train breakdown", json.dumps(train_breakdown(
        model, iface, batch, spec, train["ms_per_step"])), f"({card})",
        flush=True)
    del model, iface  # (j) builds three engines of its own
    torch.cuda.empty_cache()

    # From here two lanes share the card: the loop lane (a spawned process:
    # (o), (q3) with (p), (r), (s)) and this process's (j)-(n), (q1), (q2),
    # (u)-(y), (bb), (cc), (z); then (t), (aa), (dd) and (ee) alone. (j)-(o),
    # (q2), (q3), (r), (s) and (u)-(x) run at 4 of the 24 layers, (t) at 8
    # (full width): the cuts that make room for the later phases in the
    # time limit
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    t_lanes = time.monotonic()
    secs, room_waits = {}, {}

    def mark(name, t0):
        secs[name] = time.monotonic() - t0
        return secs[name]

    try:
        # the HF checkpoints the loops load, at 4 and (for (t)) 8 layers,
        # each written once and freed: their cache goes back to the card,
        # which the loops' processes share
        hf_tmp = tempfile.mkdtemp(prefix="chip_smoke_hf_")
        atexit.register(shutil.rmtree, hf_tmp, True)
        cut_hf = loop_checkpoint(cut, os.path.join(hf_tmp, "cut_hf"), "cuda")
        torch.cuda.empty_cache()
        lane.go(cut, cut_hf)
        elastic_cfg = dataclasses.replace(cfg, n_layers=ELASTIC_LAYERS)
        elastic_hf = loop_checkpoint(elastic_cfg, os.path.join(
            hf_tmp, "elastic_hf"), "cuda")
        torch.cuda.empty_cache()

        # (j) trainer steps of the async-PPO recipe, then the host path
        t_trainer = time.monotonic()
        tr, tbatch, tdata, trainer = run_trainer(fa, cut, trainer_batch(
            cut.vocab_size), spec)
        print("trainer step", json.dumps(trainer), f"({card})", flush=True)
        compare_ref_inf(tr, tbatch, spec)
        print("trainer breakdown", json.dumps(trainer_breakdown(
            tr, tbatch, spec)), f"({card})", flush=True)

        # (k) checkpoints at full width, under a temporary directory
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            ckpt = run_checkpoints(tr, cut, tbatch, tdata, spec, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

        # (l) one SFT step
        sft = run_sft(tr, cut, tbatch, spec)
        trainer_launches = dict(tr.launches)
        print("trainer path", json.dumps({
            "launches": tr.launches, "checkpoints": ckpt,
            "sft_ms": sft["ms"],
            "phases_j_to_l_s": mark("j_to_l", t_trainer),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)

        # (m) weight sync: the trained actor over disk, a second model over
        # the stream, a dead endpoint; under a temporary directory
        t_sync = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sync_")
        try:
            wsync = run_weight_sync(fa, cut, tr.actor, eos, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("weight sync", json.dumps({
            **wsync, "phase_m_s": mark("m", t_sync),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        del tr  # (n)'s trainer process builds its own engines
        torch.cuda.empty_cache()

        # (n) the sync-PPO loop: a master here, a trainer in a spawned
        # process
        t_loop = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
        try:
            loop = run_sync_loop(cut, tmp, steps=3, eos=eos)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("sync loop", json.dumps({
            **loop, "phase_n_s": mark("n", t_loop),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        loop_launches = loop["launches_total"]

        # (q1) prefix reuse at 24 layers, (q2) request classes at 4
        t_q = time.monotonic()
        params = init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        prefix = run_prefix_reuse(fa, cfg, params, eos)
        print("(q1) prefix reuse", json.dumps(prefix), f"({card})",
              flush=True)
        del params
        torch.cuda.empty_cache()
        params = init_params(cut, seed=0, device="cuda", dtype=torch.bfloat16)
        classes = run_classes(fa, cut, params, eos)
        print("(q2) request classes", json.dumps({
            **classes, "phase_q1_q2_s": mark("q1_q2", t_q),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        del params
        torch.cuda.empty_cache()
        serving_k1 = prefix["k1_launches"] + classes["k1_launches"]

        # (u) SFT through its entry point, with automatic evaluation on the
        # card
        t_u = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_")
        try:
            sft_eval = run_sft_auto_eval(cut, tmp, cut_hf, fa=fa)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("(u) sft and automatic evaluation", json.dumps({
            **{k: sft_eval[k] for k in ("ms_per_step", "trained_tokens_per_s",
                                         "trainer_peak_gb",
                                         "eval_child_peak_gb", "eval_secs",
                                         "card_mb_max_with_eval",
                                         "scored_while_training",
                                         "step2_scored_after_s", "held_s",
                                         "launcher_auto_eval",
                                         "eval_child_dtype")},
            "phase_u_s": mark("u", t_u),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)

        # (v) reward-model training, (w) the fused node, (x) the
        # multi-turn agent
        t_v = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_rw_")
        try:
            rw = run_reward_model(fa, cut_hf, tmp)
            torch.cuda.empty_cache()
            t_w = time.monotonic()
            fused = run_fused(fa, cut_hf, tmp)
            torch.cuda.empty_cache()
            t_x = time.monotonic()
            multi = run_multi_turn(fa, cut, eos, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        secs["v"], secs["w"] = t_w - t_v, t_x - t_w
        print("(v)-(x)", json.dumps({
            "rw_ms_per_step": rw["ms_per_step"], "rw_peak_gb": rw["peak_gb"],
            "fused_ms": fused["fused_ms"], "serial_ms": fused["serial_ms"],
            "multi_turn_wall_s": multi["wall_s"],
            "phase_v_s": secs["v"], "phase_w_s": secs["w"],
            "phase_x_s": mark("x", t_x),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        torch.cuda.empty_cache()

        # (y) GPT-2 small at full width and depth
        t_y = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_gpt2_")
        try:
            gpt2 = run_gpt2(fa, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("(y) gpt2 small", json.dumps({
            **gpt2, "phase_y_s": mark("y", t_y),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)

        # (bb) multi-GPU parallelism, part one: the train step on a
        # one-rank NCCL mesh, then the device transport at full depth
        # beside disk and stream
        t_bb = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        try:
            mesh = run_mesh_step(fa, cfg, batch, spec, tmp, plain=plain_run)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        secs["bb_mesh"] = time.monotonic() - t_bb
        t_bb2 = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_device_")
        try:
            device_sync = run_device_sync(fa, cfg, eos, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("(bb) mesh step and device transport", json.dumps({
            "mesh_step_d1": {k: mesh["d1"][k] for k in (
                "ms_per_step", "ms_per_step_plain", "fwd_bwd_ms",
                "fwd_bwd_ms_plain", "optimizer_ms", "optimizer_ms_plain",
                "peak_gb", "peak_gb_plain", "loss_rel_max",
                "grad_norm_rel_max", "master_abs_max")},
            "publish_to_reply_s": {t: device_sync[t]["publish_to_reply_s"]
                                   for t in ("device", "disk", "stream")},
            "publish_s": {t: device_sync[t]["publish_s"]
                          for t in ("device", "disk", "stream")},
            "device_copy_ms": device_sync["device"]["consume_copy_ms"],
            "trainer_peak_gb": device_sync["device"]["trainer_peak_gb"],
            "server_peak_gb": device_sync["device"]["server_peak_gb"],
            "gates": device_sync["gates"],
            "trainer_gb_after_publish": {
                k: device_sync[k]["trainer_gb_after"]
                for k in ("device", "disk", "stream")},
            "trainer_gb_republish": [
                device_sync[k]["allocated_gb_after"]
                for k in ("republish", "republish_unconsumed")],
            "phase_bb_mesh_s": secs["bb_mesh"],
            "phase_bb_device_s": mark("bb_device", t_bb2),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        torch.cuda.empty_cache()

        # (cc) multi-GPU parallelism, part two: the ring at full width, the
        # model through it and the pipeline at 8 of the 24 layers, their
        # ranks and stages in this process
        room_waits["cc"] = wait_for_room(LANE_ROOM_GB["cc"])
        t_cc = time.monotonic()
        par = run_ring_and_pipeline(fa, dataclasses.replace(
            cfg, n_layers=PAR_LAYERS))
        print("(cc) ring attention and the pipeline", json.dumps({
            "ring_ms": {s: {k: par[f"ring_{s}"][k] for k in (
                "ring_fwd_ms", "rank_fwd_ms_sum", "rank_fwd_ms_max",
                "k1_whole_ms", "ring_bwd_ms", "k2_k3_whole_ms",
                "ring_fwd_device_ms", "ring_bwd_device_ms",
                "k1_whole_device_ms")}
                for s in ("zigzag", "naive")},
            "ring_n8_err_of_tol": {
                g or "out": par["ring_zigzag_n8"][f"{g}max_abs_err"]
                / par["ring_zigzag_n8"][f"{g}tol"]
                for g in ("", "dq_", "dk_", "dv_")},
            "ring_model": {k: par["ring_model"][k] for k in (
                "loss_kernels", "loss_plain", "grad_cosine",
                "max_grad_norm_rel_err", "plain", "ring")},
            "pipeline": {k: par["pipeline"][k] for k in (
                "plain", "1f1b", "gpipe", "faults")},
            "phase_cc_s": mark("cc", t_cc),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        torch.cuda.empty_cache()

        # (z) Gemma-2B at full width
        room_waits["z"] = wait_for_room(LANE_ROOM_GB["z"])
        t_z = time.monotonic()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_gemma_")
        try:
            # 2 SFT steps, cut from 3 to make room for (cc)
            gemma = run_gemma(fa, tmp, steps=2)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print("(z) gemma 2b", json.dumps({
            **{k: v for k, v in gemma.items() if k != "sft"},
            "phase_z_s": mark("z", t_z),
            "script_s": time.monotonic() - t_start}), f"({card})",
            flush=True)
        torch.cuda.empty_cache()
        secs["main_lane"] = time.monotonic() - t_lanes
        loops = lane.join(900)
    finally:
        lane.stop()
    secs["lanes"] = time.monotonic() - t_lanes
    async_launches = loops["o"]["launches_total"]
    served_launches = loops["q3"]["launches_total"]
    fleet_launches = loops["r"]["launches_total"]
    relaunch_launches = loops["s"]["launches_total"]
    torch.cuda.empty_cache()  # every loop's engine and server is gone

    # (t) the elastic fleet: the autoscaler's second server, cordon and
    # uncordon; the card to itself
    t_t = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        elastic = run_elastic_fleet(elastic_cfg, tmp, hf_dir=elastic_hf)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("(t) elastic fleet", json.dumps({
        **elastic, "ms_per_step_o": loops["o"]["ms_per_step"],
        "phase_t_s": mark("t", t_t),
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    elastic_launches = elastic["launches_total"]
    torch.cuda.empty_cache()

    # (aa) Mixture-of-Experts: K1-K3 at Qwen3-30B-A3B's heads (32 q over 4
    # kv heads of 128), then the model served at full width (6 layers), the
    # MoE layer, PPO steps at 2 layers and the HF round trip
    t_aa = time.monotonic()
    k1_128_check = check_k1(fa, 8, 1024, 32, 4, 128, seed=6)
    timing_128 = k1_record(fa, 8, 1024, Hq=32, Hkv=4, D=128)
    bwd_128_check = check_bwd(fa, 2, 1792, 32, 4, 128, seed=5)
    bwd_timing_128 = bwd_records(fa, B=2, T=1792, Hq=32, Hkv=4, D=128)
    print("K1-K3 at 32/4 heads of 128", json.dumps(
        [timing_128, bwd_timing_128]), f"({card})", flush=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    try:
        moe = run_moe(fa, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("(aa) qwen3 30b a3b", json.dumps({
        **{k: moe[k] for k in ("config", "card_free_gb_before_build",
                               "build_s", "stage_s", "weights_gib",
                               "launches")},
        "serve": {k: v for k, v in moe["serve"].items()
                  if k in ("prefill_dropped_frac", "decode_dropped_frac",
                           "decode_capacity", "breakdown")},
        "server": moe["serve"]["serve"],
        "train": {k: moe["train"][k] for k in (
            "ms_per_step", "trained_tokens_per_s", "peak_gb",
            "warmup_step_s")},
        "hf": moe["hf"], "phase_aa_s": mark("aa", t_aa),
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    torch.cuda.empty_cache()

    # (dd) expert parallelism at Qwen3-30B-A3B's width: the layer through
    # one-process EP, then PPO steps at 2 of 48 layers against plain
    t_dd = time.monotonic()
    ep = run_ep(fa)
    ep_layer, ep_train = ep["layer"], ep["train"]
    print("(dd) expert parallelism", json.dumps({
        "layer": {str(e): {k: r[k] for k in (
            "nodrop_max_abs_err", "nodrop_tol", "dropped_frac",
            "dropped_frac_plain", "ep_ms", "ep_device_ms", "exchange_ms",
            "exchange_share")} for e, r in ep_layer["ep"].items()},
        "grouped_ms": ep_layer["grouped_ms"],
        "grouped_device_ms": ep_layer["grouped_device_ms"],
        "train": {k: ep_train[k] for k in (
            "mb_shape", "n_mbs", "limits", "ep", "misrouted",
            "ms_per_step_ep", "ms_per_step_plain", "peak_gb_ep",
            "peak_gb_plain", "gauge_ep", "gauge_plain", "launches")},
        "phase_dd_layer_s": ep["layer_s"], "phase_dd_train_s": ep["train_s"],
        "phase_dd_s": mark("dd", t_dd),
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    torch.cuda.empty_cache()

    # (ee) the decoupled generation fleet: a tp=2 meshed server of
    # Qwen2.5-0.5B at full depth, its two ranks on the one card, then a
    # device publication into its layout; K1 at the ranks' 7/1 heads
    t_ee = time.monotonic()
    k1_g7_check = check_k1(fa, 8, 1024, 7, 1, 64, seed=6)
    k1_g7 = k1_record(fa, 8, 1024, Hq=7, Hkv=1)
    k1_whole = k1_record(fa, 8, 1024)  # the unsharded server's 14/2 heads
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gen_mesh_")
    try:
        gen_mesh = run_gen_mesh(
            fa, cfg, eos, tmp, prompts,
            {"prefill_ms_per_call": prefill_ms,
             "decode_ms_per_step": decode_ms},
            device_sync["device"]["publish_to_reply_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("(ee) decoupled generation fleet", json.dumps({
        "k1_g7": {**k1_g7, "max_abs_err": k1_g7_check["max_abs_err"]},
        "k1_14_2": k1_whole,
        **{k: gen_mesh[k] for k in (
            "tp", "prefills", "k1_launches", "k1_per_rank",
            "plain_in_prefill", "prefill_ms_per_call", "decode_ms_per_step",
            "unsharded", "logits", "kv_bytes", "memory",
            "publish_to_reply_s",
            "unsharded_publish_to_reply_s", "publish_memory", "uuid",
            "legs_s")},
        "phase_ee_s": mark("ee", t_ee),
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    torch.cuda.empty_cache()

    # (ff) generation servers over fsdp and pp: an f2p2 server of
    # Qwen2.5-0.5B at full depth (each rank 12 layers at half their fsdp
    # width), its four ranks on the one card, then a device publication
    # into its layout
    t_ff = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gen_fp_")
    try:
        gen_fp = run_gen_mesh(
            fa, cfg, eos, tmp, prompts,
            {"prefill_ms_per_call": prefill_ms,
             "decode_ms_per_step": decode_ms,
             "tp2_prefill_ms_per_call": gen_mesh["prefill_ms_per_call"],
             "tp2_decode_ms_per_step": gen_mesh["decode_ms_per_step"]},
            device_sync["device"]["publish_to_reply_s"], phase="ff")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("(ff) generation servers over fsdp and pp", json.dumps({
        **{k: gen_fp[k] for k in (
            "spec", "prefills", "k1_launches", "k1_per_rank",
            "k1_per_rank_per_prefill", "plain_in_prefill",
            "prefill_ms_per_call", "decode_ms_per_step", "unsharded",
            "fsdp_gather_first", "fsdp_gather", "memory",
            "logits", "kv_bytes", "param_bytes", "publish_to_reply_s",
            "unsharded_publish_to_reply_s", "publish_memory", "uuid",
            "legs_s")},
        "tp2_publish_to_reply_s": gen_mesh["publish_to_reply_s"],
        "phase_ff_s": mark("ff", t_ff),
        "script_s": time.monotonic() - t_start}), f"({card})", flush=True)
    print("phase seconds", json.dumps({
        "a_to_i": t_lanes - t_start, "main_lane": secs,
        "loop_lane": {**loops["seconds"], "lane": loops["lane_s"]},
        "room_waits_s": {**room_waits, **{
            f"loop_{k}": v for k, v in loops["room_waits_s"].items()}},
        "script": time.monotonic() - t_start}), flush=True)

    lib_line = ("areal_tpu/ops/pallas/flash_attention.py:200 backward: the "
                "Pallas TPU library's {} :{} (pallas_call :{})")
    train_launches = train["launches"]
    # launches of each path, K1 (whose server paths add their prefills) and
    # K2/K3; (z) is the one path at head_dim 256
    paths = {"train": train_launches, "trainer": trainer_launches,
             "sync_loop": loop_launches, "async_loop": async_launches,
             "served_observed_loop": served_launches,
             "reward_fleet": fleet_launches,
             "relaunch_drain": relaunch_launches,
             "elastic_fleet": elastic_launches,
             "sft_auto_eval": sft_eval["launches"],
             "reward_model": rw["launches"], "gpt2": gpt2["launches"],
             "mesh_step": mesh["launches"],
             **{f"ring_{s}": {k: par[f"ring_{s}"]["fwd_launches"][k]
                              + par[f"ring_{s}"]["bwd_launches"][k]
                              for k in KERNEL_NAMES}
                for s in ("zigzag", "naive", "zigzag_n8")},
             "ring_model": par["ring_model"]["ring"]["launches"],
             **{f"pipeline_{s}": par["pipeline"][s]["launches"]
                for s in ("1f1b", "gpipe")}}
    k1_paths = {"serve": serve_launches, "weight_sync": wsync["k1_launches"],
                "serving": serving_k1,
                **{k: v["flash_attention_fwd"] for k, v in paths.items()},
                "fused_rew_ref": fused["launches"]["flash_attention_fwd"],
                "multi_turn": multi["k1_launches"],
                "device_sync": device_sync["k1_launches"],
                "gen_mesh": gen_mesh["k1_launches"],
                "gen_mesh_f2p2": gen_fp["k1_launches"]}
    k1_paths["sft_auto_eval_children"] = sum(
        sft_eval["eval_child_k1"].values())
    k1_paths["sft_auto_eval"] -= k1_paths["sft_auto_eval_children"]
    gemma_launches = gemma["launches"]
    moe_launches = {"qwen3_moe": moe["launches"],
                    "qwen3_moe_ep": ep_train["launches"]}
    sources = {"fwd": "areal_tpu_torch/ops/csrc/flash_attention.cu",
               "bwd": "areal_tpu_torch/ops/csrc/flash_attention_bwd.cu"}
    kernels = []
    # (z) is the one path at head_dim 256; (aa) and (dd) at 128
    for D, launches_by_path, k1_rec, bwd_rec, k1_t, bwd_t in (
            (64, None, k1_train_check, bwd_train_check, timing_train,
             bwd_timing),
            (256, {"gemma": gemma_launches}, k1_256_check, bwd_256_check,
             timing_256, bwd_timing_256),
            (128, moe_launches, k1_128_check, bwd_128_check, timing_128,
             bwd_timing_128)):
        tag = "" if D == 64 else f" (head_dim {D})"
        k1_by = k1_paths if D == 64 else {
            p: v["flash_attention_fwd"] for p, v in launches_by_path.items()}
        kernels.append({
            "name": "flash_attention_fwd" + tag, "route": "cuda",
            "source": sources["fwd"],
            "replaces": "areal_tpu/ops/pallas/flash_attention.py:200",
            "launches": sum(k1_by.values()), "launches_by_path": k1_by,
            "max_abs_err": k1_rec["max_abs_err"],
            "ms": k1_t["kernel_ms"], "kernel_ms": k1_t["kernel_ms"],
            "plain_ms": k1_t["plain_ms"], "bound_ms": k1_t["bound_ms"],
            "bound_by": k1_t["bound_by"], "library_ms": k1_t["library_ms"],
            "shape": {k: k1_t[k] for k in ("B", "T")},
        })
        for name, fn, line, call, err in (
                ("flash_attention_bwd_dkv", "_flash_attention_bwd_dkv", 941,
                 1121, max(bwd_rec["dk_max_abs_err"],
                           bwd_rec["dv_max_abs_err"])),
                ("flash_attention_bwd_dq", "_flash_attention_bwd_dq", 1287,
                 1456, bwd_rec["dq_max_abs_err"])):
            rec = bwd_t[name]
            by = ({k: v[name] for k, v in paths.items()} if D == 64
                  else {p: v[name] for p, v in launches_by_path.items()})
            kernels.append({
                "name": name + tag, "route": "cuda", "source": sources["bwd"],
                "replaces": lib_line.format(fn, line, call),
                "launches": sum(by.values()), "launches_by_path": by,
                "max_abs_err": err,
                "ms": rec["kernel_ms"], "kernel_ms": rec["kernel_ms"],
                "plain_ms": bwd_t["plain_bwd_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": bwd_t["sdpa_bwd_ms"],
                "shape": {k: bwd_t[k] for k in ("B", "T")},
            })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
