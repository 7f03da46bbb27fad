"""Chip smoke test of the PyTorch/CUDA port on one GPU: the generation path
and the training step, under the default Config() (gate FFN), under
configs/train_corpus.yml (s2 FFN), and under the default Config() with
SINGA_TPU_FUSED_SO2 set (the fused SO(2) edge attention, K6), with
SINGA_TPU_HYBRID_ATTN set (the encoder's hybrid attention, K7) and with
SINGA_TPU_DENSE_ATTN set (its dense attention, K8); the host data path
(the ETL's shard served on the card, re-docking); then the adversarial
fine-tuning under configs/gan_recipe.yml with its docking pass-rate.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one (there is no CPU fallback).
Imports nothing of JAX or of the JAX package. Phases, one JSON line each
(``elapsed_s``: seconds since the start of the script):

  1. device   name and power limit (nvidia-smi), torch and CUDA versions
  2. build    every kernel of ``singa_tpu_torch/csrc`` built from source
              (one nvcc per source, all started together), with the seconds
              and ptxas's report (registers, spills) of K1's and K7's
              (``k1_ptxas``: the tile kernel and the CUDA-core instance),
              K1b's and K7b's, K8's, K8b's, K4's
              (its tensor-core kernel's instances) and K4b's kernels, of
              K2's (``k2_ptxas``: its tensor-core kernel's instances and
              split at 16 channels, and its CUDA-core instance), of K2b's
              kernels (dx, weight, split), of K3's and K3b's (``k3_ptxas``:
              their tensor-core kernels, with their shared memory and
              threads at I 29, C 128, G 70, and the CUDA-core instance), of
              K5's and K5b's (``k5_ptxas``: their tensor-core kernels, one
              instance a form, and their CUDA-core instance) and of the
              GEMM kernels of K6 and K6b (of the sources this run compiled)
     mma_rate the card's mma.sync TF32 rate (csrc/mma_tf32.cu), the
              ceiling of the tensor-core kernels, a third of it for split
              TF32
     kernel_bwd_lmax4  K2 and K2b at lmax 4 (the lmax of
              configs/train_lmax4.yml and configs/gan_recipe.yml, whose
              GAN phases, 15, run it), C = Co = 16, H 512, 14,336 nodes,
              seeded inputs:
              each against its plain version (K2 to TOL, each output of K2b
              to BWD_TOL of its largest magnitude), with the times
  3. kernel   for K1/K2/K3: the inputs the generation path hands the kernel
              (8 pockets, default Config), the kernel against its plain
              PyTorch version on the card (max error vs the stated
              tolerance), kernel_ms / plain_ms (CUDA events, median of 20
              after warm-up) and bound_ms (the larger of bytes over 3.35 TB/s
              and float32 operations over 67 TFLOP/s); K2's and K3's lines
              also hold and time their CUDA-core instance at the same call
              (``cuda_cores``), K3's the wrapper's host time a call
              (``host_ms``); the serving calls of K3 must take its
              tensor-core kernel
  4. main     default Config(), seeded weights on cuda, the first 8 sorted
              val pockets through generate_for_pocket (20 beams, max length
              200, grammar mask, length penalty 0.7): launch counts per
              encode_pocket (K1 = 6, K2 = 3, K3 = 3, K4 = 0), encode_ms /
              decode_ms, molecules/s, finite scores, a few SMILES
     profile  torch.profiler over one encode_pocket and the first 40 decode
              steps: device busy time (kernels, copies and sets; the CUDA
              activity alone is traced), idle share, the costliest kernels
  5. vs_cpu   encode_pocket on the card (kernels) vs on the CPU (plain
              versions) with the same weights, 2 pockets
  6. cli      generate.main(... --device cuda) on one pocket writes its CSV
  7. the same serving path under configs/train_corpus.yml (ffn_activation
     s2): kernel_s2 (K4 at every distinct call of one encode_pocket),
     main_s2 (generate_for_pocket on the 8 pockets; per encode K4 = 3,
     K2 = 0, K1 = 6, K3 = 3; encode_ms, molecules/s, the encode's profile),
     vs_cpu_s2 (2 pockets), and kernel_s2act: K5 and K5b, on no path of
     the port or of the JAX package, held to their plain versions on the
     two inputs the JAX package's XLA path sends through s2_activation: the
     s2 FFN's hidden [N, 49, 512] at the serving encode (lin1 of K4's
     captured input, as the plain K4 forms it) and the attention's message
     [E, 29, 128] (K3's captured input, m-primary, mmax 2), with a seeded
     cotangent; both calls must take the tensor-core kernels, and each
     line also holds and times the CUDA-core instance at the same call
     (``cuda_cores``) and gives the wrapper's host time (``host_ms``)
  8. kernel_train / kernel_bwd  for K1-K3 and K1b-K3b: every distinct call
              (by shapes) that one training microbatch (32 complexes of
              data/corpus/train, default Config in float32) makes of each
              kernel, its inputs and cotangents against the plain version on
              the card, with kernel_ms / plain_ms / bound_ms; K1's and K1b's
              (and, in the hybrid phases, K7's and K7b's) lines also say what
              the tensor-core kernel walked (K1/K7: rows taken live,
              dead-weighted rows, rows taken again whole, slots evaluated,
              and the bound over the live pairs alone), and the pair kernel
              walked, as it counts it (``walks``: rows skipped for a zero
              cotangent, rows taken with their live slots, rows taken
              whole, slots evaluated, beside the inputs' live slots and
              B*N*K), and hold the CUDA-core instance of the same
              algorithm (the one other widths run) at the same call
              (``cuda_cores``: its time and errors; K1/K7's is
              attn_fwd_kernel, every slot evaluated); K3's and K3b's lines
              hold their CUDA-core instance and give the wrapper's host
              time a call (``host_ms``), and their calls must take the
              tensor-core kernels
  9. train    the port's Trainer (default Config, float32) on
              data/corpus/train through the Prefetcher, batch 64 in 2
              microbatches of 32: warm-up steps, then timed steps (step_ms,
              graphs/s, loss and gradient norm per step, peak memory), the
              launches of every kernel (12 per optimizer step of each of
              K1-K3 and K1b-K3b, none of K4/K4b/K5/K5b), a finite gradient
              that is non-zero somewhere for every parameter, and on one
              fixed batch a loss after 5 steps below the first step's
     train_profile  torch.profiler over one optimizer step: device busy time,
              idle share, the costliest kernels, K2b's kernels by name
              (``k2b_kernels``: the dx kernel, the weight kernel, the split
              of the dx kernel's weights, and sum_rows_kernel, which the
              other backwards' sums also run;
              in every train_profile* phase whose path runs K2b), K1b's or
              K7b's (``k1b_kernels``: the pair kernel, the plan, the dk/dv
              stage, sum_rows_kernel; where the path runs either), K1's or
              K7's (``k1_kernels``: the tile kernel, the plan, the copy
              kernel and the CUDA-core instance), and the
              SM clock, power and temperature nvidia-smi sampled meanwhile;
              train_profile_s2 also K4's two kernels by name
              (``k4_kernels``: the tensor-core kernel and the split of its
              weights), every train_profile* phase whose path runs K2
              K2's (``k2_kernels``: the same two and the CUDA-core
              instance), and every one whose
              path runs K3 K3's and K3b's kernels (``k3_kernels``: the
              tensor-core ones and the CUDA-core instances); where
              the launch counters' rise over the profiled step says a
              matched hand kernel ran more often than the profile shows
              (the profiler dropped device events), the step is profiled
              again, up to 3 times (``profiles_taken``, ``shortfall``)
 10. train_vs_cpu  loss and every gradient on the card (kernels) vs the CPU
              (plain versions), the same seeded weights, 2 complexes; a second
              card run at the same inputs as a witness of the card's own
              spread; for each comparison the L2 and max-abs errors, where
              the elements over the max-abs bound sit, and the ReLU inputs
              whose sign differs between the two runs
 11. train_cli  python -m singa_tpu_torch.train.loop --data data/corpus
              --max-iters 2 --device cuda into a temporary logdir writes its
              checkpoint; the generation CLI reads that checkpoint for one
              pocket and launches exactly one encode_pocket's kernels
     pdb      from that checkpoint, one pocket served from a protein PDB and
              a ligand SDF: the first sorted val complex's protein nodes
              written as a PDB block (8 atoms a residue, UNK, the element in
              columns 77-78) with its own ligand SDF, through
              generate.main(--input --ligand --props --device cuda): one
              encode's launches (K1 = 6, K2 = 3, K3 = 3, the rest 0), 1 +
              topk rows of the seven columns (smiles, score, valid, qed, sa,
              logp, tpsa) with finite scores, two builds of the batch equal
              bit for bit, the card's encode_pocket of that batch within
              CPU_TOL of the CPU's with the same weights; the
              featurization's host seconds, encode_ms, decode_ms and the
              valid share (``pdb valid: n/m`` on a line of its own)
     etl      the port's ETL (``singa_tpu_torch.tools.make_dataset --index``)
              on DOCK_COMPLEX (a drug-sized val complex: its PDB block and
              SDF, written as for pdb) writes one shard, the Vina
              library built first from singa_tpu_torch/cpp/src into
              build/vina/ (g++); generate.main(--input <shard> --device
              cuda) serves it from that checkpoint: one encode's launches
              (K1 = 6, K2 = 3, K3 = 3, the rest 0), 1 + topk rows, the
              card's encode_pocket of the shard within CPU_TOL of the CPU's,
              the shard's vina label equal to score_complex of the pocket;
              the library's build seconds, the ligand's atoms and torsions
              and the ETL's host seconds
     dock     ``python -m singa_tpu_torch.tools.dock_ligand`` on the same
              complex at exhaustiveness 8 and each of REDOCK_SEEDS (a
              process of its own): the CLI's and the search's host seconds,
              the ligand's atoms and torsions, every pose written, the best
              score finite and no worse than the input pose's, every pose's
              bond lengths the input's, score_complex of every written pose
              its table score; the best and the nearest pose's RMSD from the
              input pose at each seed
 12. the training phases again under configs/train_corpus.yml in float32
     (batch 32 as one microbatch): kernel_train_s2 / kernel_bwd_s2 (K4 and
     K4b at every distinct call of one step, 6 each), train_s2 (per step
     K4 = K4b = K1 = K1b = K3 = K3b = 6, K2 = K2b = 0), train_profile_s2,
     train_vs_cpu_s2 and train_cli_s2 (``--config``, a float32 copy of
     configs/train_corpus.yml; the generation CLI serves from the
     checkpoint's s2 config, through K4); then the file at its own
     bfloat16: kernel_train_s2_bf16 / kernel_bwd_s2_bf16 (K4·bf16 and
     K4b·bf16 at every distinct call of a microbatch, each held to its
     bfloat16 twin within BF16_TOL, bound at the bfloat16 rate and
     ``bound_tc_ms`` at half a TF32 product: every product of both on
     bfloat16 m16n8k16 mma.sync), train_s2_bf16 (per step the
     bfloat16 instances of K1, K1b, K3, K3b, K4, K4b 6 each, every float32
     count 0), train_profile_s2_bf16 (``k4_kernels``: K4·bf16's kernel and
     weight kernel and K4b·bf16's kernel by name, K4's float32 tensor-core
     kernel and split and its CUDA-core kernel 0),
     train_cli_s2_bf16 (``--config configs/train_corpus.yml``) and
     train_s2_bf16_vs_f32 (both steps' time, busy time, peak memory)
 13. the default Config with SINGA_TPU_FUSED_SO2 set for these phases only
     (every phase before runs with it unset and asserts K6 = K6b = 0):
     kernel_so2 (K6 at every distinct call of one encode_pocket of the 8
     pockets), main_so2 (generate_for_pocket; per encode K1 = 6, K2 = 3,
     K6 = 3, K3 = 0; encode_ms, decode_ms, molecules/s, the encode's
     profile, and the fused encode against the unfused one on the card
     under CPU_TOL), vs_cpu_so2, then the training phases as in 8-11 with
     suffix _so2 (batch 64 as 2 x 32; per step K1 = K1b = K2 = K2b = K6 =
     K6b = 12, K3 = K3b = 0; train_cli_so2's generation launches K6 = 3);
     then configs/train.yml at its own bfloat16 under the switch (suffix
     _so2_bf16; batch 64 as 2 x 32, BF16_WARMUP + BF16_STEPS steps, no
     _vs_cpu): kernel_train / kernel_bwd (K6·bf16 and K6b·bf16 at every
     distinct call of a microbatch, each held to its bfloat16 twin within
     BF16_TOL, bound at the bfloat16 rate and ``bound_tc_ms`` with the
     GEMM at half a TF32 product, bfloat16 m16n8k16 mma.sync, and the grid
     stages at one), train (per step 12 of each of K1·bf16, K2·bf16, K1b·bf16,
     K2b·bf16, K6·bf16 and K6b·bf16, every float32 count 0, K3 and K3b
     0), train_profile (``k6_bf16_kernels``: the weights' rounding, the
     rotation and the grid on the tensor cores at bfloat16 24 a step, the
     backward rotation and grid 12, the GEMM on bfloat16 operands, their
     float32 instances and the grid's CUDA-core kernels 0;
     ``so2_gemm``) and train_cli (``--config configs/train.yml``, the switch
     set); train_so2_bf16_vs_f32 sets its step beside train_so2's
 14. the default Config with SINGA_TPU_HYBRID_ATTN set for these phases
     only, then with SINGA_TPU_DENSE_ATTN set (every phase before runs with
     both unset and asserts K7 = K7b = K8 = K8b = 0): kernel_hybrid /
     kernel_dense (K7 or K8 at every distinct call of one encode_pocket of
     the 8 pockets), main_hybrid / main_dense (generate_for_pocket; per
     encode K7 or K8 = 6, K1 = 0, K2 = 3, K3 = 3; encode_ms, decode_ms,
     molecules/s, the encode's profile; the encode against the K1 encode on
     the card: the hybrid one held to CPU_TOL, the dense one only reported,
     beside the rows whose in-degree exceeds K, where the two differ by
     design), vs_cpu_hybrid / vs_cpu_dense, then the training phases as in
     8-11 with suffix _hybrid / _dense (batch 64 as 2 x 32, FORM_WARMUP +
     FORM_STEPS steps; per step K7 = K7b (or K8 = K8b) = K2 = K2b = K3 = K3b
     = 12, K1 = K1b = 0); dense_lists / dense_lists_dense: at each distinct
     call of K8 (serving) and of K8 and K8b (a training microbatch), the
     live pairs, padded and closed-form rows, tiles per row, the per-pair
     scratch against the all-columns one, the kernels' residency, and their
     times with rows by descending live count (theirs) and in index order;
     then configs/train.yml at its own bfloat16 under each switch (suffix
     _hybrid_bf16 / _dense_bf16; batch 64 as 2 x 32, BF16_WARMUP +
     BF16_STEPS steps, no _vs_cpu): kernel_train / kernel_bwd (K7·bf16 and
     K7b·bf16, or K8·bf16 and K8b·bf16, at every distinct call of a
     microbatch, each held to its bfloat16 twin within BF16_TOL, bound at
     the bfloat16 rate; K7's, K7b's and K8b's lines with ``walks``,
     ``bound_tc_ms`` at one TF32 product and their CUDA-core instance at
     the same call), train (per step 12 of each of K2·bf16, K3·bf16,
     K2b·bf16, K3b·bf16 and the form's two bfloat16 instances, every
     float32 count 0), train_profile (the form's bfloat16 kernels by name,
     ``k7_bf16_kernels`` / ``k8_bf16_kernels``, 12 a step, their float32
     instances 0; K8b·bf16's tensor-core kernels, its CUDA-core ones 0)
     and train_cli (``--config configs/train.yml``, the
     switch set); train_forms_bf16_vs_f32 sets each form's bfloat16 step
     beside its float32 one; train_vs_cpu_bf16: configs/train.yml cut to
     lmax 2, a bfloat16 training step's loss and every gradient on the card
     against the CPU (2 complexes, the same seeded weights) under no switch,
     the hybrid switch, the dense switch and SINGA_TPU_FUSED_SO2 (``so2``:
     K6·bf16, K6b·bf16), and configs/train_corpus.yml cut the same way
     (``s2``: K4·bf16, K4b·bf16): the gradients' L2 difference within
     GAN_BF16_CPU_TOL of their L2 norm, the loss within GAN_BF16_LOSS_TOL,
     and the form's bfloat16 kernels launched on the card
 15. the adversarial fine-tuning path under configs/gan_recipe.yml (lmax 4,
     gate FFN), first at its own bfloat16 as a user runs it (suffix _bf16:
     gan_bf16 with 3 rounds and the --vina-eval report below, every launch
     one of a bfloat16 instance; gan_kernel_bf16 and gan_profile_bf16; and
     gan_vs_cpu_bf16, a g step at the recipe's widths cut to lmax 2, card
     against CPU at bfloat16: the gradients' L2 difference within
     GAN_BF16_CPU_TOL of their L2 norm, loss and reward within
     GAN_BF16_LOSS_TOL), then in float32 through a float32 copy of the
     file: gan (``singa_tpu_torch.train.gan.main`` at batch 64
     on data/corpus with 2 CE warm-up steps, 2 rounds of WGAN-GP with the
     grammar mask and a quality sample each round, the counts set to 0 just
     before and read just after: each round's host ms split into sample,
     host bridge, d, graph-D and g with torch.cuda.synchronize around each
     part, its launches (K1 = 12, K2 = K3 = 6, K1b = 6, K2b = K3b = 3, the
     rest 0: the sample's encode_pocket and the g step's, forward and
     backward), the losses (all finite), pct_valid, the quality samples and
     peak memory; gan_bf16's ``--vina-eval 8``: the final report docks 8
     samples of the encoded batch on the host and carries pct_vina_good,
     n_vina_scored and vina_mean, its seconds ``vina_eval_s`` apart from
     ``cli_s``; gan_vina_eval_bf16 prints that report, which may dock none,
     as few of a 2-CE-step generator's samples parse),
     gan_generate (the generation CLI serves one val pocket
     from the final checkpoint: one encode's launches, one CSV row),
     gan_vina (``vina_conditioning_host`` on 8 train complexes on the card
     with their ligands' own tokens equals the same call on the batch's CPU
     copy, at least 4 docked; each call's host seconds),
     gan_kernel (every distinct call of K1-K3 and K1b-K3b in one g step at
     batch 64, held to its plain version and timed as kernel_train holds
     them; K2, K3 and K3b must take their tensor-core kernels at lmax 4),
     gan_profile (its g step at batch 64 under the profiler: device busy
     time, idle share, the costliest device ops; gan_profile_bf16 profiles
     a whole round) and gan_vs_cpu (one g step's loss, mean reward and every generator
     gradient on the card against the CPU, 2 complexes, the same seeded
     weights and the tokens the card sampled, TRAIN_CPU_TOL)
then a ``total`` line (the script's seconds so far), the card's name and
power limit as nvidia-smi prints them, the kernels line and
``{"ok": true, "device": {...}}`` last. The kernels line lists all sixteen
kernels and their fourteen bfloat16 instances: ``launches`` counted over the training run of the kernel's path
(K1-K3, K1b-K3b: train; K4, K4b: train_s2; K6, K6b: train_so2; K7, K7b:
train_hybrid; K8, K8b: train_dense; K5, K5b: none, 0, with ``"path":
null``; the bfloat16 instances: K1-K3b's train_bf16, K4's and K4b's
train_s2_bf16, K7's and K7b's train_hybrid_bf16, K8's and K8b's
train_dense_bf16, K6's and K6b's train_so2_bf16); ``ms``, ``plain_ms`` and ``bound_ms`` the means per launch over one
microbatch's calls (kernel_train / kernel_bwd and their twins, each distinct
call weighted by how often the microbatch makes it; K5/K5b: kernel_s2act's
two calls), ``max_abs_err`` the largest over those calls. K7's times are
the kernel's alone: the torch.gather calls that feed it are path time, in
the profiles (main_hybrid's encode_profile, train_profile_hybrid); K7b's
bytes count the gathered rows of live slots only, K7's those and the v rows
of its dead-weighted rows' slots. K1's and K7's operations are those of
the live slots and of the dead-weighted rows' slots (the v-EdgeMLP, smear
and aggregate; a row that copies the row before's inputs costs none);
``bound_live_only_ms`` beside them counts the live pairs alone. The entries of
K1, K7, K1b, K7b, K2, K2b, K3, K3b, K4, K4b, K5, K5b, K6 and K6b also have ``bound_tc_ms`` and
``split_tf32_flops`` (per launch): the larger of
the operations that run as split TF32 (K1's and K7's EdgeMLPs on live
slots and their v-EdgeMLP on the dead-weighted rows' slots; K1b's and
K7b's EdgeMLPs, dh and
four weight gradients, once per live pair; K2's h, y and gates, all of
its work; K3's two and K3b's three grid transforms, all of their work;
K5's two and K5b's three, but at I 49 their last coefficient row;
K2b's five per-degree products
h, dmid, dx, dw1, dw2 and its gates and row-0 gate term; K4's h, y and
two grid transforms, but at lmax 6 their last coefficient row; K4b's four
grid transforms; K6's
and K6b's conv and weight-gradient products, the GEMM of
csrc/so2_chain.cuh) at three TF32 products each over 495 TFLOP/s and the
rest over 67 TFLOP/s, since the two units issue together, or the bytes
over 3.35 TB/s if that is larger. K1's, K7's, K1b's, K7b's, K2's, K2b's,
K3's, K3b's, K4's, K4b's, K5's and K5b's also have the ptxas report and the residency (blocks per SM,
threads, dynamic shared memory per block) of their tensor-core kernel (K2b: of its weight
kernel, and of its dx kernel as ``dx_residency``; K2 and K4: at the
training microbatch's widths, which must take it; K5 and K5b at each of
kernel_s2act's two inputs; K2, K3, K3b, K5 and K5b also
``cuda_cores_ms``, their CUDA-core instance at the same calls, and K3, K3b,
K5 and K5b ``host_ms``, their wrapper's host time a call); K6's and
K6b's the same of the GEMM's kernels (``gemm_ptxas``,
``gemm_residency``), and train_profile_so2 reports those kernels' device
time in the profiled step and their rate (``so2_gemm``: the split-TF32
operations of one step's K6 and K6b calls over that time). Any failed
check raises. TF32 is off for matmuls and cuDNN, so every PyTorch product
runs in full float32 (K1b's and K7b's EdgeMLP products, K2's and K2b's products,
K4's grid transforms and per-degree products, K3's, K3b's, K4b's, K5's and K5b's grid
transforms,
K1's and K7's EdgeMLPs and K6's and K6b's products run as split TF32
inside the kernels,
csrc/mma_tf32.cuh, to float32 round-off).

The bfloat16 phases (kernel_train_bf16, kernel_bwd_bf16, train_bf16,
train_profile_bf16, train_cli_bf16; configs/train.yml at its own
bfloat16, 12 launches a step of each bfloat16 instance, every float32
count 0; and the _s2_bf16 phases, configs/train_corpus.yml at its own
bfloat16, 6 a step of K1, K3, K1b, K3b, K4 and K4b's) hold each instance
to its bfloat16 twin within ``BF16_TOL`` of each output's largest (and the
_hybrid_bf16, _dense_bf16 and _so2_bf16 phases K7's, K7b's, K8's, K8b's,
K6's and K6b's). K8·bf16
and K8b·bf16 run K8's and K8b's CUDA-core kernels at bfloat16 storage (the
kernels line: ptxas from the build's ``dense_ptxas``, residency at the
microbatch's widths). The other twelve bfloat16 instances run
their tensor-core kernels at bfloat16 storage, one TF32 product for each
product of two bfloat16 values (exact in float32), or one bfloat16
m16n8k16 mma.sync for each 16-deep product (K4b·bf16's chain, K6·bf16's
and K6b·bf16's GEMM: half a TF32 product's time): their lines carry
``bound_tc_ms`` at those products (``tf32_products``) and
``cuda_cores`` (K1-K3b: their CUDA-core instances at the same call, held to the
twin the same way; K4, K4b, K6 and K6b have none at bfloat16; K6's and
K6b's kernels line the ptxas of their bfloat16 stages, ``k6_bf16_ptxas`` in
the build line, and their GEMM's and grid stages' residency,
``gemm_residency`` and ``grid_residency``; K1's, K7's, K1b's and K7b's
also ``walks``, K1's and K7's
``bound_live_only_ms``), the kernels line their ``cuda_cores_ms``, ptxas
and residency (``k1_bf16_ptxas`` and ``k1b_bf16_ptxas``: K1's and K7's
forms, ``k2_bf16_ptxas``,
``k2b_bf16_ptxas``, ``k3_bf16_ptxas``, ``k4_bf16_ptxas``,
``k4b_bf16_ptxas`` in the build line; K2b's dx
kernel's residency as ``dx_residency``); K3's and K3b's also ``host_ms``. Every train_profile* phase requires the tensor-core kernels of
K1/K7, K2, K1b/K7b, K2b, K3 and K3b to have run where its path runs them:
K1's plan, tile and copy kernels, K2's weight split, K1b's pair kernel,
K2b's weight split and K3's and K3b's kernels once a call, and none of
their CUDA-core kernels.
train_bf16_vs_f32 sets the bfloat16 step's time, device busy time and
peak memory beside float32's.
"""
from __future__ import annotations

import contextlib
import csv
import glob
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
S2_CONFIG = os.path.join("configs", "train_corpus.yml")  # ffn_activation: s2
T_START = time.perf_counter()
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bfloat16 on the tensor cores (the bf16 rows' bound)
# a bfloat16 kernel vs its bfloat16 plain twin: each output's largest error
# within 1e-2 of its largest magnitude. The two round the same values at the
# same points, but sum in other orders, so a value near a rounding boundary
# can land one bfloat16 step (2^-8 relative) apart and carry into what
# follows; float32 outputs (weight gradients) sum such terms.
BF16_TOL = 1e-2
TRAIN_CONFIG = os.path.join("configs", "train.yml")  # Config()'s path at its own bfloat16
TOL = {"atol": 1e-4, "rtol": 1e-4}  # kernel vs plain: reordered float32 sums
CPU_TOL = {"atol": 2e-3, "rtol": 2e-3}  # whole encoder, card vs CPU
PROFILE_STEPS = 40  # decode steps traced by the profile phase
PROFILE_TRIES = 3  # device_profile: profiles taken at most while hand kernels go missing
# backward kernel vs plain backward: each output within BWD_TOL of its own
# largest magnitude (weight gradients are sums over ~1e6 slot terms taken
# in another order)
BWD_TOL = 1e-4
# the training step on the card vs the CPU, and on the card vs a second card
# run: every gradient's L2 error within this share of its L2 norm (floored
# at 1e-3 of the largest gradient norm of the model). float32 sums in other
# orders through ~40 layers, and a ReLU input that round-off puts on the
# other side of zero moves one token's share of one row of a weight
# gradient, so the max-abs error is reported beside it with the elements
# over it and the ReLU inputs whose sign differs between the runs
TRAIN_CPU_TOL = 2e-3
# one warm-up step suffices: kernel_train's microbatch has already run the
# model forward and backward on the card; the first step creates Adam's state
TRAIN_WARMUP, TRAIN_STEPS, FIXED_STEPS = 1, 3, 5
BF16_WARMUP, BF16_STEPS = 1, 2  # train_bf16
S2_WARMUP, S2_STEPS = 1, 3  # the s2 training path (batch 32, one microbatch)
SO2_WARMUP, SO2_STEPS = 1, 3  # the fused SO(2) attention's training path (batch 64, 2 x 32)
FORM_WARMUP, FORM_STEPS = 1, 2  # the hybrid and dense attention's training paths (2 x 32)
FUSED_SO2 = "SINGA_TPU_FUSED_SO2"  # GraphAttention's switch to kernel K6
HYBRID_ATTN = "SINGA_TPU_HYBRID_ATTN"  # NeighborGraphMHA's switch to kernel K7
DENSE_ATTN = "SINGA_TPU_DENSE_ATTN"  # the encoder's switch to kernel K8 (wins over K7's)
SO2_GEMM = "so2::gemm_kernel"  # K6's and K6b's GEMM kernels in a profile (csrc/so2_chain.cuh)
# K2b's kernels in a profile (csrc/so3_gate_ffn_bwd.cu); sum_rows_kernel is
# also the second pass of K1b's, K4b's, K6b's and K8b's sums
# (the dx and weight kernels' names match their CUDA-core instances' too,
# which K2B_CC counts apart; the split runs once a tensor-core call)
K2B_KERNELS = ("gate_ffn_bwd_dx_kernel", "gate_ffn_bwd_w_kernel", "gate_ffn_bwd_wsplit_kernel",
               "sum_rows_kernel")
K2B_CC = "cc::gate_ffn_bwd"
# K1b's and K7b's kernels in a profile (csrc/neighbor_attn_bwd.cu): the
# tensor-core pair kernel, the plan, the dk/dv stage, the sums' second
# pass; K1B_CC their CUDA-core pair kernel
K1B_KERNELS = ("list_bwd_pair_kernel", "list_plan_kernel", "list_dkdv_kernel", "sum_rows_kernel")
K1B_CC = "list_bwd_cc_kernel"
# K1's and K7's kernels in a profile (csrc/neighbor_attn.cu): the tensor-core
# tile kernel, the plan and the copies of dead-weighted rows; K1_CC their
# CUDA-core instance (csrc/encoder_attn.cuh; K8's forward shares its name,
# and runs on no path that runs K1 or K7)
K1_KERNELS = ("list_fwd_tile_kernel", "list_fwd_plan_kernel", "list_fwd_copy_kernel")
K1_CC = "attn_fwd_kernel"
# K4's kernels in a profile (csrc/so3_ffn.cu): the tensor-core kernel and the
# split of its weights, two launches for each K4 call
K4_KERNELS = ("ffn_tc_kernel", "ffn_wsplit_kernel")
# K4's and K4b's bfloat16 kernels in a profile (their instances at T =
# bf16): K4's tensor-core kernel and split, two launches for each K4·bf16
# call, K4b's kernel one for each K4b·bf16 call; K4_CC K4's CUDA-core
# instance, which runs no bfloat16
K4_BF16_KERNELS = ("ffn_fwd_bf16_kernel<", "ffn_wfrag_bf16_kernel", "ffn_bwd_bf16_kernel<")
K4_CC = "cc::ffn_cc_kernel"
# K4's float32 tensor-core kernel and split, which the bfloat16 path must
# not run (K2's gate_ffn_* kernels do not match)
K4_F32 = ("::ffn_tc_kernel<", "::ffn_wsplit_kernel<")
# K7's and K7b's bfloat16 kernels in a profile (their form 1 instances at T =
# bf16): the tile kernel once a K7·bf16 call, the pair kernel once a
# K7b·bf16 call; K7_F32 their float32 instances, which the bfloat16 path
# must not run
K7_BF16_KERNELS = ("list_fwd_tile_kernel<1, .*bfloat16", "list_bwd_pair_kernel<1, .*bfloat16")
K7_F32 = ("list_fwd_tile_kernel<1, float>", "list_bwd_pair_kernel<1, float>")
# K8's and K8b's bfloat16 kernels in a profile: the forward (csrc/
# encoder_attn.cuh's dense form at T = bf16) once a K8·bf16 call, the
# tensor-core pair kernel and dk/dv stage (csrc/neighbor_attn_bwd.cu's list
# kernels in their dense form, form 2) once a K8b·bf16 call; K8B_BF16_CC
# K8b·bf16's CUDA-core kernels (encoder_attn.cuh's, for rows over one
# tile), K8_F32 their float32 instances
K8_BF16_KERNELS = ("attn_fwd_kernel<2, .*bfloat16", "list_bwd_pair_kernel<2, .*bfloat16",
                   "list_dkdv_kernel<2, .*bfloat16")
K8B_BF16_CC = ("attn_bwd_pair_kernel<2, .*bfloat16", "csr_dkdv_kernel<2, .*bfloat16")
K8_F32 = ("attn_fwd_kernel<2, float>", "attn_bwd_pair_kernel<2, float>")
# K6's and K6b's bfloat16 kernels in a profile (csrc/so2_chain.cuh at T =
# bf16): the weights' rounding, the rotation and the grid on the tensor
# cores, once a K6·bf16 and once a K6b·bf16 call (the backward recomputes
# the forward to mid); K6b·bf16's backward rotation and grid, once a
# K6b·bf16 call; the GEMM on bfloat16 operands. K6_F32 their float32
# instances (the grid's: its CUDA-core kernels), which the bfloat16 path
# must not run
K6_BF16_KERNELS = ("round_weights_kernel", r"so2::rotate_fwd_kernel<__nv_bfloat16>",
                   r"so2::grid_fwd_tc_kernel<", r"so2::rotate_bwd_kernel<__nv_bfloat16>",
                   r"so2::grid_bwd_tc_kernel<", r"so2::gemm_kernel<.*Bf16In")
K6_F32 = (r"so2::gemm_kernel<\w+, \w+, \w+, float>", "so2::rotate_fwd_kernel<float>",
          "so2::rotate_bwd_kernel<float>", r"so2::grid_fwd_kernel\(", r"so2::grid_bwd_kernel\(")
# K2's kernels in a profile (csrc/so3_gate_ffn.cu): the tensor-core kernel and
# the split of its weights, two launches for each K2 call; K2_CC its
# CUDA-core instance
K2_KERNELS = ("gate_ffn_tc_kernel", "gate_ffn_wsplit_kernel")
K2_CC = "cc::gate_ffn_kernel"
# K3's and K3b's tensor-core kernels in a profile (csrc/s2_act.cu), either
# dtype; K3_CC their CUDA-core instances
K3_KERNELS = ("s2_silu_sep_tc_kernel", "s2_silu_sep_bwd_tc_kernel")
K3_CC = "cc::s2_silu_sep"
LMAX4_NODES = 14336  # kernel_bwd_lmax4: a training microbatch's nodes
GAN_CONFIG = os.path.join("configs", "gan_recipe.yml")  # lmax 4, gate FFN, batch 64
# the gan phases' CE warm-up steps and adversarial rounds: gan_bf16 (the
# recipe at its own bfloat16, as a user runs it) and gan (float32)
GAN_PRETRAIN, GAN_ROUNDS, GAN_F32_ROUNDS = 2, 3, 2
# gan_vs_cpu_bf16: a g step at the recipe's widths cut to lmax 2 on the card
# and on the CPU at bfloat16; both round at the same points and sum in
# other orders, so a value near a rounding boundary lands a bfloat16 step
# apart and carries on (the CPU tests measure the port against JAX at 4-5 %
# on the g step's gradients, tests/test_torch_bf16_gan.py): the gradients'
# L2 difference over their L2 norm within 5e-2, the loss and reward within
# 5e-3 of the CPU's
GAN_BF16_CPU_TOL, GAN_BF16_LOSS_TOL = 5e-2, 5e-3
GAN_VINA_EVAL = 8  # the gan phase's --vina-eval: samples docked at the final report
VINA_KEYS = ("pct_vina_good", "n_vina_scored", "vina_mean")  # what --vina-eval reports
# the etl and dock phases' complex: a drug-sized val ligand (amlodipine, 28
# heavy atoms, 10 torsions). Its input pose, like every corpus pose, is a
# placement and not the score's minimum: the search finds better-scoring
# poses elsewhere, and which one comes first turns on the last bits of the
# host's arithmetic. So the dock phase reports the RMSD from the input pose
# at each seed and gates on what every correct search must give: a best
# score no worse than the input pose's, bonds kept, each pose's score its own
DOCK_COMPLEX = "amlodipine_s0_54"
REDOCK_SEEDS = (0, 1, 2)
BOND_TOL = 1e-3  # A: a pose's bond lengths vs the input's (the SDF keeps 1e-4 A)
RESCORE_TOL = 5e-3  # kcal/mol: score_complex of a written pose vs its table score


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, match=(), mods=None, expect=None) -> dict:
    """Device time of fn() by kernel under torch.profiler, beside the wall
    time of the same call unprofiled. The device's busy time is the sum of
    its kernels' times, memory copies and sets among them (one stream, so
    they do not overlap). The profiler traces the CUDA activity alone (the
    host side's events, which nothing here reads, made ``key_averages``
    several times slower on a training step). User annotations among the
    device events (a ``record_function`` range's span on the card, such as
    ``Optimizer.step#Adam.step``, which covers kernels counted already and
    the gaps between them), should any appear, are left out, told apart by
    ``FunctionEventAvg.is_user_annotation``, their spans' sum reported
    apart (``annotation_ms``). The idle share is the rest of the
    unprofiled wall time. ``match``: names (regular expressions); for each, the device time
    and launches of the kernels whose name it matches (``re.search``).

    ``expect(rise)`` (with ``mods``, the kernel modules): from the launch
    counters' rise over the profiled call ({kernel: launches}, counts set
    to 0 just before it), the launches each matched hand kernel must show
    there. The profiler drops every device event of about one traced call
    in 450 (PERF.md §7), which would lower the busy time unseen; so a
    profile whose matched kernels fall short of that is taken again, fn()
    with it, up to PROFILE_TRIES profiles: ``profiles_taken`` and each
    take's ``shortfall`` ({name: [launches seen, launches made]}) say what
    happened, and the last take is the one reported."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    shortfalls = []
    for _ in range(PROFILE_TRIES if expect is not None else 1):
        if expect is not None:
            zero_counts(mods)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [e for e in device if not e.is_user_annotation]
        matched = {}
        for name in match:
            hits = [e for e in ops if re.search(name, e.key)]
            matched[name] = {"launches": sum(e.count for e in hits),
                             "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}
        if expect is None:
            break
        short = {n: [matched[n]["launches"], want] for n, want in expect(read_counts(mods)).items()
                 if matched[n]["launches"] < want}
        shortfalls.append(short)
        if not short:
            break
    annotations = [e for e in device if e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    checked = {} if expect is None else {"profiles_taken": len(shortfalls),
                                         "shortfall": shortfalls}
    return {
        **checked,
        "wall_ms": wall_ms,
        # None: the profiler saw no device work here, so busy time is not measured
        "device_busy_ms": busy_ms if ops else None,
        "idle_share": 1.0 - busy_ms / wall_ms if ops else None,
        "device_ops": sum(e.count for e in ops),
        "annotation_ms": {e.key[:80]: e.self_device_time_total / 1e3 for e in annotations},
        "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
        "matched": matched,
    }


class ClockSampler:
    """nvidia-smi reading the SM clock, power draw and temperature every
    50 ms while the block runs; ``report`` gives each as [min, median,
    max] over the samples (none when nvidia-smi gave none)."""

    QUERY = "--query-gpu=clocks.sm,power.draw,temperature.gpu"

    def __enter__(self):
        self.proc = subprocess.Popen(["nvidia-smi", self.QUERY, "--format=csv,noheader,nounits",
                                      "-lms", "50"], stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        rows = []
        for ln in out.splitlines():
            try:
                rows.append([float(x) for x in ln.split(",")])
            except ValueError:
                continue
        rows = [r for r in rows if len(r) == 3]
        spread = lambda i: ([min(r[i] for r in rows), statistics.median(r[i] for r in rows),
                             max(r[i] for r in rows)] if rows else None)
        self.report = {"samples": len(rows), "sm_clock_mhz": spread(0), "power_w": spread(1),
                       "temperature_c": spread(2)}
        return False


def ptxas_report(log: str) -> dict:
    """Registers, spills and stack per kernel from one source's nvcc
    -Xptxas -v output, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif name and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
    return out


def mma_rate(sms: int) -> dict:
    """The card's rate of mma.sync.m16n8k8 TF32 (csrc/mma_tf32.cu, chains
    of independent products in registers, no memory traffic), with one and
    four blocks of 8 warps per SM: the ceiling of the tensor-core kernels'
    work (K4's, K4b's, K6's and K6b's among them), and a third of it for
    their split-TF32 products."""
    import ctypes

    from singa_tpu_torch.ops.cuda import build

    lib = build.load("mma_tf32")
    fn = lib.mma_tf32_rate_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chains = lib.mma_tf32_rate_chains()
    out, iters = {}, 4096
    for per_sm in (1, 4):
        blocks = sms * per_sm
        buf = torch.empty(blocks * 256, device="cuda")
        ms = time_ms(lambda: build.check(fn(buf.data_ptr(), blocks, iters, build.stream_ptr(buf)),
                                         "mma_tf32_rate"), iters=10)
        tflops = blocks * 8 * iters * chains * 2048 / ms / 1e9
        out[f"blocks_per_sm_{per_sm}"] = {"ms": ms, "tf32_tflop_per_s": tflops,
                                          "split_tflop_per_s": tflops / 3}
    return out


def dense_lists_report(args, kw) -> dict:
    """What K8/K8b walk at one captured call: the live pairs and rows, the
    closed-form rows, tiles per live row at each kernel's tile, the
    backward's per-pair scratch (against the [B*N*N, kd + vd + 2H] of the
    all-columns kernel), each kernel's residency, the largest live count
    the lists recorded, and what reading it costs ``live_columns`` on the
    card (``max_live_sync_ms``: the host's time of ``int(counts.max())`` on
    the lists' counts, the one host sync it adds beside ``nonzero``'s,
    median of 20)."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    qt, _, v, adj, ds = args[:5]
    lists = k8.DenseLists(*kw["lists"])
    B, N, _ = adj.shape
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[2] // H, args[6].shape[0]
    counts = (lists.row_offsets[1:] - lists.row_offsets[:-1]).long()
    live = counts[counts > 0]
    per_pair = (kd + vd + 2 * H) * 4
    tiles = lambda T: float(((live + T - 1) // T).float().mean()) if live.numel() else 0.0
    res = k8.residency(N, H, kd, vd, De)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(counts.max())
        times.append((time.perf_counter() - t0) * 1e3)
    return {"rows": B * N, "pairs": B * N * N, "live_pairs": int(lists.cols.numel()),
            "max_live": lists.max_live, "max_live_sync_ms": statistics.median(times),
            "padded_rows": int((ds[..., 0] <= -0.5 * k8.BIG).sum()),
            "closed_form_rows": int((counts == 0).sum()),
            "largest_live_count": int(counts.max()) if counts.numel() else 0,
            "mean_live_count": float(live.float().mean()) if live.numel() else 0.0,
            "tiles_per_live_row": {k: tiles(r["tile"]) for k, r in res.items()},
            "rows_over_one_bwd_tile": int((counts > res["bwd"]["tile"]).sum()),
            "scratch_bytes": int(lists.cols.numel()) * per_pair,
            "all_columns_scratch_bytes": B * N * N * per_pair, "residency": res}


def row_order_ms(fn, args, kw) -> dict:
    """K8's or K8b's kernel (``fn``, a ``*_cuda`` wrapper) at one captured
    call, timed with its rows taken by descending live count (the lists'
    order) and in index order: what the order buys."""
    from singa_tpu_torch.ops.cuda import dense_edge_attn as k8

    lists = k8.DenseLists(*kw["lists"])
    index = lists._replace(row_order=torch.arange(lists.row_order.numel(), dtype=torch.int32,
                                                  device=lists.row_order.device))
    with torch.no_grad():
        return {"by_live_count_ms": time_ms(lambda: fn(*args, lists=lists)),
                "index_order_ms": time_ms(lambda: fn(*args, lists=index))}


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def k3_cost(args, out):
    x, s, tg, fg = args
    E, I, C = x.shape
    G = tg.shape[0]
    # to-grid and from-grid contractions, 2 operations per multiply-add
    return nbytes(x, s, tg, fg, out), 2.0 * E * C * G * (2 * I - 1)


def k3_split_flops(args) -> float:
    """The operations of K3 that its tensor-core kernel (the one every call
    of the paths takes) runs as split TF32: both grid transforms, all of
    ``k3_cost``'s operations (silu and row 0's silu(s) are not counted)."""
    return k3_cost(args, None)[1]


def k3b_split_flops(args) -> float:
    """K3b's: its three grid transforms, all of ``k3b_cost``'s operations."""
    return k3b_cost(args, ())[1]


def host_ms(fn, iters: int = 20) -> float:
    """The host's time a call of ``fn`` (a kernel's wrapper: checks,
    allocation, the C call and the launch), over ``iters`` calls queued on
    an idle card without a synchronise between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def instance_report(spec, mod, args, kw) -> dict:
    """K3's, K3b's, K5's or K5b's wrapper's host time a call (``host_ms``;
    the kernels line's ``ms``, by CUDA events around the wrapper, includes
    it where it exceeds the device's), and the CUDA-core instance, which the
    shapes the tensor-core kernels do not take run, at the same call
    (``cuda_cores``: its time, and its outputs against the plain version as
    ``hold`` holds the kernel; a bfloat16 instance's within ``spec.tol`` of
    each output's largest, in its dtype)."""
    launch, plain = getattr(mod, f"{spec.fn}_cuda"), getattr(mod, f"{spec.fn}_plain")
    cuda_cores = lambda: launch(*args, **kw, cuda_cores=True)
    as_tuple = lambda r: (r,) if torch.is_tensor(r) else tuple(r)
    with torch.no_grad():
        got, want = as_tuple(cuda_cores()), as_tuple(plain(*args))
        if spec.outs is None:
            err, _, ok = held_as_forward(spec, got[0], want[0])
            errs = {"out": [err, want[0].float().abs().max().item()]}
        else:
            errs = {o: [(a.float() - b.float()).abs().max().item(),
                        b.float().abs().max().item()] for o, a, b in zip(spec.outs, got, want)}
            ok = all(e <= (spec.tol or BWD_TOL) * m for e, m in errs.values()) and all(
                a.dtype == b.dtype for a, b in zip(got, want))
        del got, want
        ms = time_ms(cuda_cores)
        host = host_ms(lambda: launch(*args, **kw))
    return {"host_ms": host, "cuda_cores": {"ms": ms, "errors": errs, "ok": ok}}


def k2_cost(args, out):
    x, w1, b1, wg, bg, w2, b2, lmax = args
    N, I, C = x.shape
    H, Co = w1.shape[2], w2.shape[2]
    flops = 2.0 * N * (I * C * H + C * lmax * H + I * H * Co)
    return nbytes(x, w1, b1, wg, bg, w2, b2, out), flops


def k2_split_flops(args) -> float:
    """The operations of K2 that its tensor-core kernel (the one every call
    of the gate paths takes) runs as split TF32: h and y, 2·N·I·H·(C + Co),
    and the gates, 2·N·C·lmax·H: all of them."""
    x, w1, _, _, _, w2, _, lmax = args
    N, I, C = x.shape
    H, Co = w1.shape[2], w2.shape[2]
    return 2.0 * N * (I * H * (C + Co) + C * lmax * H)


def held_as_forward(spec, got, want) -> tuple[float, object, bool]:
    """A forward's output against its plain version as ``hold`` holds the
    kernel: (max abs error, tolerance, within it); a bfloat16 instance's
    within ``spec.tol`` of the output's largest magnitude, in its dtype."""
    err = (got.float() - want.float()).abs().max().item()
    if spec.tol is not None:
        return (err, f"{spec.tol} x the output's max",
                got.dtype == want.dtype and err <= spec.tol * want.float().abs().max().item())
    return err, TOL, bool(torch.allclose(got, want, **TOL))


def k2_report(spec, mod, args, kw) -> dict:
    """K2's CUDA-core instance, which the widths the tensor-core kernel
    does not take run, at the same call (``cuda_cores``: its time, and its
    output against the plain version as ``hold`` holds the kernel)."""
    cuda_cores = lambda: mod.so3_gate_ffn_cuda(*args, **kw, cuda_cores=True)
    with torch.no_grad():
        err, tol, ok = held_as_forward(spec, cuda_cores(), mod.so3_gate_ffn_plain(*args))
        ms = time_ms(cuda_cores)
    return {"cuda_cores": {"ms": ms, "max_abs_err": err, "tolerance": tol, "ok": ok}}


def pair_flops(H: int, kd: int, vd: int, De: int) -> tuple[float, float]:
    """Operations per live (node, neighbour) pair of the encoder attention:
    (forward, backward). Forward: the smear, both EdgeMLPs, the score and
    the aggregate; backward: the EdgeMLPs' backward (dW2, dh, dW1) and the
    score/aggregate products."""
    forward = 2 * (De * kd + kd * kd + De * vd + vd * vd) + 3 * H * (kd + vd) + 4 * De
    backward = 4 * (kd * kd + vd * vd) + 2 * De * (kd + vd) + 9 * H * (kd + vd)
    return forward, backward


def dead_weighted_rows(nbr_mask, ds) -> torch.Tensor:
    """[B, N] the rows K1 and K7 take dead-weighted: no live slot, and
    exp(-1e9 - max(ds, -1e9)) != 0 in float32 in some head (the padded
    rows). Each takes its K slots on the v-EdgeMLP alone."""
    weighs = (torch.exp(-1e9 - torch.clamp(ds, min=-1e9)) != 0).any(-1)
    return ~nbr_mask.any(-1) & weighs


def copy_rows(args) -> torch.Tensor:
    """[B, N] the dead-weighted rows that K1 and K7 take as copies of the
    row before them: that row is dead-weighted too, in the same graph, and
    reads the same distances and rows of v (the same nbr; K7: the same
    gathered v rows), bit for bit. The corpus's padded nodes all sit at the
    origin, so every padded row of a graph but the first is one."""
    nbr_mask, dist, ds = args[-14], args[-13], args[-12]
    dead = dead_weighted_rows(nbr_mask, ds)
    rows = args[2] if args[1].dim() == 4 else args[3]  # K7's v_nb, or nbr
    bits = lambda t: t.contiguous().view(torch.int32)
    same = (bits(dist)[:, 1:] == bits(dist)[:, :-1]).all(-1)
    same &= (bits(rows)[:, 1:] == bits(rows)[:, :-1]).flatten(2).all(-1)
    out = torch.zeros_like(dead)
    out[:, 1:] = dead[:, 1:] & dead[:, :-1] & same
    return out


def list_fwd_work(args) -> tuple[float, float, float]:
    """What K1's (and K7's) data needs: (operations, those of them that run
    as split TF32, the slots of the dead-weighted rows). A live slot costs
    ``pair_flops``' forward, its two EdgeMLPs split; a dead-weighted row's
    slot the v-EdgeMLP (split), the smear and the aggregate, 2 (De vd + vd
    vd) + 2 H vd + 4 De, but a copy's (``copy_rows``) nothing: its sums are
    the row before's. A live row's dead slots weigh exp(-1e9 - m) = 0
    exactly and cost nothing (rows whose live scores sit near -1e9, taken
    again whole, are not counted: the function does not need them)."""
    qt, v, nbr_mask, ds, centers = args[0], args[2], args[-14], args[-12], args[-10]
    K = nbr_mask.shape[2]
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[-1] // H, centers.shape[0]
    live = float(nbr_mask.sum().item())
    dead = float(dead_weighted_rows(nbr_mask, ds).sum().item()) * K
    taken = dead - float(copy_rows(args).sum().item()) * K
    flops = live * pair_flops(H, kd, vd, De)[0] + taken * (2 * (De * vd + vd * vd) + 2 * H * vd
                                                           + 4 * De)
    split = 2.0 * (live * (De * (kd + vd) + kd * kd + vd * vd) + taken * (De * vd + vd * vd))
    return flops, split, dead


def k1_cost(args, out):
    return nbytes(*args, out), list_fwd_work(args)[0]


def k1_split_flops(args) -> float:
    """The operations of K1 (and K7) that run as split TF32 on the tensor
    cores: both EdgeMLPs once per live slot, the v-EdgeMLP once per slot of
    a dead-weighted row that is not a copy (the scores, the softmax and the
    aggregate stay float32)."""
    return list_fwd_work(args)[1]


def gathered_bytes(nbr_mask, k_nb, v_nb) -> float:
    """The bytes of K7's and K7b's gathered rows that the data needs: the
    rows of live slots (a dead slot's row is never read)."""
    return float(nbr_mask.sum().item()) * (k_nb.shape[-1] + v_nb.shape[-1]) * k_nb.element_size()


def k7_cost(args, out):
    # K1's work from the gathered rows: the k and v rows of live slots, and
    # the v rows of the dead-weighted rows' slots (a copy's too: telling it
    # from its source reads them)
    qt, k_nb, v_nb, *rest = args
    flops, _, dead = list_fwd_work(args)
    b = (gathered_bytes(rest[0], k_nb, v_nb) + dead * v_nb.shape[-1] * v_nb.element_size()
         + nbytes(qt, *rest, out))
    return b, flops


def live_only_bound_ms(args, out, rate: float = F32_FLOP_PER_S) -> float:
    """K1's or K7's bound over the live pairs alone: their operations and,
    for K7, the gathered rows of live slots (the dead-weighted rows left
    out), comparable with the bound of a kernel that evaluates every slot.
    ``rate``: the peak the row's own ``bound_ms`` takes (989 TFLOP/s for a
    bfloat16 instance), so that it never exceeds the bound over every slot."""
    qt, nbr_mask, ds, centers = args[0], args[-14], args[-12], args[-10]
    H = ds.shape[2]
    rows = args[1].dim() == 4  # K7's gathered rows
    kd, vd = qt.shape[2] // H, args[2].shape[-1] // H
    flops = float(nbr_mask.sum().item()) * pair_flops(H, kd, vd, centers.shape[0])[0]
    b = (gathered_bytes(nbr_mask, args[1], args[2]) + nbytes(args[0], *args[3:], out) if rows
         else nbytes(*args, out))
    return bound_ms(b, flops, rate)[0]


def dense_work(adj, ds, HV: int) -> tuple[float, float, float]:
    """What K8's data needs: (live pairs, the padded rows' forward
    operations, their backward's). A live row's dead columns weigh
    exp(-1e9 - m) = 0 exactly. A padded row (self score -1e9, no live
    column) weighs its N columns and itself alike, and its EdgeMLPs all see
    the smear of BIG, one w_v: its output is (w_v * sum_j v_j + dval) /
    (N + 1), one column sum of v per graph (N x HV additions) and ~3 HV
    operations per row. The backward adds per graph the padded rows' summed
    cotangent spread over the N columns of dv (N x HV), and per row its
    da, dot, share of that sum and dw_v (~6 HV)."""
    from singa_tpu_torch.ops.cuda.dense_edge_attn import BIG

    live = float((adj < 0.5 * BIG).sum().item())
    padded = ds[..., 0] <= -0.5 * BIG  # [B, N]
    rows = float(padded.sum().item())
    graphs = float(padded.any(dim=1).sum().item())
    N = adj.shape[2]
    return live, graphs * N * HV + rows * 3 * HV, graphs * N * HV + rows * 6 * HV


def k8_cost(args, out):
    (qt, k, v, adj, ds, dv, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff) = args
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[2] // H, centers.shape[0]
    live, padded_fwd, _ = dense_work(adj, ds, H * vd)
    b = nbytes(qt, k, v, adj, ds, dv, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, out)
    return b, live * pair_flops(H, kd, vd, De)[0] + padded_fwd


def k3b_cost(args, outs):
    x, s, tg, fg, g = args
    E, I, C = x.shape
    G = tg.shape[0]
    # per (edge, channel, grid point): the grid value (recomputed), the lifted
    # cotangent and the to-grid transpose, I multiply-adds each
    return nbytes(x, s, tg, fg, g, *outs), 2.0 * E * C * G * 3 * I


def k2b_cost(args, outs):
    x, w1, b1, wg, bg, w2, lmax, dy = args
    N, I, C = x.shape
    H, Co = w1.shape[2], w2.shape[2]
    # h (recomputed), dmid, dx, dw1, dw2 per degree; gates (recomputed), dwg
    # and the gate path's dx on row 0
    flops = 2.0 * N * (I * C * H * 3 + I * Co * H * 2 + C * lmax * H * 3)
    return nbytes(x, w1, b1, wg, bg, w2, dy, *outs), flops


def k1b_cost(args, outs):
    """K1b's, and K7b's: the same arguments with k_nb/v_nb [B, N, K, *] in
    place of k and v (their rows of live slots counted)."""
    (qt, k, v, nbr, nbr_mask, dist, ds, dv, centers,
     wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g) = args
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[-1] // H, centers.shape[0]
    pairs = float(nbr_mask.sum().item())  # the work this data needs: live pairs
    rows = gathered_bytes(nbr_mask, k, v) if k.dim() == 4 else nbytes(k, v)
    b = rows + nbytes(qt, nbr, nbr_mask, dist, ds, dv, centers,
                      wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, g, *outs)
    return b, pairs * sum(pair_flops(H, kd, vd, De))


def k1b_split_flops(args) -> float:
    """The operations of K1b (and K7b) that run as split TF32 on the tensor
    cores, once per live pair: the two EdgeMLPs (smear -> hidden -> w),
    dh = (dw W2^T) * sigmoid(pre) and the four weight gradients (the scores,
    the softmax, dqt, dw, dk/dv and the biases stay float32)."""
    nbr_mask, centers, wk1, wv1 = args[4], args[8], args[9], args[13]
    De, kd, vd = centers.shape[0], wk1.shape[1], wv1.shape[1]
    per_pair = 2.0 * (2 * De * (kd + vd) + 3 * (kd * kd + vd * vd))
    return float(nbr_mask.sum().item()) * per_pair


def cuda_cores_report(spec, mod, args, kw) -> dict:
    """A backward's CUDA-core instance, which every shape its tensor-core
    kernels do not take runs, at the same call (``cuda_cores``: its time,
    and each output against the plain version as ``hold`` holds the
    kernel: within BWD_TOL, or a bfloat16 instance's ``tol``, of its
    largest): the work cut without the tensor cores."""
    launch, plain = getattr(mod, f"{spec.fn}_cuda"), getattr(mod, f"{spec.fn}_plain")
    cuda_cores = lambda: launch(*args, **kw, cuda_cores=True)
    with torch.no_grad():
        errs = {o: [(a.float() - b.float()).abs().max().item(), b.float().abs().max().item()]
                for o, a, b in zip(spec.outs, cuda_cores(), plain(*args))}
        ms = time_ms(cuda_cores)
    tol = spec.tol or BWD_TOL
    return {"cuda_cores": {"ms": ms, "errors": errs,
                           "ok": all(e <= tol * m for e, m in errs.values())}}


def list_bwd_report(spec, mod, args, kw) -> dict:
    """K1b's or K7b's kernels at one call: what the pair kernel walked, as it
    counts it (``walks``: rows skipped for a zero cotangent, rows taken with
    their live slots, rows taken again whole, slots evaluated, beside the
    inputs' rows, live slots and B*N*K), and ``cuda_cores_report``."""
    launch = getattr(mod, f"{spec.fn}_cuda")
    nbr_mask = args[4]
    B, N, K = nbr_mask.shape
    stats = torch.zeros(4, dtype=torch.int32, device=nbr_mask.device)
    with torch.no_grad():
        launch(*args, **kw, stats=stats)
    zero, live, whole, slots = stats.tolist()
    return {"walks": {"rows": B * N, "rows_zero_cotangent": zero, "rows_live": live,
                      "rows_whole": whole, "slots_evaluated": slots, "slots": B * N * K,
                      "live_slots": int(nbr_mask.sum())},
            **cuda_cores_report(spec, mod, args, kw)}


def list_fwd_report(spec, mod, args, kw) -> dict:
    """K1's or K7's kernels at one call: what the tensor-core kernel walked,
    as it counts it (``walks``: rows taken with their live slots,
    dead-weighted rows evaluated and copied, rows taken again whole, slots
    evaluated, beside the inputs' rows, live slots, dead-weighted rows, copy
    rows and B*N*K), the bound over the live pairs alone
    (``bound_live_only_ms``), and the CUDA-core instance
    (``attn_fwd_kernel``, every slot evaluated; what other widths run) at
    the same call (``cuda_cores``: its time, and its output against the
    plain version as ``hold`` holds the kernel)."""
    launch, plain = getattr(mod, f"{spec.fn}_cuda"), getattr(mod, f"{spec.fn}_plain")
    nbr_mask, ds = args[-14], args[-12]
    B, N, K = nbr_mask.shape
    stats = torch.zeros(4, dtype=torch.int32, device=nbr_mask.device)
    cuda_cores = lambda: launch(*args, **kw, cuda_cores=True)
    with torch.no_grad():
        out = launch(*args, **kw, stats=stats)
        err, tol, ok = held_as_forward(spec, cuda_cores(), plain(*args))
        ms = time_ms(cuda_cores)
    live, dead, whole, slots = stats.tolist()
    return {"walks": {"rows": B * N, "rows_live": live, "rows_dead_weighted": dead,
                      "rows_copied": B * N - live - dead - whole, "rows_whole": whole,
                      "slots_evaluated": slots, "slots": B * N * K,
                      "live_slots": int(nbr_mask.sum()),
                      "dead_weighted_rows": int(dead_weighted_rows(nbr_mask, ds).sum()),
                      "copy_rows": int(copy_rows(args).sum())},
            "bound_live_only_ms": live_only_bound_ms(args, out, spec.rate),
            "cuda_cores": {"ms": ms, "max_abs_err": err, "tolerance": tol, "ok": ok}}


def k8b_cost(args, outs):
    (qt, k, v, adj, ds, dv, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff, g) = args
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[2] // H, centers.shape[0]
    live, padded_fwd, padded_bwd = dense_work(adj, ds, H * vd)
    b = nbytes(qt, k, v, adj, ds, dv, centers, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, g, *outs)
    return b, live * sum(pair_flops(H, kd, vd, De)) + padded_fwd + padded_bwd


def k8b_split_flops(args) -> float:
    """The operations of K8b·bf16 that its tensor-core kernels run on the
    tensor cores, once per live pair: K1b's (the two EdgeMLPs, dh and the
    four weight gradients), at one TF32 product each."""
    adj, centers, wk1, wv1 = args[3], args[6], args[7], args[11]
    from singa_tpu_torch.ops.cuda.dense_edge_attn import BIG

    De, kd, vd = centers.shape[0], wk1.shape[1], wv1.shape[1]
    per_pair = 2.0 * (2 * De * (kd + vd) + 3 * (kd * kd + vd * vd))
    return float((adj < 0.5 * BIG).sum().item()) * per_pair


def dense_bwd_report(spec, mod, args, kw) -> dict:
    """K8b·bf16's kernels at one call: which instance its shape picks
    (``instance``: its tensor-core kernels where every row fits one tile),
    what the tensor-core pair kernel walked, as it counts it (``walks``:
    rows skipped for a zero cotangent, rows taken with their live columns,
    (row, head) pairs whose max would leave a dead column a weight, live
    pairs evaluated, rows in closed form, beside the inputs' rows and live
    pairs), and ``cuda_cores_report``: its CUDA-core instance at the same
    call."""
    launch = getattr(mod, f"{spec.fn}_cuda")
    qt, adj, ds = args[0], args[3], args[4]
    lists = mod.DenseLists(*kw["lists"])
    H = ds.shape[2]
    B, N, _ = adj.shape
    instance = mod.bwd_bf16_instance(lists.max_live, H, qt.shape[2] // H,
                                     args[2].shape[2] // H, args[6].shape[0])
    stats = torch.zeros(5, dtype=torch.int32, device=adj.device)
    with torch.no_grad():
        launch(*args, **kw, stats=stats)
    zero, live, weighted, pairs, closed = stats.tolist()
    if instance == "tensor_cores" and weighted:
        raise AssertionError(f"{spec.name}: {weighted} (row, head) pairs whose max leaves a "
                             "dead column a weight")
    return {"instance": instance, "largest_live_count": lists.max_live,
            "walks": {"rows": B * N, "rows_zero_cotangent": zero, "rows_live": live,
                      "rows_closed_form": closed, "dead_weighted_heads": weighted,
                      "pairs_evaluated": pairs, "live_pairs": int(lists.cols.numel())},
            **cuda_cores_report(spec, mod, args, kw)}


def k4_cost(args, out):
    x, w1, b1, wg, bg, w2, b2, tg, fg, lmax = args
    N, I, C = x.shape
    H, Co, G = w1.shape[2], w2.shape[2], tg.shape[0]
    # the gate product, two per-degree products and the two grid transforms
    flops = 2.0 * N * (C * H + I * C * H + I * H * Co + 2 * G * I * H)
    return nbytes(x, w1, b1, wg, bg, w2, b2, tg, fg, out), flops


def k4_split_flops(args) -> float:
    """The operations of K4 that its tensor-core kernel (the one every call
    of the s2 path takes) runs on the tensor cores (split TF32 at float32,
    bfloat16 m16n8k16 at bfloat16): h and y, 2·N·I·H·(C + Co), and the two
    grid transforms, 2·N·2·G·r·H, but at lmax 6 their last row (r = I - 1),
    which runs in float32 on the CUDA cores; the gates stay float32."""
    x, w1, _, _, _, w2, _, tg, _, _ = args
    N, I, C = x.shape
    H, Co, G = w1.shape[2], w2.shape[2], tg.shape[0]
    r = I - 1 if I == 49 else I
    return 2.0 * N * H * (I * (C + Co) + 2 * G * r)


def k4b_cost(args, outs):
    x, w1, b1, wg, bg, w2, tg, fg, lmax, dy = args
    N, I, C = x.shape
    H, Co, G = w1.shape[2], w2.shape[2], tg.shape[0]
    # four grid transforms (v and the lifted cotangent, mid and dh), five
    # per-degree products (h, dmid, dx, dw1, dw2) and three gate products
    # (g0, dwg, the gate path's dx)
    flops = 2.0 * N * (4 * G * I * H + 3 * I * C * H + 2 * I * H * Co + 3 * C * H)
    return nbytes(x, w1, b1, wg, bg, w2, tg, fg, dy, *outs), flops


def k4b_split_flops(args) -> float:
    """The operations of K4b that run as split TF32 on the tensor cores:
    its four grid transforms (the rest stays float32)."""
    x, w1, _, _, _, _, tg, _, _, _ = args
    N, I, _ = x.shape
    return 2.0 * N * 4 * tg.shape[0] * I * w1.shape[2]


def k2b_split_flops(args) -> float:
    """The operations of K2b that run as split TF32 on the tensor cores: the
    per-degree products h, dmid (both kernels recompute them; the function
    needs them once), dx, dw1 and dw2, and the dx kernel's gates and row-0
    gate term; dwg and the weight kernel's gates stay float32."""
    x, w1, _, _, _, w2, lmax, _ = args
    N, I, C = x.shape
    H = w1.shape[2]
    return 2.0 * N * (I * H * (3 * C + 2 * w2.shape[2]) + 2 * C * lmax * H)


def bound_tc_ms(nbytes: float, flops: float, split_flops, products: float = 3) -> float:
    """The least time of a kernel whose ``split_flops`` run as ``products``
    TF32 products each (three: split TF32 of float32 values; one: two
    bfloat16 values in one TF32 product; half: a bfloat16 m16n8k16
    mma.sync, at twice the TF32 rate) at the tensor cores' rate and the
    rest of ``flops`` at the float32 rate: the tensor cores and the float32
    units issue together, so the larger of the two, or its bytes at the
    memory rate if larger still. ``split_flops`` may also be a dict
    {products: operations}: a kernel whose tensor-core work runs at more
    than one rate (K6·bf16's and K6b·bf16's GEMM on bfloat16 m16n8k16, their
    grid stages one TF32 product a product)."""
    parts = split_flops if isinstance(split_flops, dict) else {products: split_flops}
    t_tc = sum(p * f for p, f in parts.items()) / TF32_FLOP_PER_S
    t_ops = max(t_tc, (flops - sum(parts.values())) / F32_FLOP_PER_S)
    return max(t_ops, nbytes / MEM_BYTES_PER_S) * 1e3


def k6_split_flops(args) -> float:
    """The operations of K6 that run as split TF32 on the tensor cores: its
    conv-1 and conv-2 products (one multiply-add per weight element and
    edge), so2_chain.cuh's GEMM; the rotation and the grid stay float32."""
    x, w1s, w2s = args[0], args[4], args[6]
    return 2.0 * x.shape[0] * sum(w.numel() for w in (*w1s, *w2s))


def k6b_split_flops(args) -> float:
    """K6b's GEMM operations: conv 1 recomputed, dw1 and dmpr (three
    conv-1-sized products), dw2 and dmid (two conv-2-sized ones)."""
    x, w1s, w2s = args[0], args[4], args[6]
    return 2.0 * x.shape[0] * (3 * sum(w.numel() for w in w1s) + 2 * sum(w.numel() for w in w2s))


def k6_bf16_split_flops(args) -> dict:
    """K6·bf16's tensor-core operations by rate: its GEMM on bfloat16
    m16n8k16 mma.sync (half a TF32 product's time) and its grid stage, the
    grid both ways over the H hidden channels as k6_cost counts it, one TF32
    product a product; the rotation stays float32."""
    E, H, (G, I) = args[0].shape[0], args[12], args[8].shape
    return {0.5: k6_split_flops(args), 1: 4.0 * E * G * I * H}


def k6b_bf16_split_flops(args) -> dict:
    """K6b·bf16's the same: its GEMM, and the grid to mid and back (k6b_cost's
    count)."""
    E, H, (G, I) = args[0].shape[0], args[11], args[7].shape
    return {0.5: k6b_split_flops(args), 1: 8.0 * E * G * I * H}


def gemm_split_flops(spec, args) -> float:
    """The GEMM's operations of a K6 or K6b call (either dtype)."""
    split = spec.split_flops(args)
    return split[0.5] if isinstance(split, dict) else split


def k5_cost(args, out):
    x, tg, fg = args
    N, I, C = x.shape
    return nbytes(x, tg, fg, out), 2.0 * N * C * tg.shape[0] * I * 2


def k5b_cost(args, outs):
    x, tg, fg, g = args
    N, I, C = x.shape
    # the grid value (recomputed), the lifted cotangent and the to-grid transpose
    return nbytes(x, tg, fg, g, *outs), 2.0 * N * C * tg.shape[0] * I * 3


def k5_split_rows(I: int) -> int:
    """Coefficient rows that K5's and K5b's tensor-core kernels take through
    split TF32: all but the last at I 49 (the full lmax-6 grid), whose row
    48 stays float32."""
    return I - 1 if I == 49 else I


def k5_split_flops(args) -> float:
    """The operations of K5 that its tensor-core kernel (the one both of
    kernel_s2act's calls take) runs as split TF32: its two grid transforms
    over ``k5_split_rows``."""
    x, tg = args[0], args[1]
    N, I, C = x.shape
    return 2.0 * N * C * tg.shape[0] * k5_split_rows(I) * 2


def k5b_split_flops(args) -> float:
    """K5b's: its three grid transforms over ``k5_split_rows``."""
    return k5_split_flops(args) * 3 / 2



def so2_rotation_flops(lmax: int, mmax: int, C: int) -> float:
    """Per edge: the block-diagonal rotation J_kept Z J^T Z of C channels
    (per degree l a (2l+1)^2 product, then min(2l+1, 2mmax+1) kept rows),
    its two z-rotations (3 operations per coefficient each) and the radial
    modulation of the n_trunc kept rows."""
    n = [2 * l + 1 for l in range(lmax + 1)]
    kept = [min(k, 2 * mmax + 1) for k in n]
    return C * (2.0 * sum(k * k + r * k for k, r in zip(n, kept)) + 6 * sum(n) + sum(kept))


def k6_cost(args, outs):
    x, rad, phi, beta, w1s, b1, w2s, b2, tg, fg, lmax, mmax, H, F2, alpha_ch = args
    E, _, C = x.shape
    G, I = tg.shape
    # conv 1 and conv 2 (every section weight element is one multiply-add per
    # edge), the grid both ways over the H hidden channels, the rotation
    per_edge = (2.0 * sum(w.numel() for w in (*w1s, *w2s)) + 4.0 * G * I * H
                + so2_rotation_flops(lmax, mmax, C))
    return nbytes(x, rad, phi, beta, *w1s, b1, *w2s, b2, tg, fg, *outs), E * per_edge


def k6b_cost(args, outs):
    x, rad, phi, beta, w1s, b1, w2s, tg, fg, lmax, mmax, H, F2, alpha_ch, *cts = args
    E, _, C = x.shape
    G, I = tg.shape
    # conv 1 recomputed, then its weight gradient and its input cotangent;
    # conv 2's weight gradient and input cotangent (z is never recomputed);
    # the grid to mid (recomputed) and back (the lifted cotangent, dh); the
    # rotation and its transpose
    per_edge = (2.0 * (3 * sum(w.numel() for w in w1s) + 2 * sum(w.numel() for w in w2s))
                + 8.0 * G * I * H + 2 * so2_rotation_flops(lmax, mmax, C))
    b = nbytes(x, rad, phi, beta, *w1s, b1, *w2s, tg, fg, *cts, *outs)
    return b, E * per_edge


def capture_calls(fns: dict, run) -> dict:
    """Run ``run()`` with each function ``{name: module}`` of ``fns`` wrapped
    to record its calls. Returns {name: {shapes: [args, kwargs, calls]}}: the
    first call's arguments (cloned) for each distinct set of tensor shapes,
    and how many calls had those shapes."""
    captured = {name: {} for name in fns}
    originals = []

    def clone(a):
        if torch.is_tensor(a):
            return a.detach().clone()
        return [clone(v) for v in a] if isinstance(a, (list, tuple)) else a
    for name, mod in fns.items():
        orig = getattr(mod, name)
        originals.append((mod, name, orig))

        def rec(*args, _name=name, _orig=orig, **kw):
            key = tuple(tuple(a.shape) for a in (*args, *kw.values()) if torch.is_tensor(a))
            seen = captured[_name].get(key)
            if seen is None:
                captured[_name][key] = [tuple(map(clone, args)),
                                        {k: clone(v) for k, v in kw.items()}, 1]
            else:
                seen[2] += 1
            return _orig(*args, **kw)

        setattr(mod, name, rec)
    try:
        run()
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    return captured


ATTN_BWD_OUTS = ("dqt", "dk", "dv", "d_diag_scores", "d_diag_value", "dwk1", "dbk1", "dwk2",
                 "dbk2", "dwv1", "dbv1", "dwv2", "dbv2")  # K1b's, K7b's and K8b's outputs


class Kernel(NamedTuple):
    name: str
    module: str  # singa_tpu_torch.ops.cuda.<module>
    fn: str  # ``<fn>_cuda`` is the kernel, ``<fn>_plain`` its plain version
    counter: str  # the module's launch counter
    source: str
    replaces: str
    cost: object
    outs: tuple | None  # the backward's output names; None: a forward
    split_flops: object = None  # (args) -> its operations that run as split TF32
    report: object = None  # (spec, mod, args, kw) -> more of this call, for kernel_bwd*
    rate: float = F32_FLOP_PER_S  # the peak its bound takes for the operations
    tol: float | None = None  # bfloat16 instances: BF16_TOL of each output's largest
    tf32_products: float = 3  # TF32 products a product of split_flops takes (bfloat16: 1 or 0.5)


def bf16_instance(spec: Kernel, tensor_cores: bool = False, report=None,
                  counter: str | None = None) -> Kernel:
    """The bfloat16 instance of a kernel of a training path: the same
    wrapper and plain function at bfloat16 activations, its own launch
    counter (``counter``, else the kernel's with ``_bf16``), its bound at
    the bfloat16 tensor-core rate. ``tensor_cores`` (all but K8's): its
    tensor-core kernels, one TF32 product for
    each product of two bfloat16 values (``bound_tc_ms`` at one product),
    and ``report`` at each call (the CUDA-core instance at the same call;
    K1's, K7's, K1b's, K7b's and K8b's walks; K3's and K3b's wrapper host
    time); else its CUDA-core kernel."""
    return spec._replace(name=f"{spec.name}_bf16", counter=counter or f"{spec.counter}_bf16",
                         split_flops=spec.split_flops if tensor_cores else None, report=report,
                         rate=BF16_FLOP_PER_S, tol=BF16_TOL, tf32_products=1)


K1, K2, K3, K1B, K2B, K3B, K4, K4B, K5, K5B, K6, K6B, K7, K7B, K8, K8B = KERNELS = [
    Kernel("neighbor_attn_fused", "neighbor_attn", "neighbor_attn", "launches",
           "singa_tpu_torch/csrc/neighbor_attn.cu", "singa_tpu/ops/pallas/neighbor_attn.py:306",
           k1_cost, None, k1_split_flops, list_fwd_report),
    Kernel("so3_gate_ffn_fused", "so3_ffn", "so3_gate_ffn", "launches",
           "singa_tpu_torch/csrc/so3_gate_ffn.cu", "singa_tpu/ops/pallas/so3_ffn.py:497",
           k2_cost, None, k2_split_flops, k2_report),
    Kernel("s2_silu_sep", "s2_act", "s2_silu_sep", "launches",
           "singa_tpu_torch/csrc/s2_act.cu", "singa_tpu/ops/pallas/s2_act.py:230", k3_cost, None,
           k3_split_flops, instance_report),
    Kernel("neighbor_attn_bwd", "neighbor_attn", "neighbor_attn_bwd", "launches_bwd",
           "singa_tpu_torch/csrc/neighbor_attn_bwd.cu", "singa_tpu/ops/pallas/neighbor_attn.py:362",
           k1b_cost, ATTN_BWD_OUTS, k1b_split_flops, list_bwd_report),
    Kernel("so3_gate_ffn_bwd", "so3_ffn", "so3_gate_ffn_bwd", "launches_bwd",
           "singa_tpu_torch/csrc/so3_gate_ffn_bwd.cu", "singa_tpu/ops/pallas/so3_ffn.py:529",
           k2b_cost, ("dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"), k2b_split_flops),
    Kernel("s2_silu_sep_bwd", "s2_act", "s2_silu_sep_bwd", "launches_bwd",
           "singa_tpu_torch/csrc/s2_act.cu", "singa_tpu/ops/pallas/s2_act.py:209",
           k3b_cost, ("dx", "d_scalars"), k3b_split_flops, instance_report),
    Kernel("so3_ffn_fused", "so3_ffn", "so3_ffn", "launches_s2",
           "singa_tpu_torch/csrc/so3_ffn.cu", "singa_tpu/ops/pallas/so3_ffn.py:321", k4_cost, None,
           k4_split_flops),
    Kernel("so3_ffn_bwd", "so3_ffn", "so3_ffn_bwd", "launches_s2_bwd",
           "singa_tpu_torch/csrc/so3_ffn_bwd.cu", "singa_tpu/ops/pallas/so3_ffn.py:351",
           k4b_cost, ("dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2"), k4b_split_flops),
    Kernel("s2_silu", "s2_act", "s2_silu", "launches_silu",
           "singa_tpu_torch/csrc/s2_act.cu", "singa_tpu/ops/pallas/s2_act.py:248", k5_cost, None,
           k5_split_flops, instance_report),
    Kernel("s2_silu_bwd", "s2_act", "s2_silu_bwd", "launches_silu_bwd",
           "singa_tpu_torch/csrc/s2_act.cu", "singa_tpu/ops/pallas/s2_act.py:123",
           k5b_cost, ("dx",), k5b_split_flops, instance_report),
    Kernel("so2_attn_fused", "so2_attn", "so2_attn", "launches",
           "singa_tpu_torch/csrc/so2_attn.cu", "singa_tpu/ops/pallas/so2_attn.py:387", k6_cost, None,
           k6_split_flops),
    Kernel("so2_attn_bwd", "so2_attn", "so2_attn_bwd", "launches_bwd",
           "singa_tpu_torch/csrc/so2_attn_bwd.cu", "singa_tpu/ops/pallas/so2_attn.py:452", k6b_cost,
           ("dx", "drad", "dw1_0", "dw1_1", "dw1_2", "db1", "dw2_0", "dw2_1", "dw2_2", "db2"),
           k6b_split_flops),
    Kernel("neighbor_attn_hybrid", "neighbor_attn", "neighbor_attn_hybrid", "launches_hybrid",
           "singa_tpu_torch/csrc/neighbor_attn.cu", "singa_tpu/ops/pallas/neighbor_attn.py:492",
           k7_cost, None, k1_split_flops, list_fwd_report),
    Kernel("neighbor_attn_hybrid_bwd", "neighbor_attn", "neighbor_attn_hybrid_bwd",
           "launches_hybrid_bwd", "singa_tpu_torch/csrc/neighbor_attn_bwd.cu",
           "singa_tpu/ops/pallas/neighbor_attn.py:518", k1b_cost, ATTN_BWD_OUTS, k1b_split_flops,
           list_bwd_report),
    Kernel("dense_edge_attn", "dense_edge_attn", "dense_edge_attn", "launches",
           "singa_tpu_torch/csrc/dense_edge_attn.cu", "singa_tpu/ops/pallas/dense_edge_attn.py:230",
           k8_cost, None),
    Kernel("dense_edge_attn_bwd", "dense_edge_attn", "dense_edge_attn_bwd", "launches_bwd",
           "singa_tpu_torch/csrc/dense_edge_attn_bwd.cu",
           "singa_tpu/ops/pallas/dense_edge_attn.py:277", k8b_cost, ATTN_BWD_OUTS),
]
# configs/train.yml's, every one on the tensor cores
BF16_PATH = [bf16_instance(K1, True, list_fwd_report), bf16_instance(K2, True, k2_report),
             bf16_instance(K3, True, instance_report), bf16_instance(K1B, True, list_bwd_report),
             bf16_instance(K2B, True, cuda_cores_report),
             bf16_instance(K3B, True, instance_report)]
K1_BF16, K2_BF16, K3_BF16, K1B_BF16, K2B_BF16, K3B_BF16 = BF16_PATH
# configs/train_corpus.yml's at its bfloat16 (K1, K3, K1b, K3b as above)
# (K4·bf16's products and K4b·bf16's grid transforms on bfloat16 m16n8k16
# mma.sync: half a TF32 product's time each)
S2_BF16_PATH = [bf16_instance(K4, True)._replace(tf32_products=0.5),
                bf16_instance(K4B, True)._replace(tf32_products=0.5)]
K4_BF16, K4B_BF16 = S2_BF16_PATH
# configs/train.yml's under SINGA_TPU_HYBRID_ATTN (K7's and K7b's tensor-core
# kernels at bfloat16) and under SINGA_TPU_DENSE_ATTN (K8's CUDA-core
# kernel at bfloat16, K8b's tensor-core kernels at one TF32 product a
# product); K2, K3, K2b and K3b as in BF16_PATH
HYBRID_BF16_PATH = [bf16_instance(K7, True, list_fwd_report),
                    bf16_instance(K7B, True, list_bwd_report, "launches_bwd_hybrid_bf16")]
K7_BF16, K7B_BF16 = HYBRID_BF16_PATH
DENSE_BF16_PATH = [bf16_instance(K8),
                   bf16_instance(K8B, True, dense_bwd_report)._replace(
                       split_flops=k8b_split_flops)]
K8_BF16, K8B_BF16 = DENSE_BF16_PATH
# configs/train.yml's under SINGA_TPU_FUSED_SO2 (K6's and K6b's stages at
# bfloat16: the GEMM on bfloat16 m16n8k16 mma.sync, the grid stages on the
# tensor cores at one TF32 product a product); K1, K2, K1b and K2b as in
# BF16_PATH
SO2_BF16_PATH = [bf16_instance(K6, True)._replace(split_flops=k6_bf16_split_flops),
                 bf16_instance(K6B, True)._replace(split_flops=k6b_bf16_split_flops)]
K6_BF16, K6B_BF16 = SO2_BF16_PATH
KERNELS += BF16_PATH + S2_BF16_PATH + HYBRID_BF16_PATH + DENSE_BF16_PATH + SO2_BF16_PATH
GATE_PATH = [K1, K2, K3, K1B, K2B, K3B]  # held at the default Config's training microbatch
S2_PATH = [K4, K4B]  # held at configs/train_corpus.yml's
SO2_PATH = [K6, K6B]  # held at the default Config's, with SINGA_TPU_FUSED_SO2 set
HYBRID_PATH = [K7, K7B]  # ... with SINGA_TPU_HYBRID_ATTN set
DENSE_PATH = [K8, K8B]  # ... with SINGA_TPU_DENSE_ATTN set


@contextlib.contextmanager
def switched(var: str):
    """The switch ``var`` set for the duration, unset after (``main`` unsets
    every switch before the first phase). FUSED_SO2: every GraphAttention
    runs its edge chain as K6 (K6b backward) instead of rotate, SO2Conv, K3.
    HYBRID_ATTN: every encoder-1 layer runs K7/K7b in place of K1/K1b.
    DENSE_ATTN: the encoder builds adj_dist and every layer runs K8/K8b."""
    os.environ[var] = "1"
    try:
        yield
    finally:
        os.environ.pop(var)


def kernel_modules() -> dict:
    import importlib

    return {k.module: importlib.import_module(f"singa_tpu_torch.ops.cuda.{k.module}")
            for k in KERNELS}


def zero_counts(mods) -> None:
    for k in KERNELS:
        setattr(mods[k.module], k.counter, 0)


def read_counts(mods) -> dict:
    return {k.name: getattr(mods[k.module], k.counter) for k in KERNELS}


def capture(specs, mods, run) -> dict:
    """``capture_calls`` of the kernels ``specs`` over ``run()``."""
    return capture_calls({f"{k.fn}_cuda": mods[k.module] for k in specs}, run)


def sep_shapes(args) -> tuple:
    """(I, C, G) of a K3 or K3b call's arguments (x, scalars, to_grid, ...)."""
    return args[0].shape[1], args[0].shape[2], args[2].shape[0]


def check_k3_instance(mods, captured) -> None:
    """Raise unless every captured K3 (and K3b) call's shapes take the
    tensor-core kernels at the call's dtype."""
    for name in ("s2_silu_sep_cuda", "s2_silu_sep_bwd_cuda"):
        for args, _, _ in captured.get(name, {}).values():
            shapes = sep_shapes(args)
            instance = mods["s2_act"].s2_silu_sep_instance(
                *shapes, bf16=args[0].dtype == torch.bfloat16)
            if instance != "tensor_cores":
                raise AssertionError(f"{name} at (I, C, G) = {shapes} runs {instance}, "
                                     "not the tensor-core kernel")


def hold(spec: Kernel, mod, args, kw) -> dict:
    """One kernel against its plain version on the same inputs on the card:
    the errors against the tolerance, kernel_ms / plain_ms and the bound. A
    forward is held to TOL; each output of a backward to BWD_TOL of its own
    largest magnitude."""
    launch, plain = getattr(mod, f"{spec.fn}_cuda"), getattr(mod, f"{spec.fn}_plain")
    as_tuple = lambda r: (r,) if torch.is_tensor(r) else tuple(r)
    with torch.no_grad():
        got, want = as_tuple(launch(*args, **kw)), as_tuple(plain(*args))
        torch.cuda.synchronize()
        if spec.tol is not None:  # a bfloat16 instance: each output within its tolerance
            names = spec.outs or (("out",) if len(got) == 1 else
                                  tuple(f"out{i}" for i in range(len(got))))
            errs = {o: [(a.float() - b.float()).abs().max().item(), b.float().abs().max().item(),
                        (a != b).float().mean().item(), str(a.dtype).replace("torch.", "")]
                    for o, a, b in zip(names, got, want)}
            ok = all(e <= spec.tol * scale for e, scale, _, _ in errs.values()) and all(
                a.dtype == b.dtype for a, b in zip(got, want))
            max_abs = max(e[0] for e in errs.values())
            tol = f"{spec.tol} x each output's max ([err, max, share of elements unequal, dtype])"
        elif spec.outs is None:  # every output within TOL
            diffs = [(a - b).abs() for a, b in zip(got, want)]
            errs = {"max_abs_err": max(d.max().item() for d in diffs),
                    "max_rel_err": max((d / (b.abs() + TOL["atol"] / TOL["rtol"])).max().item()
                                       for d, b in zip(diffs, want))}
            ok = all(bool(torch.allclose(a, b, **TOL)) for a, b in zip(got, want))
            max_abs, tol = errs["max_abs_err"], TOL
        else:
            errs = {o: [(a - b).abs().max().item(), b.abs().max().item()]
                    for o, a, b in zip(spec.outs, got, want)}
            ok = all(e <= BWD_TOL * scale for e, scale in errs.values())
            max_abs, tol = max(e for e, _ in errs.values()), f"{BWD_TOL} x each output's max"
        del want
        k_ms = time_ms(lambda: launch(*args, **kw))
        p_ms = time_ms(lambda: plain(*args))
    b, f = spec.cost(args, got[0] if spec.outs is None and len(got) == 1 else got)
    b += nbytes(*kw.values())
    bms, by = bound_ms(b, f, spec.rate)
    tc = {}
    if spec.split_flops is not None:
        split = spec.split_flops(args)
        tc = {"bound_tc_ms": bound_tc_ms(b, f, split, spec.tf32_products),
              "split_tf32_flops": sum(split.values()) if isinstance(split, dict) else split,
              "tf32_products": ({str(p): o for p, o in split.items()} if isinstance(split, dict)
                                else spec.tf32_products)}
    return {"shapes": [list(a.shape) for a in (*args, *kw.values()) if torch.is_tensor(a)],
            "max_abs_err": max_abs, "errors": errs, "tolerance": tol, "ok": ok,
            "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by, "bytes": b,
            "flops": f, "fraction_of_bound": bms / k_ms, **tc}


def hold_all(specs, mods, captured, phase, per, path) -> dict:
    """``hold`` every captured call of every kernel in ``specs``, one line
    each; raises on the first disagreement. Returns each kernel's line of
    the kernels table: times per launch averaged over the calls, weighted by
    how often each was made; ``path`` names the run whose launches it will
    report."""
    results = {}
    for spec in specs:
        recs = []
        for args, kw, calls in captured[f"{spec.fn}_cuda"].values():
            rec = hold(spec, mods[spec.module], args, kw)
            if spec.report is not None:
                rec.update(spec.report(spec, mods[spec.module], args, kw))
            emit({"phase": phase, "name": spec.name, per: calls, **rec})
            if not rec["ok"] or not rec.get("cuda_cores", {"ok": True})["ok"]:
                raise AssertionError(f"{spec.name}: kernel disagrees with its plain version {rec}")
            recs.append((calls, rec))
        if not recs:
            raise AssertionError(f"{spec.name}: no call captured")
        n = sum(c for c, _ in recs)
        mean = lambda key: sum(c * r[key] for c, r in recs) / n
        results[spec.name] = {
            "name": spec.name, "route": "cuda", "source": spec.source, "replaces": spec.replaces,
            "launches": None, "path": path, "max_abs_err": max(r["max_abs_err"] for _, r in recs),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": max(recs, key=lambda cr: cr[0] * cr[1]["bound_ms"])[1]["bound_by"],
            "library_ms": None,
        }
        if spec.split_flops is not None:
            results[spec.name]["bound_tc_ms"] = mean("bound_tc_ms")
            results[spec.name]["split_tf32_flops"] = mean("split_tf32_flops")
        if spec.report is not None:  # the CUDA-core instance, timed at the same calls
            results[spec.name]["cuda_cores_ms"] = sum(c * r["cuda_cores"]["ms"]
                                                      for c, r in recs) / n
        if "bound_live_only_ms" in recs[0][1]:
            results[spec.name]["bound_live_only_ms"] = mean("bound_live_only_ms")
        if "host_ms" in recs[0][1]:
            results[spec.name]["host_ms"] = mean("host_ms")
    return results


def grad_report(got: dict, want: dict, tol: float) -> dict:
    """Every gradient of ``got`` against ``want`` by two measures, each
    floored at 1e-3 of the set's largest (leaves whose true gradient is zero,
    like a bias that softmax cancels, are round-off on both sides): the L2
    error over ``tol`` x the leaf's L2 norm (``l2``, the gate), and the
    max-abs error over ``tol`` x the leaf's largest magnitude (``max_abs``),
    with the elements over that bound: for each leaf that has any, how many
    of its elements and of its rows (a Linear weight's output channels), and
    the largest few of the worst leaf."""
    norms = {n: w.norm().item() for n, w in want.items()}
    maxes = {n: w.abs().max().item() for n, w in want.items()}
    top, top_max = max(norms.values()), max(maxes.values())
    out = {"l2": 0.0, "l2_leaf": "", "max_abs": 0.0, "max_abs_leaf": "", "over": {}}
    worst_diff = None
    for name, w in want.items():
        diff = got[name] - w
        l2 = diff.norm().item() / (tol * max(norms[name], 1e-3 * top))
        if l2 > out["l2"]:
            out["l2"], out["l2_leaf"] = l2, name
        bound = tol * max(maxes[name], 1e-3 * top_max)
        ratio = diff.abs().max().item() / bound
        if ratio > out["max_abs"]:
            out["max_abs"], out["max_abs_leaf"], worst_diff = ratio, name, diff
        over = diff.abs() > bound
        if bool(over.any()):
            rows = over.reshape(over.shape[0], -1).any(dim=1) if over.dim() > 1 else over
            out["over"][name] = {"elements": int(over.sum()), "of": over.numel(),
                                 "rows": int(rows.sum()), "of_rows": rows.numel()}
    if worst_diff is not None:
        name = out["max_abs_leaf"]
        idx = worst_diff.abs().flatten().topk(min(5, worst_diff.numel())).indices
        out["largest"] = [[[int(j) for j in np.unravel_index(int(i), worst_diff.shape)],
                           got[name].flatten()[i].item(), want[name].flatten()[i].item()]
                          for i in idx]
    return out


def relu_inputs(model) -> tuple[list, list]:
    """Forward hooks that keep the input of every ReLU of the model (the
    output of each PositionwiseFFN's conv1) as (module name, tensor), in call
    order. Returns (kept, hooks)."""
    from singa_tpu_torch.models.cpromg import PositionwiseFFN

    kept = []
    hooks = [m.conv1.register_forward_hook(
                 lambda _m, _i, out, _n=n: kept.append((_n, out.detach().cpu())))
             for n, m in model.named_modules() if isinstance(m, PositionwiseFFN)]
    return kept, hooks


def relu_flips(got: list, want: list) -> dict:
    """ReLU inputs of two runs: how many changed sign, by module, and the
    largest magnitude (in ``want``) among those that did."""
    flips, near = {}, 0.0
    for (name, a), (_, b) in zip(got, want):
        flip = (a > 0) != (b > 0)
        if bool(flip.any()):
            flips[name] = flips.get(name, 0) + int(flip.sum())
            near = max(near, b[flip].abs().max().item())
    return {"relu_inputs": sum(b.numel() for _, b in want), "sign_flips": sum(flips.values()),
            "by_module": flips, "largest_flipped_magnitude": near}


def dense_lists_lines(mods, captured, suffix: str) -> None:
    """dense_lists{suffix}: at each distinct K8 and K8b call of a training
    microbatch, what the kernels walk and their times in both row orders."""
    for spec in (K8, K8B):
        for args, kw, calls in captured[f"{spec.fn}_cuda"].values():
            fn = getattr(mods[spec.module], f"{spec.fn}_cuda")
            emit({"phase": f"dense_lists{suffix}", "name": spec.name,
                  "calls_per_microbatch": calls, **dense_lists_report(args, kw),
                  "row_order": row_order_ms(fn, args, kw)})


def path_instances(specs, mods, captured, results: dict) -> None:
    """At a training microbatch's widths: the kernels each call of the path
    must take (K2's at either dtype, K2b's, K4's, K3's and K3b's
    tensor-core ones; raises otherwise) and the residency of the path's
    tensor-core kernels, into
    ``results``. Holds no captured tensor past its return, so the train
    phase's peak memory does not count them."""
    for spec, bf16 in ((K2B, False), (K2B_BF16, True)):
        if spec not in specs:
            continue
        # K2b's tensor-core kernels take the microbatch's widths; their residency
        args = next(iter(captured["so3_gate_ffn_bwd_cuda"].values()))[0]
        x, w1, _, _, _, w2, lmax, _ = args
        widths = (lmax, x.shape[2], w1.shape[2], w2.shape[2])
        instance = mods["so3_ffn"].so3_gate_ffn_bwd_instance(*widths)
        if instance != "tensor_cores":
            raise AssertionError(f"K2b at {widths} runs {instance}, not the tensor-core kernels")
        fn = mods["so3_ffn"].gate_bwd_residency
        results[spec.name]["residency"] = fn(*widths, bf16=bf16)
        results[spec.name]["dx_residency"] = fn(*widths, dx=True, bf16=bf16)
    for spec, bf16 in ((K2, False), (K2_BF16, True)):
        if spec not in specs:
            continue
        # K2's tensor-core kernel at the microbatch's widths: it takes the call
        x, w1, _, _, _, w2, _, lmax = next(iter(captured["so3_gate_ffn_cuda"].values()))[0]
        widths = (lmax, x.shape[2], w1.shape[2], w2.shape[2])
        instance = mods["so3_ffn"].so3_gate_ffn_instance(*widths)
        if instance != "tensor_cores":
            raise AssertionError(f"K2 at {widths} runs {instance}, not the tensor-core kernel")
        results[spec.name]["residency"] = mods["so3_ffn"].gate_fwd_residency(*widths, bf16=bf16)
    if K4 in specs:  # K4's tensor-core kernel at the microbatch's widths: it takes the call
        x, w1, _, _, _, w2, _, tg, _, lmax = next(iter(captured["so3_ffn_cuda"].values()))[0]
        widths = (lmax, x.shape[2], w1.shape[2], w2.shape[2], tg.shape[0])
        instance = mods["so3_ffn"].s2_fwd_instance(*widths)
        if instance != "tensor_cores":
            raise AssertionError(f"K4 at {widths} runs {instance}, not the tensor-core kernel")
        results[K4.name]["residency"] = mods["so3_ffn"].s2_fwd_residency(*widths)
    for fwd, bwd, bf16 in ((K3, K3B, False), (K3_BF16, K3B_BF16, True)):
        if fwd not in specs:
            continue
        # K3's and K3b's tensor-core kernels take the microbatch's calls
        check_k3_instance(mods, captured)
        shapes = sep_shapes(next(iter(captured["s2_silu_sep_cuda"].values()))[0])
        results[fwd.name]["residency"] = mods["s2_act"].sep_residency(*shapes, bf16=bf16)
        results[bwd.name]["residency"] = mods["s2_act"].sep_residency(*shapes, bwd=True,
                                                                      bf16=bf16)
    if K4_BF16 in specs:  # K4's bfloat16 instance takes the call; its residency
        x, w1, _, _, _, w2, _, tg, _, lmax = next(iter(captured["so3_ffn_cuda"].values()))[0]
        widths = (lmax, x.shape[2], w1.shape[2], w2.shape[2], tg.shape[0])
        if mods["so3_ffn"].s2_fwd_instance(*widths, bf16=True) != "tensor_cores":
            raise AssertionError(f"K4·bf16 does not take {widths}")
        results[K4_BF16.name]["residency"] = mods["so3_ffn"].s2_fwd_residency(*widths, bf16=True)
    for spec, bf16 in ((K4B, False), (K4B_BF16, True)):
        if spec not in specs:
            continue
        # K4b's residency at the microbatch's widths
        args = next(iter(captured["so3_ffn_bwd_cuda"].values()))[0]
        x, w1, _, _, _, w2, tg, _, lmax, _ = args
        results[spec.name]["residency"] = mods["so3_ffn"].s2_bwd_residency(
            lmax, x.shape[2], w1.shape[2], w2.shape[2], tg.shape[0], bf16=bf16)
    if K6_BF16 in specs:  # K6·bf16's and K6b·bf16's grid stages at the microbatch's widths
        x, _, _, _, _, _, _, _, tg, _, lmax, mmax, H, F2, alpha_ch = next(
            iter(captured["so2_attn_cuda"].values()))[0]
        for spec, bwd in ((K6_BF16, False), (K6B_BF16, True)):
            results[spec.name]["grid_residency"] = mods["so2_attn"].grid_residency(
                lmax, mmax, x.shape[2], H, F2, alpha_ch, tg.shape[0], bwd=bwd)


def train_vs_cpu(dev, cfg, val_files, suffix: str) -> None:
    """train_vs_cpu: loss and every gradient, the card vs the CPU and the
    card vs a second card run, with the same seeded weights (trained ones
    differ from run to run: the backward of PyTorch's index_select adds with
    atomics); L2 gate and loss within TRAIN_CPU_TOL."""
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss

    small = load_npz(val_files[:2])
    runs = {}
    for run, b in (("cuda", small.to(dev)), ("cuda_again", small.to(dev)), ("cpu", small)):
        model = SINGA(cfg, device=b.protein.x.device, seed=cfg.train.seed)
        kept, hooks = relu_inputs(model)
        loss = cross_entropy_loss(model(b), b.tokens.target)
        loss.backward()
        for h in hooks:
            h.remove()
        runs[run] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}, kept)
        del model, loss
    torch.cuda.empty_cache()
    (l_gpu, g_gpu, r_gpu), (l_again, g_again, r_again), (l_cpu, g_cpu, r_cpu) = runs.values()
    vs_cpu = grad_report(g_gpu, g_cpu, TRAIN_CPU_TOL)
    vs_card = grad_report(g_again, g_gpu, TRAIN_CPU_TOL)
    ok = (vs_cpu["l2"] <= 1.0 and vs_card["l2"] <= 1.0
          and abs(l_gpu - l_cpu) <= TRAIN_CPU_TOL * abs(l_cpu)
          and abs(l_again - l_gpu) <= TRAIN_CPU_TOL * abs(l_gpu))
    emit({"phase": f"train_vs_cpu{suffix}", "complexes": 2, "loss_cuda": l_gpu,
          "loss_cuda_again": l_again, "loss_cpu": l_cpu, "tolerance": TRAIN_CPU_TOL,
          "card_vs_cpu": {**vs_cpu, "relu": relu_flips(r_gpu, r_cpu)},
          "card_vs_card": {**vs_card, "relu": relu_flips(r_again, r_gpu)}, "ok": ok})
    if not ok:
        raise AssertionError("the card's training step disagrees with the CPU's or its own")


def train_vs_cpu_bf16(dev, cfg, s2_cfg, val_files) -> None:
    """train_vs_cpu_bf16: ``cfg`` (configs/train.yml) cut to lmax 2, one
    bfloat16 training step's loss and every gradient on the card (kernels)
    against the CPU (plain twins), 2 complexes, the same seeded weights,
    under no switch (K1·bf16), SINGA_TPU_HYBRID_ATTN (K7·bf16),
    SINGA_TPU_DENSE_ATTN (K8·bf16) and SINGA_TPU_FUSED_SO2 (K6·bf16, form
    ``so2``); and ``s2_cfg`` (configs/train_corpus.yml) cut to lmax 2 (K4·bf16,
    form ``s2``). Both sides round at the same points and sum in other
    orders, so a value near a rounding boundary lands a bfloat16 step apart
    and carries on: the gradients' L2 difference over their L2 norm within
    GAN_BF16_CPU_TOL, the loss within GAN_BF16_LOSS_TOL (gan_vs_cpu_bf16's),
    ``grad_report`` at that tolerance reported; the card's step must launch
    the form's bfloat16 kernels (``launches``, their forward and backward
    counts)."""
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.dtypes import compute_dtype_scope
    from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss

    mods = kernel_modules()
    small = load_npz(val_files[:2])
    lines = {}
    for form, var, c, kernels in (("neighbor", None, cfg, (K1_BF16, K1B_BF16)),
                                  ("hybrid", HYBRID_ATTN, cfg, HYBRID_BF16_PATH),
                                  ("dense", DENSE_ATTN, cfg, DENSE_BF16_PATH),
                                  ("so2", FUSED_SO2, cfg, SO2_BF16_PATH),
                                  ("s2", None, s2_cfg, S2_BF16_PATH)):
        c = tiny_gan_config(c)
        runs = {}
        with switched(var) if var else contextlib.nullcontext():
            for run, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
                model = SINGA(c, device=d, seed=c.train.seed)
                b = small.to(d)
                zero_counts(mods)
                with compute_dtype_scope("bfloat16"):
                    loss = cross_entropy_loss(model(b), b.tokens.target)
                    loss.backward()
                runs[run] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                             read_counts(mods))
                del model, loss, b
        torch.cuda.empty_cache()
        (l_gpu, g_gpu, counts), (l_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
        cat = lambda g: torch.cat([g[n].double().flatten() for n in sorted(g_cpu)])
        l2 = ((cat(g_gpu) - cat(g_cpu)).norm() / cat(g_cpu).norm()).item()
        launched = {k.name: counts[k.name] for k in kernels}
        ok = (l2 <= GAN_BF16_CPU_TOL and abs(l_gpu - l_cpu) <= GAN_BF16_LOSS_TOL * abs(l_cpu)
              and all(launched.values()))
        lines[form] = {"ffn_activation": c.embedding.ffn_activation, "loss_cuda": l_gpu,
                       "loss_cpu": l_cpu, "l2_of_all": l2, "launches": launched,
                       "grads": grad_report(g_gpu, g_cpu, GAN_BF16_CPU_TOL), "ok": ok}
    ok = all(line["ok"] for line in lines.values())
    emit({"phase": "train_vs_cpu_bf16", "compute_dtype": "bfloat16", "lmax": 2, "complexes": 2,
          "tolerance": GAN_BF16_CPU_TOL, "loss_tolerance": GAN_BF16_LOSS_TOL, **lines, "ok": ok})
    if not ok:
        raise AssertionError("train_vs_cpu_bf16: the card's bfloat16 step disagrees with the CPU's")


def train_phases(dev, results: dict, val_files, cfg, suffix: str, specs, per_step: dict,
                 cli_args: list, warmup: int, steps: int, after_cli=None,
                 vs_cpu: bool = True) -> dict:
    """kernel_train, kernel_bwd, train, train_profile, train_vs_cpu (unless
    ``vs_cpu`` is False) and train_cli (each phase name + ``suffix``) under
    ``cfg`` at its compute dtype; returns the train phase's step_ms,
    peak_mem_gb and the profiled step's device busy time; fills
    ``results`` with the lines of the kernels ``specs``, whose launches come
    from this path's train phase. ``per_step``: the launches of every kernel
    that one optimizer step must make (the rest must make none).
    ``after_cli(checkpoints, tmp)``, if given, runs after train_cli with the
    checkpoint directory it wrote and the phases' temporary directory."""
    from singa_tpu_torch.data.dataset import BucketedNpzDataset
    from singa_tpu_torch.data.pipeline import Prefetcher
    from singa_tpu_torch.dtypes import compute_dtype_scope
    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.train.loop import Trainer
    from singa_tpu_torch.train.loop import main as train_main

    mods = kernel_modules()
    train_dir = os.path.join(ROOT, "data", "corpus", "train")
    path = f"train{suffix}"
    micro_size = cfg.train.microbatch or cfg.train.batch_size

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, logdir=os.path.join(tmp, "run"), device=dev)
        data = Prefetcher(BucketedNpzDataset(train_dir, cfg.train.batch_size, seed=0),
                          depth=2, device=dev)
        it = iter(data)

        # kernel_train / kernel_bwd: every call one training microbatch makes
        # of the path's kernels, each distinct one held to its plain version
        first = next(it)
        micro = first.rows(0, micro_size)

        def one_microbatch():
            trainer.model.zero_grad(set_to_none=True)
            with compute_dtype_scope(cfg.train.compute_dtype):
                trainer.loss(micro).backward()

        captured = capture(specs, mods, one_microbatch)
        if K8 in specs:
            dense_lists_lines(mods, captured, suffix)
        results.update(hold_all([k for k in specs if k.outs is None], mods, captured,
                                f"kernel_train{suffix}", "calls_per_microbatch", path))
        results.update(hold_all([k for k in specs if k.outs], mods, captured,
                                f"kernel_bwd{suffix}", "calls_per_microbatch", path))
        gemm_flops = None  # so2_chain.cuh's GEMM operations per optimizer step
        for pair in ((K6, K6B), (K6_BF16, K6B_BF16)):
            if pair[0] in specs:
                micro_per_step = cfg.train.batch_size // micro_size
                gemm_flops = micro_per_step * sum(
                    calls * gemm_split_flops(spec, args) for spec in pair
                    for args, _, calls in captured[f"{spec.fn}_cuda"].values())
        path_instances(specs, mods, captured, results)
        del captured, micro

        # train: warm-up and timed optimizer steps, counts zeroed just before
        zero_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        log = []
        batch = first
        for i in range(warmup + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, gnorm = trainer.train_step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            log.append({"step_ms": ms, "loss": loss.item(), "grad_norm": gnorm.item()})
            batch = next(it)
        n_steps = len(log)
        counts = read_counts(mods)
        for k in specs:
            results[k.name]["launches"] = counts[k.name]
        timed = [s["step_ms"] for s in log[warmup:]]
        step_ms = statistics.median(timed)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        grads_ok = [n for n, p in trainer.model.named_parameters()
                    if p.grad is None or not bool(torch.isfinite(p.grad).all())
                    or not bool((p.grad != 0).any())]
        # a fixed batch: the loss after FIXED_STEPS updates is below the first
        fixed = [trainer.train_step(batch)[0].item() for _ in range(FIXED_STEPS + 1)]
        expected = {n: per_step.get(n, 0) * n_steps for n in counts}
        emit({"phase": path, "ffn_activation": cfg.embedding.ffn_activation,
              "batch": cfg.train.batch_size, "microbatch": cfg.train.microbatch,
              "steps": log, "warmup_steps": warmup, "step_ms": step_ms,
              "graphs_per_s": cfg.train.batch_size / (step_ms / 1e3),
              "peak_mem_gb": peak_gb, "launches": counts,
              "launches_per_step": {n: c / n_steps for n, c in counts.items()},
              "params": trainer.num_params(), "params_without_good_grad": grads_ok,
              "fixed_batch_losses": fixed})
        if counts != expected:
            raise AssertionError(f"launches over {n_steps} steps {counts}, expected {expected}")
        if grads_ok:
            raise AssertionError(f"parameters without a finite non-zero gradient: {grads_ok[:10]}")
        if not fixed[-1] < fixed[0]:
            raise AssertionError(f"loss on a fixed batch did not fall: {fixed}")
        if not all(np.isfinite([s["loss"] for s in log])):
            raise AssertionError(f"non-finite training loss: {log}")

        # train_profile: one optimizer step
        k2b_calls = per_step.get(K2B.name, 0) + per_step.get(K2B_BF16.name, 0)
        k1b_calls = sum(per_step.get(k.name, 0) for k in (K1B, K7B, K1B_BF16, K7B_BF16))
        k1_calls = sum(per_step.get(k.name, 0) for k in (K1, K7, K1_BF16, K7_BF16))
        k2_calls = per_step.get(K2.name, 0) + per_step.get(K2_BF16.name, 0)
        runs_k2b, runs_k1b = k2b_calls > 0, k1b_calls > 0
        runs_k1, runs_k2 = k1_calls > 0, k2_calls > 0
        runs_k4 = per_step.get(K4.name, 0) > 0
        runs_k4_bf16 = per_step.get(K4_BF16.name, 0) > 0
        runs_k3 = sum(per_step.get(k.name, 0) for k in (K3, K3_BF16)) > 0
        # the hand kernels a call of the path launches once each, by name in
        # a profile, with the kernels whose calls launch them and their
        # CUDA-core kernels (one name or a tuple: kernels the path must not run)
        once = [(K1_KERNELS, (K1, K7, K1_BF16, K7_BF16), K1_CC),
                (("gate_ffn_wsplit_kernel",), (K2, K2_BF16), K2_CC),
                (("gate_ffn_bwd_wsplit_kernel",), (K2B, K2B_BF16), K2B_CC),
                (("list_bwd_pair_kernel",), (K1B, K7B, K1B_BF16, K7B_BF16), K1B_CC),
                (K3_KERNELS[:1], (K3, K3_BF16), K3_CC),
                (K3_KERNELS[1:], (K3B, K3B_BF16), K3_CC),
                (K4_BF16_KERNELS[:2], (K4_BF16,), (K4_CC, *K4_F32)),
                (K4_BF16_KERNELS[2:], (K4B_BF16,), K4_CC),
                (K7_BF16_KERNELS[:1], (K7_BF16,), K7_F32[0]),
                (K7_BF16_KERNELS[1:], (K7B_BF16,), K7_F32[1]),
                (K8_BF16_KERNELS[:1], (K8_BF16,), K8_F32[0]),
                (K8_BF16_KERNELS[1:], (K8B_BF16,), (K8_F32[1], *K8B_BF16_CC)),
                (K6_BF16_KERNELS[:3], (K6_BF16, K6B_BF16), K6_F32[0]),
                (K6_BF16_KERNELS[3:5], (K6B_BF16,), K6_F32[2]),
                (K6_BF16_KERNELS[2:3], (K6_BF16, K6B_BF16), K6_F32[3]),
                (K6_BF16_KERNELS[4:5], (K6B_BF16,), K6_F32[4])]
        once = [(tcs, specs, cc) for tcs, specs, cc in once
                if sum(per_step.get(k.name, 0) for k in specs)]
        # the bfloat16 instances of K7/K7b, K8/K8b and K6/K6b by name, their
        # float32 instances beside them
        forms_bf16 = {key: names for key, names, spec in (
            ("k7_bf16_kernels", (*K7_BF16_KERNELS, *K7_F32), K7_BF16),
            ("k8_bf16_kernels", (*K8_BF16_KERNELS, *K8B_BF16_CC, *K8_F32), K8_BF16),
            ("k6_bf16_kernels", (*K6_BF16_KERNELS, *K6_F32), K6_BF16)) if per_step.get(spec.name)}
        with ClockSampler() as clocks:
            prof = device_profile(lambda: trainer.train_step(batch),
                                  (SO2_GEMM,) * (gemm_flops is not None)
                                  + (*K2B_KERNELS, K2B_CC) * runs_k2b
                                  + (*K1B_KERNELS, K1B_CC) * runs_k1b
                                  + (*K1_KERNELS, K1_CC) * runs_k1
                                  + K4_KERNELS * runs_k4 + (*K2_KERNELS, K2_CC) * runs_k2
                                  + (*K4_BF16_KERNELS, K4_CC, *K4_F32) * runs_k4_bf16
                                  + (*K3_KERNELS, K3_CC) * runs_k3
                                  + tuple(n for names in forms_bf16.values() for n in names), mods,
                                  lambda rise: {n: sum(rise[k.name] for k in specs)
                                                for tcs, specs, _ in once for n in tcs})
        extra = {}
        if gemm_flops is not None:  # K6's and K6b's GEMMs: device time and rate
            ms = prof["matched"][SO2_GEMM]["device_ms"]
            extra["so2_gemm"] = {"launches": prof["matched"][SO2_GEMM]["launches"], "device_ms": ms,
                                 "split_tf32_flops": gemm_flops,
                                 "tflop_per_s": gemm_flops / ms / 1e9 if ms else None}
        if runs_k2b:  # K2b's kernels by name, in the profiled step
            extra["k2b_kernels"] = {n: prof["matched"][n] for n in (*K2B_KERNELS, K2B_CC)}
        if runs_k1b:  # K1b's (or K7b's) kernels by name
            extra["k1b_kernels"] = {n: prof["matched"][n] for n in (*K1B_KERNELS, K1B_CC)}
        if runs_k1:  # K1's (or K7's) kernels by name
            extra["k1_kernels"] = {n: prof["matched"][n] for n in (*K1_KERNELS, K1_CC)}
        if runs_k4:  # K4's kernels by name
            extra["k4_kernels"] = {n: prof["matched"][n] for n in K4_KERNELS}
        if runs_k4_bf16:  # K4's and K4b's bfloat16 kernels by name, none of K4's others
            extra["k4_kernels"] = {n: prof["matched"][n]
                                   for n in (*K4_BF16_KERNELS, K4_CC, *K4_F32)}
        if runs_k2:  # K2's kernels by name
            extra["k2_kernels"] = {n: prof["matched"][n] for n in (*K2_KERNELS, K2_CC)}
        if runs_k3:  # K3's and K3b's kernels by name
            extra["k3_kernels"] = {n: prof["matched"][n] for n in (*K3_KERNELS, K3_CC)}
        for key, names in forms_bf16.items():
            extra[key] = {n: prof["matched"][n] for n in names}
        emit({"phase": f"train_profile{suffix}", "step": prof, "clocks": clocks.report, **extra})
        # K1/K7, K2, K1b/K7b, K2b, K3 and K3b ran their tensor-core kernels
        # at every call of the step: K1's plan, tile and copy kernels, K2's
        # weight split, K1b's pair kernel, K2b's weight split and K3's and
        # K3b's kernels once a call, none of their CUDA-core kernels; at
        # bfloat16 K4's bfloat16 kernel and split and K4b's kernel too
        for tcs, specs, cc in once:
            calls = sum(per_step.get(k.name, 0) for k in specs)
            ccs = (cc,) if isinstance(cc, str) else cc
            got = tuple(prof["matched"][n]["launches"] for n in (*tcs, *ccs))
            if got != (calls,) * len(tcs) + (0,) * len(ccs):
                raise AssertionError(f"{(*tcs, *ccs)} launched {got} times in a step, expected "
                                     f"{calls} each and 0")
        data.close()
        summary = {"compute_dtype": cfg.train.compute_dtype, "step_ms": step_ms,
                   "peak_mem_gb": peak_gb, "device_busy_ms": prof["device_busy_ms"],
                   "idle_share": prof["idle_share"]}

        del trainer
        torch.cuda.empty_cache()

        if vs_cpu:
            train_vs_cpu(dev, cfg, val_files, suffix)


        # train_cli: 2 steps through the CLI, then generation from its
        # checkpoint (and the config.yml the trainer wrote beside it)
        logdir = os.path.join(tmp, "cli")
        t1 = time.perf_counter()
        train_main([*cli_args, "--data", os.path.join(ROOT, "data", "corpus"), "--max-iters", "2",
                    "--device", "cuda", "--logdir", logdir])
        train_s = time.perf_counter() - t1
        ckpts = sorted(os.listdir(os.path.join(logdir, "checkpoints")))
        out = os.path.join(tmp, "gen.csv")
        zero_counts(mods)
        gen_main(["--checkpoint", os.path.join(logdir, "checkpoints"), "--input", val_files[0],
                  "--output", out, "--device", "cuda"])
        gen_counts = read_counts(mods)
        with open(out) as f:
            rows = list(csv.reader(f))
        emit({"phase": f"train_cli{suffix}", "args": cli_args, "seconds": train_s,
              "checkpoints": ckpts, "generation_launches": gen_counts,
              "generated": [[r[0][:80], r[1]] for r in rows[1:]]})
        if ckpts != ["2"] or rows[0] != ["smiles", "score"] or len(rows) != 1 + cfg.generate.topk:
            raise AssertionError(f"train CLI wrote {ckpts}; generation wrote {rows}")
        if gen_counts != serve_counts(cfg):
            raise AssertionError(f"generation from the checkpoint launched {gen_counts}")
        if after_cli is not None:
            after_cli(os.path.join(logdir, "checkpoints"), tmp)
    return summary


def val_pdb(tmp: str, name: str | None = None) -> tuple[str, str, str, int]:
    """(val npz, its ligand SDF, a PDB block of its protein nodes written
    under ``tmp``, the block's atom count) of the val complex ``name``, the
    first sorted one by default: ATOM records, 8 atoms a residue named UNK,
    the element in columns 77-78 (the repository holds no PDB)."""
    from singa_tpu_torch.chem.pdb import write_pdb

    vals = os.path.join(ROOT, "data", "corpus", "val")
    val = (os.path.join(vals, name + ".npz") if name
           else sorted(glob.glob(os.path.join(vals, "*.npz")))[0])
    stem = os.path.basename(val)[: -len(".npz")]
    sdf = os.path.join(ROOT, "data", "corpus_raw", stem + "_ligand.sdf")
    with np.load(val) as z:
        m = z["protein.mask"]
        block = write_pdb(z["protein.pos"][m], z["protein.atomic_num"][m])
    pdb = os.path.join(tmp, stem + ".pdb")
    with open(pdb, "w") as f:
        f.write(block)
    return val, sdf, pdb, int(m.sum())


def pdb_phase(dev, ckpt_dir: str, tmp: str) -> None:
    """pdb: one pocket served from a protein PDB and a ligand SDF. The first
    sorted val complex's protein nodes are written as a PDB block (ATOM
    records, 8 atoms a residue named UNK, the element in columns 77-78) and
    paired with that complex's own ligand SDF; generate.main(--input pdb
    --ligand sdf --props --device cuda) serves it from the checkpoint
    train_cli wrote. Raises unless one encode's kernels launch as
    serve_counts says (K1 = 6, K2 = 3, K3 = 3, the rest 0), the CSV has
    1 + topk rows of the seven columns with finite scores, two builds of the
    batch agree bit for bit, and the card's encode_pocket of the PDB-built
    batch lies within CPU_TOL of the CPU's with the same weights. Reports the
    featurization's host seconds (build_from_files, warm imports), encode_ms,
    decode_ms and the valid share (the CLI prints ``valid: n/m``)."""
    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.data.complex_builder import build_from_files
    from singa_tpu_torch.generate.generate import main as gen_main

    val, sdf, pdb, pdb_atoms = val_pdb(tmp)
    cfg = load_config(os.path.join(os.path.dirname(ckpt_dir), "config.yml"))
    want = serve_counts(cfg)
    if {k.name: want[k.name] for k in (K1, K2, K3)} != {K1.name: 6, K2.name: 3, K3.name: 3} or \
            sum(want.values()) != 12:
        raise AssertionError(f"the pdb phase serves the default Config only: {want}")

    feat_s = []
    built = []
    for _ in range(2):
        t1 = time.perf_counter()
        built.append(build_from_files(pdb, sdf, cfg.shapes, cfg.model.decoder.tgt_len))
        feat_s.append(time.perf_counter() - t1)
    leaves = [torch.utils._pytree.tree_leaves(b) for b in built]
    same = len(leaves[0]) == len(leaves[1]) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*leaves))
    batch = built[0]

    mods = kernel_modules()
    out = os.path.join(tmp, "pdb.csv")
    zero_counts(mods)
    t1 = time.perf_counter()
    gen_main(["--checkpoint", ckpt_dir, "--input", pdb, "--ligand", sdf, "--output", out,
              "--props", "--device", "cuda"])
    cli_s = time.perf_counter() - t1
    counts = read_counts(mods)
    with open(out) as f:
        rows = list(csv.reader(f))
    header = ["smiles", "score", "valid", "qed", "sa", "logp", "tpsa"]
    finite = all(np.isfinite(float(r[1])) for r in rows[1:])
    n_valid = sum(r[2] == "1" for r in rows[1:])

    model, enc_ms, decode_ms, vs = card_vs_cpu_encode(ckpt_dir, cfg, batch, dev)
    emit({"phase": "pdb", "complex": os.path.basename(val), "pdb_atoms": pdb_atoms,
          "pocket_atoms": int(batch.protein.mask.sum()), "ligand_atoms": int(batch.ligand.mask.sum()),
          "pl_edges": int(batch.pl.mask.sum()), "featurize_host_s": feat_s,
          "builds_bit_equal": same, "cli_s": cli_s, "launches_per_encode_pocket": counts,
          "encode_ms": enc_ms, "decode_ms": decode_ms, "valid": f"{n_valid}/{len(rows) - 1}",
          "vs_cpu": vs, "rows": [r[:3] for r in rows[1:4]]})
    print(f"pdb valid: {n_valid}/{len(rows) - 1}", flush=True)
    if counts != want:
        raise AssertionError(f"pdb: launches per encode_pocket {counts}, expected {want}")
    if rows[0] != header or len(rows) != 1 + cfg.generate.topk or not finite:
        raise AssertionError(f"pdb: unexpected CLI csv {rows[:3]}")
    if not same:
        raise AssertionError("pdb: two builds of the batch differ")
    if not vs["ok"]:
        raise AssertionError("pdb: card encode_pocket disagrees with the CPU")


def after_train_cli(dev, ckpt_dir: str, tmp: str) -> None:
    """The phases that serve or build data from train_cli's checkpoint: pdb,
    etl, dock."""
    pdb_phase(dev, ckpt_dir, tmp)
    etl_phase(dev, ckpt_dir, tmp)
    dock_phase(tmp)


def card_vs_cpu_encode(ckpt_dir: str, cfg, batch, dev):
    """The checkpoint's model on the card and on the CPU: (card model, its
    warm encode_ms, one beam_generate's decode_ms, the card's encode_pocket
    of the CPU ``batch`` against the CPU's under CPU_TOL)."""
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.train.checkpointing import CheckpointManager

    model = SINGA(cfg, device=dev).eval()
    cpu_model = SINGA(cfg, device="cpu").eval()
    for mdl in (model, cpu_model):
        if CheckpointManager(ckpt_dir).restore(mdl) is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    enc_ms, (enc, pad) = timed_encode(model, batch.to(dev))
    decode_ms = timed_decode(model, enc, pad, cfg)
    with torch.inference_mode():
        enc_cpu, _ = cpu_model.encode_pocket(batch)
    diff = (enc.cpu() - enc_cpu).abs()
    vs = {"max_abs_err": diff.max().item(), "max_abs_value": enc_cpu.abs().max().item(),
          "tolerance": CPU_TOL, "ok": bool(torch.allclose(enc.cpu(), enc_cpu, **CPU_TOL))}
    return model, enc_ms, decode_ms, vs


def etl_phase(dev, ckpt_dir: str, tmp: str) -> None:
    """etl: the port's ETL (``singa_tpu_torch.tools.make_dataset.main
    --index``) on DOCK_COMPLEX's PDB block and its own SDF, then
    ``generate.main(--input <shard> --device cuda)`` serves the shard from
    the checkpoint train_cli wrote. Raises unless the shard was written, one
    encode launches K1 6, K2 3 and K3 3 (the rest 0), the CSV has 1 + topk
    rows with finite scores, the card's encode_pocket of the shard lies
    within CPU_TOL of the CPU's, and the shard's vina label is the float32
    of ``score_complex`` of the same pocket. Reports the Vina library's
    build seconds, the ligand's atoms and torsions and the ETL's host
    seconds for the one complex."""
    from singa_tpu_torch.chem.pdb import PDBProtein
    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.cpp import vina
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.dock import torsion_tree
    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.tools import make_dataset

    t1 = time.perf_counter()
    lib = vina.build()
    build_s = time.perf_counter() - t1
    val, sdf, pdb, _ = val_pdb(tmp, DOCK_COMPLEX)
    index = os.path.join(tmp, "etl_index.txt")
    with open(index, "w") as f:
        f.write(f"{pdb} {sdf} val\n")
    t1 = time.perf_counter()
    shards = make_dataset.main(["--index", index, "--outdir", os.path.join(tmp, "etl")])
    etl_s = time.perf_counter() - t1
    if len(shards) != 1:
        raise AssertionError(f"etl: wrote {shards}")
    shard = shards[0]
    cfg = load_config(os.path.join(os.path.dirname(ckpt_dir), "config.yml"))
    want = serve_counts(cfg)

    mods = kernel_modules()
    out = os.path.join(tmp, "etl.csv")
    zero_counts(mods)
    t1 = time.perf_counter()
    gen_main(["--checkpoint", ckpt_dir, "--input", shard, "--output", out, "--device", "cuda"])
    cli_s = time.perf_counter() - t1
    counts = read_counts(mods)
    with open(out) as f:
        rows = list(csv.reader(f))
    finite = all(np.isfinite(float(r[1])) for r in rows[1:])

    batch = load_npz([shard])
    _, enc_ms, _, vs = card_vs_cpu_encode(ckpt_dir, cfg, batch, dev)
    lig = parse_sdf(sdf)
    pocket, _ = PDBProtein(pdb).pocket(lig.pos, radius=10.0)
    score = vina.score_complex(pocket, lig)
    label = float(batch.props.vina[0])
    with np.load(val) as z:
        stored = float(z["props.vina"])
    emit({"phase": "etl", "complex": os.path.basename(val), "vina_library": os.path.relpath(lib, ROOT),
          "vina_build_s": build_s, "etl_host_s": etl_s, "complexes": 1,
          "pocket_atoms": int(batch.protein.mask.sum()), "ligand_atoms": int(batch.ligand.mask.sum()),
          "torsions": len(torsion_tree(lig).axes), "vina_label": label, "score_complex": score, "corpus_vina_label": stored,
          "cli_s": cli_s, "launches_per_encode_pocket": counts, "encode_ms": enc_ms,
          "vs_cpu": vs, "rows": [[r[0][:80], r[1]] for r in rows[1:3]]})
    if counts != want:
        raise AssertionError(f"etl: launches per encode_pocket {counts}, expected {want}")
    if rows[0] != ["smiles", "score"] or len(rows) != 1 + cfg.generate.topk or not finite:
        raise AssertionError(f"etl: unexpected CLI csv {rows[:3]}")
    if not vs["ok"]:
        raise AssertionError("etl: card encode_pocket of the shard disagrees with the CPU")
    if label != np.float32(score) or label == 0.0:
        raise AssertionError(f"etl: vina label {label}, score_complex {score}")


def redock(pdb: str, sdf: str, poses_sdf: str, seed: int) -> dict:
    """One ``python -m singa_tpu_torch.tools.dock_ligand`` run at
    exhaustiveness 8 and ``seed``, in a process of its own as a user runs
    it; its table, stderr readings and the poses it wrote."""
    from singa_tpu_torch.chem.sdf import parse_sdf

    t1 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "singa_tpu_torch.tools.dock_ligand", pdb, sdf,
                          "--exhaustiveness", "8", "--seed", str(seed), "--out", poses_sdf],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
                         text=True, timeout=300)
    cli_s = time.perf_counter() - t1
    if res.returncode != 0:
        raise AssertionError(f"dock: the CLI failed:\n{res.stdout}\n{res.stderr}")
    table = [ln.split("|") for ln in res.stdout.splitlines() if ln.count("|") == 2][1:]
    err = res.stderr
    with open(poses_sdf) as f:
        poses = [parse_sdf(b + "$$$$\n") for b in f.read().split("$$$$\n") if b.strip()]
    return {"cli_s": cli_s, "scores": [float(r[1]) for r in table], "poses": poses,
            "atoms_torsions": tuple(map(int, re.search(
                r"ligand: (\d+) atoms, (\d+) torsions", err).groups())),
            "input_score": float(re.search(r"input-pose affinity:\s*(\S+)", err).group(1)),
            "search_s": float(re.search(r"search: (\S+)s", err).group(1))}


def dock_phase(tmp: str) -> None:
    """dock: the dock CLI (``redock``) re-docks DOCK_COMPLEX's ligand into
    its PDB block at exhaustiveness 8, at each of REDOCK_SEEDS. Reports the
    ligand's atoms and torsions, the CLI's and the search's host seconds
    (seed 0's are ``dock_host_s``), the input pose's score, and at each seed
    the best score and the best pose's and the nearest pose's RMSD from the
    input pose. Raises unless, at every seed, the poses file holds every
    pose of the table, the best score is finite and no worse than the input
    pose's, every pose keeps the input's bond lengths within BOND_TOL (the
    search moves torsions and the rigid body only), and ``score_complex``
    of every written pose is its table score within RESCORE_TOL."""
    from singa_tpu_torch.chem.pdb import PDBProtein
    from singa_tpu_torch.chem.sdf import parse_sdf
    from singa_tpu_torch.cpp import vina
    from singa_tpu_torch.tools.dock_ligand import rmsd

    _, sdf, pdb, _ = val_pdb(tmp, DOCK_COMPLEX)
    lig = parse_sdf(sdf)
    pocket, _ = PDBProtein(pdb).pocket(lig.pos, radius=10.0)
    ref = np.asarray(lig.pos, np.float64)
    i, j = np.asarray(lig.bonds).T

    def bond_lengths(pos):
        pos = np.asarray(pos, np.float64)
        return np.linalg.norm(pos[i] - pos[j], axis=-1)

    runs = {seed: redock(pdb, sdf, os.path.join(tmp, f"poses_{seed}.sdf"), seed)
            for seed in REDOCK_SEEDS}
    report = {}
    for seed, r in runs.items():
        rmsds = [rmsd(p.pos, ref) for p in r["poses"]]
        bond_err = max(np.abs(bond_lengths(p.pos) - bond_lengths(ref)).max() for p in r["poses"])
        rescore_err = max(abs(vina.score_complex(pocket, p) - sc)
                          for p, sc in zip(r["poses"], r["scores"]))
        report[seed] = {"cli_s": r["cli_s"], "search_s": r["search_s"],
                        "best_score": r["scores"][0], "best_rmsd_from_input": rmsds[0],
                        "nearest_rmsd_from_input": min(rmsds), "poses": len(r["scores"]),
                        "written": len(r["poses"]), "max_bond_err": bond_err,
                        "max_rescore_err": rescore_err, "scores": r["scores"]}
    first = runs[REDOCK_SEEDS[0]]
    atoms, torsions = first["atoms_torsions"]
    emit({"phase": "dock", "complex": DOCK_COMPLEX, "exhaustiveness": 8, "ligand_atoms": atoms,
          "torsions": torsions, "pocket_atoms": pocket.num_atoms,
          "dock_host_s": first["search_s"], "cli_s": first["cli_s"],
          "input_pose_score": first["input_score"], "bond_tol": BOND_TOL,
          "rescore_tol": RESCORE_TOL, "by_seed": report})
    for seed, r in report.items():
        if not r["poses"] or r["written"] != r["poses"]:
            raise AssertionError(f"dock: seed {seed}: {r['poses']} poses, {r['written']} written")
        if not (np.isfinite(r["best_score"]) and r["best_score"] <= first["input_score"]):
            raise AssertionError(f"dock: seed {seed}: best score {r['best_score']}, the input "
                                 f"pose's {first['input_score']}")
        if not (r["max_bond_err"] <= BOND_TOL and r["max_rescore_err"] <= RESCORE_TOL):
            raise AssertionError(f"dock: seed {seed}: bond error {r['max_bond_err']} A, "
                                 f"rescore error {r['max_rescore_err']}")


def kernel_bwd_lmax4(mods) -> None:
    """K2 and K2b at lmax 4 (configs/train_lmax4.yml, configs/gan_recipe.yml),
    C = Co = 16, H 512, a training microbatch's LMAX4_NODES nodes, on seeded
    inputs: each held to its plain version as ``hold`` holds them, timed.
    The GAN phases (gan_kernel) hold the same kernels at the g step's own
    calls."""
    lmax, N, H, C = 4, LMAX4_NODES, 512, 16
    L = lmax + 1
    rng = np.random.default_rng(41)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).cuda()
    x, w1, b1, wg, bg, w2 = (f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
                             0.1 * f(lmax * H), 0.1 * f(L, H, C))
    recs = {K2.name: hold(K2, mods[K2.module], (x, w1, b1, wg, bg, w2, 0.1 * f(C), lmax), {}),
            K2B.name: hold(K2B, mods[K2B.module], (x, w1, b1, wg, bg, w2, lmax, f(N, L * L, C)), {})}
    emit({"phase": "kernel_bwd_lmax4", "lmax": lmax, "nodes": N, "kernels": recs})
    bad = [n for n, r in recs.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"{bad}: kernel disagrees with its plain version at lmax 4")


def serve_counts(cfg) -> dict:
    """The launches of every kernel in one generate_for_pocket: one
    encode_pocket's (embedding stage 1 in gen_mode, then the kNN encoder),
    under the switches as they are set now: K6 in place of K3 with
    SINGA_TPU_FUSED_SO2; K8 in place of K1 with SINGA_TPU_DENSE_ATTN, else
    K7 with SINGA_TPU_HYBRID_ATTN."""
    from singa_tpu_torch.equivariant.attention import _fused_so2_enabled
    from singa_tpu_torch.models.neighbor_graph import _dense_attn, _hybrid_attn

    ffn = K4 if cfg.embedding.ffn_activation == "s2" else K2
    attn = K6 if _fused_so2_enabled() else K3
    encoder = K8 if _dense_attn() else K7 if _hybrid_attn() else K1
    want = {encoder.name: cfg.model.encoder.num_interactions, attn.name: cfg.embedding.num_layers,
            ffn.name: cfg.embedding.num_layers}
    return {k.name: want.get(k.name, 0) for k in KERNELS}


def checked_generate(model, batch, cfg, mods):
    """generate_for_pocket on ``batch``, the counts set to 0 just before and
    read just after: (seconds, smiles, scores, counts). Raises unless every
    kernel launched as ``serve_counts`` says, every pocket got its molecules
    and every score is finite."""
    from singa_tpu_torch.generate.generate import generate_for_pocket

    zero_counts(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smiles, scores = generate_for_pocket(model, batch, cfg)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(mods)
    expected = serve_counts(cfg)
    if counts != expected:
        raise AssertionError(f"launches per encode_pocket {counts}, expected {expected}")
    want = batch.batch_size * cfg.generate.topk
    if len(smiles) != want or not bool(torch.isfinite(torch.as_tensor(scores)).all()):
        raise AssertionError(f"{len(smiles)} molecules (expected {want}), scores {scores}")
    return total_s, smiles, scores, counts


def timed_decode(model, enc, pad, cfg) -> float:
    """The wall time in ms of one beam_generate from an encoding."""
    from singa_tpu_torch.generate.beam import beam_generate

    g = cfg.generate
    with torch.inference_mode():
        prop = torch.tensor([g.prop] * enc.shape[0], dtype=torch.float32, device=enc.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        beam_generate(model, enc, pad, prop, num_beams=g.num_beams, max_length=g.max_length,
                      length_penalty=g.length_penalty, topk=g.topk,
                      grammar_mask=g.grammar_mask, allow_dot=g.allow_dot)
        torch.cuda.synchronize()
    return (time.perf_counter() - t1) * 1e3


def timed_encode(model, batch, n: int = 3):
    """The median wall time of ``n`` warm encode_pocket calls, and the last
    call's output."""
    with torch.inference_mode():
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = model.encode_pocket(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times), out


def vs_cpu(model, cfg, files, dev, phase: str) -> None:
    """encode_pocket on the card (kernels) vs on the CPU (plain versions),
    the same seeded weights, 2 pockets, within CPU_TOL."""
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.models.singa import SINGA

    cpu_model = SINGA(cfg, device="cpu", seed=0).eval()
    small = load_npz(files[:2])
    with torch.inference_mode():
        enc_gpu, _ = model.encode_pocket(small.to(dev))
        enc_cpu, _ = cpu_model.encode_pocket(small)
    diff = (enc_gpu.cpu() - enc_cpu).abs()
    ok = bool(torch.allclose(enc_gpu.cpu(), enc_cpu, **CPU_TOL))
    emit({"phase": phase, "ffn_activation": cfg.embedding.ffn_activation, "pockets": 2,
          "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
          "max_abs_value": enc_cpu.abs().max().item(), "tolerance": CPU_TOL, "ok": ok})
    if not ok:
        raise AssertionError(f"{phase}: card encode_pocket disagrees with the CPU")


def serve_s2_phases(dev, files, batch, mods, results: dict) -> None:
    """kernel_s2, main_s2, vs_cpu_s2 and kernel_s2act under
    configs/train_corpus.yml (serving ignores train.compute_dtype and runs
    in float32); fills ``results`` with K5's and K5b's lines."""
    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.models.singa import SINGA

    cfg = load_config(os.path.join(ROOT, S2_CONFIG))
    model = SINGA(cfg, device=dev, seed=0).eval()

    def encode():
        with torch.inference_mode():
            model.encode_pocket(batch)

    # kernel_s2: K4 at every distinct call of one encode_pocket (K3's
    # inputs are kept for kernel_s2act)
    captured = capture([K3, K4], mods, encode)
    hold_all([K4], mods, captured, "kernel_s2", "calls_per_encode", None)

    total_s, smiles, _, counts = checked_generate(model, batch, cfg, mods)
    enc_ms, _ = timed_encode(model, batch)
    with torch.inference_mode():
        enc_prof = device_profile(lambda: model.encode_pocket(batch))
    emit({"phase": "main_s2", "config": S2_CONFIG, "pockets": 8,
          "launches_per_encode_pocket": counts, "generate_for_pocket_s": total_s,
          "molecules_per_s": len(smiles) / total_s, "encode_ms": enc_ms,
          "encode_profile": enc_prof, "smiles": [s[:80] for s in smiles[:4]]})

    vs_cpu(model, cfg, files, dev, "vs_cpu_s2")
    del model

    # kernel_s2act: K5 and K5b on the s2 FFN's hidden and on the attention's
    # message, each with a seeded cotangent
    (x, w1, b1, _, _, _, _, tg, fg, lmax), _, _ = next(iter(captured["so3_ffn_cuda"].values()))
    (msg, _, tg_m, fg_m), _, _ = next(iter(captured["s2_silu_sep_cuda"].values()))
    del captured
    with torch.no_grad():
        l_of = mods["so3_ffn"]._l_of(lmax, dev)
        hidden = torch.einsum("nic,ich->nih", x, w1.index_select(0, l_of)).contiguous()
        hidden[:, 0] += b1
    gen = torch.Generator(device=dev).manual_seed(0)
    cot = lambda t: torch.randn(t.shape, generator=gen, device=dev)
    # clones made outside inference mode, so the plain backward may save them
    inputs = {"ffn_hidden": (hidden, tg.clone(), fg.clone()),
              "attention_message": (msg.clone(), tg_m.clone(), fg_m.clone())}
    act = {"s2_silu_cuda": {}, "s2_silu_bwd_cuda": {}}
    residency = {K5.name: {}, K5B.name: {}}
    for name, args in inputs.items():
        act["s2_silu_cuda"][name] = [args, {}, 1]
        act["s2_silu_bwd_cuda"][name] = [(*args, cot(args[0])), {}, 1]
        # K5's and K5b's tensor-core kernels take both calls
        shapes = (args[0].shape[1], args[0].shape[2], args[1].shape[0])
        instance = mods["s2_act"].s2_silu_instance(*shapes)
        if instance != "tensor_cores":
            raise AssertionError(f"K5 and K5b at (I, C, G) = {shapes} run {instance}, "
                                 "not the tensor-core kernels")
        residency[K5.name][name] = mods["s2_act"].silu_residency(*shapes)
        residency[K5B.name][name] = mods["s2_act"].silu_residency(*shapes, bwd=True)
    for k, line in hold_all([K5, K5B], mods, act, "kernel_s2act", "calls", None).items():
        # on no path: the runs above assert no launch
        results[k] = {**line, "launches": 0, "residency": residency[k]}
    del act, inputs, hidden


def serve_so2_phases(dev, files, batch, mods, cfg) -> None:
    """kernel_so2, main_so2 and vs_cpu_so2: the default Config's serving path
    with SINGA_TPU_FUSED_SO2 set (the caller sets it), K6 in every
    GraphAttention; main_so2 also holds the fused encode to the unfused one
    on the card, at the same seeded weights."""
    from singa_tpu_torch.models.singa import SINGA

    model = SINGA(cfg, device=dev, seed=0).eval()

    def encode():
        with torch.inference_mode():
            model.encode_pocket(batch)

    # kernel_so2: K6 at every distinct call of one encode_pocket
    hold_all([K6], mods, capture([K6], mods, encode), "kernel_so2", "calls_per_encode", None)

    total_s, smiles, _, counts = checked_generate(model, batch, cfg, mods)
    enc_ms, (enc, pad) = timed_encode(model, batch)
    decode_ms = timed_decode(model, enc, pad, cfg)
    with torch.inference_mode():
        enc_prof = device_profile(lambda: model.encode_pocket(batch))
        os.environ.pop(FUSED_SO2)
        try:
            unfused, _ = model.encode_pocket(batch)
        finally:
            os.environ[FUSED_SO2] = "1"
        diff = (enc - unfused).abs()
        ok = bool(torch.allclose(enc, unfused, **CPU_TOL))
    emit({"phase": "main_so2", FUSED_SO2: "1", "pockets": 8, "launches_per_encode_pocket": counts,
          "generate_for_pocket_s": total_s, "molecules_per_s": len(smiles) / total_s,
          "encode_ms": enc_ms, "decode_ms": decode_ms, "encode_profile": enc_prof,
          "vs_unfused": {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
                         "tolerance": CPU_TOL, "ok": ok},
          "smiles": [s[:80] for s in smiles[:4]]})
    if not ok:
        raise AssertionError("so2: the fused encode_pocket disagrees with the unfused one")
    del enc, pad, unfused

    vs_cpu(model, cfg, files, dev, "vs_cpu_so2")


def serve_form_phases(dev, files, batch, mods, cfg, form: str) -> None:
    """kernel_<form>, main_<form> and vs_cpu_<form>: the default Config's
    serving path with the form's switch set (the caller sets it), K7
    (hybrid) or K8 (dense) in every encoder-1 layer. main_<form> also runs
    the K1 encode on the card at the same weights: the hybrid encode is the
    same function and is held to it within CPU_TOL; the dense one attends
    over the untruncated adjacency, so its difference is reported beside
    the rows whose in-degree exceeds K, and not gated."""
    from singa_tpu_torch.models.neighbor_graph import build_neighbor_graph
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.ops.cuda.dense_edge_attn import BIG

    spec, var = (K7, HYBRID_ATTN) if form == "hybrid" else (K8, DENSE_ATTN)
    model = SINGA(cfg, device=dev, seed=0).eval()

    def encode():
        with torch.inference_mode():
            model.encode_pocket(batch)

    captured = capture([spec], mods, encode)
    hold_all([spec], mods, captured, f"kernel_{form}", "calls_per_encode", None)
    if form == "dense":
        for args, kw, calls in captured[f"{K8.fn}_cuda"].values():
            emit({"phase": "dense_lists", "name": K8.name, "calls_per_encode": calls,
                  **dense_lists_report(args, kw),
                  "row_order": row_order_ms(mods[K8.module].dense_edge_attn_cuda, args, kw)})
    del captured

    total_s, smiles, _, counts = checked_generate(model, batch, cfg, mods)
    enc_ms, (enc, pad) = timed_encode(model, batch)
    decode_ms = timed_decode(model, enc, pad, cfg)
    with torch.inference_mode():
        enc_prof = device_profile(lambda: model.encode_pocket(batch))
        os.environ.pop(var)
        try:
            k1_enc, _ = model.encode_pocket(batch)
        finally:
            os.environ[var] = "1"
        diff = (enc - k1_enc).abs()
        same = bool(torch.allclose(enc, k1_enc, **CPU_TOL))
        e = cfg.model.encoder
        g = build_neighbor_graph(batch.protein.pos, batch.protein.mask, e.knn, e.smear_stop,
                                 e.edge_channels, with_adj_dist=True)
        live = g.adj_dist < 0.5 * BIG
        graph = {"K": g.nbr.shape[2], "rows": live.shape[0] * live.shape[1],
                 "padded_rows": int((~batch.protein.mask).sum()),
                 "rows_in_degree_over_K": int((live.sum(-1) > g.nbr.shape[2]).sum()),
                 "largest_in_degree": int(live.sum(-1).max()),
                 "live_pair_share": float(live.float().mean())}
        del g, live
    vs_k1 = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
             "tolerance": CPU_TOL, "within_tolerance": same}
    emit({"phase": f"main_{form}", var: "1", "pockets": 8, "launches_per_encode_pocket": counts,
          "generate_for_pocket_s": total_s, "molecules_per_s": len(smiles) / total_s,
          "encode_ms": enc_ms, "decode_ms": decode_ms, "encode_profile": enc_prof,
          "vs_k1_encode": vs_k1, "graph": graph, "smiles": [s[:80] for s in smiles[:4]]})
    if form == "hybrid" and not same:
        raise AssertionError("hybrid: the K7 encode_pocket disagrees with the K1 one")
    del enc, pad, k1_enc

    vs_cpu(model, cfg, files, dev, f"vs_cpu_{form}")


@contextlib.contextmanager
def gan_round_timer(mods, rounds: list):
    """While the block runs, every ``GANTrainer.train_round`` appends to
    ``rounds`` its host ms (with ``torch.cuda.synchronize`` before and after
    each part) split into sample, host bridge, d, graph-D and g, and the
    launches of every kernel in that round (the counters' difference)."""
    from singa_tpu_torch.train.gan import GANTrainer

    parts = {"sample": "sample", "_host_bridge": "host_bridge", "d_step": "d", "d_eval": "d",
             "gd_step": "graph_d", "gd_eval": "graph_d", "g_step": "g"}
    originals = {n: getattr(GANTrainer, n) for n in (*parts, "train_round")}
    current: dict = {}

    def timed(name):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *args, **kw)
            torch.cuda.synchronize()
            if current:  # outside a round (the quality samples) nothing is split
                current[parts[name]] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def train_round(self, *args, **kw):
        before = read_counts(mods)
        current.update(dict.fromkeys(parts.values(), 0.0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["train_round"](self, *args, **kw)
        torch.cuda.synchronize()
        after = read_counts(mods)
        rounds.append({"round_ms": (time.perf_counter() - t0) * 1e3, "host_ms": dict(current),
                       "launches": {n: after[n] - before[n] for n in after}})
        current.clear()
        return out

    for name in parts:
        setattr(GANTrainer, name, timed(name))
    GANTrainer.train_round = train_round
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(GANTrainer, name, fn)


def gan_round_counts(cfg) -> dict:
    """The launches of every kernel in one adversarial round (d and g steps
    1): two encode_pockets (the sample's and the g step's) and one backward
    through the second; at the config's compute dtype (bfloat16: the
    bfloat16 instances, every float32 count 0)."""
    enc_layers, blocks = cfg.model.encoder.num_interactions, cfg.embedding.num_layers
    k1, k2, k3, k1b, k2b, k3b = (BF16_PATH if cfg.train.compute_dtype == "bfloat16"
                                 else GATE_PATH)
    want = {k1.name: 2 * enc_layers, k2.name: 2 * blocks, k3.name: 2 * blocks,
            k1b.name: enc_layers, k2b.name: blocks, k3b.name: blocks}
    return {k.name: want.get(k.name, 0) for k in KERNELS}


def gan_phase(dev, files, mods, cfg, cfg_path: str, suffix: str, n_rounds: int,
              vina_eval: int) -> None:
    """gan{suffix}: ``python -m singa_tpu_torch.train.gan`` as a user runs it
    under ``cfg_path`` (``cfg``, at its compute dtype) at batch 64 (2 CE
    warm-up steps, ``n_rounds`` rounds, WGAN-GP, grammar mask, a quality
    sample each round), the counts set to 0 just before and read just after;
    with ``vina_eval``, gan_vina_eval{suffix}: its --vina-eval report, whose
    three keys must be there (after 2 CE steps few samples parse, so it may
    dock none: gan_vina is the phase that holds docking to a count); then
    gan_generate{suffix}: the generation CLI serves one val pocket from the
    final checkpoint."""
    from singa_tpu_torch.generate.generate import main as gen_main
    from singa_tpu_torch.train import gan

    per_round = gan_round_counts(cfg)
    path = GATE_PATH if cfg.train.compute_dtype == "float32" else BF16_PATH
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "gan")
        rounds: list = []
        vina_eval_s = []
        docked = gan.vina_conditioning_host

        def timed_vina(*args, **kw):
            t1 = time.perf_counter()
            out = docked(*args, **kw)
            vina_eval_s.append(time.perf_counter() - t1)
            return out

        zero_counts(mods)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gan.vina_conditioning_host = timed_vina
        try:
            with gan_round_timer(mods, rounds):
                gan.main(["--config", cfg_path,
                          "--data", os.path.join(ROOT, "data", "corpus"), "--batch-size", "64",
                          "--graph-loss", "wgan-gp", "--grammar-mask",
                          "--pretrain", str(GAN_PRETRAIN), "--rounds", str(n_rounds),
                          "--eval-every", "1", "--vina-eval", str(vina_eval),
                          "--device", "cuda", "--logdir", logdir])
        finally:
            gan.vina_conditioning_host = docked
        cli_s = time.perf_counter() - t0
        counts = read_counts(mods)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            metrics = [json.loads(ln) for ln in f]
        losses = [{k.split("/")[1]: m[k] for k in m if k.startswith("gan/")} for m in metrics[:-1]]
        emit({"phase": f"gan{suffix}", "config": os.path.relpath(cfg_path, ROOT),
              "compute_dtype": cfg.train.compute_dtype, "batch": 64, "rounds": n_rounds,
              "pretrain_steps": GAN_PRETRAIN, "cli_s": cli_s, "vina_eval": vina_eval,
              "vina_eval_s": vina_eval_s, "per_round": rounds,
              "launches_per_round_expected": per_round, "launches": counts, "losses": losses,
              "pct_valid": [m.get("gan/pct_valid") for m in metrics[:-1]],
              "quality": [{k.split("/")[1]: m[k] for k in m if k.startswith("quality/")}
                          for m in metrics], "peak_mem_gb": peak_gb})
        for r in rounds:
            if r["launches"] != per_round:
                raise AssertionError(f"gan: a round launched {r['launches']}, expected {per_round}")
        if len(rounds) != n_rounds or any(counts[k.name] == 0 for k in path):
            raise AssertionError(f"gan: {len(rounds)} rounds, launches {counts}")
        bad = [ln for ln in losses if not all(np.isfinite(list(ln.values())))]
        if bad or len(losses) != n_rounds:
            raise AssertionError(f"gan: non-finite losses {losses}")
        final = metrics[-1]
        if vina_eval:
            vina_report = {k: final.get(f"quality/{k}") for k in VINA_KEYS}
            emit({"phase": f"gan_vina_eval{suffix}", "vina_eval": vina_eval,
                  "vina_eval_s": vina_eval_s, **vina_report})
            if len(vina_eval_s) != 1 or any(v is None for v in vina_report.values()) \
                    or not 0 <= vina_report["n_vina_scored"] <= vina_eval:
                raise AssertionError(f"gan: --vina-eval ran {len(vina_eval_s)} times, "
                                     f"report {final}")

        # the final checkpoint serves one val pocket through the generation CLI
        out = os.path.join(tmp, "gan.csv")
        zero_counts(mods)
        gen_main(["--checkpoint", logdir, "--input", files[0], "--output", out, "--device", "cuda"])
        gen_counts = read_counts(mods)
        with open(out) as f:
            rows = list(csv.reader(f))
        emit({"phase": f"gan_generate{suffix}",
              "checkpoints": sorted(os.listdir(os.path.join(logdir, "checkpoints"))),
              "launches": gen_counts, "rows": [[r[0][:80], r[1]] for r in rows[1:]]})
        if rows[0] != ["smiles", "score"] or len(rows) != 1 + cfg.generate.topk:
            raise AssertionError(f"gan_generate wrote {rows}")
        if gen_counts != serve_counts(cfg):
            raise AssertionError(f"gan_generate launched {gen_counts}")


def gan_kernel_phase(dev, mods, cfg, suffix: str = "", profile_round: bool = True) -> None:
    """gan_kernel{suffix}: every distinct kernel call of one g step at full
    width (64 train complexes, tokens sampled by the port) at the config's
    compute dtype, each held to its plain version (at bfloat16 its twin,
    ``BF16_TOL``) and timed as kernel_train holds them; the calls must take
    the tensor-core kernels (K2, K3, K3b at lmax 4). Then
    gan_profile{suffix}: one round (sample, host bridge, d, graph-D, g)
    under the profiler, or (``profile_round`` False: the float32 path, cut
    to stay within the script's time) its g step alone, a twentieth of
    the round's device events."""
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.train import gan

    specs = GATE_PATH if cfg.train.compute_dtype == "float32" else BF16_PATH
    train_files = sorted(glob.glob(os.path.join(ROOT, "data", "corpus", "train", "*.npz")))[:64]
    batch = load_npz(train_files).to(dev)
    tr = gan.GANTrainer(cfg, graph_loss="wgan-gp", grammar_mask=True)
    tr.init(SINGA(cfg, device=dev, seed=0), 1)
    rng = torch.Generator(device=dev).manual_seed(0)
    tokens = tr.sample(batch, rng)
    chem_r, fake = tr._host_bridge(tokens)
    captured = capture(specs, mods, lambda: tr.g_step(batch, tokens, chem_r, fake))
    phase = f"gan_kernel{suffix}"
    lines = hold_all([k for k in specs if k.outs is None], mods, captured, phase,
                     "calls_per_g_step", "gan")
    lines.update(hold_all([k for k in specs if k.outs], mods, captured, phase,
                          "calls_per_g_step", "gan"))
    path_instances(specs, mods, captured, lines)
    emit({"phase": phase, "compute_dtype": cfg.train.compute_dtype, "lmax": cfg.embedding.lmax,
          "batch": 64, "valid_fakes": float(fake[3].sum()),
          "kernels": {n: {k: v[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "max_abs_err", "residency") if k in v}
                      for n, v in lines.items()}})
    del captured
    # gan_profile: where one round's (or g step's) time goes (device busy,
    # idle share, the costliest device ops)
    if profile_round:
        prof = {"round": device_profile(lambda: tr.train_round(batch, rng))}
    else:
        prof = {"g_step": device_profile(lambda: tr.g_step(batch, tokens, chem_r, fake))}
    emit({"phase": f"gan_profile{suffix}", "batch": 64, **prof})


def gan_vs_cpu_phase(dev, files, cfg, suffix: str = "") -> None:
    """gan_vs_cpu{suffix}: one g step's loss and generator gradients, 2
    complexes, on the card (kernels) and on the CPU (plain versions), with
    the same seeded weights and the tokens the card sampled, at the
    config's compute dtype. float32 (the recipe's widths): every leaf by
    ``grad_report`` under TRAIN_CPU_TOL. bfloat16 (``cfg`` cut to lmax 2,
    where the CPU's bfloat16 is cheap): the gradients' L2 difference over
    their L2 norm within GAN_BF16_CPU_TOL, the loss and reward within
    GAN_BF16_LOSS_TOL, ``grad_report`` at that tolerance reported."""
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.train import gan

    bf16 = cfg.train.compute_dtype == "bfloat16"
    small = load_npz(files[:2])
    runs = {}
    tokens = None
    for run, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        tr = gan.GANTrainer(cfg, graph_loss="wgan-gp", grammar_mask=True)
        tr.init(SINGA(cfg, device=d, seed=0), 1)
        b = small.to(d)
        if tokens is None:
            tokens = tr.sample(b, torch.Generator(device=d).manual_seed(0)).cpu()
        chem_r, fake = tr._host_bridge(tokens.to(d))
        with tr._precision():
            loss, reward, _ = tr.g_loss(b, tokens.to(d), chem_r, fake)
            loss.backward()
        runs[run] = (loss.item(), reward.item(), float(fake[3].sum()),
                     {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                      for n, p in tr.generator.named_parameters()})
        del tr, b, loss
    (l_gpu, r_gpu, v_gpu, g_gpu), (l_cpu, r_cpu, v_cpu, g_cpu) = runs["cuda"], runs["cpu"]
    if bf16:
        tol, loss_tol = GAN_BF16_CPU_TOL, GAN_BF16_LOSS_TOL
        cat = lambda g: torch.cat([g[n].double().flatten() for n in sorted(g_cpu)])
        l2 = ((cat(g_gpu) - cat(g_cpu)).norm() / cat(g_cpu).norm()).item()
        report = {"l2_of_all": l2, **grad_report(g_gpu, g_cpu, tol)}
        grads_ok = l2 <= tol
    else:
        tol = loss_tol = TRAIN_CPU_TOL
        report = grad_report(g_gpu, g_cpu, tol)
        grads_ok = report["l2"] <= 1.0
    ok = (grads_ok and abs(l_gpu - l_cpu) <= loss_tol * abs(l_cpu)
          and abs(r_gpu - r_cpu) <= loss_tol * abs(r_cpu) and v_gpu == v_cpu)
    emit({"phase": f"gan_vs_cpu{suffix}", "compute_dtype": cfg.train.compute_dtype,
          "lmax": cfg.embedding.lmax, "complexes": 2, "valid_fakes": v_gpu,
          "g_loss_cuda": l_gpu, "g_loss_cpu": l_cpu, "reward_cuda": r_gpu, "reward_cpu": r_cpu,
          "leaves": len(g_cpu), "leaves_with_grad": sum(bool((g != 0).any()) for g in g_cpu.values()),
          "tolerance": tol, "loss_tolerance": loss_tol, "grads": report, "ok": ok})
    if not ok:
        raise AssertionError(f"gan_vs_cpu{suffix}: the card's g step disagrees with the CPU's")


def gan_vina_phase(dev) -> None:
    """gan_vina: ``vina_conditioning_host`` on the first 8 sorted
    data/corpus/train complexes as a batch on the card, with the ligands'
    own SMILES as the sampled tokens (a CUDA tensor), against the same call
    on the batch's CPU copy. Raises unless the two dicts are equal and at
    least 4 molecules docked; reports each call's host seconds."""
    from singa_tpu_torch.config import SOS_TOKEN
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.train.rewards import vina_conditioning_host

    files = sorted(glob.glob(os.path.join(ROOT, "data", "corpus", "train", "*.npz")))[:8]
    batch = load_npz(files)
    tgt = batch.tokens.target.long()
    tokens = torch.cat([torch.full_like(tgt[:, :1], SOS_TOKEN), tgt[:, :-1]], 1)
    got = {}
    for run, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        t1 = time.perf_counter()
        out = vina_conditioning_host(batch.to(d), tokens.to(d), n_eval=8)
        got[run] = (out, time.perf_counter() - t1)
    (card, card_s), (cpu, cpu_s) = got["cuda"], got["cpu"]
    same = card.keys() == cpu.keys() and all(
        card[k] == cpu[k] or (math.isnan(card[k]) and math.isnan(cpu[k])) for k in card)
    emit({"phase": "gan_vina", "rows": 8, "cuda": card, "cpu": cpu, "vina_eval_s": card_s,
          "vina_eval_cpu_batch_s": cpu_s, "equal": same})
    if not same:
        raise AssertionError(f"gan_vina: the card batch gives {card}, its CPU copy {cpu}")
    if card["n_vina_scored"] < 4:
        raise AssertionError(f"gan_vina: only {card['n_vina_scored']} of 8 molecules docked")


def tiny_gan_config(cfg):
    """``cfg`` cut to lmax 2 (mmax 2; the featurizer's width with it), its
    other widths as they are: gan_vs_cpu_bf16's, where a CPU step at
    bfloat16 is cheap."""
    import dataclasses

    emb = dataclasses.replace(cfg.embedding, lmax=2, mmax=2)
    model = dataclasses.replace(cfg.model, featurizer_feat_dim=emb.sphere_channels * 9)
    return dataclasses.replace(cfg, embedding=emb, model=model)


def gan_phases(dev, files, mods) -> None:
    """Under configs/gan_recipe.yml (lmax 4, gate FFN, batch 64): at its own
    bfloat16, as a user runs it, gan_bf16 (with the --vina-eval report),
    gan_kernel_bf16 / gan_profile_bf16 and gan_vs_cpu_bf16 (lmax 2); then
    in float32, through a float32 copy of the file, gan (GAN_F32_ROUNDS
    rounds), gan_vina, gan_kernel / gan_profile (its g step alone) and
    gan_vs_cpu."""
    from singa_tpu_torch.config import load_config
    from singa_tpu_torch.train.checkpointing import save_config
    from singa_tpu_torch.train.loop import float32_config

    recipe = os.path.join(ROOT, GAN_CONFIG)
    cfg = load_config(recipe)
    if cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"{GAN_CONFIG} trains in {cfg.train.compute_dtype}")
    gan_phase(dev, files, mods, cfg, recipe, "_bf16", GAN_ROUNDS, GAN_VINA_EVAL)
    torch.cuda.empty_cache()
    gan_kernel_phase(dev, mods, cfg, "_bf16")
    torch.cuda.empty_cache()
    gan_vs_cpu_phase(dev, files, tiny_gan_config(cfg), "_bf16")
    torch.cuda.empty_cache()
    f32 = float32_config(cfg)
    with tempfile.TemporaryDirectory() as f32_dir:
        save_config(f32_dir, f32)
        gan_phase(dev, files, mods, f32, os.path.join(f32_dir, "config.yml"), "",
                  GAN_F32_ROUNDS, 0)
    gan_vina_phase(dev)
    torch.cuda.empty_cache()
    gan_kernel_phase(dev, mods, f32, profile_round=False)
    torch.cuda.empty_cache()
    gan_vs_cpu_phase(dev, files, f32)
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    for var in (FUSED_SO2, HYBRID_ATTN, DENSE_ATTN):  # each switch is set for its phases only
        os.environ.pop(var, None)
    from singa_tpu_torch.config import Config, load_config
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.generate.beam import beam_generate
    from singa_tpu_torch.generate.generate import main as cli_main
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.ops.cuda import build
    from singa_tpu_torch.train.checkpointing import save_config
    from singa_tpu_torch.train.loop import float32_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "tf32": False})

    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    # K4b's kernel, and K4's tensor-core kernel's instances; float32, and
    # (bf16) K4's and K4b's bfloat16 instances with K4's split
    k4b_all = ptxas_report(logs["so3_ffn_bwd"])
    k4b_ptxas = {k: v for k, v in k4b_all.items() if "bfloat16" not in k}
    k4_all = ptxas_report(logs["so3_ffn"])
    k4_ptxas = {k: v for k, v in k4_all.items() if "ffn_tc_kernel" in k and "bfloat16" not in k}
    k4_bf16_ptxas = {k: v for k, v in k4_all.items() if "bfloat16" in k or "wfrag" in k}
    k4b_bf16_ptxas = {k: v for k, v in k4b_all.items() if "bfloat16" in k}
    # the dx, weight and split kernels, their float32 instances and (bf16)
    # their bfloat16 ones (the CUDA-core instance's among both)
    k2b_all = {k: v for k, v in ptxas_report(logs["so3_gate_ffn_bwd"]).items()
               if "gate_ffn_bwd_" in k}
    k2b_ptxas = {k: v for k, v in k2b_all.items() if "bfloat16" not in k}
    k2b_bf16_ptxas = {k: v for k, v in k2b_all.items() if "bfloat16" in k}
    # K2's tensor-core kernel (its instances for every row count) and split at
    # 16 channels in and out, and its CUDA-core instance; float32, and (bf16)
    # bfloat16
    k2_all = {k: v for k, v in ptxas_report(logs["so3_gate_ffn"]).items()
              if "ILi16ELi16E" in k or "cc15gate_ffn_kernel" in k}
    k2_ptxas = {k: v for k, v in k2_all.items() if "bfloat16" not in k}
    k2_bf16_ptxas = {k: v for k, v in k2_all.items() if "bfloat16" in k}
    # K3's and K3b's kernels: the tensor-core ones (with their dynamic shared
    # memory and threads at the main path's I 29, C 128, G 70) and the
    # CUDA-core instance
    from singa_tpu_torch.ops.cuda.s2_act import sep_residency

    k3_all = {k: v for k, v in ptxas_report(logs["s2_act"]).items() if "s2_silu_sep" in k}
    for k, v in k3_all.items():
        if "tc_kernel" in k:
            v["residency"] = sep_residency(29, 128, 70, bwd="bwd" in k, bf16="bfloat16" in k)
    k3_ptxas = {k: v for k, v in k3_all.items() if "bfloat16" not in k}
    k3_bf16_ptxas = {k: v for k, v in k3_all.items() if "bfloat16" in k}
    # K5's and K5b's kernels: the tensor-core ones (an instance a form: I <=
    # 32, 33 .. 48, 49 with the tail row) and the CUDA-core instance
    k5_ptxas = {k: v for k, v in ptxas_report(logs["s2_act"]).items()
                if "s2_silu_tc_kernel" in k or "s2_silu_bwd_tc_kernel" in k
                or "s2_silu_kernel" in k}
    # K6's and K6b's GEMM kernels (float32), and (bf16) their bfloat16
    # stages: the GEMM on bfloat16 operands, the rotation, the grid, the
    # weights' rounding
    so2_all = {n: ptxas_report(logs[n]) for n in ("so2_attn", "so2_attn_bwd")}
    is_bf16 = lambda k: "Bf16In" in k or "bfloat16" in k or "round_weights" in k
    gemm_ptxas = {n: {k: v for k, v in r.items() if "gemm_kernel" in k and not is_bf16(k)}
                  for n, r in so2_all.items()}
    k6_bf16_ptxas = {n: {k: v for k, v in r.items() if is_bf16(k)} for n, r in so2_all.items()}
    # the pair kernels of K1b (form 0: ILi0E) and of K7b (form 1: ILi1E):
    # tensor cores (list_bwd_pair_kernel) and CUDA cores (list_bwd_cc_kernel)
    k1b_all = {k: v for k, v in ptxas_report(logs["neighbor_attn_bwd"]).items()
               if "list_bwd_pair_kernel" in k or "list_bwd_cc_kernel" in k}
    k1b_ptxas = [{k: v for k, v in k1b_all.items() if f"ILi{form}E" in k and "bfloat16" not in k}
                 for form in (0, 1)]
    k1b_bf16_ptxas = [{k: v for k, v in k1b_all.items() if f"ILi{form}E" in k and "bfloat16" in k}
                      for form in (0, 1)]  # K1b's and K7b's bfloat16 instances
    # K8b·bf16's tensor-core kernels: the list kernels' dense form (2), its plan
    k8b_bf16_ptxas = {k: v for k, v in ptxas_report(logs["neighbor_attn_bwd"]).items()
                      if "ILi2E" in k or "dense_plan_kernel" in k}
    # the forward kernels of K1 (form 0) and K7 (form 1): the tensor-core
    # tile kernel and the CUDA-core instance (attn_fwd_kernel); float32, and
    # K1's bfloat16 instance's
    k1_all = {k: v for k, v in ptxas_report(logs["neighbor_attn"]).items()
              if "list_fwd_tile_kernel" in k or "attn_fwd_kernel" in k}
    k1_ptxas = [{k: v for k, v in k1_all.items() if f"ILi{form}E" in k and "bfloat16" not in k}
                for form in (0, 1)]
    k1_bf16_ptxas = [{k: v for k, v in k1_all.items() if f"ILi{form}E" in k and "bfloat16" in k}
                     for form in (0, 1)]  # K1's and K7's bfloat16 instances
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": sorted(logs), "ptxas": ptxas,
          "dense_ptxas": {n: ptxas_report(logs[n]) for n in ("dense_edge_attn",
                                                             "dense_edge_attn_bwd")},
          "k4_ptxas": k4_ptxas, "k4b_ptxas": k4b_ptxas, "k2_ptxas": k2_ptxas,
          "k2b_ptxas": k2b_ptxas, "k3_ptxas": k3_ptxas, "k5_ptxas": k5_ptxas,
          "so2_gemm_ptxas": gemm_ptxas,
          "k1b_ptxas": k1b_ptxas, "k1_ptxas": k1_ptxas,
          "k1b_bf16_ptxas": k1b_bf16_ptxas, "k2b_bf16_ptxas": k2b_bf16_ptxas,
          "k1_bf16_ptxas": k1_bf16_ptxas, "k2_bf16_ptxas": k2_bf16_ptxas,
          "k3_bf16_ptxas": k3_bf16_ptxas, "k4_bf16_ptxas": k4_bf16_ptxas,
          "k4b_bf16_ptxas": k4b_bf16_ptxas, "k6_bf16_ptxas": k6_bf16_ptxas,
          "k8b_bf16_ptxas": k8b_bf16_ptxas})

    emit({"phase": "mma_rate",
          **mma_rate(torch.cuda.get_device_properties(0).multi_processor_count)})
    kernel_bwd_lmax4(kernel_modules())
    torch.cuda.empty_cache()

    # the main path's batch and model
    files = sorted(glob.glob(os.path.join(ROOT, "data", "corpus", "val", "*.npz")))[:8]
    if len(files) != 8:
        raise RuntimeError(f"expected 8 val pockets, found {len(files)}")
    cfg = Config()
    batch = load_npz(files).to(dev)
    model = SINGA(cfg, device=dev, seed=0).eval()

    # kernel: each forward kernel's calls in one encode_pocket (also a
    # warm-up), held to its plain version. The kernels line takes its numbers
    # from the training path (train_phases)
    mods = kernel_modules()

    def encode():
        with torch.inference_mode():
            model.encode_pocket(batch)

    captured = capture([K1, K2, K3], mods, encode)
    check_k3_instance(mods, captured)
    hold_all([K1, K2, K3], mods, captured, "kernel", "calls_per_encode", None)
    del captured

    # main path: counts set to 0 just before, read just after
    total_s, smiles, scores, counts = checked_generate(model, batch, cfg, mods)

    # the two halves timed on their own (warm)
    enc_ms, (enc, pad) = timed_encode(model, batch)
    torch.cuda.reset_peak_memory_stats()
    decode_ms = timed_decode(model, enc, pad, cfg)
    emit({"phase": "main", "pockets": 8, "launches_per_encode_pocket": counts,
          "generate_for_pocket_s": total_s, "molecules_per_s": len(smiles) / total_s,
          "encode_ms": enc_ms, "decode_ms": decode_ms,
          "decode_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "scores": [float(s) for s in scores],
          "smiles": [s[:80] for s in smiles[:4]]})

    # where the time goes: device busy and idle share of one encode_pocket and
    # of the first PROFILE_STEPS decode steps
    g = cfg.generate
    with torch.inference_mode():
        prop = torch.tensor([g.prop] * 8, dtype=torch.float32, device=dev)
        enc_prof = device_profile(lambda: model.encode_pocket(batch))
        dec_prof = device_profile(lambda: beam_generate(
            model, enc, pad, prop, num_beams=g.num_beams, max_length=PROFILE_STEPS + 1,
            length_penalty=g.length_penalty, topk=g.topk, grammar_mask=g.grammar_mask,
            allow_dot=g.allow_dot))
    emit({"phase": "profile", "encode_pocket": enc_prof,
          f"decode_{PROFILE_STEPS}_steps": dec_prof})
    del enc, pad

    # the card (kernels) vs the CPU (plain versions), same weights, 2 pockets
    vs_cpu(model, cfg, files, dev, "vs_cpu")

    # the CLI on one pocket with the seeded weights
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        out = os.path.join(tmp, "out.csv")
        torch.save(model.state_dict(), ckpt)
        t1 = time.perf_counter()
        cli_main(["--checkpoint", ckpt, "--input", files[0], "--output", out,
                  "--device", "cuda"])
        cli_s = time.perf_counter() - t1
        with open(out) as f:
            rows = list(csv.reader(f))
    if rows[0] != ["smiles", "score"] or len(rows) != 1 + cfg.generate.topk:
        raise AssertionError(f"unexpected CLI csv: {rows}")
    emit({"phase": "cli", "seconds": cli_s, "rows": [[r[0][:80], r[1]] for r in rows[1:]]})
    del model
    torch.cuda.empty_cache()

    results = {}
    serve_s2_phases(dev, files, batch, mods, results)
    torch.cuda.empty_cache()
    with switched(FUSED_SO2):
        serve_so2_phases(dev, files, batch, mods, cfg)
    torch.cuda.empty_cache()
    for form, var in (("hybrid", HYBRID_ATTN), ("dense", DENSE_ATTN)):
        with switched(var):
            serve_form_phases(dev, files, batch, mods, cfg, form)
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()

    f32_step = train_phases(dev, results, files, float32_config(cfg), "", GATE_PATH,
                            {k.name: 12 for k in GATE_PATH}, [], TRAIN_WARMUP, TRAIN_STEPS,
                            after_cli=lambda ckpt, tmp: after_train_cli(dev, ckpt, tmp))
    torch.cuda.empty_cache()
    # train_bf16: configs/train.yml (Config()'s path) at its own bfloat16,
    # through the six bfloat16 instances only (every float32 count 0)
    bf16_cfg = load_config(os.path.join(ROOT, TRAIN_CONFIG))
    if bf16_cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"{TRAIN_CONFIG} trains in {bf16_cfg.train.compute_dtype}")
    bf16_step = train_phases(dev, results, files, bf16_cfg, "_bf16", BF16_PATH,
                             {k.name: 12 for k in BF16_PATH}, ["--config", TRAIN_CONFIG],
                             BF16_WARMUP, BF16_STEPS, vs_cpu=False)
    emit({"phase": "train_bf16_vs_f32", "float32": f32_step, "bfloat16": bf16_step,
          "note": "reported, not claimed: the float32 step runs the tensor-core kernels; the "
                  "bfloat16 step the tensor-core kernels of K1, K2, K3, K1b, K2b and K3b at "
                  "bfloat16 (one TF32 product a product)"})
    torch.cuda.empty_cache()
    # train_s2: configs/train_corpus.yml in float32 (its CLI phase on a
    # float32 copy of the file: the file itself now trains at bfloat16)
    s2_bf16_cfg = load_config(os.path.join(ROOT, S2_CONFIG))
    if s2_bf16_cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"{S2_CONFIG} trains in {s2_bf16_cfg.train.compute_dtype}")
    s2_cfg = float32_config(s2_bf16_cfg)
    with tempfile.TemporaryDirectory() as f32_dir:
        save_config(f32_dir, s2_cfg)
        s2_step = train_phases(dev, results, files, s2_cfg, "_s2", S2_PATH,
                               {k.name: 6 for k in (K1, K3, K1B, K3B, K4, K4B)},
                               ["--config", os.path.join(f32_dir, "config.yml")], S2_WARMUP,
                               S2_STEPS)
    torch.cuda.empty_cache()
    # train_s2_bf16: the same configuration at its own bfloat16, through the
    # bfloat16 instances only (every float32 count 0): K4·bf16 and K4b·bf16
    # held at every distinct call of a microbatch
    s2_bf16_step = train_phases(dev, results, files, s2_bf16_cfg, "_s2_bf16", S2_BF16_PATH,
                                {k.name: 6 for k in (K1_BF16, K3_BF16, K1B_BF16, K3B_BF16,
                                                     K4_BF16, K4B_BF16)},
                                ["--config", S2_CONFIG], S2_WARMUP, S2_STEPS, vs_cpu=False)
    emit({"phase": "train_s2_bf16_vs_f32", "float32": s2_step, "bfloat16": s2_bf16_step,
          "note": "reported, not claimed: both steps run the tensor-core kernels, the "
                  "bfloat16 step's K4·bf16 and K4b·bf16 chain on bfloat16 m16n8k16 mma.sync, "
                  "its K1, K1b, K3 and K3b at one TF32 product a product"})
    torch.cuda.empty_cache()
    with switched(FUSED_SO2):
        so2_step = train_phases(dev, results, files, float32_config(cfg), "_so2", SO2_PATH,
                                {k.name: 12 for k in (K1, K2, K1B, K2B, K6, K6B)}, [],
                                SO2_WARMUP, SO2_STEPS)
    torch.cuda.empty_cache()
    # train_so2_bf16: configs/train.yml at its own bfloat16 under the switch,
    # through the bfloat16 instances only (every float32 count 0, K3 and K3b
    # 0): K6·bf16 and K6b·bf16 held at every distinct call of a microbatch
    with switched(FUSED_SO2):
        so2_bf16_step = train_phases(
            dev, results, files, bf16_cfg, "_so2_bf16", SO2_BF16_PATH,
            {k.name: 12 for k in (K1_BF16, K2_BF16, K1B_BF16, K2B_BF16, K6_BF16, K6B_BF16)},
            ["--config", TRAIN_CONFIG], BF16_WARMUP, BF16_STEPS, vs_cpu=False)
    emit({"phase": "train_so2_bf16_vs_f32", "float32": so2_step, "bfloat16": so2_bf16_step,
          "note": "reported, not claimed: configs/train.yml made float32 against its own "
                  "bfloat16, both under SINGA_TPU_FUSED_SO2; the bfloat16 step's K6 and K6b "
                  "with their GEMM on bfloat16 m16n8k16 mma.sync, their grid stages on the "
                  "tensor cores at one TF32 product a product"})
    form_steps = {}
    for suffix, var, path in (("_hybrid", HYBRID_ATTN, HYBRID_PATH),
                              ("_dense", DENSE_ATTN, DENSE_PATH)):
        torch.cuda.empty_cache()
        with switched(var):
            form_steps[suffix] = train_phases(
                dev, results, files, float32_config(cfg), suffix, path,
                {k.name: 12 for k in (K2, K3, K2B, K3B, *path)}, [], FORM_WARMUP, FORM_STEPS)
    # configs/train.yml at its own bfloat16 under each switch, through the
    # bfloat16 instances only (every float32 count 0): K7·bf16 and K7b·bf16,
    # or K8·bf16 and K8b·bf16, held at every distinct call of a microbatch
    for suffix, var, path in (("_hybrid", HYBRID_ATTN, HYBRID_BF16_PATH),
                              ("_dense", DENSE_ATTN, DENSE_BF16_PATH)):
        torch.cuda.empty_cache()
        with switched(var):
            form_steps[f"{suffix}_bf16"] = train_phases(
                dev, results, files, bf16_cfg, f"{suffix}_bf16", path,
                {k.name: 12 for k in (K2_BF16, K3_BF16, K2B_BF16, K3B_BF16, *path)},
                ["--config", TRAIN_CONFIG], BF16_WARMUP, BF16_STEPS, vs_cpu=False)
    emit({"phase": "train_forms_bf16_vs_f32",
          **{f"{form}_{dt}": form_steps[f"_{form}{sfx}"] for form in ("hybrid", "dense")
             for dt, sfx in (("float32", ""), ("bfloat16", "_bf16"))},
          "note": "reported, not claimed: each form's float32 step (configs/train.yml made "
                  "float32) and bfloat16 step, the same batches and steps"})
    torch.cuda.empty_cache()
    train_vs_cpu_bf16(dev, bf16_cfg, s2_bf16_cfg, files)
    torch.cuda.empty_cache()

    gan_phases(dev, files, mods)

    results[K4.name]["ptxas"] = k4_ptxas
    results[K4B.name]["ptxas"] = k4b_ptxas
    results[K4_BF16.name]["ptxas"] = k4_bf16_ptxas
    results[K4B_BF16.name]["ptxas"] = k4b_bf16_ptxas
    results[K2.name]["ptxas"] = k2_ptxas
    results[K2B.name]["ptxas"] = k2b_ptxas
    results[K2B_BF16.name]["ptxas"] = k2b_bf16_ptxas
    dense_ptxas = {n: ptxas_report(logs[n]) for n in ("dense_edge_attn", "dense_edge_attn_bwd")}
    for spec, lib, bf16 in ((K8, "dense_edge_attn", False), (K8B, "dense_edge_attn_bwd", False),
                            (K8_BF16, "dense_edge_attn", True),
                            (K8B_BF16, "dense_edge_attn_bwd", True)):
        results[spec.name]["ptxas"] = {k: v for k, v in dense_ptxas[lib].items()
                                       if ("bfloat16" in k) == bf16}
    for spec, bf16 in ((K8, False), (K8_BF16, True)):  # at the training microbatch's widths
        results[spec.name]["residency"] = mods["dense_edge_attn"].residency(
            384, 4, 32, 64, 64, bf16=bf16)
    # K8b·bf16: its tensor-core kernels (the main path's), its CUDA-core ones beside
    results[K8B_BF16.name]["cuda_cores_ptxas"] = results[K8B_BF16.name]["ptxas"]
    results[K8B_BF16.name]["ptxas"] = k8b_bf16_ptxas
    results[K8B_BF16.name]["residency"] = {
        "tensor_cores": mods["dense_edge_attn"].bwd_tc_residency(),
        "cuda_cores": mods["dense_edge_attn"].residency(384, 4, 32, 64, 64, bf16=True)["bwd"]}
    for spec, hybrid in ((K1B_BF16, False), (K7B_BF16, True)):
        results[spec.name]["ptxas"] = k1b_bf16_ptxas[int(hybrid)]
        results[spec.name]["residency"] = mods["neighbor_attn"].bwd_residency(hybrid, bf16=True)
    results[K2_BF16.name]["ptxas"] = k2_bf16_ptxas
    for spec, hybrid in ((K1_BF16, False), (K7_BF16, True)):
        results[spec.name]["ptxas"] = k1_bf16_ptxas[int(hybrid)]
        results[spec.name]["residency"] = mods["neighbor_attn"].fwd_residency(hybrid, bf16=True)
    results[K3.name]["ptxas"] = results[K3B.name]["ptxas"] = k3_ptxas
    results[K3_BF16.name]["ptxas"] = results[K3B_BF16.name]["ptxas"] = k3_bf16_ptxas
    results[K5.name]["ptxas"] = results[K5B.name]["ptxas"] = k5_ptxas
    for spec, hybrid in ((K1B, False), (K7B, True)):  # the pair kernels of each form
        results[spec.name]["residency"] = mods["neighbor_attn"].bwd_residency(hybrid)
        results[spec.name]["ptxas"] = k1b_ptxas[int(hybrid)]
    for spec, hybrid in ((K1, False), (K7, True)):  # the forward's tile kernels
        results[spec.name]["residency"] = mods["neighbor_attn"].fwd_residency(hybrid)
        results[spec.name]["ptxas"] = k1_ptxas[int(hybrid)]
    for bf16, fwd, bwd, ptx in ((False, K6, K6B, gemm_ptxas), (True, K6_BF16, K6B_BF16,
                                                                k6_bf16_ptxas)):
        residency = mods["so2_attn"].gemm_residency(bf16=bf16)
        for spec, lib in ((fwd, "so2_attn"), (bwd, "so2_attn_bwd")):
            results[spec.name]["gemm_ptxas"] = ptx[lib]
            results[spec.name]["gemm_residency"] = residency
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    print(smi, flush=True)
    emit({"kernels": [results[k.name] for k in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
