#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, train,
time.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. device   — the card's name, count, power limit; TF32 off everywhere.
  2. build    — ``nvcc`` builds the ``tt_contract``, ``mesh_apply`` and
                ``flash_attention`` sources of this checkout, all at once;
                prints ptxas' entry, register and spill lines.
  3. kernel   — ``tt_contract`` (the fiber body) against its plain PyTorch
                version on the card at the paper's spec (B = 2048, the served
                pool, and 65,536), the reduced config's spec at a B that is
                not a multiple of the tile, and a rank-4 non-square spec;
                bound ``max|kernel − plain| ≤ 1e-5·max|plain| + 1e-6`` (f32
                sums in another order); and bit for bit against
                ``tt_contract_batched`` at P = 1 (two launches of the one
                fiber body, on tiles of their own).  Each row names its
                design and tile (``fiber_tile``).  At the paper's
                spec it times the kernel, the plain version and ``x @
                tt_to_full(cores).T`` (the one-call library yardstick) with
                CUDA events, and the kernel alone in a ``torch.profiler``
                trace (``kernel_device_ms``).
  4. serve    — the port's main path through the entry points a user calls:
                ``SolverRegistry.register_fresh`` of the paper's solver
                (hjb-20d, tonn, hidden 1024, ranks [1,2,1,2,1], noise on) and
                heat-10d (tt, hidden 1024), a ``PdeServingEngine`` of 8×256
                slots, 31 mixed requests incl. one larger than the pool, then
                an exact repeat that the cache answers.  Checks: all done and
                finite, served values equal a direct ``model.u`` (rtol =
                atol = 1e-6: the head's matmul may pick another cuBLAS
                algorithm per batch size), the same forward on the CPU (plain
                path, rtol = atol = 1e-5), two programs built, and two kernel
                launches per program run.
  5. batched  — ``tt_contract_batched`` at the three launches of a training
                step on the paper's spec (P = 11: layer 0 on the 100 rows and
                on the 21 identity columns, shared; the hidden layer on
                4300 rows per entry), at black-scholes-100d's (layer 0 on
                its 101 identity columns, the hidden layer on 20,300 rows
                per entry), at helmholtz-2d's (layer 0 on its 2 identity
                columns and on the 25 boundary rows, shared; the hidden
                layer on 500 stencil rows and on 25 boundary rows per
                entry), the spectral steps' hidden launches (hjb-20d at M
                16: 31,600 line rows per entry; ns-2d: 4,600) and a
                rank-4 non-square spec at P = 3,
                B = 777, against ``tt_contract_batched_ref`` at the bound of
                phase 3; every entry p bit for bit against
                ``tt_contract(x[p], cores[p])``.  Each row names its design
                (the fiber body) and tile and the launch's device time alone
                in a ``torch.profiler`` trace (``kernel_device_ms``).  Times
                the three stencil hidden-layer launches, their plain
                version and ``torch.bmm(x, Wᵀ)`` against the densified
                per-entry weights.
  6. mesh     — ``mesh_apply_stacked`` on the 16- and 4-port layouts of the
                paper's core meshes, transposed and not, x shared and per
                entry, and a 64-port layout, against
                ``photonic.mesh_apply_stacked`` at the same bound and bit for
                bit.  Times the 16-port transposed identity feed of a
                densification, its plain version and ``torch.matmul``
                against the densified per-entry unitaries.  Then
                ``mesh_densify_stacked`` over all core matrices of the
                paper's config (G = 8, S = 11) and of the reduced one (G =
                6, S = 3), noise on and off, 8-bit DAC phases on and off,
                against the plain twin ``photonic.mesh_densify_stacked`` on
                the card bit for bit and on the CPU at the same bound.  Times
                the grouped call (a ZO step's densification) against the
                loop of 8 ``to_dense_stacked`` through the standalone entry
                and the plain twin; for scale only (no one call computes
                phases → cores), the 16 ``torch.matmul`` calls of the same
                meshes made dense: each mesh's feed against its per-entry
                unitary.
  6b. mesh-wide — ``mesh_apply_stacked`` on the layouts whose tables pass
                shared memory (onn's 1024-port meshes), through the route
                ``mesh_apply.wide_route`` picks and each route forced: route
                A (``warp_rows``) and the owner walk bit for bit against
                ``photonic.mesh_apply_stacked`` on the card, route B
                (``dense``, a 3xTF32 product) within ``1e-5·max|plain| +
                1e-6``: 1024 ports transposed and not, x shared (100 and 21
                rows, layer 0's launches) and per entry (S = 11, 4300 rows:
                the hidden layer's two launches), a ``decompose_orthogonal``
                layout of 256 ports (509 levels), 160 ports at S = 3, B =
                777, a 160-port layout whose pairs are not adjacent (the
                owner walk by dispatch); route A and the owner walk on 16-
                and 64-port layouts bit for bit against the resident
                design.  At the hidden layer's U mesh it times the dispatch
                (route B), route A and the owner walk forced (CUDA events,
                and each one's kernels alone in a trace that starts on a
                fill: ``kernel_device_ms``), the plain version and
                ``torch.bmm`` against the 11 unitaries made dense (TF32
                off); layer 0's route A launches alone.
  6c. mesh-grad — the two mesh backwards against their plain versions
                within ``MESH_GRAD_BOUND``·max|plain| (1e-4) per output:
                ``mesh_densify_grad`` (the grouped backward) on the paper's
                8 core matrices at S = 1 and 11, noise on and off (its warp
                design), and on tt_L 2's 64-port matrices (its block
                design, which recovers their states), against
                ``ref.mesh_densify_grad_ref``; ``mesh_apply_stacked_grad``
                — the resident backward on 16- and 64-port meshes on 4300
                rows and onn's 21-port layer-0 V mesh on 100 shared rows,
                the warp-rows backward (``mesh_rows_grad_kernel``) handed
                y and dy at 1024 ports on 4300 rows (route B's output;
                the U mesh there and layer 0's on 100 and 21 shared rows
                in phase 21b), a 256-port Reck layout (509 levels) and
                160 ports at S = 3, B = 777 — transposed and
                not, against ``ref.mesh_apply_grad_ref``; each call one
                launch of its design, two calls bit for bit.  Times the
                grouped one at S = 1 and 11 (also a call's host time,
                ``host_ms``, and beside it an empty kernel's launch,
                ``empty_launch_ms`` and ``empty_kernel_device_ms``: the
                floor) and the resident one at 64
                ports and 21 ports (CUDA events; one call alone in a trace
                that starts on a fill, with its kernels a call and each
                one's time), the plain versions and, for scale (no one
                PyTorch call gives dφ), ``torch.autograd.grad`` through
                the plain forwards; the warp-rows one likewise at 1024
                ports on 4300, 100 and 21 rows, and the dense one, in
                phase 21b.
  7. train    — the port's trainer (``repro_torch.launch.train.main``) on
                the card: the paper's TONN_ONCHIP_FUSED (hjb-20d, tonn,
                hidden 1024, noise on), N = 10, batch 100, 50 steps and a
                checkpoint.  Checks: finite losses and val MSE, the median
                of the last 10 losses below the first, the ±1 buffers
                bit-unchanged, exactly 3 ``tt_contract_batched`` and 1
                ``mesh_densify_stacked`` launches per step (and 1 grouped
                densification per validation forward) and no
                ``mesh_apply_stacked``; one step's stacked
                stencil u-values and (P,) losses on the card against the
                same params, ξ, batch and noise through the plain path on
                the CPU (u within 1e-4 of max|u|, losses rtol 1e-1: the FD
                residual amplifies f32 differences by 1/h² = 1e4); the
                checkpoint, which carries the chip's noise, loads into
                ``SolverRegistry`` without ``hw_noise=`` and its served u
                equals the trainer's final ``model.u`` (1e-6).  Times a ZO
                step with CUDA events, traces a steady window of 5
                (``torch.profiler``: kernels per step, the device's busy
                share of the window, the top 5) and counts the aten ops of
                one ``prepare_params_stacked``.
  8. quant-kernel — ``tt_contract_batched_quant``, which quantizes the f32
                cores in its launch, for int8 and fp8-e4m3 at the three
                launches of a QAT step (the shapes of phase 5, block 32) and
                the rank-4 spec at P = 3, B = 777, blocks 32 and 24 (every
                core's last run padded), with an all-zero block.  Checks:
                every entry bit-equal to ``tt_contract_batched`` on the
                ``fake_quant_stacked`` cores; the bound of phase 3 against
                ``tt_contract_batched_quant_ref``.  Times the int8
                hidden-layer call, its plain version and ``torch.bmm``
                against the densified fake-quantized weights, and traces
                one call in a window that starts on a fill (the profiler
                may drop a window's first kernel): one kernel and nothing
                else (the output's allocation launches none), whose device
                time is ``kernel_device_ms``.
  9. train-quant — phase 7 with ``--quant int8 --quant-block 32
                --phase-bits 8`` added to its argv: the same checks with 3
                ``tt_contract_batched_quant``, 0 ``tt_contract_batched`` and
                1 ``mesh_densify_stacked`` launches per step, the checkpoint's
                meta carrying the quant config, and the final val MSE at most
                10× the f32 run's (``benchmarks/quantized.py``'s notch).  The
                card-vs-CPU step counts weight codes that the two devices'
                densified cores put on either side of a rounding edge; where
                there are any, the CPU runs on the card's densified cores.
                Then 5 steps of ``--quant fp8_e4m3``: launch counts, finite
                losses.
 10. serve-quant — an engine over the ``hjb`` and ``heat`` solvers of phase 4
                with f32, int8 and fp8 requests mixed in one burst.  Checks:
                every value equals a direct ``u`` of the request's config
                (1e-6; quantized ones differ from f32), one program per
                (solver, config), two ``tt_contract`` launches per program
                run, a resubmitted burst answered by the cache alone, an f32
                repeat of an int8 request not answered from int8 entries.
 11. flash-kernel — ``flash_attention`` against ``ref.attention_ref`` on the
                card, bf16 through the ``wgmma`` design (TMA-fed tensor cores,
                P split into two bf16 halves) and f32 through the ``simple``
                one (each row names its design and the worst element's share
                of the bound): (a) qwen2.5-3b's prefill layer (B 4, H 16, KH
                2, S 2048, D 128, causal) in bf16 and f32, (b)
                h2o-danube-3-4b's (B 1, H 32, KH 8, S 8192, D 120, window
                4096), (c) chunked prefill (Sq 256 < Sk 2304), (d) one query
                over 300 keys, (e) bidirectional over whisper's 1500 frames
                (not a tile multiple), (f) causal with Sq 64 > Sk 32, whose
                first 32 rows see no key and must be exact zeros, (g) the
                reduced qwen shape (D 24, f32).  Bound, per element
                (``ref.attention_bound``): f32 ``|Δ| ≤ 1e-5·max|plain| +
                1e-6``; bf16 one bf16 ulp of the element's own |plain|
                (2^(⌊log2|plain|⌋ − 7)) on top of that: the two round f32
                values that differ in the last bits, and a pair that straddles
                a rounding edge lands one bf16 ulp apart.  At (a) times the
                kernel, the plain version and
                ``F.scaled_dot_product_attention(is_causal=True,
                enable_gqa=True)`` (the library yardstick; valid only at Sq =
                Sk, where its top-left causal alignment equals the kernel's
                bottom-right one), and records SDPA's own share of the bound
                (a finding, not a check); times (b) too.
 12. lm-serve — the LM slice's main path: ``transformer.init_params`` of the
                full qwen2.5-3b (bf16, seed 0) on the card, ``prefill`` of 4
                prompts of 2048 tokens (``max_len`` 2048 + 16), then 16 greedy
                ``decode_step``s.  Checks: logits finite; exactly 36
                ``flash_attention`` launches in the prefill, all of the
                ``wgmma`` design, and 0 in the decode; prefill's last-token
                logits against the same prefill with ``ref.attention_ref`` in
                place of the kernel (the check independent of the kernel),
                against ``forward`` at position S−1 (which runs the kernel
                too), and the first decode's against ``forward`` on the S+1
                tokens at position S (within 2e-2·max|logit|, the bar of
                ``tests/test_arch_smoke.py``).  Times a prefill and a decode
                step.  Then the same config cut to 2 layers in f32:
                ``prefill`` of B 2, S 256 on the card against the CPU's plain
                path (last-token logits within 1e-4·max|logit|). Then
                ``launch.serve.ServingEngine`` over the full bf16 model (4
                slots, ``max_len`` 256, 4 requests of 16-token prompts and 16
                new tokens): all finish with 16 tokens, and a second engine on
                the same params gives the same tokens.
 13. bp-kernel — ``tt_contract_grad``, the hand-written backward of
                ``tt_contract`` (the off-chip BP baselines' kernel; the TPU
                kernel has none), against ``ref.tt_contract_grad_ref`` at the
                three BP launches of the paper's config at batch 100 (layer 0
                on the 100 rows and on the 21 identity columns, no dx; the
                hidden layer on 4300 rows, with dx), the reduced spec at B
                1000, the rank-4 spec at B 777 and a 4096-wide spec at B 777
                (rows too wide to save every forward state), each with its
                layout (saved states, rows and blocks).  dx at phase 3's bound;
                each dG_k within ``tt_contract.grad_bound`` of the plain
                chain in float64 (the kernel's summation depth, which grows
                with the reduction length over B·M_<k·N_>k, times the
                magnitudes it adds), with the worst element's share of it;
                two calls bit for bit.  Two traced windows of 5 calls, call k
                on dy·2^k, each output 2^k times the first call's bits (a
                sum that missed a block's partials would leave stale ones),
                one kernel a call; one window starts on the kernel, one on
                four PyTorch fills (``trace_launches``: what each trace
                recorded).
                Times the hidden-layer call (CUDA events and alone in the
                second window), its plain version and ``torch.autograd.grad``
                of ``x @ tt_to_full(cores).T``.
 14. train-bp — ``launch.train.main`` with the BP optimizers at hidden
                1024, batch 100: tt + AdamW for 50 steps with a checkpoint,
                tonn (noise on) + AdamW and dense + SGD for 10.  Checks:
                finite losses and val MSE, the tt loss falling (median of the
                last 10 below the first), 3 ``tt_contract`` and 3
                ``tt_contract_grad`` launches a step (plus 2 ``tt_contract``
                per validation forward; none in dense) and no other kernel;
                one step's gradients card vs CPU (``Σ u·w`` and
                ``Σ w·fd_u_stencil`` — the BP step's 3 + 3 TT launches,
                counted, without the residual's 1/h² — within
                1e-4·max|grad| per leaf, nonzero; the loss's at the FD floor,
                and in tt and dense each f32 loss gradient's distance to the
                CPU's float64 one, recorded); the checkpoint's ``params`` and
                ``opt`` round-trip, ``--resume`` continues the run bit for
                bit.  tonn's and onn's BP go through the mesh backwards:
                tonn a grouped densification and its backward a step, onn
                (noise on, 10 steps) 6 meshes and 6 backwards a step (4
                meshes a validation forward): at hidden 64 all resident,
                at hidden 1024 2 resident + 2 route A + 2 route B forward
                and 2 resident + 2 warp-rows + 2 dense backwards (the
                backward follows the forward's route; 1
                ``mesh_product_grad`` launch a dense backward), checked
                by design (``_onn_bp_designs``); no run reaches
                ``prepare_params_plain``; their card-vs-CPU gradients run
                through the kernels (tonn with the noise model on and off;
                onn at hidden 1024 on 4 points, held to the CPU's float64
                gradients within max(1e-4·max|grad|, ``F32_FLOOR_FACTOR``
                times the CPU f32 path's own distance) per leaf, its loss
                gradient at the FD floor too).  A second 5-step run gives the same losses and
                params bit for bit in tt, tonn and both onn rows.  Times a
                BP step of tt, tonn and onn (CUDA events, a traced window
                of 5).
 15. train-seq — ``--pinn-mode tonn --pinn-noise --sequential`` at hidden
                1024 for 5 steps (N = 10, batch 100): 1 grouped
                densification and 2 ``tt_contract`` launches per loss
                evaluation, 11 and 22 a step, and no batched chain or
                standalone mesh; one step's (N,) losses and base loss card
                vs CPU (rtol 1e-1) and a perturbed model's stencil u (1e-4
                of max|u|).  Times a sequential step.
 16. train-onn — the paper's ONN baseline (``ONN_ONCHIP``: hjb-20d, onn,
                hidden 1024, noise on) through the trainer, fused ZO with
                N = 10, batch 100, 10 steps and a checkpoint.  Checks: finite
                losses and val MSE, the ±1 buffers bit-unchanged, the
                ``mesh_apply_stacked`` launches of each design and route a
                step (2 resident; layer 0's 1024-port U mesh on the 100
                rows and 21 columns by route A; the hidden layer's V and U
                on 4300 rows by route B) and per validation forward (1000
                rows), no TT chain and no grouped densification; one step's
                stacked stencil u and losses card vs CPU on the first 3
                entries of the stack (u within 1e-4 of max|u|, losses rtol
                1e-1); the checkpoint serves without ``hw_noise=``, equal to
                ``model.u`` (1e-6).  Times a ZO step (CUDA events, a traced
                window of 5).  Then 2 ``--sequential`` steps: 44 meshes a
                step (11 resident, 33 wide on 4300 rows), finite losses;
                times a sequential step.
 17. serve-onn — an engine over a fresh onn solver (hjb-20d, hidden 1024,
                noise on): served u against a direct ``model.u`` (rtol =
                atol = 1e-6) and the CPU (1e-5), 1 resident and 3 wide
                meshes (the routes of a 2048-row pool) a program run; times
                a full-pool program.
 18. table2   — paper Table 2 and the §4.2 training cost from the port's
                cost model (``benchmarks/torch_table2_cost.py``, host
                arithmetic): 2,095,104 ONN MZIs, TONN-1's 1,008 (2,078.5×
                fewer), TONN-2's 28, 42,000 inferences an epoch, 1.354 J and
                1.151 s over 5,000 epochs, each within 1% of the paper where
                the paper agrees.
 19. table1   — the paper's five Table 1 rows (tt off-chip ideal, tt
                off-chip mapped onto the noisy chip, tonn on-chip with
                noise, dense off-chip, onn on-chip with noise) through
                ``benchmarks/torch_table1_hjb.run_row`` at hidden 1024,
                ``tt_L`` 4, batch 100, N = 10, and the off-chip ONN row
                (dense mapped onto noise: onn by BP) there too, for 20
                epochs each: finite val MSEs, each row's kernel launches
                exactly its path's (``_table1_want``: 2 ``tt_contract`` + 2
                ``tt_contract_grad`` a BP step, tonn's 1 grouped
                densification and its backward more, onn's 4 meshes (1
                resident, 3 route B) and 4 backwards (1 resident, 3
                dense); 1 grouped densification + 2
                ``tt_contract_batched`` a tonn ZO step, 1 resident + 3 wide
                meshes an onn ZO step, none for dense; and the validation
                forwards') and none of the other counted kernels; ms a step
                on CUDA events.
 21. train-pde — ``launch.train.main`` trains heat-20d,
                black-scholes-100d (101-wide input, 203-row FD stencil) and
                helmholtz-2d (2-wide input, a boundary term on 25 rows a
                step, ``--bc-weight 2``) at the paper's config (tonn, hidden
                1024, ``PAPER_TONN_SPEC``, noise on, ``fd_fast``, fused),
                N = 10, batch 100, 20 steps each with a checkpoint.  Checks:
                finite losses, val MSE and final per-term losses, the ±1
                buffers bit-unchanged, exactly the launches ``_pde_want``
                counts from the code (a step: 1 grouped densification and 3
                ``tt_contract_batched``, 5 with the boundary term; a
                validation forward: 1 densification and 2 ``tt_contract``;
                helmholtz-2d's logged per-term losses: 1 densification and
                5 ``tt_contract``) and no other counted kernel, the median
                of the last 5 losses below the first and the loss on a held
                batch lower at the trained params than at the initial ones
                (for helmholtz-2d, whose loss ZO training does not move,
                ``STILL_LOSS``: every trainable leaf moved); one step's
                stacked
                stencil u and boundary u card vs CPU on the first 3 entries
                of the stack (1e-4 of max|u|) and its losses (rtol 1e-1,
                the FD floor); the checkpoint served without ``hw_noise=``
                equal to ``model.u`` (1e-6), with the trained term weights
                on its problem.  Times a ZO step (CUDA events, a traced window of
                5: the hidden launch in ``match_each_ms``).  Then the
                stacked Stein loss (``residual_losses_stacked`` with
                ``deriv="stein"``) at heat-20d on the trained model, P 11,
                B 100, S 32, z drawn on the card from a seeded generator:
                1 grouped densification and 2 per-entry
                ``tt_contract_batched`` launches and nothing else counted;
                the per-entry layer-0 launch (11 × 6,500 rows of the
                1024-wide padded input) against
                ``ref.tt_contract_batched_ref`` at phase 3's bound, timed
                (CUDA events, alone in a trace, its plain version,
                ``torch.bmm`` against the densified weights); the stencil u
                of the first 3 entries card vs CPU with the same z (1e-4 of
                max|u|); identical params in all 11 entries give 11
                distinct losses.  Times one call.
 21a. train-spectral — ``_train_pde`` again on hjb-20d with ``--estimator
                spectral`` (M 16: 31,600 line rows an entry) and on ns-2d
                with ``--estimator auto`` (its own spectral estimator, a
                ``Domain``, a Fourier feature map, ``ic`` and ``data`` terms
                on 25 rows each), 20 steps each.  Checks as phase 21's,
                with the spectral launches (a step: 1 grouped densification
                and 2 ``tt_contract_batched``, 2 more for each of ns-2d's
                terms; no identity-columns launch): card vs CPU on one
                step's first 3 entries for the u over the line rows and the
                terms' rows (1e-4 of max|u|) and the losses (rtol 1e-1: the
                spectral ∂² amplifies u's differences by k_max² ≤ (16π)² <
                1/h²), and the derivatives from the card's line values
                (cuFFT) held to ``spectral_derivs_ref`` in float64 within
                twice the CPU FFT's distance; hjb-20d's loss falls, ns-2d
                (``STILL_LOSS``: the JAX package's own ns-2d ZO run misses
                its bar) moves every trainable leaf; both checkpoints
                serve with their term weights.
 21c. train-coeff — the coefficient-conditioned families: ``_train_pde`` on
                black-scholes-100d-rs with ``--coeffs-per-step 4`` (101
                physical columns and (r, σ): 103 of the 1024-wide padded
                input; the hidden launch on 11 × 20,300 rows) and on
                heat-10d-kappa with ``--coeff-range kappa=0.7:1.5
                --coeff-dist loguniform`` (its Dirichlet term: 2 launches
                more a step), 20 steps each, checked as phase 21's (a step
                1 grouped densification and 3 ``tt_contract_batched``, 5
                with the term; the loss falls; one step's u card vs CPU on
                3 entries).  Each checkpoint is served (``_serves_family``)
                at ``COEFF_SERVED`` coefficient instances from the trained
                ranges by one ``c{K}`` program, built at warm-up, with no
                rebuild after it; each request equal to ``model.u`` on its
                augmented rows (1e-6); an out-of-range request refused
                before it queues; the loaded problem's term weights the
                trained ones (no latency is read: the request sizes
                exercise the packer, they are not a traffic mix).  Then
                hjb-10d-lam by
                BP (``--optimizer adamw``, tt, hidden 48, batch 128, 400
                steps: the reference's budget; 3 ``tt_contract`` and 3
                ``tt_contract_grad`` a step) held to its family tolerance,
                val MSE < 1e-2 at each of 5 coefficient draws, and the
                range's ends giving different fields.
 21d. train-dist — distributed ZO (``repro_torch.parallel.zo_shard``) at
                the paper's config (hjb-20d, ``TONN_ONCHIP_FUSED``, hidden
                1024, N = 10, batch 100) in a 2-rank ``gloo`` world on the
                card (``zo_shard.run_ranks``; both ranks on one H100, the
                O(N) loss vector crossing the host): on ``2x1`` (6 of 12
                padded entries a rank) and ``1x2`` (50 points a rank) the
                gradient and base loss against the single-rank fused
                ``zoo.spsa_gradient`` of the same generator (atol
                1e-4·max|g|, rtol 1e-3; base rtol 1e-4; printed with
                whether it is bit-equal; every rank the same bits), the
                bytes one step puts on the wire (every collective counted,
                ``measure_collective_bytes``) within ``wire_bound_bytes``
                and below the params', 3 ``tt_contract_batched`` + 1
                grouped densification a rank a step over 5 counted steps
                and in a traced window, ms a step (CUDA events, host
                median) of each layout and of the single-rank fused step.
                Then ``launch.train --shard perturbation --mesh 2x1
                --async-ckpt`` for 20 steps (each rank's wrapper counts: 3
                B1 + 1 B3 a step, rank 0's validation forwards besides;
                the loss falls) and ``--resume`` to 30 (10 steps, the
                checkpoint's and the ZO state's step 30); the watchdog's
                straggles printed.
 21b. mesh-grad-wide — phase 6c's three cases of the warp-rows backward
                at onn's hidden 1024 (``MESH_GRAD_WIDE``: handed the hidden
                layer's U mesh's y and dy on 4300 rows, layer 0's on 100
                and 21), checked and timed as 6c times the others, and
                the dense backward (``MESH_GRAD_DENSE``: x and M from
                route B's forward at 1024 ports on 4300 rows, transposed,
                on a shared x at S = 2, and 160 ports at S = 3 on 777),
                against ``ref.mesh_apply_dense_grad_ref`` and the rows'
                ``ref.mesh_apply_grad_ref`` within ``MESH_GRAD_BOUND``, a
                launch of design ``dense`` and one ``mesh_product_grad``
                a call, two calls bit for bit, timed in turns with the
                warp-rows backward on the same forward's y and dy, each
                product beside ``torch.matmul``; in a Python process of
                their own: in this one, ``torch.profiler`` loses their
                windows late in the run, and timed in 6c they make phase
                8's window get lost.
 22. report   — one ``{"kernels": [...], "profile_retries": {...}}`` line
                (the profiler windows each phase took again because they
                held no device event; each phase also prints its count
                after it runs), the card's name and power limit, then
                ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device, or run outside a checkout of the repository, it exits
non-zero before printing any result.  ``tools/zo_step.py`` measures the ZO
step of any checkout's port with this script's ``measure_zo_step``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# outside the tensor cores — the rates the TT chain's f32 FMAs run at — and
# dense bf16 on the tensor cores, attention's products in bf16.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
# 67 TFLOP/s counts an FMA as two operations; a product or a sum rounded on
# its own (the mesh kernels' bit-equal Givens form) takes one issue slot
PEAK_F32_ISSUE = PEAK_F32_FLOPS / 2


def _time_ms(fn, iters: int, warmup: int = 5, host: bool = False) -> float:
    """Mean device time of one call over ``iters`` back-to-back calls, on
    CUDA events; ``host`` times on the host's clock instead (a run on the
    CPU: ``benchmarks/torch_zo_step.py --device cpu``)."""
    import torch
    for _ in range(warmup):
        fn()
    if host:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(spec, batch: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over bandwidth (x read
    once, y written once, cores read once) and FLOPs over the f32 peak."""
    bytes_moved = 4 * (batch * spec.in_dim + batch * spec.out_dim
                       + spec.num_params)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = spec.contraction_flops(batch) / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _batched_bound(spec, P: int, B: int, shared: bool,
                   ops_per_param: int = 0) -> tuple:
    """(bound_ms, bound_by) of a batched launch: x (read once, shared or
    per entry), y and each entry's f32 cores at the card's memory rate,
    against the chains' FLOPs (and ``ops_per_param`` per core element) at
    the f32 peak."""
    x_elems = (1 if shared else P) * B * spec.in_dim
    t_bytes = 4 * (x_elems + P * B * spec.out_dim
                   + P * spec.num_params) / PEAK_BYTES_PER_S * 1e3
    t_ops = P * (spec.contraction_flops(B) + ops_per_param * spec.num_params
                 ) / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} x{count}; nvidia-smi: {card}", flush=True)
    return name, count, card


KERNEL_SOURCES = ("tt_contract", "mesh_apply", "flash_attention")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:   # one nvcc each
        libs = list(pool.map(_build.build, KERNEL_SOURCES))
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s (cached builds take no time)",
          flush=True)
    for name, lib in zip(KERNEL_SOURCES, libs):
        _build.load_library(name)
        for line in Path(f"{lib}.log").read_text().splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "smem", "spill")):
                print(f"[build] {name} ptxas: {line.strip()}", flush=True)


def _check_close(name: str, label: str, got, plain) -> tuple:
    """(max|got − plain|, max|plain|); raises past 1e-5·max|plain| + 1e-6."""
    import torch
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not (torch.isfinite(got).all().item() and err <= 1e-5 * scale + 1e-6):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}: max|diff| {err:.3e}, max|plain| "
                             f"{scale:.3e}")
    return err, scale


def _u_close(label: str, u_card, u_cpu) -> tuple:
    """(max|card − CPU|, max|CPU|) of stencil u-values; raises past
    1e-4·max|u| (the same f32 chain on two devices, sin of two
    libraries)."""
    err = (u_card - u_cpu).abs().max().item()
    scale = u_cpu.abs().max().item()
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{label}: stencil u card vs CPU max|diff| "
                             f"{err:.3e}, max|u| {scale:.3e}")
    return err, scale


def _load_served(name: str, ckpt: str, device, term_weights: dict | None):
    """A trainer's checkpoint loaded into a new ``SolverRegistry``; with
    ``term_weights``, the loaded problem's ``term_weights()`` equal to
    them.  Returns the registry."""
    from repro_torch.serving import SolverRegistry
    reg = SolverRegistry(device=device)
    solver = reg.load_checkpoint(name, ckpt, device=device)
    if (term_weights is not None
            and solver.model.problem.term_weights() != term_weights):
        raise AssertionError(f"{name}: served term weights "
                             f"{solver.model.problem.term_weights()}, "
                             f"trained {term_weights}")
    return reg


def _serves_checkpoint(name: str, ckpt: str, model, params, noise,
                       device, term_weights: dict | None = None) -> float:
    """A trainer's checkpoint, which carries the chip's noise, loaded into
    ``SolverRegistry`` without ``hw_noise=`` and served through an engine:
    700 points equal to the trainer's own ``model.u`` (1e-6); with
    ``term_weights``, the loaded problem's ``term_weights()`` equal to
    them.  Returns max|served − direct|."""
    import numpy as np
    import torch
    from repro_torch.device import counter_generator
    from repro_torch.serving import PdeServingEngine, PointRequest
    reg = _load_served(name, ckpt, device, term_weights)
    engine = PdeServingEngine(reg, slots=4, slot_points=256, device=device)
    pts = model.problem.sample_collocation(counter_generator(11), 700)
    req = engine.submit(PointRequest(name, pts.numpy()))
    engine.run()
    with torch.no_grad():
        direct = model.u(params, pts.to(device), noise).cpu().numpy()
    np.testing.assert_allclose(req.out, direct, rtol=1e-6, atol=1e-6)
    return float(np.abs(req.out - direct).max())


def phase_kernel(device) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import ref, tt_contract as ttc

    cases = [("paper", tt.PAPER_TONN_SPEC, 2048, True),
             ("paper", tt.PAPER_TONN_SPEC, 65536, True),
             ("reduced-64", tt.auto_factorize(64, 64, L=3, max_rank=2), 1000,
              False),
             ("rank4-256x512", tt.auto_factorize(256, 512, L=3, max_rank=4),
              777, False)]
    results = []
    for i, (label, spec, batch, timed) in enumerate(cases):
        gen = torch.Generator().manual_seed(1000 + i)
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((batch, spec.in_dim), generator=gen).to(device)
        y_k = ttc.tt_contract(x, cores, spec)
        y_p = ref.tt_contract_ref(x, cores, spec)
        torch.cuda.synchronize()
        err = (y_k - y_p).abs().max().item()
        scale = y_p.abs().max().item()
        tol = 1e-5 * scale + 1e-6
        if not (torch.isfinite(y_k).all().item() and err <= tol):
            raise AssertionError(
                f"tt_contract disagrees with its plain version at {label} "
                f"B={batch}: max|diff| {err:.3e} > {tol:.3e}")
        # two launches of the one body: tt_contract_batched at P = 1
        y_b = ttc.tt_contract_batched(x, [c[None] for c in cores], spec)[0]
        if not torch.equal(y_k, y_b):
            raise AssertionError(
                f"tt_contract differs from tt_contract_batched at P = 1 at "
                f"{label} B={batch}: {int((y_k != y_b).sum())} elements")
        row = {"spec": label, "modes": [list(spec.out_modes),
                                        list(spec.in_modes)],
               "ranks": list(spec.ranks), "batch": batch, "design": "fibers",
               "tile": dataclasses.asdict(ttc.fiber_tile(spec, batch)),
               "max_abs_err": err, "max_abs_plain": scale,
               "bitwise_equal_batched_p1": True}
        if timed:
            w = tt.tt_to_full(cores, spec)
            iters = 200 if batch <= 4096 else 20
            row["ms"] = _time_ms(lambda: ttc.tt_contract(x, cores, spec), iters)
            # back-to-back calls can be bound by the host; the kernel alone
            row["kernel_device_ms"] = _profile(
                lambda: ttc.tt_contract(x, cores, spec),
                match="tt_contract_kernel")["match_ms"]
            row["plain_ms"] = _time_ms(
                lambda: ref.tt_contract_ref(x, cores, spec), iters)
            row["library_ms"] = _time_ms(lambda: torch.matmul(x, w.T), iters)
            row["bound_ms"], row["bound_by"] = _bound(spec, batch)
            row["bound_us"] = row["bound_ms"] * 1e3
        results.append(row)
        print(f"[kernel] {json.dumps(row)}", flush=True)
    return {"cases": results}


def phase_serve(device) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import pinn
    from repro_torch.core.photonic import NoiseModel
    from repro_torch.device import to_device
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)

    # the paper's on-chip fused config (repro/configs/hjb_pinn.py,
    # TONN_ONCHIP_FUSED) and the second solver of the mixed traffic
    cfgs = {
        "hjb": pinn.PINNConfig(hidden=1024, mode="tonn", tt_rank=2, tt_L=4,
                               deriv="fd_fast", use_fused_kernel=True,
                               noise=NoiseModel(enabled=True),
                               pde="hjb-20d"),
        "heat": pinn.PINNConfig(hidden=1024, mode="tt", tt_rank=2, tt_L=4,
                                use_fused_kernel=True, pde="heat-10d"),
    }
    reg = SolverRegistry(device=device)
    for seed, (name, cfg) in enumerate(cfgs.items()):
        reg.register_fresh(name, cfg, seed=seed, device=device)
    engine = PdeServingEngine(reg, slots=8, slot_points=256, device=device)

    rng = np.random.RandomState(0)
    names = reg.names()
    traffic = []
    for i in range(30):
        name = names[i % 2]
        n = int(rng.randint(1, 257))
        traffic.append((name, rng.uniform(
            0.02, 0.98, (n, reg.get(name).in_dim)).astype(np.float32)))
    traffic.append(("hjb", rng.uniform(0.02, 0.98, (3000, 21)).astype(
        np.float32)))                                    # larger than the pool

    ttc.tt_contract.launches = 0                          # main path starts
    t_warm = time.perf_counter()
    engine.warmup()
    t_warm = time.perf_counter() - t_warm
    t0 = time.perf_counter()
    reqs = [engine.submit(PointRequest(name, pts)) for name, pts in traffic]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # an exact repeat is answered by the cache at submit, without a program
    repeat = engine.submit(PointRequest(*traffic[0]))
    launches = ttc.tt_contract.launches                   # main path ends

    stats = engine.serving_stats()
    expected = 2 * (len(names) + stats["program_runs"])
    if launches != expected:
        raise AssertionError(f"tt_contract launched {launches} times, "
                             f"expected {expected} (2 per program run)")
    if stats["compiles"] != len(names):
        raise AssertionError(f"{stats['compiles']} programs built, "
                             f"expected {len(names)}")
    if not repeat.done or stats["cache_hits"] != len(traffic[0][1]):
        raise AssertionError(f"the repeated request missed the cache: "
                             f"{stats['cache_hits']} hits")
    reqs.append(repeat)
    # time per full-pool program call, back to back on CUDA events (2
    # kernels plus the elementwise ops and the head; the host's launch
    # rate can bound it), beside the host clock's time per engine step
    program_ms = {}
    for name in names:
        s = reg.get(name)
        pool = s.problem.sample_collocation(
            torch.Generator().manual_seed(1),
            engine.slots * engine.slot_points).to(device)
        with torch.no_grad():
            program_ms[name] = _time_ms(lambda: s.model.u(s.params, pool), 50)
    worst = 0.0
    for r in reqs:
        if not (r.done and r.out.shape == (len(r.points),)
                and np.isfinite(r.out).all()):
            raise AssertionError(f"request for {r.solver} not served")
        s = reg.get(r.solver)
        with torch.no_grad():
            direct = s.model.u(s.params, torch.tensor(
                r.points, dtype=torch.float32, device=device)).cpu().numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        worst = max(worst, float(np.abs(r.out - direct).max()))
    # the same forward through the plain path on the CPU
    cpu_err = 0.0
    for r in reqs[:2]:
        s = reg.get(r.solver)
        params = to_device(s.params, torch.device("cpu"))
        with torch.no_grad():
            ref_u = s.model.u(params, torch.tensor(
                r.points, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(r.out, ref_u, rtol=1e-5, atol=1e-5)
        cpu_err = max(cpu_err, float(np.abs(r.out - ref_u).max()))

    lat_ms = np.asarray([r.latency_s for r in reqs[:-1]]) * 1e3
    points = sum(len(r.points) for r in reqs[:-1])
    out = {"requests": len(reqs) - 1, "points": points,
           "warmup_s": t_warm, "wall_ms": wall * 1e3,
           "points_per_s": points / wall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "max_abs_served_vs_direct": worst,
           "max_abs_served_vs_cpu": cpu_err,
           "step_ms": wall * 1e3 / stats["steps"],
           "program_ms": program_ms,
           "launches": launches,
           "stats": {k: stats[k] for k in ("compiles", "program_runs",
                                           "steps", "cache_hits",
                                           "points_served",
                                           "points_padded")}}
    print(f"[serve] {json.dumps(out)}", flush=True)
    return out


TIMED_BATCHED = ("hidden-stencil", "bs100-hidden-stencil",
                 "helm-hidden-stencil", "hidden-spectral", "ns-2d-hidden")


def phase_batched(device) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import ref, tt_contract as ttc

    paper = tt.PAPER_TONN_SPEC
    rank4 = tt.auto_factorize(256, 512, L=3, max_rank=4)
    # label -> (spec, P, rows, shared x); "hidden-stencil" is the main one
    # (hjb-20d's ZO step), the bs100 ones black-scholes-100d's (101 inputs:
    # 203 stencil rows a point, 101 identity columns), the helm ones
    # helmholtz-2d's (2 inputs: 5 stencil rows a point, 2 identity columns;
    # its boundary term's 25 rows, layer 0 shared and the hidden layer per
    # entry, fewer rows than a tile); "hidden-spectral" hjb-20d's spectral
    # step (M 16: 100·(21·15+1) line rows an entry), "ns-2d-hidden" ns-2d's
    # (100·(3·15+1))
    cases = {"layer0-rows": (paper, 11, 100, True),
             "layer0-columns": (paper, 11, 21, True),
             "hidden-stencil": (paper, 11, 4300, False),
             "bs100-layer0-columns": (paper, 11, 101, True),
             "bs100-hidden-stencil": (paper, 11, 20300, False),
             "helm-layer0-columns": (paper, 11, 2, True),
             "helm-hidden-stencil": (paper, 11, 500, False),
             "helm-boundary-layer0": (paper, 11, 25, True),
             "helm-boundary-hidden": (paper, 11, 25, False),
             "rank4-777": (rank4, 3, 777, False),
             "hidden-spectral": (paper, 11, 31600, False),
             "ns-2d-hidden": (paper, 11, 4600, False)}
    results = {}
    for i, (label, (spec, P, B, shared)) in enumerate(cases.items()):
        gen = torch.Generator().manual_seed(2000 + i)
        per = [tt.tt_init(gen, spec) for _ in range(P)]
        cores = [torch.stack([c[k] for c in per]).to(device)
                 for k in range(spec.L)]
        x = torch.randn((B, spec.in_dim) if shared
                        else (P, B, spec.in_dim), generator=gen).to(device)
        y = ttc.tt_contract_batched(x, cores, spec)
        plain = ref.tt_contract_batched_ref(x, cores, spec)
        err, scale = _check_close("tt_contract_batched", label, y, plain)
        for p in range(P):              # entry p is tt_contract's chain
            single = ttc.tt_contract(x if shared else x[p].contiguous(),
                                     [c[p].contiguous() for c in cores], spec)
            if not torch.equal(y[p], single):
                raise AssertionError(f"tt_contract_batched entry {p} at "
                                     f"{label} differs from tt_contract")
        row = {"case": label, "P": P, "rows": B, "shared_x": shared,
               "modes": [list(spec.out_modes), list(spec.in_modes)],
               "ranks": list(spec.ranks), "design": "fibers",
               "tile": dataclasses.asdict(ttc.fiber_tile(spec, P * B)),
               "max_abs_err": err, "max_abs_plain": scale,
               "entries_bitwise_equal": True,
               "kernel_device_ms": _profile(
                   lambda: ttc.tt_contract_batched(x, cores, spec),
                   match="tt_contract_batched_kernel")["match_ms"]}
        if label in TIMED_BATCHED:
            w = torch.stack([tt.tt_to_full([c[p] for c in cores], spec)
                             for p in range(P)])                # (P, M, N)
            wt = w.transpose(1, 2)
            row["ms"] = _time_ms(lambda: ttc.tt_contract_batched(
                x, cores, spec), 50)
            row["plain_ms"] = _time_ms(lambda: ref.tt_contract_batched_ref(
                x, cores, spec), 10)
            row["library_ms"] = _time_ms(lambda: torch.bmm(x, wt), 50)
            row["bound_ms"], row["bound_by"] = _batched_bound(spec, P, B,
                                                              shared)
        results[label] = row
        print(f"[batched] {json.dumps(row)}", flush=True)
        del x, y, plain
    return results


def phase_mesh(device) -> dict:
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh

    # label -> (ports, S, rows, shared x, transpose); the paper's core
    # meshes have 16 and 4 ports; "v16-identity" (the V mesh of a 4x16
    # core, transposed, on the identity feed) is the main one
    cases = {"v16-identity": (16, 11, 16, True, True),
             "v4-identity": (4, 11, 4, True, True),
             "u4-per-entry": (4, 11, 16, False, False),
             "u16-per-entry": (16, 11, 4, False, False),
             "u16-shared": (16, 11, 16, True, False),
             "p64-per-entry": (64, 3, 37, False, True)}
    results = {}
    for i, (label, (ports, S, B, shared, transpose)) in enumerate(
            cases.items()):
        layout = photonic.rectangular_layout(ports)
        gen = torch.Generator().manual_seed(3000 + i)
        phases = torch.randn((S, *layout.phase_shape()), generator=gen)
        diag = torch.where(torch.rand((S, ports), generator=gen) < 0.5,
                           -1.0, 1.0)
        x = (torch.eye(ports) if label.endswith("identity") else
             torch.randn((B, ports) if shared else (S, B, ports),
                         generator=gen))
        phases, diag, x = phases.to(device), diag.to(device), x.to(device)
        y = mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)
        plain = photonic.mesh_apply_stacked(layout, phases, diag, x,
                                            transpose)
        err, scale = _check_close("mesh_apply_stacked", label, y, plain)
        row = {"case": label, "ports": ports, "levels": layout.levels,
               "S": S, "rows": B, "shared_x": shared, "transpose": transpose,
               "rows_per_block": mesh.rows_per_block(layout),
               "max_abs_err": err, "max_abs_plain": scale,
               "bitwise_equal": bool(torch.equal(y, plain))}
        if label == "v16-identity":
            eye = torch.eye(ports, device=device)
            m = photonic.mesh_apply_stacked(layout, phases, diag, eye,
                                            transpose)   # y[s] = x @ m[s]
            row["ms"] = _time_ms(lambda: mesh.mesh_apply_stacked(
                layout, phases, diag, x, transpose), 200)
            row["kernel_device_ms"] = _profile(
                lambda: mesh.mesh_apply_stacked(layout, phases, diag, x,
                                                transpose))["device_ms"]
            row["plain_ms"] = _time_ms(lambda: photonic.mesh_apply_stacked(
                layout, phases, diag, x, transpose), 50)
            row["library_ms"] = _time_ms(lambda: torch.matmul(x, m), 200)
            L = layout.levels
            x_elems = (1 if shared else S) * B * ports
            # the kernel's inputs (x, cos/sin tables, perm, diag), read
            # once, and its output, written once; 3 FLOPs per element per
            # level plus the diag product
            t_bytes = 4 * (x_elems + 2 * S * L * ports + L * ports
                           + S * ports + S * B * ports) / PEAK_BYTES_PER_S
            t_ops = S * B * ports * (3 * L + 1) / PEAK_F32_ISSUE
            row["bound_ms"], row["bound_by"] = (
                (t_bytes * 1e3, "bytes") if t_bytes >= t_ops
                else (t_ops * 1e3, "operations"))
        results[label] = row
        print(f"[mesh] {json.dumps(row)}", flush=True)
    results.update(_densify_cases(device))
    return results


def _mesh_bound(layout, S: int, B: int, shared: bool) -> tuple:
    """(bound_ms, bound_by) of one standalone mesh call in the Givens form
    (route A, the owner walk): x (read once, shared or per entry), y
    written once, and the phases, diag and plan tables (slot, sign, perm,
    owner) read once, against 3 f32 operations per element and level (two
    products and a sum, unfused, each an issue slot) plus the diag
    product."""
    from repro_torch.core import photonic
    P, L = layout.ports, layout.levels
    items = photonic.mesh_owner_plan(layout).shape[1]
    words = ((1 if shared else S) * B * P + S * B * P + S * L * layout.slots
             + S * P + 3 * L * P + L * items)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = S * B * P * (3 * L + 1) / PEAK_F32_ISSUE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dense_bound(layout, S: int, B: int, shared: bool) -> tuple:
    """(bound_ms, bound_by) of one route B call: the densification (P
    identity rows per entry in the Givens form, unfused operations at the
    issue rate) plus three TF32 products of 2·S·B·P² FLOPs at the tensor
    cores' rate, against x and y, the phases, diag and plan tables and the
    (S, P, P) scratch written and read once."""
    P, L = layout.ports, layout.levels
    words = ((1 if shared else S) * B * P + S * B * P + 2 * S * P * P
             + S * L * layout.slots + S * P + 3 * L * P)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = (S * P * P * (3 * L + 1) / PEAK_F32_ISSUE
             + 3 * 2 * S * B * P * P / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# label -> (layout, ports, S, rows, shared x, transpose, entry): onn's
# 1024-port meshes at a ZO step's launches (the hidden layer's U and V
# transposed on 11 x 4300 rows per entry; layer 0's U mesh on the 100 rows
# and the columns' transposed feed), a decompose_orthogonal layout, 160
# ports off every tile, a layout whose pairs are not adjacent, and route A
# and the owner walk on layouts the resident design holds too.  entry:
# "dispatch" (the route wide_route picks, given beside it), a route forced,
# or "resident" (route A and the owner walk against the resident design).
# "hidden-u" is the main case: route B's row; "hidden-u-warp-rows" route
# A's.
MESH_WIDE_CASES = {
    "hidden-u": ("rect", 1024, 11, 4300, False, False, "dispatch:dense"),
    "hidden-u-warp-rows": ("rect", 1024, 11, 4300, False, False,
                           "warp_rows"),
    "hidden-u-owner-walk": ("rect", 1024, 11, 4300, False, False,
                            "owner_walk"),
    "hidden-v-tr": ("rect", 1024, 11, 4300, False, True, "dispatch:dense"),
    "u1024-shared-100": ("rect", 1024, 11, 100, True, False,
                         "dispatch:warp_rows"),
    "u1024-shared-21-tr": ("rect", 1024, 11, 21, True, True,
                           "dispatch:warp_rows"),
    "reck256-per-entry": ("reck", 256, 3, 300, False, False, "warp_rows"),
    "reck256-dense-tr": ("reck", 256, 3, 400, False, True, "dispatch:dense"),
    "p160-777": ("rect", 160, 3, 777, False, False, "dispatch:dense"),
    "p160-777-warp-rows": ("rect", 160, 3, 777, False, False, "warp_rows"),
    "p160-not-adjacent": ("skew", 160, 3, 200, False, True,
                          "dispatch:owner_walk"),
    "p16-vs-resident": ("rect", 16, 11, 100, True, True, "resident"),
    "p64-vs-resident": ("rect", 64, 3, 37, False, False, "resident"),
}
# the timed cases: (ms calls, kernel_device_ms traced)
MESH_WIDE_TIMED = ("hidden-u", "hidden-u-warp-rows", "hidden-u-owner-walk",
                   "u1024-shared-100", "u1024-shared-21-tr")


def skew_layout(ports: int):
    """A layout of ``ports`` levels whose pairs are (a, a+2): too deep for
    the resident design at 160 ports, and no route A's."""
    from repro_torch.core import photonic
    ops = [(a, a + 2) for c in range(2 * ports)
           for a in range(c % 4, ports - 2, 4)]
    return photonic.schedule_ops(ports, ops)


def phase_mesh_wide(device) -> dict:
    """The wide layouts of ``mesh_apply_stacked`` against the plain version
    on the card: route A and the owner walk bit for bit, route B within
    the f32 bound; route A and the owner walk against the resident design
    where it holds the layout."""
    import numpy as np
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh

    launch = {"warp_rows": mesh.launch_warp_rows, "dense": mesh.launch_dense,
              "owner_walk": mesh.launch_owner_walk}
    results, hidden = {}, {}
    for i, (label, (kind, ports, S, B, shared, transpose, entry)) in \
            enumerate(MESH_WIDE_CASES.items()):
        if kind == "rect":
            layout = photonic.rectangular_layout(ports)
        elif kind == "skew":
            layout = skew_layout(ports)
        else:
            q, _ = np.linalg.qr(np.random.RandomState(ports)
                                .standard_normal((ports, ports)))
            layout = photonic.decompose_orthogonal(q)[0]
        gen = torch.Generator().manual_seed(3300 + i)
        phases = (0.1 * torch.randn((S, *layout.phase_shape()),
                                    generator=gen)).to(device)
        diag = torch.where(torch.rand((S, ports), generator=gen) < 0.5,
                           -1.0, 1.0).to(device)
        x = torch.randn((B, ports) if shared else (S, B, ports),
                        generator=gen).to(device)
        row = {"case": label, "ports": ports, "levels": layout.levels,
               "slots": layout.slots, "S": S, "rows": B, "shared_x": shared,
               "transpose": transpose, "design": mesh.mesh_design(layout),
               "wide_route": mesh.wide_route(layout, S, B)}
        plain = photonic.mesh_apply_stacked(layout, phases, diag, x,
                                            transpose)
        if entry == "resident":
            want = mesh.launch_resident(layout, phases, diag, x, transpose)
            _check_close("mesh_apply_stacked (resident)", label, want, plain)
            routes = ("warp_rows", "owner_walk")
        else:
            want = plain
            route = entry.split(":")[-1]
            if entry.startswith("dispatch") and row["wide_route"] != route:
                raise AssertionError(f"{label}: the {ports}-port layout at "
                                     f"S {S}, {B} rows took "
                                     f"{row['wide_route']}, not {route}")
            routes = (route,)
        for route in routes:
            before = dict(mesh.mesh_apply_stacked.design_launches)
            y = (mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)
                 if entry.startswith("dispatch")
                 else launch[route](layout, phases, diag, x, transpose))
            after = mesh.mesh_apply_stacked.design_launches
            if {k: after[k] - before[k] for k in after} != {
                    k: int(k == route) for k in after}:
                raise AssertionError(f"{label}: one {route} call counted "
                                     f"{after} after {before}")
            err, scale = _check_close(f"mesh_apply_stacked ({route})", label,
                                      y, want)
            differ = int((y != want).sum())
            if differ and route != "dense":
                raise AssertionError(f"the {route} mesh at {label}: {differ} "
                                     "elements differ from the "
                                     f"{'plain' if want is plain else 'resident'}"
                                     " version on the card")
            row[route] = {"max_abs_err": err, "max_abs_plain": scale,
                          "bitwise_equal": not differ}
        row["against"] = "resident" if entry == "resident" else "plain"
        row["max_abs_err"] = max(row[r]["max_abs_err"] for r in routes)
        if label in MESH_WIDE_TIMED:
            route = routes[0]
            call = (lambda: launch[route](layout, phases, diag, x, transpose))
            fill = torch.empty(1 << 20, device=device)
            slow = route == "owner_walk"
            row["ms"] = _time_ms(call, 3 if slow else 10, warmup=1 if slow
                                 else 2)
            # the profiler may drop a window's first kernel: a fill leads
            traced = _profile(call, match="mesh_",
                              lead=lambda: fill.fill_(0.0))
            row["kernel_device_ms"] = traced["match_ms"]
            row["kernel_each_ms"] = traced["match_each_ms"]
            row["rows_config"] = (
                list(mesh.rows_config(layout, S, ports if route == "dense"
                                      else B, mesh._sm_count(device)))
                if route != "owner_walk" else mesh.stream_rows(
                    layout, S, B, mesh._sm_count(device)))
            row["bound_ms"], row["bound_by"] = (
                _dense_bound if route == "dense" else _mesh_bound)(
                    layout, S, B, shared)
            if label.startswith("hidden-u"):
                if not hidden:
                    hidden["plain_ms"] = _time_ms(
                        lambda: photonic.mesh_apply_stacked(
                            layout, phases, diag, x, transpose), 2, warmup=1)
                    # the library yardstick: one bmm against the 11
                    # unitaries made dense (y[s] = x[s] @ m[s]), TF32 off
                    eye = torch.eye(ports, device=device)
                    m = photonic.mesh_apply_stacked(layout, phases, diag,
                                                    eye, transpose)
                    hidden["library_ms"] = _time_ms(lambda: torch.bmm(x, m),
                                                    10, warmup=2)
                    del m
                row.update(hidden)
        results[label] = row
        print(f"[mesh-wide] {json.dumps(row)}", flush=True)
    return results


def densify_inputs(hidden: int, tt_L: int, S: int, noisy: bool, bits,
                   device, seed: int, mixed_diag: bool = False) -> tuple:
    """Every core matrix of a tonn model with S stacked parameter sets
    (Φ + 0.01·N(0, 1) on the trainable leaves, drawn from ``seed``), its
    chip noise, noise model and quant config: the arguments of
    ``mesh_densify_stacked``.  The ±1 diag buffers are ``(S, P)``, or
    with ``mixed_diag`` ``(P,)`` on every odd matrix."""
    import torch
    from repro_torch.core import photonic, pinn
    from repro_torch.device import counter_generator, to_device
    from repro_torch.kernels import quant as quant_lib

    model = pinn.TensorPinn(pinn.PINNConfig(
        hidden=hidden, mode="tonn", tt_L=tt_L,
        noise=photonic.NoiseModel(enabled=noisy)))
    params = model.init(counter_generator(S))
    noise = model.sample_noise(counter_generator(S, 99))
    gen = torch.Generator().manual_seed(seed)
    pms, ps, nzs = [], [], []
    for i, layer in enumerate(model.photonic_cores):
        for k, pm in enumerate(layer):
            p = params[f"pcores{i}"][k]
            stacked = {key: v + 0.01 * torch.randn((S, *v.shape),
                                                   generator=gen)
                       for key, v in p.items()
                       if key not in photonic.PHOTONIC_BUFFER_KEYS}
            for key in photonic.PHOTONIC_BUFFER_KEYS:
                stacked[key] = (p[key] if mixed_diag and len(pms) % 2
                                else p[key].expand(S, -1).contiguous())
            pms.append(pm)
            ps.append(to_device(stacked, device))
            nzs.append(None if noise is None
                       else to_device(noise[f"pcores{i}"][k], device))
    quant = (quant_lib.QuantConfig(enabled=True, dtype=None,
                                   phase_bits=bits) if bits else None)
    return pms, ps, nzs, model.cfg.noise, quant


def aten_ops(fn) -> list:
    """The aten ops (``OpOverload``s) that one call of ``fn`` dispatches,
    in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        fn()
    return ops.seen


def op_counts(seen: list) -> dict:
    """All ops, and those that are not views (each of those is an
    allocation or a kernel on the card)."""
    return {"ops": len(seen),
            "non_view_ops": sum(not f.is_view for f in seen)}


def _dense_meshes(pms, ps, device) -> list:
    """(feed, unitary) of the 16 meshes of a densification made dense: per
    matrix the V mesh's identity feed against its per-entry transposed
    unitary (S, in, in), and an (S, in, out) feed against the U mesh's
    (S, out, out)."""
    import torch
    from repro_torch.core import photonic
    gen = torch.Generator().manual_seed(3200)
    pairs = []
    for pm, p in zip(pms, ps):
        S = p["sigma"].shape[0]
        eye_v = torch.eye(pm.in_dim, device=device)
        pairs.append((eye_v, photonic.mesh_apply_stacked(
            pm.layout_v, p["phases_v"], p["diag_v"], eye_v, transpose=True)))
        feed_u = torch.randn((S, pm.in_dim, pm.out_dim),
                             generator=gen).to(device)
        pairs.append((feed_u, photonic.mesh_apply_stacked(
            pm.layout_u, p["phases_u"], p["diag_u"],
            torch.eye(pm.out_dim, device=device))))
    return pairs


def _densify_bound(pms, ps, nzs, dac: bool) -> tuple:
    """(bound_ms, bound_by) of one grouped call (``_densify_counts``)."""
    words, ops = _densify_counts(pms, ps, nzs, dac)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_ISSUE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _densify_counts(pms, ps, nzs, dac: bool) -> tuple:
    """(words, operations) of one grouped call: its inputs (phases, sigma,
    diag buffers, chip noise, the plan's slot / sign / perm) read once and
    its cores written once, and its f32 operations, each rounded on its
    own and so one issue slot (DAC snap 3 and noise model 5 per phase;
    sin, cos and the sign product per wire and level, each counted as
    one; 3 per element per level; the diag and sigma scaling)."""
    words = ops = 0
    for pm, p, nz in zip(pms, ps, nzs):
        S = p["sigma"].shape[0]
        words += sum(t.numel() for t in p.values()) + S * pm.out_dim * pm.in_dim
        for lay, rows in ((pm.layout_u, pm.in_dim), (pm.layout_v, pm.in_dim)):
            phases = lay.levels * lay.slots
            words += 3 * lay.levels * lay.ports + (2 * phases if nz else 0)
            ops += S * (phases * ((3 if dac else 0) + (5 if nz else 0))
                        + 3 * lay.levels * lay.ports
                        + 3 * rows * lay.ports * lay.levels)
        ops += 3 * S * pm.in_dim * pm.out_dim
    return words, ops


# label -> (hidden, tt_L, S, noise, phase bits); "paper-noise" is the main
# one: the densification of a TONN_ONCHIP_FUSED ZO step (N = 10)
DENSIFY_CASES = {
    "paper-noise": (1024, 4, 11, True, None),
    "paper-noise-pb8": (1024, 4, 11, True, 8),
    "paper": (1024, 4, 11, False, None),
    "paper-pb8": (1024, 4, 11, False, 8),
    "reduced-noise-pb8": (64, 3, 3, True, 8),
    "reduced": (64, 3, 3, False, None),
}


def _densify_cases(device) -> dict:
    import torch
    from repro_torch.core import photonic
    from repro_torch.device import to_device
    from repro_torch.kernels import mesh_apply as mesh

    cpu = torch.device("cpu")
    results = {}
    for label, (hidden, tt_L, S, noisy, bits) in DENSIFY_CASES.items():
        pms, ps, nzs, model, quant = densify_inputs(hidden, tt_L, S, noisy,
                                                    bits, device, 3100 + S)
        got = mesh.mesh_densify_stacked(pms, ps, nzs, model, quant)
        plain = photonic.mesh_densify_stacked(pms, ps, nzs, model, quant)
        errs = [_check_close("mesh_densify_stacked", label, w, want)
                for w, want in zip(got, plain)]
        on_cpu = photonic.mesh_densify_stacked(
            pms, [to_device(p, cpu) for p in ps],
            [None if nz is None else to_device(nz, cpu) for nz in nzs],
            model, quant)
        cpu_errs = [_check_close("mesh_densify_stacked", f"{label} vs the "
                                 "CPU", w.cpu(), want)[0]
                    for w, want in zip(got, on_cpu)]
        # rounded op by op in the plain order: bit-equal on the card
        differ = sum(int((w != want).sum()) for w, want in zip(got, plain))
        if differ:
            raise AssertionError(f"mesh_densify_stacked at {label}: {differ} "
                                 "elements differ from the plain twin on "
                                 "the card")
        row = {"case": label, "matrices": len(pms), "S": S, "noise": noisy,
               "phase_bits": bits,
               "shapes": sorted({(pm.out_dim, pm.in_dim) for pm in pms}),
               "max_abs_err": max(e for e, _ in errs),
               "max_abs_plain": max(m for _, m in errs),
               "bitwise_equal": differ == 0, "elements_differing": differ,
               "max_abs_card_vs_cpu": max(cpu_errs)}
        if label == "paper-noise":
            row["ms"] = _time_ms(lambda: mesh.mesh_densify_stacked(
                pms, ps, nzs, model, quant), 200)
            row["host_ms"] = _host_ms(lambda: mesh.mesh_densify_stacked(
                pms, ps, nzs, model, quant), 200)
            # back-to-back calls are bound by the host; the kernel alone
            row["kernel_device_ms"] = _profile(
                lambda: mesh.mesh_densify_stacked(pms, ps, nzs, model,
                                                  quant))["device_ms"]
            row["standalone_loop_ms"] = _time_ms(lambda: [
                pm.to_dense_stacked(p, model, nz, quant)
                for pm, p, nz in zip(pms, ps, nzs)], 50)
            row["plain_ms"] = _time_ms(lambda: photonic.mesh_densify_stacked(
                pms, ps, nzs, model, quant), 20)
            # for scale only (no one call maps phases to cores): the same
            # 16 meshes as dense matmuls
            dense = _dense_meshes(pms, ps, device)
            row["matmul_16_meshes_ms"] = _time_ms(lambda: [
                torch.matmul(feed, u) for feed, u in dense], 200)
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = _densify_bound(
                pms, ps, nzs, quant is not None)
        results[f"densify-{label}"] = row
        print(f"[mesh] {json.dumps(row)}", flush=True)
    return results


MESH_GRAD_BOUND = 1e-4       # of max|plain|, per output


def _host_ms(fn, iters: int, warmup: int = 5) -> float:
    """Host time of one call over ``iters`` back-to-back calls, on the
    host's clock, without waiting for the card (whose work a call
    enqueues): a call's host half."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def _empty_launch(fill) -> dict:
    """The launch floor beside a small kernel's time: an empty kernel
    (``torch.cuda._sleep(0)``, a spin of 0 cycles) per launch back to back
    on CUDA events (``empty_launch_ms``) and alone in a trace, a fill
    leading (``empty_kernel_device_ms``: the window's device time less the
    fill's)."""
    import torch

    def empty():
        torch.cuda._sleep(0)
    prof = _profile(empty, lead=lambda: fill.fill_(0.0))
    rest = [ms for name, ms, _ in prof["top"] if "fill" not in name.lower()]
    return {"empty_launch_ms": _time_ms(empty, 200),
            "empty_kernel_device_ms": sum(rest) if rest else None}


def _grad_share(name: str, label: str, got, plain) -> tuple:
    """(max|got − plain|, max|plain|); raises past MESH_GRAD_BOUND ·
    max|plain| (the same f32 products, the phase sums in another order;
    the resident backward's states recovered level by level)."""
    import torch
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not (torch.isfinite(got).all().item()
            and err <= MESH_GRAD_BOUND * scale + 1e-12):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}: max|diff| {err:.3e}, max|plain| "
                             f"{scale:.3e}")
    return err, scale


def _densify_grad_bound(pms, ps, nzs, saves) -> tuple:
    """(bound_ms, bound_by) of one grouped backward: the forward's inputs
    read once (``_densify_counts``; dW, the cores' gradients, in place of
    the cores written) and dphases and dsigma written once, against its f32
    operations, each an issue slot: the forward again, then per element and
    level of each mesh 3 for the gradient and 3 more to recover the state
    where it is not kept, 11 per MZI and row for its phase's sum, the
    noise model's transpose (5 per phase) and σ's (5 per element of
    k)."""
    words, ops = _densify_counts(pms, ps, nzs, False)
    for pm, p, nz, keep in zip(pms, ps, nzs, saves):
        S = p["sigma"].shape[0]
        words += S * pm.k
        for lay in (pm.layout_u, pm.layout_v):
            words += S * lay.levels * lay.slots
            ops += S * (pm.in_dim * lay.ports * lay.levels * (
                3 + (0 if keep else 3)) + 11 * pm.in_dim * lay.num_mzis
                + (5 * lay.levels * lay.slots if nz else 0))
        ops += 5 * S * pm.in_dim * pm.k
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_ISSUE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# operations per MZI and row for its phase's sum, by backward design: the
# resident one's 11; the warp-rows one's 4, g_lo·y_hi − g_hi·y_lo (two
# products and a difference) and the add over the rows (its sign q is
# applied once a slot, after the rows' sum); the dense one walks M's
# identity rows by the warp-rows walk
GRAD_PAIR_OPS = {"resident": 11, "warp_rows": 4, "dense": 4}


def _apply_grad_bound(layout, S: int, B: int, design: str,
                      shared: bool = False) -> tuple:
    """(bound_ms, bound_by) of one ``mesh_apply_stacked_grad`` by
    ``design``: its inputs read and dx and dphases written once (y and
    dy, or for ``"dense"`` x, dy and M; the phases, diag and plan tables),
    against per element and level 3 operations to recover the state and
    3 for the gradient, and ``GRAD_PAIR_OPS[design]`` per MZI and row for
    its phase's sum, each an issue slot, on the B rows (``"dense"``: M's
    P identity rows, plus the two products dx = dy·Mᵀ and dM = xᵀ·dy, 3 ×
    2·S·B·P² TF32 FLOPs each at the tensor cores' rate)."""
    P, L = layout.ports, layout.levels
    words = 3 * S * B * P + 2 * S * L * layout.slots + S * P + 3 * L * P
    rows = B
    t_tf32 = 0.0
    if design == "dense":
        words += S * P * P - (S - 1) * B * P * shared
        rows = P
        t_tf32 = 2 * 3 * 2 * S * B * P * P / PEAK_TF32_FLOPS * 1e3
    ops = S * rows * (6 * P * L + GRAD_PAIR_OPS[design] * layout.num_mzis
                      + P)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_ISSUE * 1e3 + t_tf32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# label -> (hidden, tt_L, S, noise): the grouped backward on the paper's 8
# core matrices; "s1-noise" is the main one (a tonn BP step with
# --pinn-noise: a stack of one), "s11-noise" the forward's timed shape;
# "tt2-s1-noise" the 4 matrices of tt_L 2 (32 x 64 and 64 x 32), whose
# states do not fit a block: the kernel recovers them
DENSIFY_GRAD_CASES = {"s1-noise": (1024, 4, 1, True),
                      "s1": (1024, 4, 1, False),
                      "s11-noise": (1024, 4, 11, True),
                      "s11": (1024, 4, 11, False),
                      "tt2-s1-noise": (1024, 2, 1, True)}
DENSIFY_GRAD_TIMED = ("s1-noise", "s11-noise")
# label -> (ports, S, rows, shared x, transpose): the resident backward at
# onn's BP launches at hidden 64 (4300 stencil rows; layer 0's 21-port V
# mesh on the 100 rows) and a 16-port mesh, and at Table 1's off-chip ONN
# row at hidden 1024 ("v21-4300-tr", its main one: layer 0's 21-port V
# mesh, transposed, on the stencil's 4300 rows of a shared x, S = 1, as
# PhotonicMatrix.apply lays it out); the warp-rows backward handed y and dy
# at onn's BP shapes at hidden 1024 (the hidden layer's V^T and U meshes
# on 4300 stencil rows, whose forward takes route B and whose backward on
# the main path is the dense one, MESH_GRAD_DENSE; layer 0's U mesh on
# the 100 rows and on the 21 identity columns, route A), a Reck layout of
# 256 ports (decompose_orthogonal: 509 levels; ports is "reck256") and
# 160 ports at S = 3, B = 777; and an 80-port mesh on 4300 rows, which the
# dispatch sends to the resident backward's block design (every other
# resident case takes the warp design and is run through the block design
# forced as well)
MESH_GRAD_CASES = {
    "p16-4300": (16, 1, 4300, False, False),
    "p16-4300-tr": (16, 1, 4300, False, True),
    "p64-4300": (64, 1, 4300, False, False),
    "p64-4300-tr": (64, 1, 4300, False, True),
    "v21-100-tr": (21, 1, 100, True, True),
    "v21-100": (21, 1, 100, True, False),
    "v21-4300-tr": (21, 1, 4300, True, True),
    "p1024-4300": (1024, 1, 4300, False, False),
    "p1024-4300-tr": (1024, 1, 4300, False, True),
    "u1024-100": (1024, 1, 100, True, False),
    "u1024-21": (1024, 1, 21, True, False),
    "reck256-300-tr": ("reck256", 2, 300, False, True),
    "p160-777-s3": (160, 3, 777, False, False),
    "p80-4300": (80, 1, 4300, False, False),
}
MESH_GRAD_TIMED = ("p64-4300", "p64-4300-tr", "v21-100-tr", "v21-4300-tr")
# the warp-rows backward's cases checked and timed in a process of their
# own at the end of the run (phase_mesh_grad_wide), not in phase_mesh_grad
MESH_GRAD_WIDE = ("p1024-4300", "u1024-100", "u1024-21")
# label -> (ports, S, rows, shared x, transpose): the dense backward, from
# route B's forward (launch_dense_keep), in that process too, all timed:
# the hidden layer's U mesh of an onn BP step at hidden 1024 ("dense-
# p1024-4300", its main case), transposed (the V^T mesh), on a shared x,
# and 160 ports at S = 3
MESH_GRAD_DENSE = {
    "dense-p1024-4300": (1024, 1, 4300, False, False),
    "dense-p1024-4300-tr": (1024, 1, 4300, False, True),
    "dense-p1024-4300-shared": (1024, 2, 4300, True, False),
    "dense-p160-777-s3": (160, 3, 777, False, False),
}


def _grad_layout(ports):
    """The rectangular layout of ``ports``, or for ``"reck<P>"`` the
    ``decompose_orthogonal`` layout of a random orthogonal P x P (seed
    P)."""
    import numpy as np
    from repro_torch.core import photonic
    if isinstance(ports, int):
        return photonic.rectangular_layout(ports)
    P = int(ports[4:])
    q, _ = np.linalg.qr(np.random.RandomState(P).standard_normal((P, P)))
    return photonic.decompose_orthogonal(q)[0]


def _forced_block(mesh, layout, phases, diag, y, dy, transpose, shared,
                  pdx, pdph, label) -> dict:
    """A warp-design case through the resident backward's block design
    forced (``mesh._forced_resident``): one launch of it a call, dphases
    within MESH_GRAD_BOUND · max|plain| of the plain version's, dx its
    bits, two calls bit for bit."""
    import torch
    grad = mesh.mesh_apply_stacked_grad
    with mesh._forced_resident("block"):
        before = dict(grad.resident_launches)
        dx, dph = grad(layout, phases, diag, y, dy, transpose)
        by_res = {d: n - before[d] for d, n in grad.resident_launches.items()}
        again = grad(layout, phases, diag, y, dy, transpose)
    if by_res != {"warp": 0, "block": 1}:
        raise AssertionError(f"mesh_apply_stacked_grad at {label}, block "
                             f"design forced: launches {by_res}")
    err, scale = _grad_share("mesh_apply_stacked_grad",
                             f"{label} (block design)", dph, pdph)
    dxs = dx.sum(0) if shared else dx
    if not (torch.equal(dxs, pdx) and torch.equal(dx, again[0])
            and torch.equal(dph, again[1])):
        raise AssertionError(f"mesh_apply_stacked_grad at {label}, block "
                             "design forced: dx not the plain version's "
                             "bits, or two calls differ")
    return {"max_abs_err": err, "max_err_over_bound":
            err / (MESH_GRAD_BOUND * scale), "dx_bitwise_equal_plain": True,
            "repeat_bitwise_equal": True, "launches": 1}


def _mesh_grad_case(device, label: str, timed: bool) -> dict:
    """One ``MESH_GRAD_CASES`` case of ``mesh_apply_stacked_grad`` against
    ``ref.mesh_apply_grad_ref`` (one launch of its design, two calls bit
    for bit; a warp-design case through the block design forced, too) and,
    ``timed``, its times beside its bound, the plain version and autograd
    of the plain forward."""
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref
    fill = torch.empty(1, device=device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    i = list(MESH_GRAD_CASES).index(label)
    kind, S, B, shared, transpose = MESH_GRAD_CASES[label]
    layout = _grad_layout(kind)
    ports = layout.ports
    design = mesh.grad_design(layout)
    res = mesh.resident_grad_design(layout) if design == "resident" else None
    gen = torch.Generator().manual_seed(3500 + i)
    phases = torch.randn((S, *layout.phase_shape()), generator=gen).to(
        device)
    diag = torch.where(torch.rand((S, ports), generator=gen) < 0.5,
                       -1.0, 1.0).to(device)
    x = torch.randn((B, ports) if shared else (S, B, ports),
                    generator=gen).to(device)
    y = mesh.mesh_apply_stacked(layout, phases, diag, x, transpose)
    dy = torch.randn(y.shape, generator=gen).to(device)
    grad = mesh.mesh_apply_stacked_grad
    before = (grad.launches, grad.design_launches[design],
              dict(grad.resident_launches))
    dx, dph = grad(layout, phases, diag, y, dy, transpose)
    by_res = {d: n - before[2][d] for d, n in grad.resident_launches.items()}
    if not (grad.launches == before[0] + 1 and
            grad.design_launches[design] == before[1] + 1 and
            by_res == {d: int(d == res) for d in by_res}):
        raise AssertionError("mesh_apply_stacked_grad: not one launch a "
                             f"call through the {design} design "
                             f"({res or 'no resident'} design: {by_res})")
    pdx, pdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                        transpose)
    errs = [_grad_share("mesh_apply_stacked_grad", label,
                        dx.sum(0) if shared else dx, pdx),
            _grad_share("mesh_apply_stacked_grad", label, dph, pdph)]
    again = mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy,
                                         transpose)
    if not (torch.equal(dx, again[0]) and torch.equal(dph, again[1])):
        raise AssertionError(f"mesh_apply_stacked_grad at {label}: two "
                             "calls differ")
    row = {"case": label, "design": design, "ports": ports,
           "levels": layout.levels, "S": S, "rows": B,
           "shared_x": shared, "transpose": transpose,
           "forward_route": (mesh.wide_route(layout, S, B)
                             if mesh.mesh_design(layout) == "wide"
                             else "resident")}
    if res == "warp":
        pairs, R, warps, cols, per, chunk, fold = \
            mesh.resident_grad_warp_config(layout, S, B, sms)
        row.update(resident_design=res, lanes="pairs" if pairs else "lanes",
                   rows_per_warp=R, warps=warps, block_columns=cols,
                   groups_per_column=per, chunk=chunk, fold=fold,
                   kernels_per_call_by_design=1 + (cols > 1 and not fold))
    elif res == "block":
        rows = mesh.grad_rows_per_block(layout)
        cols = mesh.grad_columns(S, -(-B // rows), sms)
        row.update(resident_design=res, rows_per_block=rows,
                   block_columns=cols,
                   kernels_per_call_by_design=1 + (cols > 1))
    else:
        W, R, warps, cols = mesh.grad_rows_config(layout, S, B, sms)
        row.update(lane_width=W, rows_per_warp=R, warps=warps,
                   block_columns=cols,
                   scratch_bytes=mesh.grad_scratch_bytes(layout, S, B,
                                                         sms))
    row.update({
        "max_abs_err": max(e for e, _ in errs),
        "max_err_over_bound": max(e / (MESH_GRAD_BOUND * m)
                                  for e, m in errs if m),
        "dx_bitwise_equal_plain": bool(torch.equal(
            dx.sum(0) if shared else dx, pdx)),
        "repeat_bitwise_equal": True})
    if res is not None and not row["dx_bitwise_equal_plain"]:
        raise AssertionError(f"mesh_apply_stacked_grad at {label}: the "
                             f"{res} design's dx is not the plain version's "
                             "bits")
    if res == "warp":
        row["forced_block"] = _forced_block(mesh, layout, phases, diag, y,
                                            dy, transpose, shared, pdx, pdph,
                                            label)
    if res is not None:
        row["host_ms"] = _host_ms(lambda: mesh.mesh_apply_stacked_grad(
            layout, phases, diag, y, dy, transpose), 200)
    if timed:
        wide = design == "warp_rows"

        def call():
            return mesh.mesh_apply_stacked_grad(layout, phases, diag, y, dy,
                                                transpose)
        row["ms"] = _time_ms(call, 20 if wide else 200)
        # the backward kernel (with the trig prologue, in warp rows) and,
        # over several block columns, the small kernel that sums their
        # phase gradients (the warp design folds a few columns in its own
        # launch); a fill leads
        prof = _profile(call, match="mesh_", lead=lambda: fill.fill_(0.0))
        row["kernel_device_ms"] = prof["match_ms"]
        row["kernels_per_call"] = prof["match_kernels"]
        row["kernel_each_ms"] = prof.get("match_each_ms")
        row["plain_ms"] = _time_ms(lambda: ref.mesh_apply_grad_ref(
            layout, phases, diag, x, y, dy, transpose), 3 if wide else 20,
            warmup=1 if wide else 5)

        def autograd_plain():
            p = phases.clone().requires_grad_()
            xx = x.clone().requires_grad_()
            return torch.autograd.grad(photonic.mesh_apply_stacked(
                layout, p, diag, xx, transpose), (p, xx), dy)
        # at 1024 ports on 4300 rows autograd keeps two (4300, 1024)
        # tensors a level: ~36 GB, handed back to the card after
        row["autograd_plain_ms"] = _time_ms(
            autograd_plain, 3 if wide else 20, warmup=1 if wide else 5)
        torch.cuda.empty_cache()
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = _apply_grad_bound(layout, S, B,
                                                             design)
    print(f"[mesh-grad] {json.dumps(row)}", flush=True)
    return row


def phase_mesh_grad(device) -> dict:
    """The two mesh backwards against their plain versions
    (``ref.mesh_densify_grad_ref``, ``ref.mesh_apply_grad_ref``) within
    ``MESH_GRAD_BOUND``·max|plain| per output, each call one launch, two
    calls bit for bit; timed (CUDA events, one launch alone in a trace)
    beside the plain version and, for scale (no one PyTorch call gives
    dφ), ``torch.autograd.grad`` through the plain forward: the path the
    BP baselines took before."""
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref

    results = {}
    fill = torch.empty(1, device=device)
    for label, (hidden, tt_L, S, noisy) in DENSIFY_GRAD_CASES.items():
        pms, ps, nzs, model, _ = densify_inputs(hidden, tt_L, S, noisy,
                                                None, device, 3300 + S)
        gen = torch.Generator().manual_seed(3400 + S)
        dW = [torch.randn((S, pm.out_dim, pm.in_dim), generator=gen).to(
            device) for pm in pms]
        saves = [mesh.densify_grad_saves(pm) for pm in pms]
        design = mesh.densify_grad_design(pms)
        before = mesh.mesh_densify_grad.launches
        by_design = mesh.mesh_densify_grad.design_launches[design]
        got = mesh.mesh_densify_grad(pms, ps, nzs, model, dW)
        if not (mesh.mesh_densify_grad.launches == before + 1 and
                mesh.mesh_densify_grad.design_launches[design]
                == by_design + 1):
            raise AssertionError("mesh_densify_grad: not one launch a call "
                                 f"through the {design} design")
        # the warp design keeps every state; the block design where
        # densify_grad_saves holds
        plain = ref.mesh_densify_grad_ref(pms, ps, nzs, model, dW,
                                          design == "warp" or saves)
        errs = [_grad_share("mesh_densify_grad", label, a, b)
                for trio, ptrio in zip(got, plain)
                for a, b in zip(trio, ptrio)]
        again = mesh.mesh_densify_grad(pms, ps, nzs, model, dW)
        if not all(torch.equal(a, b) for t, u in zip(got, again)
                   for a, b in zip(t, u)):
            raise AssertionError(f"mesh_densify_grad at {label}: two calls "
                                 "differ")
        row = {"case": label, "design": design, "matrices": len(pms),
               "tt_L": tt_L, "S": S, "noise": noisy,
               "saved_states": design == "warp" or saves,
               "max_abs_err": max(e for e, _ in errs),
               "max_err_over_bound": max(e / (MESH_GRAD_BOUND * m)
                                         for e, m in errs if m),
               "repeat_bitwise_equal": True}
        if label in DENSIFY_GRAD_TIMED:
            def call():
                return mesh.mesh_densify_grad(pms, ps, nzs, model, dW)
            row["ms"] = _time_ms(call, 200)
            row["host_ms"] = _host_ms(call, 200)
            # the profiler may drop a window's first kernel: a fill leads
            prof = _profile(call, match="mesh_densify_grad",
                            lead=lambda: fill.fill_(0.0))
            row["kernel_device_ms"] = prof["match_ms"]
            row["kernels_per_call"] = prof["match_kernels"]
            row.update(_empty_launch(fill))
            row["plain_ms"] = _time_ms(lambda: ref.mesh_densify_grad_ref(
                pms, ps, nzs, model, dW, saves), 20)
            leaves = [p[k] for p in ps for k in ("phases_u", "phases_v",
                                                 "sigma")]

            def autograd_plain():
                for t in leaves:
                    t.requires_grad_()
                cores = photonic.mesh_densify_stacked(pms, ps, nzs, model)
                out = torch.autograd.grad(cores, leaves, dW)
                for t in leaves:
                    t.requires_grad_(False)
                return out
            row["autograd_plain_ms"] = _time_ms(autograd_plain, 20)
            row["library_ms"] = None
            row["bound_ms"], row["bound_by"] = _densify_grad_bound(
                pms, ps, nzs, saves)
        results[f"densify-{label}"] = row
        print(f"[mesh-grad] {json.dumps(row)}", flush=True)

    for label in MESH_GRAD_CASES:
        if label not in MESH_GRAD_WIDE:
            results[label] = _mesh_grad_case(device, label,
                                             label in MESH_GRAD_TIMED)
    return results


def _mesh_grad_dense_case(device, label: str) -> dict:
    """One ``MESH_GRAD_DENSE`` case: the dense backward (x and M from
    ``launch_dense_keep``) against its plain version
    (``ref.mesh_apply_dense_grad_ref`` on the same M) and against the
    plain backward of the rows (``ref.mesh_apply_grad_ref``), each within
    ``MESH_GRAD_BOUND``; one launch of design ``"dense"`` and one of
    ``mesh_product_grad`` a call; two calls bit for bit.  Timed: per call
    (CUDA events) and its kernels alone in a trace, beside the warp-rows
    backward on the same forward's y and dy (the parent's design; the two
    in turns, dense, rows, rows, dense), the bound, the plain version;
    the products' launch (``products_ms``: both, and each alone) beside
    ``torch.matmul`` of each product (``library_products_ms``), and the
    walk (the warp-rows design handed y := M and dy := dM, no dx) on CUDA
    events (``walk_ms``); at the main case, autograd of the plain
    forward."""
    import torch
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import ref
    fill = torch.empty(1, device=device)
    i = list(MESH_GRAD_DENSE).index(label)
    ports, S, B, shared, transpose = MESH_GRAD_DENSE[label]
    layout = photonic.rectangular_layout(ports)
    P = layout.ports
    if mesh.grad_design(layout, S, B) != "dense":
        raise AssertionError(f"{label}: the forward does not take route B")
    gen = torch.Generator().manual_seed(3600 + i)
    phases = torch.randn((S, *layout.phase_shape()), generator=gen).to(
        device)
    diag = torch.where(torch.rand((S, P), generator=gen) < 0.5, -1.0,
                       1.0).to(device)
    x = torch.randn((B, P) if shared else (S, B, P), generator=gen).to(
        device)
    y, dense = mesh.launch_dense_keep(layout, phases, diag, x, transpose)
    dy = torch.randn(y.shape, generator=gen).to(device)
    grad = mesh.mesh_apply_stacked_grad
    before = (grad.launches, grad.design_launches["dense"],
              mesh.mesh_product_grad.launches)

    def call():
        return grad(layout, phases, diag, None, dy, transpose, x=x,
                    dense=dense)
    dx, dph = call()
    if (grad.launches, grad.design_launches["dense"],
            mesh.mesh_product_grad.launches) != (
                before[0] + 1, before[1] + 1,
                before[2] + DENSE_GRAD_PRODUCTS):
        raise AssertionError(f"{label}: not one dense backward and one "
                             "product launch a call")
    dxs = dx.sum(0) if shared else dx
    pdx, pdph = ref.mesh_apply_dense_grad_ref(layout, phases, diag, x,
                                              dense, dy, transpose)
    errs = [_grad_share("the dense backward", label, dxs, pdx),
            _grad_share("the dense backward", label, dph, pdph)]
    rdx, rdph = ref.mesh_apply_grad_ref(layout, phases, diag, x, y, dy,
                                        transpose)
    rows_errs = [_grad_share("the dense backward (rows' plain version)",
                             label, dxs, rdx),
                 _grad_share("the dense backward (rows' plain version)",
                             label, dph, rdph)]
    again = call()
    if not (torch.equal(dx, again[0]) and torch.equal(dph, again[1])):
        raise AssertionError(f"the dense backward at {label}: two calls "
                             "differ")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    W, R, warps, cols = mesh.grad_rows_config(layout, S, P, sms)
    row = {"case": label, "design": "dense", "ports": P,
           "levels": layout.levels, "S": S, "rows": B, "shared_x": shared,
           "transpose": transpose, "forward_route": "dense",
           "splits": list(mesh.dense_grad_splits(S, P, B, sms)),
           "walk": {"lane_width": W, "rows_per_warp": R, "warps": warps,
                    "block_columns": cols},
           "max_abs_err": max(e for e, _ in errs),
           "max_err_over_bound": max(e / (MESH_GRAD_BOUND * m)
                                     for e, m in errs if m),
           "rows_plain_max_err_over_bound": max(
               e / (MESH_GRAD_BOUND * m) for e, m in rows_errs if m),
           "dx_bitwise_equal_plain": bool(torch.equal(dxs, pdx)),
           "repeat_bitwise_equal": True}

    def rows_call():
        return grad(layout, phases, diag, y, dy, transpose)
    turns = [_time_ms(fn, 10) for fn in (call, rows_call, rows_call, call)]
    row["ms"] = min(turns[0], turns[3])
    row["turns_ms"] = {"dense": [turns[0], turns[3]],
                       "warp_rows": [turns[1], turns[2]]}
    row["warp_rows_ms"] = min(turns[1], turns[2])
    # the products' launch, the splits' sum, the trig prologue, the walk
    # and the block columns' sum; a fill leads.  The trace may drop the
    # first of them: then the call's device time is not measured
    splits, per = mesh.dense_grad_splits(S, P, B, sms)
    kernels = 3 + (splits > 1) + (cols > 1)
    prof = _profile(call, match="mesh_", lead=lambda: fill.fill_(0.0))
    row["kernels_per_call"] = kernels
    row["kernels_traced"] = prof["match_kernels"]
    row["kernel_device_ms"] = (prof["match_ms"]
                               if prof["match_kernels"] == kernels else None)
    row["kernel_each_ms"] = prof.get("match_each_ms")
    dxp = torch.empty((S, B, P), device=device)
    dmp = torch.empty_like(dense)
    xs = x.expand(S, -1, -1) if shared else x
    row["products_ms"] = {
        "both": _time_ms(lambda: mesh.mesh_product_grad(
            dy, dense, x, dxp, dmp, splits, per), 20),
        "dx": _time_ms(lambda: mesh.mesh_product_grad(
            dy, dense, None, dxp, None), 20),
        "dM": _time_ms(lambda: mesh.mesh_product_grad(
            dy, dense, x, None, dmp, splits, per), 20)}
    walk_dm = torch.matmul(xs.transpose(-1, -2), dy)
    row["walk_ms"] = _time_ms(lambda: grad(
        layout, phases, diag, dense, walk_dm, transpose, False), 10)
    row["library_products_ms"] = {
        "dx": _time_ms(lambda: torch.matmul(dy, dense.transpose(-1, -2)),
                       20),
        "dM": _time_ms(lambda: torch.matmul(xs.transpose(-1, -2), dy), 20)}
    # each product's output (the last timed launch's) against the f32
    # torch.matmul of the same product
    row["products_max_abs_err"] = {
        "dx": _grad_share("mesh_product_grad (dx)", label, dxp,
                          torch.matmul(dy, dense.transpose(-1, -2)))[0],
        "dM": _grad_share("mesh_product_grad (dM)", label, dmp,
                          torch.matmul(xs.transpose(-1, -2), dy))[0]}
    row["products_bound_ms"], row["products_bound_by"] = _products_bound(
        S, B, P, shared)
    row["library_ms"] = None
    row["plain_ms"] = _time_ms(lambda: ref.mesh_apply_dense_grad_ref(
        layout, phases, diag, x, dense, dy, transpose), 3, warmup=1)
    row["rows_plain_ms"] = _time_ms(lambda: ref.mesh_apply_grad_ref(
        layout, phases, diag, x, y, dy, transpose), 3, warmup=1)
    if label == "dense-p1024-4300":
        def autograd_plain():
            p = phases.clone().requires_grad_()
            xx = x.clone().requires_grad_()
            return torch.autograd.grad(photonic.mesh_apply_stacked(
                layout, p, diag, xx, transpose), (p, xx), dy)
        row["autograd_plain_ms"] = _time_ms(autograd_plain, 3, warmup=1)
        torch.cuda.empty_cache()
    row["bound_ms"], row["bound_by"] = _apply_grad_bound(
        layout, S, B, "dense", shared)
    print(f"[mesh-grad] {json.dumps(row)}", flush=True)
    return row


def _products_bound(S: int, B: int, P: int, shared: bool) -> tuple:
    """(bound_ms, bound_by) of the dense backward's two products: dy and
    M read, dx written; x and dy read, dM written (the splits' partials
    not counted), against 3 × 2·S·B·P² TF32 FLOPs each."""
    words = (2 * S * B * P + S * P * P
             + (1 if shared else S) * B * P + S * B * P + S * P * P)
    t_bytes = 4 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * 3 * 2 * S * B * P * P / PEAK_TF32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mesh_grad_wide_cases(device) -> dict:
    """``MESH_GRAD_WIDE``'s cases (``_mesh_grad_case``) and
    ``MESH_GRAD_DENSE``'s (``_mesh_grad_dense_case``), checked and timed,
    then the card's cached memory handed back: autograd of the plain
    1024-level mesh on 4300 rows takes ~36 GB."""
    import torch
    out = {label: _mesh_grad_case(device, label, True)
           for label in MESH_GRAD_WIDE}
    for label in MESH_GRAD_DENSE:
        out[label] = _mesh_grad_dense_case(device, label)
    torch.cuda.empty_cache()
    return out


def phase_mesh_grad_wide() -> dict:
    """``mesh_grad_wide_cases`` in a Python process of its own, last: in
    this process, after the other phases, ``torch.profiler`` loses the
    windows of these cases, and timed before ``quant-kernel`` they make
    that phase's window get lost (PERF.md §7).  This process hands its
    cached memory back first; the child uses the kernels this run built.
    Raises if the child fails."""
    import torch
    torch.cuda.empty_cache()
    code = ("import json, sys; sys.path.insert(0, 'src'); import chip_smoke, "
            "repro_torch; out = chip_smoke.mesh_grad_wide_cases("
            "repro_torch.resolve_device('cuda')); "
            "open(sys.argv[1], 'w').write(json.dumps(out))")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "wide.json"
        subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT,
                       check=True, timeout=900)
        return json.loads(out.read_text())


def phase_quant_kernel(device) -> dict:
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.kernels import ref, tt_contract as ttc

    paper = tt.PAPER_TONN_SPEC
    rank4 = tt.auto_factorize(256, 512, L=3, max_rank=4)
    # label -> (spec, P, rows, shared x, block): the three launches of a
    # QAT step at the paper's config, whose core sizes (64) are block
    # multiples, and a rank-4 spec (core sizes 256, 1024, 128) at a block
    # that divides them and at one that pads every core's last run
    cases = {"layer0-rows": (paper, 11, 100, True, 32),
             "layer0-columns": (paper, 11, 21, True, 32),
             "hidden-stencil": (paper, 11, 4300, False, 32),
             "rank4-777-b32": (rank4, 3, 777, False, 32),
             "rank4-777-b24": (rank4, 3, 777, False, 24)}
    results = {}
    for dtype in ("int8", "fp8_e4m3"):
        for i, (label, (spec, P, B, shared, block)) in enumerate(
                cases.items()):
            quant = quant_lib.QuantConfig(enabled=True, dtype=dtype,
                                          block=block)
            gen = torch.Generator().manual_seed(4000 + i)
            per = [tt.tt_init(gen, spec) for _ in range(P)]
            cores = [torch.stack([c[k] for c in per]).to(device)
                     for k in range(spec.L)]
            cores[0][0].view(-1)[:block].zero_()  # an all-zero block
            x = torch.randn((B, spec.in_dim) if shared
                            else (P, B, spec.in_dim), generator=gen).to(device)
            y = ttc.tt_contract_batched_quant(x, cores, spec, quant)
            # the cores the kernel quantizes in its launch are
            # fake_quant_stacked's: every entry is the f32 kernel's on them
            fq = [quant_lib.fake_quant_stacked(c, quant) for c in cores]
            y_f = ttc.tt_contract_batched(x, fq, spec)
            for p in range(P):
                if not torch.equal(y[p], y_f[p]):
                    raise AssertionError(
                        f"tt_contract_batched_quant entry {p} at {label} "
                        f"({dtype}) differs from tt_contract_batched on the "
                        "fake-quantized cores")
            plain = ref.tt_contract_batched_quant_ref(x, cores, spec, quant)
            err, scale = _check_close("tt_contract_batched_quant",
                                      f"{label} {dtype}", y, plain)
            row = {"case": label, "dtype": dtype, "block": block, "P": P,
                   "rows": B, "shared_x": shared,
                   "modes": [list(spec.out_modes), list(spec.in_modes)],
                   "ranks": list(spec.ranks), "max_abs_err": err,
                   "max_abs_plain": scale,
                   "entries_bitwise_equal_f32_on_fake_quant": True}
            if label == "hidden-stencil" and dtype == "int8":
                w = torch.stack([tt.tt_to_full([c[p] for c in fq], spec)
                                 for p in range(P)])            # (P, M, N)
                wt = w.transpose(1, 2)
                row["design"] = "fibers"
                row["tile"] = dataclasses.asdict(ttc.fiber_tile(spec, P * B))
                row["ms"] = _time_ms(lambda: ttc.tt_contract_batched_quant(
                    x, cores, spec, quant), 50)
                # the call is one launch and no other kernel: the output's
                # torch.empty launches none, the quantizer runs in the launch.
                # The window starts on a fill, which torch.profiler may drop
                # as a window's first kernel (it dropped the call's launch
                # itself in a window that started on it); the fill is the
                # only other kernel the window may hold
                scratch = torch.empty(1, device=x.device)
                traced = _profile(
                    lambda: ttc.tt_contract_batched_quant(x, cores, spec,
                                                          quant),
                    match="tt_contract_batched_quant_kernel",
                    lead=lambda: scratch.fill_(0.0))
                others = [t for t in traced["top"]
                          if "tt_contract_batched_quant_kernel" not in t[0]
                          and "Fill" not in t[0]]
                if traced["match_kernels"] != 1 or others:
                    raise AssertionError(
                        f"a tt_contract_batched_quant call ran "
                        f"{traced['kernels']} kernels ({traced['top']}); "
                        "expected its own launch alone")
                row["kernels_per_call"] = traced["match_kernels"]
                row["kernel_device_ms"] = traced["match_ms"]
                row["plain_ms"] = _time_ms(
                    lambda: ref.tt_contract_batched_quant_ref(
                        x, cores, spec, quant), 10)
                row["library_ms"] = _time_ms(lambda: torch.bmm(x, wt), 50)
                # x and y, and each entry's f32 cores read once; the
                # quantization's ~4 operations per core element
                row["bound_ms"], row["bound_by"] = _batched_bound(
                    spec, P, B, shared, ops_per_param=4)
            results[f"{label}-{dtype}"] = row
            print(f"[quant-kernel] {json.dumps(row)}", flush=True)
    return results


def _train_main(argv: list, steps: int, chain: str,
                log_every: int) -> tuple:
    """``launch.train.main(argv)`` on the card with every kernel count set
    to 0 just before and read just after.  Checks 3 launches of ``chain``
    (the other chain kernel 0), 1 grouped densification and no standalone
    mesh per step, and 1 grouped densification per validation forward.
    Returns (result, launches, wall seconds)."""
    import torch
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.launch import train

    counted = {"tt_contract_batched": ttc.tt_contract_batched,
               "tt_contract_batched_quant": ttc.tt_contract_batched_quant,
               "mesh_densify_stacked": mesh.mesh_densify_stacked,
               "mesh_apply_stacked": mesh.mesh_apply_stacked}
    for fn in counted.values():                           # main path starts
        fn.launches = 0
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}  # ends
    want = {"tt_contract_batched": 0, "tt_contract_batched_quant": 0,
            "mesh_densify_stacked": steps + _val_evals(steps, log_every),
            "mesh_apply_stacked": 0}
    want[chain] = 3 * steps
    if launches != want:
        raise AssertionError(f"{launches} over {steps} steps; expected "
                             f"{want}")
    return res, launches, wall


def _code_flips(model, prepared_a: dict, prepared_b: dict) -> int:
    """Weight codes that differ between two prepared core stacks under the
    model's weight quantization (0 without it)."""
    from repro_torch.kernels import quant as quant_lib
    q = model.cfg.quant
    if not q.weights:
        return 0
    flips = 0
    for i in range(len(model.specs)):
        for a, b in zip(prepared_a[f"cores{i}"], prepared_b[f"cores{i}"]):
            qa, _ = quant_lib.quantize_blockwise_stacked(a.cpu(), q)
            qb, _ = quant_lib.quantize_blockwise_stacked(b.cpu(), q)
            flips += int((_code_bytes(qa) != _code_bytes(qb)).sum())
    return flips


def _code_bytes(codes):
    """Narrow codes as comparable integers (fp8 by its bytes)."""
    import torch
    return (codes.view(torch.uint8) if codes.dtype == torch.float8_e4m3fn
            else codes)


ZO_TRACE_STEPS = 5


def measure_zo_step(model, params, noise, mask, xt, state, n: int,
                    runs: int = 1, iters: int = 10,
                    match: str = "tt_contract",
                    term_batches: dict | None = None) -> dict:
    """ms per ZO step (``zoo.zo_signsgd_step`` over
    ``pinn.residual_losses_stacked``, N = ``n``) back to back on CUDA
    events, ``runs`` times over ``iters`` steps, then a steady window of
    ``ZO_TRACE_STEPS`` steps under ``torch.profiler`` (with the device
    time of the kernels whose name holds ``match``, ``match_ms``: the TT
    chains by default).  ``term_batches`` (a boundary term's rows) go to
    the losses as the trainer passes them.  It calls only entry points
    that every version of the port has, so ``tools/zo_step.py`` measures
    any checkout's ``repro_torch`` with it."""
    from repro_torch.core import pinn, zoo
    scfg = zoo.SPSAConfig(num_samples=n)

    def zo_step():
        return zoo.zo_signsgd_step(
            params, state, 1e-3, scfg,
            lambda sp: pinn.residual_losses_stacked(
                model, sp, xt, noise, term_batches=term_batches),
            trainable_mask=mask)

    return {"zo_step_ms": [_time_ms(zo_step, iters, warmup=2)
                           for _ in range(runs)],
            "trace": _profile(zo_step, ZO_TRACE_STEPS, match=match)}


def phase_train(device, quant: tuple = ()) -> dict:
    """The trainer at the paper's config; ``quant`` holds the extra flags
    of a quantization-aware run (empty: the f32 run)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import read_checkpoint_meta
    from repro_torch.core import pinn, zoo
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import counter_generator, to_device
    from repro_torch.launch import train

    tag = "train-quant" if quant else "train"
    steps, batch, n = 50, 100, 10
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    argv = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-noise",
            "--steps", str(steps), "--batch", str(batch), "--zo-samples",
            str(n), "--ckpt-dir", ckpt, "--ckpt-every", "25",
            "--log-every", "10", "--seed", "0", *quant]
    res, launches, wall = _train_main(
        argv, steps,
        "tt_contract_batched_quant" if "--quant" in quant
        else "tt_contract_batched", 10)
    model, params, noise = res.model, res.params, res.hw_noise
    losses = np.asarray(res.losses)
    if not (np.isfinite(losses).all() and np.isfinite(res.val_mse)):
        raise AssertionError(f"non-finite losses or val MSE {res.val_mse}")
    if not np.median(losses[-10:]) < losses[0]:
        raise AssertionError(f"loss did not fall: first {losses[0]:.4e}, "
                             f"median of the last 10 "
                             f"{np.median(losses[-10:]):.4e}")
    init, _ = train.init_solver(model, 0)
    mask = model.trainable_mask(init)
    for new, old, trainable in zip(zoo.tree_leaves(params),
                                   zoo.tree_leaves(init),
                                   zoo.tree_leaves(mask)):
        if not trainable and not torch.equal(new.cpu(), old):
            raise AssertionError("a ±1 diag buffer moved during training")

    # one step's stacked stencil and losses, card against the CPU plain
    # path, with the same params, ξ, batch and noise
    scfg = zoo.SPSAConfig(num_samples=n)
    xis = zoo.sample_perturbations(counter_generator(7, device=device),
                                   params, n, mask)
    stacked = zoo.perturbed_stack(params, xis, scfg)
    xt = next(pde_collocation_iterator(batch, seed=0, start_step=steps,
                                       problem=model.problem))

    def one_step(dev, prepared=None):
        sp, nz, x = to_device(stacked, dev), to_device(noise, dev), xt.to(dev)
        if prepared is None:
            prepared = model.prepare_params_stacked(sp, nz)
        u = model.fd_u_stencil_stacked(prepared, x, model.fd_step)
        return (u.cpu(),
                pinn.residual_losses_stacked(model, prepared, x, nz).cpu(),
                prepared)

    cpu = torch.device("cpu")
    u_card, l_card, prep_card = one_step(device)
    u_cpu, l_cpu, prep_cpu = one_step(cpu)
    # the densified cores differ from the CPU's by f32 rounding (sin/cos of
    # two libraries); a weight code that this moves across a rounding edge
    # shifts a core value by a whole quantization step.  Count such flips;
    # where there are any, the CPU runs on the card's densified cores, so
    # the check still holds the quantized chain to its plain version.
    flips = _code_flips(model, prep_card, prep_cpu)
    if flips:
        u_cpu, l_cpu, _ = one_step(cpu, to_device(prep_card, cpu))
    u_err, u_scale = _u_close("train", u_card, u_cpu)
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)

    # ms per ZO step, back to back on CUDA events, and a traced window;
    # the aten ops of one densification of the stack
    timed = measure_zo_step(model, params, noise, mask, xt.to(device),
                            zoo.ZOState(step=steps, seed=1), n)
    stacked_dev = to_device(stacked, device)
    prepare_ops = op_counts(aten_ops(
        lambda: model.prepare_params_stacked(stacked_dev, noise)))

    # the checkpoint carries the run's config, quant included, and serves:
    # registry + engine against the final model.u
    meta = read_checkpoint_meta(ckpt)
    if pinn.config_from_meta(meta["pinn"]) != model.cfg:
        raise AssertionError(f"checkpoint meta {meta['pinn']} is not the "
                             f"run's config {model.cfg}")
    # the checkpoint carries the chip's noise: it loads without hw_noise=
    served = _serves_checkpoint("hjb", ckpt, model, params, noise, device)
    shutil.rmtree(ckpt)
    out = {"steps": steps, "batch": batch, "zo_samples": n,
           "quant": model.cfg.quant.tag(),
           "launches": launches, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1]),
           "loss_median_last10": float(np.median(losses[-10:])),
           "losses": [float(v) for v in losses], "val_mse": res.val_mse,
           "zo_step_ms": timed["zo_step_ms"][0],
           "zo_step_trace": timed["trace"],
           "prepare_params_stacked_ops": prepare_ops,
           "host_step_ms_median": 1e3 * float(np.median(res.step_seconds)),
           "train_wall_s": wall,
           "stencil_u_max_abs_card_vs_cpu": u_err, "stencil_u_max": u_scale,
           "weight_code_flips_card_vs_cpu": flips,
           "losses_card": l_card.tolist(), "losses_cpu": l_cpu.tolist(),
           "served_vs_direct_max_abs": served}
    print(f"[{tag}] {json.dumps(out)}", flush=True)
    return out


def phase_train_quant(device, f32_val_mse: float) -> dict:
    """The QAT run of TONN_ONCHIP_FUSED (int8 block 32, 8-bit phases; the
    f32 run's checks plus the accuracy notch), then 5 fp8 steps."""
    import numpy as np
    out = phase_train(device, quant=("--quant", "int8", "--quant-block",
                                     "32", "--phase-bits", "8"))
    # benchmarks/quantized.py's accuracy notch: QAT within one decade of f32
    if not out["val_mse"] <= 10.0 * f32_val_mse:
        raise AssertionError(f"QAT val MSE {out['val_mse']:.4e} is more than "
                             f"10x the f32 run's {f32_val_mse:.4e}")
    steps = 5
    res, launches, _ = _train_main(
        ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-noise",
         "--steps", str(steps), "--batch", "100", "--zo-samples", "10",
         "--log-every", "10", "--seed", "0", "--quant", "fp8_e4m3"],
        steps, "tt_contract_batched_quant", 10)
    if not (np.isfinite(res.losses).all() and np.isfinite(res.val_mse)):
        raise AssertionError(f"fp8 QAT: non-finite losses {res.losses}")
    out["fp8"] = {"steps": steps, "launches": launches,
                  "losses": [float(v) for v in res.losses],
                  "val_mse": res.val_mse}
    out["f32_val_mse"] = f32_val_mse
    print(f"[train-quant] fp8 {json.dumps(out['fp8'])}", flush=True)
    return out


def phase_serve_quant(device) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import pinn
    from repro_torch.core.photonic import NoiseModel
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)

    cfgs = {
        "hjb": pinn.PINNConfig(hidden=1024, mode="tonn", tt_rank=2, tt_L=4,
                               deriv="fd_fast", use_fused_kernel=True,
                               noise=NoiseModel(enabled=True),
                               pde="hjb-20d"),
        "heat": pinn.PINNConfig(hidden=1024, mode="tt", tt_rank=2, tt_L=4,
                                use_fused_kernel=True, pde="heat-10d"),
    }
    reg = SolverRegistry(device=device)
    for seed, (name, cfg) in enumerate(cfgs.items()):
        reg.register_fresh(name, cfg, seed=seed, device=device)
    engine = PdeServingEngine(reg, slots=8, slot_points=256, device=device)
    quants = {"f32": None,
              "int8": quant_lib.QuantConfig(enabled=True, dtype="int8"),
              "fp8": quant_lib.QuantConfig(enabled=True, dtype="fp8_e4m3")}
    rng = np.random.RandomState(1)
    names = reg.names()
    traffic = []
    for i in range(30):
        name = names[i % 2]
        qname = list(quants)[(i // 2) % 3]
        n = int(rng.randint(1, 257))
        traffic.append((name, qname, rng.uniform(
            0.02, 0.98, (n, reg.get(name).in_dim)).astype(np.float32)))

    ttc.tt_contract.launches = 0                          # main path starts
    t0 = time.perf_counter()
    reqs = [engine.submit(PointRequest(name, pts, quant=quants[q]))
            for name, q, pts in traffic]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ttc.tt_contract.launches                   # main path ends
    stats = dict(engine.stats)
    if launches != 2 * stats["program_runs"]:
        raise AssertionError(f"tt_contract launched {launches} times over "
                             f"{stats['program_runs']} program runs")
    if stats["compiles"] != len(names) * len(quants):
        raise AssertionError(f"{stats['compiles']} programs built; expected "
                             "one per (solver, quant config)")
    worst = {q: 0.0 for q in quants}
    gap = {q: 0.0 for q in quants}
    for (name, q, pts), r in zip(traffic, reqs):
        if not (r.done and np.isfinite(r.out).all()):
            raise AssertionError(f"{q} request for {name} not served")
        s = reg.get(name)
        model = s.model
        if quants[q] is not None:
            model = pinn.TensorPinn(dataclasses.replace(
                model.cfg, quant=quants[q]), problem=model.problem)
        x = torch.tensor(pts, device=device)
        with torch.no_grad():
            direct = model.u(s.params, x).cpu().numpy()
            f32 = s.model.u(s.params, x).cpu().numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        worst[q] = max(worst[q], float(np.abs(r.out - direct).max()))
        gap[q] = max(gap[q], float(np.abs(r.out - f32).max()))
    for q in ("int8", "fp8"):
        if not gap[q] > 1e-5:
            raise AssertionError(f"{q} serving equals f32 serving "
                                 f"(max gap {gap[q]:.3e})")
    # a resubmitted burst is answered by the cache, with no new program
    runs = stats["program_runs"]
    again = [engine.submit(PointRequest(name, pts, quant=quants[q]))
             for name, q, pts in traffic]
    if not all(r.done for r in again) or \
            engine.stats["program_runs"] != runs or \
            engine.stats["compiles"] != stats["compiles"]:
        raise AssertionError("the resubmitted burst was not served from the "
                             "cache alone")
    for r, r0 in zip(again, reqs):
        np.testing.assert_array_equal(r.out, r0.out)
    # an f32 repeat of a quantized request misses the quantized entries
    name, _, pts = next(t for t in traffic if t[1] == "int8")
    hits = engine.stats["cache_hits"]
    f32_repeat = engine.submit(PointRequest(name, pts))
    engine.run()
    if f32_repeat.done is not True or engine.stats["cache_hits"] != hits:
        raise AssertionError("an f32 query was answered from int8 entries")
    s = reg.get(name)
    with torch.no_grad():
        f32 = s.model.u(s.params, torch.tensor(pts, device=device))
    np.testing.assert_allclose(f32_repeat.out, f32.cpu().numpy(), rtol=1e-6,
                               atol=1e-6)
    # time per full-pool program call of each (solver, config)
    program_ms = {}
    for name in names:
        pool = reg.get(name).problem.sample_collocation(
            torch.Generator().manual_seed(1),
            engine.slots * engine.slot_points).to(device)
        for q, quant in quants.items():
            program = engine._program(name, quant)
            program_ms[f"{name}|{q}"] = _time_ms(lambda: program(pool), 50)
    out = {"requests": len(reqs), "wall_ms": wall * 1e3,
           "launches": launches,
           "max_abs_served_vs_direct": worst, "max_abs_quant_vs_f32": gap,
           "program_ms": program_ms,
           "stats": {k: stats[k] for k in ("compiles", "program_runs",
                                           "steps", "points_served")}}
    print(f"[serve-quant] {json.dumps(out)}", flush=True)
    return out


# label -> (B, H, KH, Sq, Sk, D, causal, window, dtypes); "a" is the main one
FLASH_CASES = {
    "a-qwen-prefill": (4, 16, 2, 2048, 2048, 128, True, None,
                       ("bfloat16", "float32")),
    "b-danube-window": (1, 32, 8, 8192, 8192, 120, True, 4096,
                        ("bfloat16", "float32")),
    "c-chunked-prefill": (2, 16, 2, 256, 2304, 128, True, None,
                          ("bfloat16", "float32")),
    "d-single-query": (4, 16, 2, 1, 300, 128, True, None,
                       ("bfloat16", "float32")),
    "e-bidirectional": (2, 8, 8, 1500, 1500, 64, False, None,
                        ("bfloat16", "float32")),
    "f-masked-rows": (1, 4, 2, 64, 32, 32, True, None,
                      ("bfloat16", "float32")),
    "g-reduced": (2, 4, 2, 200, 200, 24, True, None, ("float32",)),
}


def _flash_bound(B, H, KH, Sq, Sk, D, causal, window, dtype) -> tuple:
    """(bound_ms, bound_by, unmasked pairs): 4·D FLOPs per (q, k) pair that
    this case's masks leave, at the dtype's peak, against q, k, v and the
    output moved once."""
    import numpy as np
    q_abs = np.arange(Sq, dtype=np.int64) + (Sk - Sq)
    hi = np.minimum(q_abs, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = (np.maximum(q_abs - window + 1, 0) if window is not None
          else np.zeros(Sq, np.int64))
    pairs = B * H * int(np.maximum(hi - lo + 1, 0).sum())
    size = 2 if dtype == "bfloat16" else 4
    t_ops = 4 * D * pairs / (PEAK_BF16_FLOPS if size == 2
                             else PEAK_F32_FLOPS) * 1e3
    t_bytes = size * 2 * (B * H * Sq * D + B * KH * Sk * D) / \
        PEAK_BYTES_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, pairs


def phase_flash_kernel(device) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    results = {}
    for i, (label, (B, H, KH, Sq, Sk, D, causal, window, dtypes)) in \
            enumerate(FLASH_CASES.items()):
        gen = torch.Generator().manual_seed(5000 + i)
        base = [torch.randn(shape, generator=gen) for shape in
                ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D))]
        for dtype in dtypes:
            q, k, v = (t.to(device=device, dtype=getattr(torch, dtype))
                       for t in base)
            out = fa.flash_attention(q, k, v, causal, window)
            plain = ref.attention_ref(q, k, v, causal, window)
            torch.cuda.synchronize()
            diff = (out.float() - plain.float()).abs()
            err = diff.max().item()
            # the worst element's share of its own bound (≤ 1 passes)
            share = (diff / ref.attention_bound(plain)).max().item()
            if not (torch.isfinite(out).all().item() and share <= 1.0):
                raise AssertionError(
                    f"flash_attention disagrees with its plain version at "
                    f"{label} {dtype}: max|diff| {err:.3e}, {share:.3f} of "
                    "the bound at the worst element")
            row = {"case": label, "dtype": dtype,
                   "design": fa.DESIGNS[q.dtype], "B": B, "H": H, "KH": KH,
                   "Sq": Sq, "Sk": Sk, "D": D, "causal": causal,
                   "window": window, "max_abs_err": err,
                   "max_abs_plain": plain.float().abs().max().item(),
                   "max_err_over_bound": share}
            if Sq > Sk and causal:         # rows with no key: exact zeros
                dead = out[:, :, :Sq - Sk]
                if not torch.equal(dead, torch.zeros_like(dead)):
                    raise AssertionError(f"{label}: rows that see no key "
                                         "are not zeros")
                row["masked_rows_zero"] = True
            bound, by, pairs = _flash_bound(B, H, KH, Sq, Sk, D, causal,
                                            window, dtype)
            row.update(bound_ms=bound, bound_by=by, unmasked_pairs=pairs)
            if label.startswith("a-"):
                row["ms"] = _time_ms(lambda: fa.flash_attention(
                    q, k, v, causal, window), 20)
                row["plain_ms"] = _time_ms(lambda: ref.attention_ref(
                    q, k, v, causal, window), 10)
                # the one-call library yardstick; its is_causal aligns
                # queries top-left, equal to the kernel's alignment at Sq = Sk
                row["library_ms"] = _time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), 20)
                lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                     enable_gqa=True)
                lib_diff = (lib.float() - plain.float()).abs()
                row["library_max_abs_vs_plain"] = lib_diff.max().item()
                row["library_max_err_over_bound"] = (
                    lib_diff / ref.attention_bound(plain)).max().item()
            if label.startswith("b-"):         # the longest window layer
                row["ms"] = _time_ms(lambda: fa.flash_attention(
                    q, k, v, causal, window), 5, warmup=1)
            results[f"{label}-{dtype}"] = row
            print(f"[flash-kernel] {json.dumps(row)}", flush=True)
            del q, k, v, out, plain, diff
    return results


# windows a lost trace is taken again, each after a longer pause (0.5,
# 1, 2, ... s): runs lose one or two in a row now and then;
# `quant-kernel`'s hidden-stencil window has lost up to five in a row
# (once a window and then only its kernel, the lead fill kept), and
# caught the kernel on the fifth try once
PROFILE_TRIES = 7
PROFILE_RETRIES = {"windows": 0}     # windows taken again, over the run
PROFILE_LAGS: list = []              # each window's device_lag_ms


def _profile(fn, calls: int = 1, match: str | None = None,
             lead=None, count: tuple = ()) -> dict:
    """``calls`` back-to-back calls of ``fn``, a steady window after one
    warm call, under ``torch.profiler`` (CPU + CUDA): the window's wall
    time (host clock, ending in a synchronize), the summed time of the
    device kernels (one stream: they do not overlap), the device's busy
    share of the wall, the kernels in all and per call, and the five
    kernels that take most of the time; with ``match``, also the device
    time and count of the kernels whose name contains it, the longest one
    of them, and each one's time in launch order over one call's share
    (``match_ms``, ``match_kernels``, ``match_max_ms``, ``match_each_ms``).
    A window whose trace holds no device event at all, or with ``match``
    none whose name holds it (the profiler lost the window, or the
    kernel: every caller launches kernels in it, and a kernel ``match``
    names), is taken again, up to ``PROFILE_TRIES`` windows, each retake
    counted in ``PROFILE_RETRIES`` and in the result's ``retries``, each
    after a pause twice the last (from 0.5 s); after that the device
    numbers are the last window's (None where it held no device event:
    not measured).  ``lead``, if given, runs inside the window before the
    calls and before the clock starts (its kernels are counted).
    ``device_lag_ms``: the window's first device event's start less its
    first kernel launch's on the host, on the trace's clock (also in
    ``PROFILE_LAGS``); a lost window's message counts the launches the
    host made in it.  ``count``: names whose device kernels the window
    counts, per call (``counts``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()                                                   # warm
    torch.cuda.synchronize()
    for tries in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if lead is not None:
                lead()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = [e.time_range.start for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and "LaunchKernel" in e.name]
        names = [e.name for e in device]
        if names and (match is None or any(match in n for n in names)):
            break
        if tries + 1 < PROFILE_TRIES:
            PROFILE_RETRIES["windows"] += 1
            print("[profile] a window held no device event"
                  + (f" named {match!r}" if names else "")
                  + f" ({len(launches)} kernel launches on the host); "
                    "taken again", flush=True)
            time.sleep(0.5 * 2 ** tries)
    lag = (None if not (device and launches) else
           (min(e.time_range.start for e in device) - min(launches)) / 1e3)
    PROFILE_LAGS.append(lag)
    by_name: dict = {}
    matched = []                                      # (start, ms)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
            if match is not None and match in e.name:
                matched.append((e.time_range.start,
                                e.time_range.elapsed_us() / 1e3))
    device_ms = sum(ms for ms, _ in by_name.values()) if by_name else None
    kernels = sum(n for _, n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    out = {"calls": calls, "retries": tries, "wall_ms": wall_ms,
           "device_lag_ms": lag,
           "device_ms": device_ms,
           "busy_share": None if device_ms is None else device_ms / wall_ms,
           "kernels": kernels, "kernels_per_call": kernels / calls,
           "top": [[name[:80], ms, n] for name, (ms, n) in top]}
    if match is not None:
        hits = [(ms, n) for name, (ms, n) in by_name.items() if match in name]
        out["match_ms"] = sum(ms for ms, _ in hits) if hits else None
        out["match_kernels"] = sum(n for _, n in hits)
        out["match_max_ms"] = max((ms for _, ms in matched), default=None)
        out["match_each_ms"] = [ms for _, ms in
                                sorted(matched)[:len(matched) // calls]]
    if count:
        out["counts"] = {c: sum(n for name, (_, n) in by_name.items()
                                if c in name) / calls for c in count}
    return out


def _grad_bound_ms(spec, batch: int, need_dx: bool) -> tuple:
    """(bound_ms, bound_by) of one ``tt_contract_grad``: x and dy read,
    dx written (need_dx), the cores read and their gradients written at
    the card's memory rate, against the FMAs the backward needs at the f32
    peak — the forward states A_0..A_{L-1} (steps 0..L-2), every dG_k and
    every dA_k (without dA_0 when dx is not needed)."""
    bytes_moved = 4 * (batch * spec.in_dim * (2 if need_dx else 1)
                       + batch * spec.out_dim + 2 * spec.num_params)
    step = []
    m_prefix, n_suffix = 1, spec.in_dim
    for r, m, n, rn in spec.core_shapes:
        n_suffix //= n
        step.append(2 * batch * m_prefix * n_suffix * r * n * m * rn)
        m_prefix *= m
    flops = sum(step[:-1]) + sum(step) + sum(step[0 if need_dx else 1:])
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bp_kernel(device) -> dict:
    """``tt_contract_grad`` against ``ref.tt_contract_grad_ref`` at the
    three BP launches of the paper's config (batch 100), the reduced spec
    off the tile and the rank-4 spec: dx at phase 3's bound, each dG_k
    within ``tt_contract.grad_bound`` of the plain chain in float64, two
    calls bit for bit; times the hidden-layer call."""
    import torch
    from repro_torch.core import tt
    from repro_torch.kernels import ref, tt_contract as ttc

    paper = tt.PAPER_TONN_SPEC
    # label -> (spec, rows, need_dx); "hidden-stencil" is the main one
    cases = {"layer0-rows": (paper, 100, False),
             "layer0-columns": (paper, 21, False),
             "hidden-stencil": (paper, 4300, True),
             "reduced-1000": (tt.auto_factorize(64, 64, L=3, max_rank=2),
                              1000, True),
             "rank4-777": (tt.auto_factorize(256, 512, L=3, max_rank=4), 777,
                           True),
             # rows of 8192 floats, steps not in place: fewer states saved
             "wide-777": (tt.auto_factorize(4096, 4096, L=4, max_rank=2),
                          777, True)}
    results = {}
    for i, (label, (spec, B, need_dx)) in enumerate(cases.items()):
        gen = torch.Generator().manual_seed(4000 + i)
        cores = [c.to(device) for c in tt.tt_init(gen, spec)]
        x = torch.randn((B, spec.in_dim), generator=gen).to(device)
        dy = torch.randn((B, spec.out_dim), generator=gen).to(device)
        dx, grads = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
        pdx, pgrads = ref.tt_contract_grad_ref(x, cores, spec, dy, need_dx)
        _, exact = ref.tt_contract_grad_ref(
            x.double(), [c.double() for c in cores], spec, dy.double(),
            False)
        bounds = ttc.grad_bound(x, cores, spec, dy)
        torch.cuda.synchronize()
        tile = ttc.grad_tile(spec, B)
        tiles, blocks = ttc.grad_grid(tile, B)
        row = {"case": label, "rows": B, "need_dx": need_dx,
               "modes": [list(spec.out_modes), list(spec.in_modes)],
               "ranks": list(spec.ranks), "tile": dataclasses.asdict(tile),
               "row_tiles": tiles, "blocks": blocks,
               "sum_groups": ttc.grad_groups(blocks)}
        if need_dx:
            row["dx_max_abs_err"], row["dx_max_abs_plain"] = _check_close(
                "tt_contract_grad dx", label, dx, pdx)
        share, err32 = 0.0, 0.0
        for k, (g, e, b, p) in enumerate(zip(grads, exact, bounds, pgrads)):
            over = ((g.double() - e).abs() / b).max().item()
            if not (torch.isfinite(g).all().item() and over <= 1.0):
                raise AssertionError(
                    f"tt_contract_grad dG_{k} at {label}: worst element at "
                    f"{over:.3e} of its bound")
            share = max(share, over)
            err32 = max(err32, (g - p).abs().max().item())
        row["dG_max_err_over_bound"] = share
        row["dG_max_abs_err_vs_plain_f32"] = err32
        row["dG_max_abs_err_vs_plain_f64"] = max(
            (g.double() - e).abs().max().item()
            for g, e in zip(grads, exact))
        row["dG_max_abs"] = max(e.abs().max().item() for e in exact)
        again = ttc.tt_contract_grad(x, cores, spec, dy, need_dx)
        if not (all(torch.equal(a, b) for a, b in zip(grads, again[1]))
                and (not need_dx or torch.equal(dx, again[0]))):
            raise AssertionError(f"tt_contract_grad at {label}: two calls "
                                 "differ")
        row["repeat_bitwise_equal"] = True
        row["max_abs_err"] = max(row.get("dx_max_abs_err", 0.0),
                                 row["dG_max_abs_err_vs_plain_f64"])
        # Traced windows of 5 calls, call k on dy·2^k (the warm call k =
        # 0): scaling by a power of two is exact through every product and
        # sum, so each call must give the first call's bits times 2^k.  A
        # block whose partials the sum missed, or a sum that ran before
        # them, would leave the previous call's values (2^(k-1)) or stale
        # memory.  The first window starts on the kernel; the second
        # starts on four PyTorch fills (``lead``), which take the place of
        # the kernels the trace may drop at a window's start.
        # a window the profiler loses is taken again (``_profile``), each
        # retake 5 more calls: enough powers for every window it may take
        dys = [dy * 2.0 ** k for k in range(1 + 5 * PROFILE_TRIES)]
        windows = {}
        for name, lead in (("bare", None),
                           ("lead", lambda: [torch.zeros(1, device=device)
                                             for _ in range(4)])):
            outs = []

            def scaled():
                outs.append(ttc.tt_contract_grad(x, cores, spec,
                                                 dys[len(outs)], need_dx))

            trace = _profile(scaled, 5, match="tt_contract_grad", lead=lead)
            for k, (sdx, sgrads) in enumerate(outs):
                if not (all(torch.equal(a, b * 2.0 ** k)
                            for a, b in zip(sgrads, grads))
                        and (not need_dx or torch.equal(sdx, dx * 2.0 ** k))):
                    raise AssertionError(
                        f"tt_contract_grad at {label}, traced call {k}: not "
                        f"2^{k} times the first call's bits")
            by = {kname: (ms, n) for kname, ms, n in trace["top"]
                  if "tt_contract_grad" in kname}
            if len(by) > 1:
                raise AssertionError(f"tt_contract_grad at {label}: more "
                                     f"than one kernel a call: {list(by)}")
            windows[name] = {"trace": trace, "by": by,
                             "launches_in_trace": sum(
                                 n for _, n in by.values())}
        row["scaled_calls_bitwise_exact"] = True
        row["trace_launches"] = {k: w["launches_in_trace"]
                                 for k, w in windows.items()}
        by = windows["lead"]["by"]
        row["kernel_device_ms"] = (None if not by else
                                   sum(ms for ms, _ in by.values())
                                   / sum(n for _, n in by.values()))
        row["kernels_per_call"] = sum(n for _, n in by.values()) / 5
        trace = windows["lead"]["trace"]
        if label == "hidden-stencil":
            row["trace"] = trace
            leaf_cores = [c.clone().requires_grad_() for c in cores]
            leaf_x = x.clone().requires_grad_(need_dx)

            def library():
                w = tt.tt_to_full(leaf_cores, spec)
                return torch.autograd.grad(
                    leaf_x @ w.T, ([leaf_x] if need_dx else []) + leaf_cores,
                    dy)

            row["ms"] = _time_ms(lambda: ttc.tt_contract_grad(
                x, cores, spec, dy, need_dx), 50)
            row["plain_ms"] = _time_ms(lambda: ref.tt_contract_grad_ref(
                x, cores, spec, dy, need_dx), 10)
            row["library_ms"] = _time_ms(library, 20)
            row["forward_ms"] = _time_ms(
                lambda: ttc.tt_contract(x, cores, spec), 50)
            row["bound_ms"], row["bound_by"] = _grad_bound_ms(spec, B,
                                                              need_dx)
        results[label] = row
        print(f"[bp-kernel] {json.dumps(row)}", flush=True)
    return results


BP_COUNTED = ("tt_contract", "tt_contract_grad", "tt_contract_batched",
              "tt_contract_batched_quant", "mesh_densify_stacked",
              "mesh_densify_grad", "mesh_apply_stacked",
              "mesh_apply_stacked_grad", "mesh_product_grad")
DENSE_GRAD_PRODUCTS = 1  # a dense backward's product launches (dx and dM
                         # in one)
ONN_BP_MESHES = 6        # onn's fd_fast stencil: layer 0 on the rows and on
                         # the identity columns, the hidden layer: 2 meshes
                         # each, forward and backward
ONN_VAL_MESHES = 4       # a validation forward: 2 layers of 2 meshes
ONN_CHECK_BATCH = 4      # onn at hidden 1024: card vs CPU on 4 points
F32_FLOOR_FACTOR = 4.0   # the card's f32 error to float64 against the
                         # CPU f32 path's: two f32 paths, each rounding
                         # 1,024 levels (and the card recovering states)


# onn at hidden 1024 (batch 100, 1000 validation points), by design and
# route, written out rather than asked of the dispatch under test: a BP
# step's 6 meshes forward (layer 0's 21-port V mesh resident and its
# 1024-port U mesh route A, each on the rows and on the identity columns;
# the hidden layer's V^T and U route B on the 4300 stencil rows) and
# backward, whose design follows the forward's route (2 resident, 2 warp
# rows, 2 dense); a validation forward's 4 (1 resident, 3 route A)
ONN_1024_STEP = ({"resident": 2, "warp_rows": 2, "dense": 2},
                 {"resident": 2, "warp_rows": 2, "dense": 2})
ONN_1024_VAL = {"resident": 1, "warp_rows": 3}


def _onn_bp_designs(model, batch: int, steps: int, evals: int,
                    val_points: int = 1000) -> tuple:
    """The mesh launches by design of ``steps`` onn BP steps (fd_fast:
    layer 0 on the ``batch`` rows and on the in_dim identity columns, the
    hidden layer's two meshes on the (2·in_dim + 1)·batch stencil rows)
    and ``evals`` validation forwards of ``val_points`` rows: (forward
    designs and routes, backward designs).  At hidden 1024 the fixed
    counts ``ONN_1024_STEP`` and ``ONN_1024_VAL``; else each mesh's from
    its layout and rows as the kernels pick them."""
    from repro_torch.kernels import mesh_apply as mesh
    fwd = dict.fromkeys(mesh.DESIGNS, 0)
    bwd = dict.fromkeys(mesh.GRAD_DESIGNS, 0)
    if model.cfg.hidden == 1024:
        assert (batch, val_points) == (100, 1000)
        for d, n in ONN_1024_STEP[0].items():
            fwd[d] += n * steps
        for d, n in ONN_1024_VAL.items():
            fwd[d] += n * evals
        for d, n in ONN_1024_STEP[1].items():
            bwd[d] += n * steps
        return fwd, bwd
    n = model.in_dim
    pm0, pm1 = model.photonic
    route = _mesh_route
    for layout, rows in ((pm0.layout_v, batch), (pm0.layout_v, n),
                         (pm0.layout_u, batch), (pm0.layout_u, n),
                         (pm1.layout_v, (2 * n + 1) * batch),
                         (pm1.layout_u, (2 * n + 1) * batch)):
        fwd[route(layout, rows)] += steps
        bwd[mesh.grad_design(layout, 1, rows)] += steps
    for layout in (pm0.layout_v, pm0.layout_u, pm1.layout_v, pm1.layout_u):
        fwd[route(layout, val_points)] += evals
    return fwd, bwd


def _mesh_route(layout, rows: int, S: int = 1) -> str:
    """The design or wide route ``mesh_apply_stacked`` takes for S
    meshes of ``layout`` on ``rows`` rows per entry."""
    from repro_torch.kernels import mesh_apply as mesh
    if mesh.mesh_design(layout) == "resident":
        return "resident"
    return mesh.wide_route(layout, S, rows)




def _counted():
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import tt_contract as ttc
    return {name: getattr(ttc if name.startswith("tt") else mesh, name)
            for name in BP_COUNTED}


def _run_counted(argv: list) -> tuple:
    """``launch.train.main(argv)`` on the card with every kernel count set
    to 0 just before and read just after, and the plain densification
    ``TensorPinn.prepare_params_plain`` refused while it runs (the main path
    never calls it).  Returns (result, launches, wall seconds)."""
    import torch
    from repro_torch.core import pinn
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.launch import train

    def refused(*args, **kwargs):
        raise AssertionError("the trainer reached prepare_params_plain")

    counted = _counted()
    plain = pinn.TensorPinn.prepare_params_plain
    pinn.TensorPinn.prepare_params_plain = refused
    try:
        mesh.mesh_apply_stacked.design_launches = dict.fromkeys(
            mesh.DESIGNS, 0)
        mesh.mesh_apply_stacked_grad.design_launches = dict.fromkeys(
            mesh.GRAD_DESIGNS, 0)
        mesh.mesh_apply_stacked_grad.resident_launches = dict.fromkeys(
            mesh.RESIDENT_GRAD_DESIGNS, 0)
        mesh.mesh_densify_grad.design_launches = dict.fromkeys(
            mesh.GRAD_GROUP_DESIGNS, 0)
        for fn in counted.values():                       # main path starts
            fn.launches = 0
        t0 = time.perf_counter()
        res = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pinn.TensorPinn.prepare_params_plain = plain
    return res, {name: fn.launches for name, fn in counted.items()}, wall


def _val_evals(steps: int, log_every: int) -> int:
    """Validation forwards a run makes: one per logged step, one at the end
    (each two ``tt_contract`` launches, outside autograd)."""
    return len(range(0, steps, log_every)) + 1


def _bp_grads(model, noise, dev, fn, at, xt, dtype=None) -> tuple:
    """``fn(prepared params, xt, noise)`` at ``at`` on ``dev`` (in
    ``dtype``, or each leaf's own) and its gradients, on the CPU, of the
    trainable leaves: through ``prepare_params``, as the BP step
    densifies (on the card tonn's grouped backward)."""
    import torch
    from repro_torch.core import zoo
    from repro_torch.device import to_device
    mask = model.trainable_mask(at)
    p = zoo.tree_map(lambda t, m: t.detach().to(dev, dtype or t.dtype)
                     .requires_grad_(m), at, mask)
    nz = None if noise is None else to_device(noise, dev)
    prepared, nz = model.prepare_params(p, nz)
    out = fn(prepared, xt.to(dev, dtype or xt.dtype), nz)
    return out.item(), [g.cpu() for g in torch.autograd.grad(
        out, [t for t in zoo.tree_leaves(p) if t.requires_grad])]


def _bp_grad_fns(model, batch: int) -> dict:
    """The scalar functions whose BP gradients are compared card vs CPU:
    ``Σ u·w`` (w fixed, random), ``Σ w_s·fd_u_stencil`` (w_s fixed, random
    over the stencil's (2A+1)×B values: the BP step's launches without the
    residual's 1/h²) and the residual loss."""
    import torch
    from repro_torch.core import pinn
    w = torch.randn(batch, generator=torch.Generator().manual_seed(3))
    ws = torch.randn(2 * model.in_dim + 1, batch,
                     generator=torch.Generator().manual_seed(4))
    return {
        "Σu·w": lambda p, x, nz: torch.sum(model.u(p, x, nz)
                                           * w.to(x.device)),
        "Σw·fd_u_stencil": lambda p, x, nz: torch.sum(
            model.fd_u_stencil(p, x, model.fd_step, nz) * ws.to(x.device)),
        "loss": lambda p, x, nz: pinn.residual_loss(model, p, x, nz)}


def _f64_floor_leaves(card, plain, exact) -> list:
    """Per leaf, the float64 rule of ``_card_vs_cpu_grads``: (the card's
    distance to the CPU's float64 gradient, its tolerance max(1e-4·max|
    grad|, ``F32_FLOOR_FACTOR`` times the CPU f32 path's own distance to
    it), and where that own distance sets the tolerance the card's over
    it, else None); max-abs distances."""
    out = []
    for a, b, e in zip(card, plain, exact):
        err = (a.double() - e).abs().max().item()
        own = (b.double() - e).abs().max().item()
        bar = 1e-4 * e.abs().max().item()
        floor = F32_FLOOR_FACTOR * own
        out.append((err, max(bar, floor) + 1e-12,
                    err / own if floor > bar else None))
    return out


def _card_vs_cpu_grads(model, params, init_params, noise, xt,
                       device, loss: bool = True,
                       f64_floor: bool = False) -> dict:
    """One BP step's gradients on the card (through the kernels'
    backwards: ``_bp_grads``) against the CPU's plain path on the same
    batch and noise (``_bp_grad_fns``).  Strict, within 1e-4·max|grad| per
    leaf: of ``Σ u·w`` at the run's final params, and of ``Σ
    w·fd_u_stencil`` at the initial and the final params: the fd_fast
    stencil runs the BP step's launches (counted here: 3 forward and 3
    backward TT launches and tonn's grouped densification and its
    backward, or onn's 6 meshes and their backwards).  Of the residual
    loss at the run's initial params (loss ~1) at the FD noise floor,
    relative L2 within 2.5e-1 and the loss within rtol 2.5e-1 (the
    residual's second differences amplify f32 rounding by 1/h² = 1e4: the
    port's f32 sits 6–7% from float64 there, measured on the CPU at hidden
    1024), all nonzero.  At the final params, where the loss is small and
    the gradient mostly FD noise, the loss gradients' relative L2 is
    recorded and not checked; beside it, in tt and dense (which the port
    also runs in float64), each f32 gradient's relative L2 to the CPU's
    float64 one, at both points.  ``loss`` False leaves the loss out.
    ``f64_floor`` (onn at hidden 1024, whose 1,024-level meshes put f32's
    own rounding above 1e-4·max|grad|: on the CPU the f32 gradient of
    Σu·w sits 6.0 times that bar from the float64 one at layer 0's bias,
    0.055 times at hidden 64) holds the card's gradients, the loss's at
    the initial params too, to the CPU's float64 ones instead, per leaf
    by ``_f64_floor_leaves``; the card-vs-CPU f32 shares against
    1e-4·max|grad| (``card_vs_cpu_shares``) and the card's distance to
    float64 over the CPU f32 path's (``card_over_cpu_f64_distance``, the
    worst leaf whose tolerance that distance sets: what
    ``F32_FLOOR_FACTOR`` bounds) are recorded."""
    import numpy as np
    import torch
    fns = _bp_grad_fns(model, xt.shape[0])

    def rel_l2(a, b):
        a = torch.cat([g.flatten() for g in a]).double()
        b = torch.cat([g.flatten() for g in b]).double()
        return ((a - b).norm() / b.norm()).item()

    cpu = torch.device("cpu")
    raw_shares, over_own = {}, {}

    def strict(name, at, launches=None, tag=""):
        fn = fns[name]
        counted = _counted()
        before = {k: f.launches for k, f in counted.items()}
        _, card = _bp_grads(model, noise, device, fn, at, xt)
        if launches is not None:
            launches.update({k: f.launches - before[k]
                             for k, f in counted.items()})
        _, plain = _bp_grads(model, noise, cpu, fn, at, xt)
        raw = max((a - b).abs().max().item()
                  / (1e-4 * b.abs().max().item() + 1e-12)
                  for a, b in zip(card, plain))
        if f64_floor:
            exact = _bp_grads(model, noise, cpu, fn, at, xt,
                              torch.float64)[1]
            rule = _f64_floor_leaves(card, plain, exact)
            over_own[name + tag] = max(
                (r for _, _, r in rule if r is not None), default=None)
        else:
            rule = [((a - b).abs().max().item(),
                     1e-4 * b.abs().max().item() + 1e-12, None)
                    for a, b in zip(card, plain)]
        for a, (err, tol, _) in zip(card, rule):
            if not (torch.isfinite(a).all().item() and err <= tol
                    and a.abs().max().item() > 0):
                raise AssertionError(
                    f"BP gradient of {name} card vs CPU"
                    + (" float64" if f64_floor else "")
                    + f": {err:.3e} > {tol:.3e}, or all zeros")
        raw_shares[name + tag] = raw
        return max(err / tol for err, tol, _ in rule)

    out = {"u_grad_max_err_over_tol": strict("Σu·w", params),
           "stencil_grad_max_err_over_tol_init":
               strict("Σw·fd_u_stencil", init_params, tag=" init")}
    launches = {}
    out["stencil_grad_max_err_over_tol_final"] = strict(
        "Σw·fd_u_stencil", params, launches, " final")
    mode = model.cfg.mode
    chains = 3 if mode in ("tt", "tonn") else 0
    want = dict.fromkeys(BP_COUNTED, 0)
    want["tt_contract"] = want["tt_contract_grad"] = chains
    if mode == "tonn":
        want["mesh_densify_stacked"] = want["mesh_densify_grad"] = 1
    if mode == "onn":
        want["mesh_apply_stacked"] = ONN_BP_MESHES
        want["mesh_apply_stacked_grad"] = ONN_BP_MESHES
    if launches != want:
        raise AssertionError(f"the stencil's gradient on the card launched "
                             f"{launches}, expected {want}")
    out["stencil_launches"] = launches
    if f64_floor:
        out["loss_grad_max_err_over_tol_init"] = strict("loss", init_params,
                                                        tag=" init")
        out["card_vs_cpu_shares"] = raw_shares
        out["card_over_cpu_f64_distance"] = over_own
    if not loss:
        return out
    loss_fn = fns["loss"]
    l_card, gl_card = _bp_grads(model, noise, device, loss_fn, init_params,
                                xt)
    l_cpu, gl_cpu = _bp_grads(model, noise, cpu, loss_fn, init_params, xt)
    rel = rel_l2(gl_card, gl_cpu)
    if not (all(torch.isfinite(g).all().item() for g in gl_card)
            and rel <= 2.5e-1):
        raise AssertionError(f"BP loss gradient card vs CPU: relative L2 "
                             f"{rel:.3e}")
    np.testing.assert_allclose(l_card, l_cpu, rtol=2.5e-1)
    if not all(g.abs().max().item() > 0 for g in gl_card):
        raise AssertionError("a BP gradient on the card is all zeros")
    lt_card, glt_card = _bp_grads(model, noise, device, loss_fn, params, xt)
    lt_cpu, glt_cpu = _bp_grads(model, noise, cpu, loss_fn, params, xt)
    out.update({"loss_grad_rel_l2_card_vs_cpu_init": rel,
                "loss_card_init": l_card, "loss_cpu_init": l_cpu,
                "loss_grad_rel_l2_card_vs_cpu_final":
                    rel_l2(glt_card, glt_cpu),
                "loss_card_final": lt_card, "loss_cpu_final": lt_cpu})
    if mode in ("tt", "dense"):       # the meshes run in f32
        for when, at, card, plain in (("init", init_params, gl_card, gl_cpu),
                                      ("final", params, glt_card, glt_cpu)):
            l64, g64 = _bp_grads(model, noise, cpu, loss_fn, at, xt,
                                 torch.float64)
            out[f"loss_f64_{when}"] = l64
            out[f"loss_grad_rel_l2_card_vs_f64_{when}"] = rel_l2(card, g64)
            out[f"loss_grad_rel_l2_cpu_vs_f64_{when}"] = rel_l2(plain, g64)
    return out


def measure_bp_step(model, opt, params, noise, xt, iters: int = 20,
                    match: str = "tt_contract") -> dict:
    """ms per BP step (``launch.train._bp_step_fn``) back to back on CUDA
    events, and one traced window of 5 steps (``match``: the kernels whose
    device time it sums)."""
    from repro_torch.launch import train
    step = train._bp_step_fn(model, opt, model.trainable_mask(params), noise)
    state = opt.init(params)

    def one():
        return step(params, state, xt, {})

    return {"bp_step_ms": _time_ms(one, iters, warmup=3),
            "trace": _profile(one, ZO_TRACE_STEPS, match=match)}


def phase_train_bp(device) -> dict:
    """The off-chip BP baselines through ``launch.train.main`` at the
    paper's width (hidden 1024, ``PAPER_TONN_SPEC``, batch 100): tt with
    AdamW for 50 steps and a checkpoint, tonn (noise on) with AdamW and
    dense with SGD for 10 steps each; and onn (noise on) with AdamW at
    hidden 64, whose meshes the resident backward holds, and at hidden
    1024, whose 1024-port meshes take routes A and B forward and the
    warp-rows and dense backwards, for 10 each: the mesh launches by design and
    route exactly ``_onn_bp_designs``'s, card vs CPU at hidden 1024 on
    ``ONN_CHECK_BATCH`` points."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import read_checkpoint_meta, \
        restore_checkpoint
    from repro_torch.core import zoo
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import to_device
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.launch import train
    from repro_torch.optim import get_optimizer

    batch, log_every = 100, 25
    base = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--batch",
            str(batch), "--log-every", str(log_every), "--seed", "0"]
    out = {}
    for label, flags, steps in (
            ("tt-adamw", ["--pinn-mode", "tt", "--optimizer", "adamw"], 50),
            ("tonn-noise-adamw", ["--pinn-mode", "tonn", "--pinn-noise",
                                  "--optimizer", "adamw"], 10),
            ("dense-sgd", ["--pinn-mode", "dense", "--optimizer", "sgd"],
             10),
            ("onn-adamw", ["--pinn-mode", "onn", "--pinn-noise", "--hidden",
                           "64", "--optimizer", "adamw"], 10),
            ("onn-1024-adamw", ["--pinn-mode", "onn", "--pinn-noise",
                                "--optimizer", "adamw"], 10)):
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_bp_")
        argv = base + flags + ["--steps", str(steps), "--ckpt-dir", ckpt,
                               "--ckpt-every", str(steps // 2)]
        res, launches, wall = _run_counted(argv)
        designs = (dict(mesh.mesh_apply_stacked.design_launches),
                   dict(mesh.mesh_apply_stacked_grad.design_launches))
        resident = dict(mesh.mesh_apply_stacked_grad.resident_launches)
        group_designs = dict(mesh.mesh_densify_grad.design_launches)
        evals = _val_evals(steps, log_every)
        chains = 3 * steps if label.startswith("t") else 0
        want = dict.fromkeys(BP_COUNTED, 0)
        want["tt_contract_grad"] = chains
        want["tt_contract"] = chains + (2 * evals if chains else 0)
        if "tonn" in label:   # a step's one grouped forward and backward,
            # and the validation forwards' (outside autograd)
            want["mesh_densify_stacked"] = steps + evals
            want["mesh_densify_grad"] = steps
        if "onn" in label and "tonn" not in label:
            want["mesh_apply_stacked"] = (ONN_BP_MESHES * steps
                                          + ONN_VAL_MESHES * evals)
            want["mesh_apply_stacked_grad"] = ONN_BP_MESHES * steps
            want["mesh_product_grad"] = DENSE_GRAD_PRODUCTS * _onn_bp_designs(
                res.model, batch, steps, evals)[1]["dense"]
        if launches != want:
            raise AssertionError(f"{label}: {launches} over {steps} steps; "
                                 f"expected {want}")
        onn = "onn" in label and "tonn" not in label
        expected = (_onn_bp_designs(res.model, batch, steps, evals) if onn
                    else designs)
        if designs != expected:
            raise AssertionError(f"{label}: mesh launches by design "
                                 f"{designs}, expected {expected}")
        # onn's resident backwards (its 21- and 64-port meshes) all take
        # the warp design
        want_res = {"warp": expected[1]["resident"], "block": 0}
        if resident != want_res:
            raise AssertionError(f"{label}: resident backward launches by "
                                 f"design {resident}, expected {want_res}")
        # the paper's core matrices take the grouped backward's warp design
        want_group = dict.fromkeys(mesh.GRAD_GROUP_DESIGNS, 0)
        want_group["warp"] = want["mesh_densify_grad"]
        if group_designs != want_group:
            raise AssertionError(f"{label}: grouped backward launches by "
                                 f"design {group_designs}, expected "
                                 f"{want_group}")
        losses = np.asarray(res.losses)
        if not (np.isfinite(losses).all() and np.isfinite(res.val_mse)):
            raise AssertionError(f"{label}: non-finite losses or val MSE")
        row = {"steps": steps, "batch": batch, "launches": launches,
               "densify_grad_designs": group_designs,
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "losses": losses.tolist(), "val_mse": res.val_mse,
               "host_step_ms_median":
                   1e3 * float(np.median(res.step_seconds)),
               "train_wall_s": wall}
        model, params, noise = res.model, res.params, res.hw_noise
        xt = next(pde_collocation_iterator(batch, seed=0, start_step=steps,
                                           problem=model.problem))
        if onn:
            row["mesh_designs"] = {"forward": designs[0],
                                   "backward": designs[1],
                                   "resident_backward": resident}
            row["mesh_designs_per_step"] = {
                k: {d: n for d, n in v.items() if n} for k, v in zip(
                    ("forward", "backward"),
                    _onn_bp_designs(res.model, batch, 1, 0))}
        init, _ = train.init_solver(model, 0)
        wide = label == "onn-1024-adamw"
        row["card_vs_cpu"] = _card_vs_cpu_grads(
            model, params, to_device(init, device), noise,
            xt[:ONN_CHECK_BATCH] if wide else xt, device, loss=not wide,
            f64_floor=wide)
        if "tonn" in label:   # the grouped backward without the noise model
            row["card_vs_cpu_noise_off"] = _card_vs_cpu_grads(
                model, params, to_device(init, device), None, xt, device)
        opt = get_optimizer(flags[-1])
        if label != "dense-sgd":
            # a second run of 5 steps gives the same bits
            first5, _, _ = _run_counted(base + flags + ["--steps", "5"])
            again5, _, _ = _run_counted(base + flags + ["--steps", "5"])
            if first5.losses != again5.losses or not all(
                    torch.equal(a, b) for a, b in zip(
                        zoo.tree_leaves(first5.params),
                        zoo.tree_leaves(again5.params))):
                raise AssertionError(f"{label}: two BP runs differ: "
                                     f"{first5.losses} vs {again5.losses}")
            row["repeat_losses_bitwise_equal"] = True
        if label != "dense-sgd":
            timed = measure_bp_step(
                model, opt, params, noise, xt.to(device),
                match="mesh_" if onn else "tt_contract")
            row["bp_step_ms"] = timed["bp_step_ms"]
            row["bp_step_trace"] = timed["trace"]
        if label == "tt-adamw":
            if not np.median(losses[-10:]) < losses[0]:
                raise AssertionError(
                    f"tt BP loss did not fall: first {losses[0]:.4e}, "
                    f"median of the last 10 {np.median(losses[-10:]):.4e}")
            row["loss_median_last10"] = float(np.median(losses[-10:]))
            # the checkpoint's opt subtree round-trips
            meta = read_checkpoint_meta(ckpt)
            restored, _ = restore_checkpoint(
                ckpt, {"params": params, "opt": opt.init(params)})
            for a, b in zip(zoo.tree_leaves(restored),
                            zoo.tree_leaves({"params": params,
                                             "opt": res.opt_state})):
                if not torch.equal(a, b):
                    raise AssertionError("the BP checkpoint does not hold "
                                         "the run's params and opt state")
            # --resume from step_25 continues the run
            shutil.rmtree(f"{ckpt}/step_{steps:012d}")
            resumed, _, _ = _run_counted(argv + ["--resume"])
            if resumed.losses != res.losses[steps // 2:]:
                raise AssertionError("--resume did not continue the run bit "
                                     f"for bit: {resumed.losses[:3]} vs "
                                     f"{res.losses[steps // 2:][:3]}")
            row["resume_losses_bitwise_equal"] = True
            row["checkpoint_keys"] = len(meta["keys"])
        shutil.rmtree(ckpt)
        out[label] = row
        print(f"[train-bp] {label} {json.dumps(row)}", flush=True)
    return out


def phase_train_seq(device) -> dict:
    """``--pinn-mode tonn --pinn-noise --sequential`` at the paper's width
    (N = 10, batch 100) for 5 steps: 1 grouped densification and 2
    ``tt_contract`` launches per loss evaluation (and per validation
    forward), no batched chain and no standalone mesh; one step's losses
    card vs CPU on the same params, ξ and batch."""
    import numpy as np
    import torch
    from repro_torch import pde as pde_lib
    from repro_torch.core import pinn, zoo
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import counter_generator, to_device

    steps, batch, n, log_every = 5, 100, 10, 10
    res, launches, wall = _run_counted(
        ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-mode", "tonn",
         "--pinn-noise", "--sequential", "--steps", str(steps), "--batch",
         str(batch), "--zo-samples", str(n), "--log-every", str(log_every),
         "--seed", "0"])
    want = dict.fromkeys(BP_COUNTED, 0)
    evals = (n + 1) * steps + _val_evals(steps, log_every)
    want["tt_contract"] = 2 * evals
    want["mesh_densify_stacked"] = evals
    if launches != want:
        raise AssertionError(f"sequential: {launches} over {steps} steps; "
                             f"expected {want}")
    if not (np.isfinite(res.losses).all() and np.isfinite(res.val_mse)):
        raise AssertionError(f"sequential: non-finite losses {res.losses}")
    model, params, noise = res.model, res.params, res.hw_noise
    mask = model.trainable_mask(params)
    scfg = zoo.SPSAConfig(num_samples=n)
    xis = zoo.sample_perturbations(counter_generator(7, device=device),
                                   params, n, mask)
    xt = next(pde_collocation_iterator(batch, seed=0, start_step=steps,
                                       problem=model.problem))

    def one_step(dev):
        p, z, nz = (to_device(params, dev), to_device(xis, dev),
                    to_device(noise, dev))
        x = xt.to(dev)
        with torch.no_grad():
            def loss_fn(q):
                return pinn.residual_loss(model, q, x, nz)
            losses = zoo.spsa_losses(loss_fn, p, None, scfg, xis=z)
            pts = pde_lib.fd_stencil_points(x, model.fd_step,
                                            model.in_dim)
            u = model.u(zoo.tree_map(lambda a, b: a + 0.01 * b[0], p, z),
                        pts.reshape(-1, x.shape[1]), nz)
            return losses.cpu(), loss_fn(p).cpu(), u.cpu()

    l_card, b_card, u_card = one_step(device)
    l_cpu, b_cpu, u_cpu = one_step(torch.device("cpu"))
    u_err, u_scale = _u_close("sequential", u_card, u_cpu)
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)
    np.testing.assert_allclose(b_card.numpy(), b_cpu.numpy(), rtol=1e-1)
    p_dev, x_dev = params, xt.to(device)

    def seq_step():
        return zoo.zo_signsgd_step(
            p_dev, zoo.ZOState(steps, 1), 1e-3, scfg, trainable_mask=mask,
            loss_fn=lambda q: pinn.residual_loss(model, q, x_dev, noise))

    out = {"steps": steps, "batch": batch, "zo_samples": n,
           "launches": launches, "losses": [float(v) for v in res.losses],
           "val_mse": res.val_mse,
           "host_step_ms_median": 1e3 * float(np.median(res.step_seconds)),
           "train_wall_s": wall, "seq_step_ms": _time_ms(seq_step, 5, 2),
           "seq_step_trace": _profile(seq_step, 1, match="tt_contract"),
           "stencil_u_max_abs_card_vs_cpu": u_err, "stencil_u_max": u_scale,
           "losses_card": l_card.tolist(), "losses_cpu": l_cpu.tolist(),
           "base_card": float(b_card), "base_cpu": float(b_cpu)}
    print(f"[train-seq] {json.dumps(out)}", flush=True)
    return out



ONN_COUNTED = ("tt_contract", "tt_contract_batched", "mesh_densify_stacked",
               "mesh_apply_stacked")


def _run_onn(argv: list) -> tuple:
    """``launch.train.main(argv)`` with every kernel count (and the mesh's
    per-design counts) set to 0 just before and read just after.  Returns
    (result, launches, wall seconds)."""
    import torch
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.launch import train
    counted = _counted()
    for fn in counted.values():                           # main path starts
        fn.launches = 0
    mesh.mesh_apply_stacked.design_launches = dict.fromkeys(mesh.DESIGNS, 0)
    t0 = time.perf_counter()
    res = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: counted[name].launches for name in ONN_COUNTED}
    launches.update(mesh.mesh_apply_stacked.design_launches)   # ends
    return res, launches, wall


ONN_VAL_POINTS = 1000   # launch/train.py's validation set


def _onn_want(stacked_evals: int, forwards: dict) -> dict:
    """Launches of onn runs at hidden 1024 with batch 100: a stacked
    stencil pass (S = 11) is 2 resident meshes (layer 0's 21-port V mesh
    on the rows and on the identity columns) and 4 wide ones (layer 0's
    1024-port U mesh on the 100 rows and on the 21 columns, the hidden
    layer's V and U on 43 x 100 rows); a single forward over n points
    (``forwards``: n -> how many) 1 resident and 3 wide meshes on n rows.
    Each wide mesh counts under the route ``wide_route`` picks."""
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    wide = photonic.rectangular_layout(1024)
    want = dict.fromkeys(ONN_COUNTED, 0)
    want.update(dict.fromkeys(mesh.DESIGNS, 0))
    want["resident"] = 2 * stacked_evals + sum(forwards.values())
    for S, rows, count in ([(11, 100, stacked_evals), (11, 21, stacked_evals),
                            (11, 4300, 2 * stacked_evals)]
                           + [(1, n, 3 * k) for n, k in forwards.items()]):
        want[mesh.wide_route(wide, S, rows)] += count
    want["mesh_apply_stacked"] = sum(want[d] for d in mesh.DESIGNS)
    return want


def phase_train_onn(device) -> dict:
    """The paper's ONN baseline (``ONN_ONCHIP``: hjb-20d, hidden 1024,
    noise on) through the trainer, fused ZO with N = 10 and batch 100,
    then 2 ``--sequential`` steps."""
    import numpy as np
    import torch
    from repro_torch.core import pinn, zoo
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import counter_generator, to_device
    from repro_torch.launch import train

    steps, batch, n, log_every = 10, 100, 10, 5
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_onn_")
    base = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-mode", "onn",
            "--pinn-noise", "--batch", str(batch), "--zo-samples", str(n),
            "--seed", "0"]
    res, launches, wall = _run_onn(base + [
        "--steps", str(steps), "--log-every", str(log_every), "--ckpt-dir",
        ckpt, "--ckpt-every", str(steps)])
    want = _onn_want(steps, {ONN_VAL_POINTS: _val_evals(steps, log_every)})
    if launches != want:
        raise AssertionError(f"onn: {launches} over {steps} steps; expected "
                             f"{want}")
    model, params, noise = res.model, res.params, res.hw_noise
    losses = np.asarray(res.losses)
    if not (np.isfinite(losses).all() and np.isfinite(res.val_mse)):
        raise AssertionError(f"onn: non-finite losses {losses} or val MSE "
                             f"{res.val_mse}")
    init, _ = train.init_solver(model, 0)
    mask = model.trainable_mask(init)
    for new, old, trainable in zip(zoo.tree_leaves(params),
                                   zoo.tree_leaves(init),
                                   zoo.tree_leaves(mask)):
        if not trainable and not torch.equal(new.cpu(), old):
            raise AssertionError("onn: a ±1 diag buffer moved in training")

    # one step's stacked stencil and losses, card against the CPU's plain
    # path on the same params, ξ, batch and noise; the stack is cut to its
    # first 3 entries (the CPU's plain 1024-level meshes take ~15 ms a
    # level on 3 x 4300 rows)
    scfg = zoo.SPSAConfig(num_samples=n)
    xis = zoo.sample_perturbations(counter_generator(7, device=device),
                                   params, n, mask)
    stacked = zoo.tree_map(lambda t: t[:3].contiguous(),
                           zoo.perturbed_stack(params, xis, scfg))
    xt = next(pde_collocation_iterator(batch, seed=0, start_step=steps,
                                       problem=model.problem))

    def one_step(dev):
        # the losses from the same u, as residual_losses_stacked forms them
        # (one stencil pass: the CPU's pass takes minutes)
        sp, nz, x = to_device(stacked, dev), to_device(noise, dev), xt.to(dev)
        with torch.no_grad():
            u = model.fd_u_stencil_stacked(sp, x, model.fd_step, nz)
            return u.cpu(), pinn._loss_from_u_stencil(
                model.problem, u, model.fd_step, x).cpu()

    u_card, l_card = one_step(device)
    t_cpu = time.perf_counter()
    u_cpu, l_cpu = one_step(torch.device("cpu"))
    t_cpu = time.perf_counter() - t_cpu
    u_err, u_scale = _u_close("onn", u_card, u_cpu)
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)

    # ms per ZO step on CUDA events and a traced window
    timed = measure_zo_step(model, params, noise, mask, xt.to(device),
                            zoo.ZOState(step=steps, seed=1), n, iters=5,
                            match="mesh_")

    # the checkpoint carries the chip's noise and serves without hw_noise=
    served = _serves_checkpoint("onn", ckpt, model, params, noise, device)
    shutil.rmtree(ckpt)

    # --sequential: 11 loss evaluations a step, one plain FD stencil each
    # (a single forward over the 43 x 100 stencil points: 4 meshes)
    seq_steps, seq_log = 2, 10
    seq, seq_launches, seq_wall = _run_onn(base + [
        "--steps", str(seq_steps), "--log-every", str(seq_log),
        "--sequential"])
    seq_want = _onn_want(0, {43 * batch: (n + 1) * seq_steps,
                             ONN_VAL_POINTS: _val_evals(seq_steps, seq_log)})
    if seq_launches != seq_want:
        raise AssertionError(f"onn sequential: {seq_launches} over "
                             f"{seq_steps} steps; expected {seq_want}")
    if not (np.isfinite(seq.losses).all() and np.isfinite(seq.val_mse)):
        raise AssertionError(f"onn sequential: non-finite {seq.losses}")
    x_dev = xt.to(device)

    def seq_step():
        return zoo.zo_signsgd_step(
            seq.params, zoo.ZOState(seq_steps, 1), 1e-3, scfg,
            trainable_mask=mask,
            loss_fn=lambda q: pinn.residual_loss(seq.model, q, x_dev,
                                                 seq.hw_noise))

    out = {"steps": steps, "batch": batch, "zo_samples": n,
           "launches": launches,
           "launches_per_step": _onn_want(1, {}),
           "validation_forwards": _val_evals(steps, log_every),
           "losses": [float(v) for v in losses], "val_mse": res.val_mse,
           "zo_step_ms": timed["zo_step_ms"][0],
           "zo_step_trace": timed["trace"],
           "host_step_ms_median": 1e3 * float(np.median(res.step_seconds)),
           "train_wall_s": wall,
           "stencil_u_max_abs_card_vs_cpu": u_err, "stencil_u_max": u_scale,
           "card_vs_cpu_stack": 3, "cpu_step_s": t_cpu,
           "losses_card": l_card.tolist(), "losses_cpu": l_cpu.tolist(),
           "served_vs_direct_max_abs": served,
           "sequential": {
               "steps": seq_steps, "launches": seq_launches,
               "launches_per_step": _onn_want(0, {43 * batch: n + 1}),
               "losses": [float(v) for v in seq.losses],
               "val_mse": seq.val_mse,
               "seq_step_ms": _time_ms(seq_step, 2, warmup=1),
               "host_step_ms_median":
                   1e3 * float(np.median(seq.step_seconds)),
               "train_wall_s": seq_wall}}
    print(f"[train-onn] {json.dumps(out)}", flush=True)
    return out


ONN_HIDDEN = 1024       # the served onn solver's width (ONN_ONCHIP)


def phase_serve_onn(device) -> dict:
    """An engine over a fresh onn solver (hjb-20d, hidden 1024, noise on):
    served u against a direct ``model.u`` and the CPU, 4 meshes a program
    run (1 resident, 3 wide on the pool's rows)."""
    import numpy as np
    import torch
    from repro_torch.core import pinn
    from repro_torch.core.photonic import NoiseModel
    from repro_torch.device import to_device
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.serving import (PdeServingEngine, PointRequest,
                                     SolverRegistry)

    cfg = pinn.PINNConfig(hidden=ONN_HIDDEN, mode="onn", pde="hjb-20d",
                          noise=NoiseModel(enabled=True))
    reg = SolverRegistry(device=device)
    solver = reg.register_fresh("onn", cfg, seed=2, device=device)
    engine = PdeServingEngine(reg, slots=8, slot_points=256, device=device)
    rng = np.random.RandomState(2)
    traffic = [rng.uniform(0.02, 0.98, (n, 21)).astype(np.float32)
               for n in (1, 256, 97, 700, 40)]
    mesh.mesh_apply_stacked.design_launches = dict.fromkeys(mesh.DESIGNS, 0)
    t0 = time.perf_counter()                              # main path starts
    reqs = [engine.submit(PointRequest("onn", pts)) for pts in traffic]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mesh.mesh_apply_stacked.design_launches)   # ends
    runs = engine.stats["program_runs"]
    pool = engine.slots * engine.slot_points
    want = {d: n * runs for d, n in _onn_want(0, {pool: 1}).items()
            if d in mesh.DESIGNS}
    if launches != want:
        raise AssertionError(f"onn serving: {launches} over {runs} program "
                             f"runs; expected {want}")
    worst = cpu_err = 0.0
    cpu_params = to_device(solver.params, torch.device("cpu"))
    cpu_noise = to_device(solver.noise, torch.device("cpu"))
    for k, r in enumerate(reqs):
        if not (r.done and np.isfinite(r.out).all()):
            raise AssertionError("an onn request was not served")
        pts = torch.tensor(r.points, dtype=torch.float32)
        with torch.no_grad():
            direct = solver.model.u(solver.params, pts.to(device),
                                    solver.noise).cpu().numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        worst = max(worst, float(np.abs(r.out - direct).max()))
        if k < 3:
            with torch.no_grad():
                plain = solver.model.u(cpu_params, pts, cpu_noise).numpy()
            np.testing.assert_allclose(r.out, plain, rtol=1e-5, atol=1e-5)
            cpu_err = max(cpu_err, float(np.abs(r.out - plain).max()))
    pool = solver.problem.sample_collocation(
        torch.Generator().manual_seed(1), pool).to(device)
    with torch.no_grad():
        program_ms = _time_ms(lambda: solver.model.u(solver.params, pool,
                                                     solver.noise), 5, 1)
    out = {"requests": len(reqs), "points": sum(len(t) for t in traffic),
           "wall_ms": wall * 1e3, "program_runs": runs,
           "launches": launches, "program_ms": program_ms,
           "max_abs_served_vs_direct": worst,
           "max_abs_served_vs_cpu": cpu_err}
    print(f"[serve-onn] {json.dumps(out)}", flush=True)
    return out


def phase_table2() -> dict:
    """Paper Table 2 and the §4.2 training cost from the port's cost model
    (host arithmetic): the numbers the paper's MZI, energy and latency
    claims rest on."""
    from benchmarks import torch_table2_cost
    rows = {r["name"]: r for r in torch_table2_cost.run()}
    onn, tonn1 = rows["table2/ONN"], rows["table2/TONN-1"]
    tr = rows["table2/training-efficiency(TONN-1)"]
    want = {"onn_mzis": 2_095_104, "tonn1_mzis": 1_008, "tonn2_mzis": 28,
            "inferences_per_epoch": 42_000, "total_energy_j": 1.354,
            "total_latency_s": 1.151, "mzi_reduction_vs_onn": 2078.5}
    got = {"onn_mzis": onn["mzis"], "tonn1_mzis": tonn1["mzis"],
           "tonn2_mzis": rows["table2/TONN-2"]["mzis"],
           **{k: tr[k] for k in ("inferences_per_epoch", "total_energy_j",
                                 "total_latency_s", "mzi_reduction_vs_onn")}}
    if got != want:
        raise AssertionError(f"table2: {got}; expected {want}")
    for key, paper in (("total_energy_j", 1.36), ("total_latency_s", 1.15),
                       ("inferences_per_epoch", 4.2e4)):
        if abs(got[key] / paper - 1) > 0.01:
            raise AssertionError(f"table2: {key} {got[key]} is not within "
                                 f"1% of the paper's {paper}")
    if abs(onn["mzis"] / onn["mzis_paper"] - 1) > 0.01:
        raise AssertionError(f"table2: ONN MZIs {onn['mzis']} against the "
                             f"paper's {onn['mzis_paper']}")
    print(f"[table2] {json.dumps(got)}", flush=True)
    return {"rows": list(rows.values()), **got}


# the paper's Table 1 rows at its width (hidden 1024, tt_rank 2, tt_L 4,
# batch 100, N = 10), each for a short budget
TABLE1_EPOCHS = 20
TABLE1_VAL_FORWARDS = 2          # the ideal and the mapped validation MSE


# the off-chip ONN row at hidden 1024, by design and route, written out
# rather than asked of the dispatch under test: an epoch's 4 meshes on the
# stencil's 4300 rows (layer 0's 21-port V mesh resident, the 3 1024-port
# meshes route B) and their backwards (1 resident, 3 dense); a validation
# forward's 4 on 1000 points (1 resident, 3 route A)
TABLE1_ONN_1024_EPOCH = {"resident": 1, "dense": 3, "grad_resident": 1,
                         "grad_dense": 3}
TABLE1_ONN_1024_VAL = {"resident": 1, "warp_rows": 3}


def _table1_want(mode: str, on_chip: bool, epochs: int,
                 hidden: int = 1024) -> dict:
    """Launches of one Table 1 row (``mode`` after the noise remap) over
    ``epochs`` (``deriv="fd"``: the stencil's 43 x 100 rows go through one
    forward) and its two validation forwards of 1000 points.  tt and tonn
    off-chip: 2 ``tt_contract`` forward and 2 ``tt_contract_grad``
    launches a step (tonn: 1 grouped densification and 1 grouped backward
    more), 2 ``tt_contract`` a validation forward (tonn: 1 grouped
    densification more); tonn on-chip: 1 grouped densification and 2
    ``tt_contract_batched`` a step; onn on-chip: layer 0's 21-port V mesh
    (resident) and 3 wide 1024-port meshes on 4300 rows per entry a step,
    1 + 3 on 1000 rows a validation forward; onn off-chip: 4 meshes and
    their 4 backwards on the stencil's rows a step, 4 meshes on 1000 rows
    a validation forward, each by the design or route its layout and rows
    take (at hidden 1024 the fixed ``TABLE1_ONN_1024_EPOCH`` and
    ``TABLE1_ONN_1024_VAL``: a step's layer-0 V mesh resident forward and
    backward, the 3 wide meshes route B forward and the dense backward;
    a validation forward's 3 wide meshes route A); dense:
    none."""
    from benchmarks import torch_table1_hjb as table1
    from repro_torch import pde as pde_lib
    from repro_torch.core import photonic
    from repro_torch.kernels import mesh_apply as mesh
    want = dict.fromkeys(table1.COUNTED + mesh.DESIGNS + table1.GRAD_KEYS,
                         0)
    vf = TABLE1_VAL_FORWARDS
    if mode in ("tt", "tonn") and not on_chip:
        want["tt_contract"] = 2 * epochs + 2 * vf
        want["tt_contract_grad"] = 2 * epochs
        if mode == "tonn":
            want["mesh_densify_stacked"] = epochs + vf
            want["mesh_densify_grad"] = epochs
    elif mode == "onn" and not on_chip and hidden == 1024:
        for counts, n in ((TABLE1_ONN_1024_EPOCH, epochs),
                          (TABLE1_ONN_1024_VAL, vf)):
            for k, v in counts.items():
                want[k] += v * n
        want["mesh_apply_stacked"] = 4 * (epochs + vf)
        want["mesh_apply_stacked_grad"] = 4 * epochs
    elif mode == "onn" and not on_chip:
        problem = pde_lib.get_problem("hjb-20d")
        stencil = (2 * problem.in_dim + 1) * 100
        for ports in (problem.net_dim, hidden, hidden, hidden):
            layout = photonic.rectangular_layout(ports)
            want[_mesh_route(layout, stencil)] += epochs
            want[_mesh_route(layout, table1.VAL_POINTS)] += vf
            want[f"grad_{mesh.grad_design(layout, 1, stencil)}"] += epochs
        want["mesh_apply_stacked"] = 4 * (epochs + vf)
        want["mesh_apply_stacked_grad"] = 4 * epochs
    elif mode == "tonn":
        want["mesh_densify_stacked"] = epochs + vf
        want["tt_contract_batched"] = 2 * epochs
        want["tt_contract"] = 2 * vf
    elif mode == "onn":
        wide = photonic.rectangular_layout(1024)
        want["resident"] = epochs + vf
        want[mesh.wide_route(wide, 11, 4300)] += 3 * epochs
        want[mesh.wide_route(wide, 1, table1.VAL_POINTS)] += 3 * vf
        want["mesh_apply_stacked"] = sum(want[d] for d in mesh.DESIGNS)
    return want


# the off-chip ONN row (dense mapped onto noise: onn by BP) at the paper's
# width: its hidden meshes take route B forward on the stencil's 4300 rows
# and the dense backward
TABLE1_ONN_BP = (("dense", False, True), 1024)


def phase_table1(device) -> dict:
    """The paper's five Table 1 rows through ``benchmarks/
    torch_table1_hjb.run_row`` at its width, and the off-chip ONN row
    there too, for ``TABLE1_EPOCHS`` epochs each (seed 0): every val MSE
    finite, each row's launches exactly its path's (``_table1_want``: by
    kernel, and the meshes' by design and route, forward and backward)
    and none of the other counted kernels, ms a step on CUDA events."""
    import numpy as np
    from benchmarks import torch_table1_hjb as table1
    from repro_torch.kernels import mesh_apply as mesh
    out = {}
    for key, hidden in ([(k, 1024) for k in table1.PAPER_ROWS]
                        + [TABLE1_ONN_BP]):
        name = table1.row_name(*key)
        table1.kernel_launches(reset=True)                # main path starts
        mesh.mesh_apply_stacked_grad.resident_launches = dict.fromkeys(
            mesh.RESIDENT_GRAD_DESIGNS, 0)
        r = table1.run_row(*key, hidden=hidden, tt_L=4,
                           epochs=TABLE1_EPOCHS, device=device)
        launches = table1.kernel_launches()                # ends
        resident = dict(mesh.mesh_apply_stacked_grad.resident_launches)
        want = _table1_want(r["mode"], r["on_chip"], TABLE1_EPOCHS, hidden)
        if launches != want:
            raise AssertionError(f"{name}: {launches} over {TABLE1_EPOCHS} "
                                 f"epochs; expected {want}")
        # the off-chip ONN row's resident backward (layer 0's 21-port V
        # mesh on the stencil's rows) takes the warp design
        if resident != {"warp": want["grad_resident"], "block": 0}:
            raise AssertionError(f"{name}: resident backward launches by "
                                 f"design {resident}")
        r["resident_backward"] = resident
        if not (np.isfinite(r["val_mse_mapped"])
                and np.isfinite(r["val_mse_ideal"])
                and np.isfinite(r["final_loss"])):
            raise AssertionError(f"{name}: non-finite result {r}")
        r["launches"] = {k: v for k, v in launches.items() if v}
        val_only = _table1_want(r["mode"], r["on_chip"], 0, hidden)
        r["launches_per_step"] = {k: (v - val_only[k]) / TABLE1_EPOCHS
                                  for k, v in launches.items() if v}
        out[name] = r
    print(f"[table1] {json.dumps(out)}", flush=True)
    return out


# pde -> (steps, extra trainer flags); helmholtz-2d's boundary term at λ 2
PDE_TRAIN = {"heat-20d": (20, ()), "black-scholes-100d": (20, ()),
             "helmholtz-2d": (20, ("--bc-weight", "2"))}
# problems whose loss ZO training at the paper's rate does not move: on
# the card helmholtz-2d's loss on held batches moves by ~1e-5 relative
# over 20–1000 steps and its val MSE by ~1e-4, while its step loss swings
# ±15% with the batch; the JAX package's CLI at hidden 64 does the same
# (val MSE 0.2425 → 0.2541 over 300 steps).  ns-2d likewise: the JAX
# package's own ZO run of it misses its bar (tests/test_ns.py, 1.888 →
# 1.844 over 40 steps against < 0.8×; ROADMAP queue C), and the port's at
# hidden 64 on the CPU moves its held batch by +0.6% over 20 steps.  Their
# check is that every trainable leaf moved; their losses are recorded
STILL_LOSS = ("helmholtz-2d", "ns-2d")
STEIN_P, STEIN_B, STEIN_S = 11, 100, 32


def _pde_want(problem, steps: int, log_every: int, deriv: str) -> dict:
    """The counted launches of a fused tonn run of ``problem`` with the
    resolved estimator ``deriv``: a step is 1 grouped densification and 3
    ``tt_contract_batched`` with ``fd_fast`` (layer 0 on the rows and on
    the identity columns, the hidden layer on the stencil) or 2 with
    ``spectral`` and ``fd`` (layer 0 on the shared line or stencil rows,
    the hidden layer per entry), 2 more for each boundary or data term
    (layer 0 on its shared rows, the hidden layer per entry); a validation
    forward 1 densification and 2 ``tt_contract``; a logged step of a
    problem with more than one term also 1 densification and as many
    ``tt_contract`` as the step has chains for ``per_term_losses``."""
    extra = len(problem.loss_terms()) - 1
    chains = (3 if deriv == "fd_fast" else 2) + 2 * extra
    vals = _val_evals(steps, log_every)
    logged = len(range(0, steps, log_every)) if extra else 0
    want = dict.fromkeys(BP_COUNTED, 0)
    want["tt_contract_batched"] = chains * steps
    want["mesh_densify_stacked"] = steps + vals + logged
    want["tt_contract"] = 2 * vals + chains * logged
    return want


def _train_pde(device, pde: str, steps: int, flags: tuple = ()) -> dict:
    """``launch.train.main`` on ``pde`` at the paper's config (tonn, noise
    on, ``fd_fast`` unless ``flags`` pick another estimator, fused), N =
    10, batch 100, with a checkpoint and ``flags``; its launches, card vs
    CPU on one step's first 3 entries (the stencil's or the line rows' u,
    a boundary or data term's u, the losses; with ``spectral`` also the
    derivatives from the card's line values, cuFFT against the CPU's FFT,
    both held to the float64 oracle: ``_spectral_derivs_check``), the
    checkpoint served with its term weights, a ZO step timed.  Returns the
    row and the trained result."""
    import numpy as np
    import torch
    from repro_torch.core import pinn, zoo
    from repro_torch.data import (pde_collocation_iterator,
                                  pde_term_batch_iterator)
    from repro_torch.device import counter_generator, to_device
    from repro_torch.launch import train

    batch, n, log_every = 100, 10, 10
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_pde_")
    res, launches, wall = _run_counted(
        ["--arch", "tensor-pinn", "--pde", pde, "--pinn-noise", "--steps",
         str(steps), "--batch", str(batch), "--zo-samples", str(n),
         "--ckpt-dir", ckpt, "--ckpt-every", str(steps), "--log-every",
         str(log_every), "--seed", "0", *flags])
    model, params, noise = res.model, res.params, res.hw_noise
    problem = model.problem
    deriv = pinn._resolve_deriv(model.cfg, problem)
    vals = _val_evals(steps, log_every)
    want = _pde_want(problem, steps, log_every, deriv)
    if launches != want:
        raise AssertionError(f"{pde}: {launches} over {steps} steps; "
                             f"expected {want}")
    losses = np.asarray(res.losses)
    if not (np.isfinite(losses).all() and np.isfinite(res.val_mse)):
        raise AssertionError(f"{pde}: non-finite losses {losses} or val "
                             f"MSE {res.val_mse}")
    if pde not in STILL_LOSS and not np.median(losses[-5:]) < losses[0]:
        raise AssertionError(f"{pde}: loss did not fall: first "
                             f"{losses[0]:.4e}, median of the last 5 "
                             f"{np.median(losses[-5:]):.4e}")
    init, _ = train.init_solver(model, 0)
    mask = model.trainable_mask(init)
    for new, old, trainable in zip(zoo.tree_leaves(params),
                                   zoo.tree_leaves(init),
                                   zoo.tree_leaves(mask)):
        if not trainable and not torch.equal(new.cpu(), old):
            raise AssertionError(f"{pde}: a ±1 diag buffer moved")

    # one step's stacked stencil u and losses, card against the CPU's
    # plain path on the first 3 entries of the stack
    scfg = zoo.SPSAConfig(num_samples=n)
    xis = zoo.sample_perturbations(counter_generator(7, device=device),
                                   params, n, mask)
    stacked = zoo.perturbed_stack(params, xis, scfg)
    head = zoo.tree_map(lambda t: t[:3].contiguous(), stacked)
    xt = next(pde_collocation_iterator(batch, seed=0, start_step=steps,
                                       problem=problem))
    tb = next(pde_term_batch_iterator(max(batch // 4, 8), seed=0,
                                      start_step=steps, problem=problem))

    def one_step(dev):
        sp, nz, x = to_device(head, dev), to_device(noise, dev), xt.to(dev)
        terms = to_device(tb, dev)
        prepared = model.prepare_params_stacked(sp, nz)
        if deriv == "spectral":
            rows = pinn._spectral_rows(model, x)
            u = model.u_stacked(prepared, rows)
            base = pinn._spectral_loss(model, u, rows, x)
        else:
            u = model.fd_u_stencil_stacked(prepared, x, model.fd_step)
            base = pinn._loss_from_u_stencil(problem, u, model.fd_step, x)
        u_terms = {k: model.u_stacked(prepared, xb).cpu()
                   for k, (xb, _) in terms.items()}
        losses = pinn._add_terms(base, problem, terms,
                                 lambda xb: model.u_stacked(prepared, xb))
        return u, u_terms, losses.cpu()

    u_card, ut_card, l_card = one_step(device)
    u_cpu, ut_cpu, l_cpu = one_step(torch.device("cpu"))
    derivs = (_spectral_derivs_check(model, u_card, xt.to(device))
              if deriv == "spectral" else None)
    u_card = u_card.cpu()
    u_err, u_scale = _u_close(pde, u_card, u_cpu)
    term_u = {k: _u_close(f"{pde} {k}", ut_card[k], ut_cpu[k])
              for k in ut_cpu}
    np.testing.assert_allclose(l_card.numpy(), l_cpu.numpy(), rtol=1e-1)
    with torch.no_grad():
        per_term = {k: float(v) for k, v in pinn.per_term_losses(
            model, params, xt.to(device), noise,
            term_batches=to_device(tb, device)).items()}
        # the loss on one held batch (step ``steps``'s), initial params
        # against trained ones: free of the batch-to-batch spread
        held = [float(pinn.residual_loss(model, p, xt.to(device), noise,
                                         term_batches=to_device(tb, device)))
                for p in (to_device(init, device), params)]
        held_terms = {k: float(v) for k, v in pinn.per_term_losses(
            model, to_device(init, device), xt.to(device), noise,
            term_batches=to_device(tb, device)).items()}
    if not all(np.isfinite(list(per_term.values()))):
        raise AssertionError(f"{pde}: non-finite per-term losses {per_term}")
    if pde not in STILL_LOSS and not held[1] < held[0]:
        raise AssertionError(f"{pde}: the held batch's loss did not fall: "
                             f"{held[0]:.6e} -> {held[1]:.6e}")
    if pde in STILL_LOSS:
        still = [i for i, (new, old, trainable) in enumerate(zip(
            zoo.tree_leaves(params), zoo.tree_leaves(init),
            zoo.tree_leaves(mask))) if trainable and torch.equal(new.cpu(),
                                                                 old)]
        if still:
            raise AssertionError(f"{pde}: trainable leaves {still} did not "
                                 "move")

    # the checkpoint carries the chip's noise and its term weights, and
    # serves without hw_noise=; a conditioned one at several coefficient
    # instances from one program
    if problem.coeff_spec is not None:
        served = _serves_family(pde, ckpt, model, params, noise, device,
                                term_weights=problem.term_weights())
    else:
        served = _serves_checkpoint(pde, ckpt, model, params, noise, device,
                                    term_weights=problem.term_weights())
    shutil.rmtree(ckpt)

    timed = measure_zo_step(model, params, noise, mask, xt.to(device),
                            zoo.ZOState(step=steps, seed=1), n,
                            term_batches=to_device(tb, device) or None)
    A = model.in_dim
    rows_per_entry = (u_cpu.shape[-1] if deriv == "spectral"
                      else (2 * A + 1) * batch)
    out = {"pde": pde, "in_dim": A, "hidden": model.cfg.hidden,
           "mode": model.cfg.mode, "deriv": model.cfg.deriv,
           "resolved_deriv": deriv, "noise": model.cfg.noise.enabled,
           "specs": [[list(s.out_modes), list(s.in_modes), list(s.ranks)]
                     for s in model.specs],
           "steps": steps, "batch": batch,
           "zo_samples": n, "hidden_rows_per_entry": rows_per_entry,
           "launches": launches, "validation_forwards": vals,
           "losses": [float(v) for v in losses], "val_mse": res.val_mse,
           "zo_step_ms": timed["zo_step_ms"][0],
           "zo_step_trace": timed["trace"],
           "host_step_ms_median": 1e3 * float(np.median(res.step_seconds)),
           "train_wall_s": wall,
           "stencil_u_max_abs_card_vs_cpu": u_err, "stencil_u_max": u_scale,
           "spectral_derivs": derivs,
           "term_u_max_abs_card_vs_cpu": {k: e for k, (e, _) in
                                          term_u.items()},
           "term_u_max": {k: m for k, (_, m) in term_u.items()},
           "card_vs_cpu_stack": 3, "losses_card": l_card.tolist(),
           "losses_cpu": l_cpu.tolist(),
           "term_weights": problem.term_weights(),
           "term_rows": {k: int(xb.shape[0]) for k, (xb, _) in tb.items()},
           "per_term_losses_final": per_term,
           "held_batch_loss_initial_trained": held,
           "held_batch_per_term_initial": held_terms,
           "median_last5_below_first": bool(np.median(losses[-5:])
                                            < losses[0]),
           "served_vs_direct_max_abs": served}
    if problem.coeff_spec is not None:
        out["coeff_spec"] = problem.coeff_spec.to_meta()
        out["net_dim"] = problem.net_dim
        out["served"] = served
        out["served_vs_direct_max_abs"] = served["served_vs_direct_max_abs"]
    spec = model.specs[1]
    out["hidden_bound_ms"], out["hidden_bound_by"] = _batched_bound(
        spec, n + 1, rows_per_entry, False)
    return out, res


def _spectral_derivs_check(model, u_card, xt) -> dict:
    """The derivatives of one step's spectral loss from the card's u over
    the line rows (the first 3 entries): on the card (cuFFT) and from the
    same values on the CPU, each against ``spectral_derivs_ref`` in
    float64; raises where the card's distance passes twice the CPU's, or
    twice the f32 floor ε·max|v|·k_max^p (p = 1 for ∂, 2 for ∂²) where the
    CPU sits below it.  Returns both distances and the bounds."""
    import numpy as np
    from repro_torch.core import spectral
    from repro_torch.core.pinn import _spectral_grid
    problem = model.problem
    M, extent, periodization = _spectral_grid(model)
    rows = spectral.spectral_line_rows(xt, model.in_dim, M, extent)
    carrier = problem.spectral_carrier(rows, xt)
    vals = u_card if carrier is None else u_card - carrier[0]
    lines = spectral.line_vals_from_rows_vals(vals, xt.shape[0],
                                              model.in_dim, M)
    card = spectral.spectral_derivs(lines, extent, periodization)
    cpu = spectral.spectral_derivs(lines.cpu(), extent, periodization)
    oracle = spectral.spectral_derivs_ref(lines.cpu().numpy(), extent,
                                          periodization)
    out = {"lines": list(lines.shape), "points": M}
    for p, (c, h, r) in enumerate(zip(card, cpu, oracle), start=1):
        c_err = float(np.abs(c.cpu().numpy() - r).max())
        h_err = float(np.abs(h.numpy() - r).max())
        floor = (float(np.finfo(np.float32).eps) * lines.abs().max().item()
                 * (np.pi * M / extent) ** p)
        bound = 2 * max(h_err, floor)
        if not c_err <= bound:
            raise AssertionError(f"spectral d{p}: card {c_err:.3e} from the "
                                 f"float64 oracle, CPU {h_err:.3e}; bound "
                                 f"{bound:.3e}")
        out[f"d{p}"] = {"card_err": c_err, "cpu_err": h_err,
                        "bound": bound}
    return out


def _stein_pde(device, res) -> dict:
    """``residual_losses_stacked`` with Stein derivatives at heat-20d on
    the trained tonn model: P = 11, B = 100, S = 32, z drawn on the card
    from a seeded generator."""
    import torch
    from repro_torch.core import pinn, stein, tt, zoo
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import counter_generator, to_device
    from repro_torch.kernels import ref, tt_contract as ttc

    model = pinn.TensorPinn(dataclasses.replace(
        res.model.cfg, deriv="stein", stein_samples=STEIN_S))
    params, noise = res.params, res.hw_noise
    P, B, S = STEIN_P, STEIN_B, STEIN_S
    mask = model.trainable_mask(params)
    xis = zoo.sample_perturbations(counter_generator(8, device=device),
                                   params, P - 1, mask)
    stacked = zoo.perturbed_stack(params, xis,
                                  zoo.SPSAConfig(num_samples=P - 1))
    xt = next(pde_collocation_iterator(B, seed=0, start_step=99,
                                       problem=model.problem)).to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    z = stein.stein_directions(xt, gen, S, model.in_dim, lead=(P,))

    def stein_losses(sp=stacked):
        return pinn.residual_losses_stacked(model, sp, xt, noise, z=z)

    counted = _counted()
    for fn in counted.values():                           # main path starts
        fn.launches = 0
    losses = stein_losses()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}  # ends
    want = dict.fromkeys(BP_COUNTED, 0)
    want["tt_contract_batched"] = 2
    want["mesh_densify_stacked"] = 1
    if launches != want:
        raise AssertionError(f"stein: {launches}; expected {want}")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"stein: non-finite losses {losses}")

    # the per-entry layer-0 launch against its plain version
    prepared = model.prepare_params_stacked(stacked, noise)
    rows = stein.stein_stencil_points(xt, z, model.cfg.stein_sigma)
    x0 = model._embed(rows.reshape(P, (2 * S + 1) * B, -1)).contiguous()
    spec, cores = model.specs[0], prepared["cores0"]
    y = ttc.tt_contract_batched(x0, cores, spec)
    err, scale = _check_close("tt_contract_batched", "stein-layer0", y,
                              ref.tt_contract_batched_ref(x0, cores, spec))
    R = (2 * S + 1) * B
    wt = torch.stack([tt.tt_to_full([c[p] for c in cores], spec)
                      for p in range(P)]).transpose(1, 2)   # (P, N, M)
    layer0 = {"case": "stein-layer0-per-entry", "P": P, "rows": R,
              "shared_x": False, "design": "fibers",
              "tile": dataclasses.asdict(ttc.fiber_tile(spec, P * R)),
              "max_abs_err": err, "max_abs_plain": scale,
              "ms": _time_ms(lambda: ttc.tt_contract_batched(x0, cores,
                                                             spec), 20),
              "kernel_device_ms": _profile(
                  lambda: ttc.tt_contract_batched(x0, cores, spec),
                  match="tt_contract_batched_kernel")["match_ms"],
              "plain_ms": _time_ms(lambda: ref.tt_contract_batched_ref(
                  x0, cores, spec), 3, warmup=1),
              "library_ms": _time_ms(lambda: torch.bmm(x0, wt), 20)}
    layer0["bound_ms"], layer0["bound_by"] = _batched_bound(spec, P, R, False)
    print(f"[batched] {json.dumps(layer0)}", flush=True)

    # the stencil u of the first 3 entries, card against the CPU, same z
    head = zoo.tree_map(lambda t: t[:3].contiguous(), stacked)

    def stencil(dev):
        prep = model.prepare_params_stacked(to_device(head, dev),
                                            to_device(noise, dev))
        return model.stein_u_stacked(prep, xt.to(dev), z[:3].to(dev),
                                     model.cfg.stein_sigma).cpu()

    u_card, u_cpu = stencil(device), stencil(torch.device("cpu"))
    u_err, u_scale = _u_close("stein", u_card, u_cpu)
    # identical params in every entry: each entry's own directions
    same = zoo.tree_map(lambda t: t[None].expand(P, *t.shape).contiguous(),
                        params)
    distinct = stein_losses(same).cpu()
    if len(set(distinct.tolist())) != P:
        raise AssertionError(f"stein: identical entries gave {distinct}")
    out = {"pde": model.problem.name, "P": P, "batch": B, "samples": S,
           "sigma": model.cfg.stein_sigma, "launches": launches,
           "losses": losses.cpu().tolist(),
           "identical_params_losses": distinct.tolist(),
           "stencil_u_max_abs_card_vs_cpu": u_err, "stencil_u_max": u_scale,
           "call_ms": _time_ms(stein_losses, 10, warmup=2),
           "call_trace": _profile(stein_losses, 1, match="tt_contract"),
           "layer0": layer0}
    return out


# pde -> (steps, trainer flags): hjb-20d by the spectral estimator (M 16:
# 11 × 31,600 hidden rows a step), ns-2d by its own (auto → spectral, M
# 16: 11 × 4,600, and its ic and data terms on 25 rows each)
SPECTRAL_TRAIN = {"hjb-20d": (20, ("--estimator", "spectral")),
                  "ns-2d": (20, ("--estimator", "auto"))}


def phase_train_spectral(device) -> dict:
    """hjb-20d with ``--estimator spectral`` and ns-2d by ``auto`` through
    the trainer at the paper's config (``_train_pde``)."""
    out = {}
    for pde, (steps, flags) in SPECTRAL_TRAIN.items():
        out[pde], _ = _train_pde(device, pde, steps, flags)
        print(f"[train-spectral] {json.dumps(out[pde])}", flush=True)
    return out


# pde -> (steps, trainer flags): black-scholes-100d-rs with C = 4 scenarios
# a step tiled over the batch; heat-10d-kappa on ranges other than the
# registry's, log-uniform, with its Dirichlet term
COEFF_TRAIN = {"black-scholes-100d-rs": (20, ("--coeffs-per-step", "4")),
               "heat-10d-kappa": (20, ("--coeff-range", "kappa=0.7:1.5",
                                       "--coeff-dist", "loguniform"))}
COEFF_SERVED = 4        # coefficient instances served from one checkpoint
# the reference's family test: hjb-10d-lam by BP AdamW at hidden 48, batch
# 128, 400 steps, held to 1e-2 per coefficient (tests/test_coeff_families)
COEFF_BP = {"pde": "hjb-10d-lam", "steps": 400, "hidden": 48, "batch": 128,
            "lr": 3e-3, "tol": 1e-2, "draws": 5}
# points a request, for the packer's edges (a single point, a full slot,
# one across three slots, sizes that straddle slots): a correctness
# exercise, not a traffic mix, so no latency is read from it
COEFF_REQUESTS = (1, 256, 97, 700, 40, 511, 3, 300)


def _serves_family(name: str, ckpt: str, model, params, noise, device,
                   term_weights: dict) -> dict:
    """A conditioned checkpoint loaded into ``SolverRegistry`` (its trained
    ranges and ``term_weights`` from meta) and served at ``COEFF_SERVED``
    coefficient instances drawn in those ranges, ``COEFF_REQUESTS``
    requests an instance, from one program: built at warm-up and never
    again, its key tagged ``c{K}``.  Each request equals the trainer's
    ``model.u`` on its augmented rows (1e-6); a request outside the ranges
    is refused before it queues.  Returns the check's numbers."""
    import numpy as np
    import torch
    from repro_torch.device import counter_generator
    from repro_torch.serving import PdeServingEngine, PointRequest
    reg = _load_served(name, ckpt, device, term_weights)
    spec = reg.get(name).coeff_spec
    if spec != model.problem.coeff_spec:
        raise AssertionError(f"{name}: served ranges {spec}, trained "
                             f"{model.problem.coeff_spec}")
    engine = PdeServingEngine(reg, slots=8, slot_points=256,
                              enable_cache=False, device=device)
    engine.warmup(name)
    compiles = engine.stats["compiles"]
    key = f"{name}|float32|c{spec.n}|8|256"
    coeffs = spec.sample(counter_generator(13), COEFF_SERVED).numpy()
    pts = model.problem.sample_collocation(
        counter_generator(11), max(COEFF_REQUESTS))[:, :model.in_dim]
    bad = np.asarray(spec.hi) * 1.5
    try:
        engine.submit(PointRequest(name, pts[:4].numpy(), coeffs=bad))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{name}: coefficients {bad} outside the "
                             "trained ranges were served")
    reqs = []
    for n in COEFF_REQUESTS:
        for c in coeffs:
            reqs.append((c, engine.submit(PointRequest(
                name, pts[:n].numpy(), coeffs=c))))
    engine.run()
    err = 0.0
    for c, r in reqs:
        if not r.done:
            raise AssertionError(f"{name}: a request was not served")
        rows = model.problem.attach_coeffs(pts[:len(r.out)], c)
        with torch.no_grad():
            direct = model.u(params, rows.to(device), noise).cpu().numpy()
        np.testing.assert_allclose(r.out, direct, rtol=1e-6, atol=1e-6)
        err = max(err, float(np.abs(r.out - direct).max()))
    stats = engine.serving_stats()
    if stats["programs"] != [key] or engine.stats["compiles"] != compiles:
        raise AssertionError(f"{name}: programs {stats['programs']}, "
                             f"{engine.stats['compiles'] - compiles} "
                             f"rebuilds after warm-up; expected [{key!r}], 0")
    return {"coeffs": coeffs.tolist(), "requests": len(reqs),
            "points": sum(len(r.out) for _, r in reqs),
            "programs": stats["programs"], "compiles": compiles,
            "rebuilds_after_warmup": engine.stats["compiles"] - compiles,
            "program_runs": stats["program_runs"],
            "served_vs_direct_max_abs": err, "refused": refused}


def _coeff_bp(device) -> dict:
    """hjb-10d-lam trained through ``launch.train.main`` by BP at the
    reference's budget (``COEFF_BP``): 3 ``tt_contract`` + 3
    ``tt_contract_grad`` a step and 2 ``tt_contract`` a validation
    forward; then val MSE at ``draws`` coefficient vectors, each below the
    family's tolerance, and the range's ends giving different fields."""
    import numpy as np
    import torch
    from repro_torch.device import counter_generator
    from repro_torch.core import pinn

    cfg, log_every = COEFF_BP, 100
    steps = cfg["steps"]
    res, launches, wall = _run_counted(
        ["--arch", "tensor-pinn", "--pde", cfg["pde"], "--pinn-mode", "tt",
         "--optimizer", "adamw", "--lr", str(cfg["lr"]), "--hidden",
         str(cfg["hidden"]), "--steps", str(steps), "--batch",
         str(cfg["batch"]), "--log-every", str(log_every), "--seed", "0"])
    want = dict.fromkeys(BP_COUNTED, 0)
    want["tt_contract_grad"] = 3 * steps
    want["tt_contract"] = 3 * steps + 2 * _val_evals(steps, log_every)
    if launches != want:
        raise AssertionError(f"{cfg['pde']} BP: {launches} over {steps} "
                             f"steps; expected {want}")
    model, params = res.model, res.params
    prob = model.problem
    draws = prob.coeff_spec.sample(counter_generator(42), cfg["draws"])
    pts = prob.sample_collocation(counter_generator(7),
                                  400)[:, :prob.in_dim].to(device)
    with torch.no_grad():
        mses = [float(pinn.validation_mse(
            model, params, prob.attach_coeffs(pts, c))) for c in draws]
        u_lo, u_hi = (model.u(params, prob.attach_coeffs(pts, c))
                      for c in (prob.coeff_spec.lo, prob.coeff_spec.hi))
    if not max(mses) < cfg["tol"]:
        raise AssertionError(f"{cfg['pde']} BP: val MSE {mses} at "
                             f"{draws.tolist()}; tolerance {cfg['tol']}")
    if torch.allclose(u_lo, u_hi):
        raise AssertionError(f"{cfg['pde']} BP: the range's ends give the "
                             "same field")
    losses = np.asarray(res.losses)
    return {**cfg, "launches": launches, "coeffs": draws.tolist(),
            "val_mse_per_coeff": mses, "val_mse": res.val_mse,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "ends_max_abs_diff": float((u_lo - u_hi).abs().max()),
            "host_step_ms_median": 1e3 * float(np.median(res.step_seconds)),
            "train_wall_s": wall}


def phase_train_coeff(device) -> dict:
    """The conditioned families: black-scholes-100d-rs and heat-10d-kappa
    through the trainer at the paper's config (``_train_pde``, their
    checkpoints served by ``_serves_family``), then hjb-10d-lam by BP
    (``_coeff_bp``)."""
    out = {}
    for pde, (steps, flags) in COEFF_TRAIN.items():
        out[pde], _ = _train_pde(device, pde, steps, flags)
        print(f"[train-coeff] {json.dumps(out[pde])}", flush=True)
    out["bp"] = _coeff_bp(device)
    print(f"[train-coeff] {json.dumps({'bp': out['bp']})}", flush=True)
    return out


DIST_LAYOUTS = (("2x1", "perturbation"), ("1x2", "batch"))
DIST_GEN = (11, 0)      # the counters of the ξ generator every rank seeds
DIST_STEPS = 5          # counted distributed steps a layout
DIST_CLI = {"steps": 20, "resume_to": 30, "log_every": 10}
DIST_KERNELS = ("tt_contract_batched_kernel", "mesh_densify_kernel")


def _dist_setup(device, batch: int):
    """TONN_ONCHIP_FUSED at hidden 1024 (hjb-20d, noise on) on ``device``:
    the model, params, chip noise, trainable mask and the first batch of
    seed 0, as the trainer draws them."""
    from repro_torch.configs.hjb_pinn import pinn_config
    from repro_torch.core import pinn
    from repro_torch.data import pde_collocation_iterator
    from repro_torch.device import to_device
    from repro_torch.launch import train
    model = pinn.TensorPinn(pinn_config(pde="hjb-20d", mode="tonn",
                                        fused=True, noise=True))
    params, noise = train.init_solver(model, 0)
    params, noise = to_device(params, device), to_device(noise, device)
    xt = next(pde_collocation_iterator(batch, seed=0,
                                       problem=model.problem)).to(device)
    return model, params, noise, model.trainable_mask(params), xt


def _dist_rank(rank: int, world: int, kw: dict) -> dict:
    """One rank of ``train-dist``'s world (``zo_shard.run_ranks``, on the
    card): for each layout its distributed gradient and base loss, the
    bytes one step puts on the wire, its kernel launches over
    ``DIST_STEPS`` counted steps (every count 0 just before, read just
    after), its ms a step on CUDA events and on the host, and a traced
    window's kernels a step."""
    import numpy as np
    import torch
    from repro_torch.core import pinn, zoo
    from repro_torch.device import counter_generator
    from repro_torch.kernels import mesh_apply as mesh
    from repro_torch.kernels import tt_contract as ttc
    from repro_torch.parallel import zo_shard
    dev = (torch.device("cuda", torch.cuda.current_device())
           if kw["device"] == "cuda" else torch.device(kw["device"]))
    model, params, noise, mask, xt = _dist_setup(dev, kw["batch"])
    cfg = zoo.SPSAConfig(num_samples=kw["n"])

    def blf(sp, x, tb=None):
        return pinn.residual_losses_stacked(model, sp, x, noise)

    counted = {"tt_contract_batched": ttc.tt_contract_batched,
               "tt_contract_batched_quant": ttc.tt_contract_batched_quant,
               "tt_contract": ttc.tt_contract,
               "mesh_densify_stacked": mesh.mesh_densify_stacked,
               "mesh_apply_stacked": mesh.mesh_apply_stacked}
    out = {"rank": rank, "device": str(dev)}
    fill = torch.zeros(1, device=dev)
    for spec, shard in DIST_LAYOUTS:
        layout = zo_shard.make_zo_mesh(spec, shard)
        g, base = zo_shard.make_distributed_spsa_gradient(
            layout, blf, cfg, trainable_mask=mask)(
            params, counter_generator(*DIST_GEN, device=dev), xt)
        step = zo_shard.make_distributed_zo_step(layout, blf, cfg,
                                                 trainable_mask=mask)
        state = zoo.ZOState(step=0, seed=1)

        def one():
            return step(params, state, xt, None, 1e-3)

        wire = zo_shard.measure_collective_bytes(one)
        for fn in counted.values():                       # main path starts
            fn.launches = 0
        p, s = params, state
        for _ in range(DIST_STEPS):
            p, s, loss = step(p, s, xt, None, 1e-3)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counted.items()}
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            float(one()[2])
            host.append((time.perf_counter() - t0) * 1e3)
        out[spec] = {
            "pert_index": layout.pert_index,
            "batch_index": layout.batch_index,
            "grad": [t.cpu().numpy() for t in zoo.tree_leaves(g)],
            "base": float(base), "devices": sorted(
                {t.device.type for t in [*zoo.tree_leaves(g), base]}),
            "wire_bytes": wire["bytes"],
            "wire_ops": [(op, shapes) for op, shapes, _ in wire["ops"]],
            "launches": launches,
            "ms": _time_ms(one, iters=10, warmup=2),
            "host_ms_median": float(np.median(host)),
            # the window opens on a fill: the profiler may drop a window's
            # first kernel, and the fill is not counted by name
            "trace": _profile(one, 3, match=DIST_KERNELS[0],
                              lead=lambda: fill.fill_(0.0),
                              count=DIST_KERNELS)}
    return out


def _dist_cli(device) -> dict:
    """``launch.train --shard perturbation --mesh 2x1 --async-ckpt`` for
    ``DIST_CLI['steps']`` steps, then ``--resume`` to ``resume_to``: each
    run spawns its 2 ranks; every rank's kernel launches are its
    wrappers' counts over the run (a fresh process: 0 at its start)."""
    import numpy as np
    from repro_torch.checkpoint import read_checkpoint_meta
    from repro_torch.launch import train
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    steps, resume_to, log_every = (DIST_CLI["steps"], DIST_CLI["resume_to"],
                                   DIST_CLI["log_every"])
    argv = ["--arch", "tensor-pinn", "--pde", "hjb-20d", "--pinn-noise",
            "--batch", "100", "--zo-samples", "10", "--ckpt-dir", ckpt,
            "--ckpt-every", "10", "--log-every", str(log_every), "--seed",
            "0", "--shard", "perturbation", "--mesh", "2x1", "--async-ckpt"]
    out = {}
    for label, extra, first, last in (
            ("run", ["--steps", str(steps)], 0, steps),
            ("resume", ["--steps", str(resume_to), "--resume"], steps,
             resume_to)):
        t0 = time.perf_counter()
        res = train.main(argv + extra)
        wall = time.perf_counter() - t0
        n = last - first
        losses = np.asarray(res.losses)
        if len(losses) != n or not np.isfinite(losses).all():
            raise AssertionError(f"{label}: losses {res.losses}")
        meta = read_checkpoint_meta(ckpt)
        if meta["step"] != last or int(res.opt_state["step"]) != last:
            raise AssertionError(f"{label}: checkpoint step {meta['step']}, "
                                 f"ZO state {res.opt_state['step']}, "
                                 f"expected {last}")
        evals = len(range(first, last, log_every)) + 1
        for r in res.ranks:
            lead = r["rank"] == 0
            want = dict.fromkeys(r["launches"], 0)
            want.update(tt_contract_batched=3 * n,
                        mesh_densify_stacked=n + (evals if lead else 0),
                        tt_contract=2 * evals if lead else 0)
            if r["launches"] != want:
                raise AssertionError(f"{label}: rank {r['rank']} launched "
                                     f"{r['launches']}; expected {want}")
            if r["losses"] != res.losses:
                raise AssertionError(f"{label}: rank {r['rank']}'s losses "
                                     "are not rank 0's")
        out[label] = {"steps": n, "wall_s": wall,
                      "loss_first": float(losses[0]),
                      "loss_last": float(losses[-1]),
                      "loss_median_last5": float(np.median(losses[-5:])),
                      "val_mse": res.val_mse, "straggles": res.straggles,
                      "host_step_ms_median":
                          1e3 * float(np.median(res.step_seconds)),
                      "launches": {r["rank"]: r["launches"]
                                   for r in res.ranks}}
    run = out["run"]
    if not run["loss_median_last5"] < run["loss_first"]:
        raise AssertionError(f"--shard: the loss did not fall: {run}")
    shutil.rmtree(ckpt)
    print(f"[train-dist] watchdog straggles: {run['straggles']} of "
          f"{steps} steps, {out['resume']['straggles']} of "
          f"{resume_to - steps} resumed", flush=True)
    return out


def _dist_launches(dist: dict, name: str) -> dict:
    """``name``'s launches in ``train-dist``: each layout's counted steps
    and the CLI's runs, rank by rank."""
    out = {spec: [r[name] for r in row["launches"]]
           for spec, row in dist["layouts"].items()}
    out.update({f"cli-{label}": [r[name] for r in run["launches"].values()]
                for label, run in dist["cli"].items()})
    return out


def phase_train_dist(device) -> dict:
    """Distributed ZO at the paper's width on one card, two ranks in a
    ``gloo`` world: the gradient and base loss of each layout against the
    single-rank fused ``zoo.spsa_gradient`` of the same generator (atol
    1e-4·max|g|, rtol 1e-3; base rtol 1e-4; bit-equality noted), the wire
    of a step within ``wire_bound_bytes`` and below the params' bytes, 3
    ``tt_contract_batched`` + 1 grouped densification a rank a step
    (counted, and in a traced window), ms a step of each layout and of the
    single-rank fused step; then the trainer's ``--shard`` CLI and its
    resume (``_dist_cli``)."""
    import numpy as np
    from repro_torch.core import pinn, zoo
    from repro_torch.device import counter_generator
    from repro_torch.parallel import zo_shard
    kw = {"batch": 100, "n": 10, "device": device.type}
    ranks = zo_shard.run_ranks(_dist_rank, 2, kw, device=device)
    model, params, noise, mask, xt = _dist_setup(device, kw["batch"])
    cfg = zoo.SPSAConfig(num_samples=kw["n"])

    def blf(sp):
        return pinn.residual_losses_stacked(model, sp, xt, noise)

    g_ref, base_ref = zoo.spsa_gradient(
        params, counter_generator(*DIST_GEN, device=device), cfg, blf, mask)
    g_ref = [t.cpu().numpy() for t in zoo.tree_leaves(g_ref)]
    base_ref = float(base_ref)
    scale = max(float(np.abs(t).max()) for t in g_ref)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in zoo.tree_leaves(params))
    single = measure_zo_step(model, params, noise, mask, xt,
                             zoo.ZOState(step=0, seed=1), kw["n"])
    layouts = {}
    for spec, _ in DIST_LAYOUTS:
        p = int(spec.split("x")[0])
        bound = zo_shard.wire_bound_bytes(kw["n"], p)
        rows = [r[spec] for r in ranks]
        for r, row in zip(ranks, rows):
            if not (row["devices"] == [device.type]
                    and r["device"].startswith(device.type)):
                raise AssertionError(f"{spec}: rank {r['rank']} ran on "
                                     f"{r['device']}, its gradient on "
                                     f"{row['devices']}")
            for a, b in zip(row["grad"], g_ref):
                np.testing.assert_allclose(a, b, atol=1e-4 * scale,
                                           rtol=1e-3, err_msg=spec)
            np.testing.assert_allclose(row["base"], base_ref, rtol=1e-4,
                                       err_msg=spec)
            for a, b in zip(row["grad"], rows[0]["grad"]):
                np.testing.assert_array_equal(a, b, err_msg=spec)
            if not 0 < row["wire_bytes"] <= bound < param_bytes:
                raise AssertionError(f"{spec}: {row['wire_bytes']} bytes on "
                                     f"the wire, bound {bound}, params "
                                     f"{param_bytes}")
            want = dict.fromkeys(row["launches"], 0)
            want.update(tt_contract_batched=3 * DIST_STEPS,
                        mesh_densify_stacked=DIST_STEPS)
            if row["launches"] != want:
                raise AssertionError(f"{spec}: rank {r['rank']} launched "
                                     f"{row['launches']} over {DIST_STEPS} "
                                     f"steps; expected {want}")
            counts = row["trace"]["counts"]
            if counts != {DIST_KERNELS[0]: 3, DIST_KERNELS[1]: 1}:
                raise AssertionError(f"{spec}: rank {r['rank']}'s traced "
                                     f"step holds {counts}")
        bit = all(np.array_equal(a, b) for a, b in zip(rows[0]["grad"],
                                                       g_ref))
        layouts[spec] = {
            "positions": [(row["pert_index"], row["batch_index"])
                          for row in rows],
            "grad_max_abs_err": max(float(np.abs(a - b).max())
                                    for a, b in zip(rows[0]["grad"], g_ref)),
            "grad_scale": scale, "grad_bit_equal": bit,
            "base": rows[0]["base"], "base_single": base_ref,
            "base_bit_equal": rows[0]["base"] == base_ref,
            "wire_bytes": [row["wire_bytes"] for row in rows],
            "wire_ops": rows[0]["wire_ops"],
            "wire_bound_bytes": bound, "param_bytes": param_bytes,
            "launches": [row["launches"] for row in rows],
            "ms": [row["ms"] for row in rows],
            "host_ms_median": [row["host_ms_median"] for row in rows],
            "trace": [{k: row["trace"][k] for k in (
                "wall_ms", "device_ms", "busy_share", "kernels_per_call",
                "counts", "match_each_ms", "retries")} for row in rows]}
        print(f"[train-dist] {spec}: grad max|Δ| "
              f"{layouts[spec]['grad_max_abs_err']:.3e} of scale "
              f"{scale:.3e} ({'bit-equal' if bit else 'not bit-equal'} to "
              f"the single-rank fused gradient), base {rows[0]['base']!r} "
              f"against {base_ref!r}", flush=True)
    out = {"world": 2, "layouts": layouts,
           "single_rank_fused": {"zo_step_ms": single["zo_step_ms"][0],
                                 "trace": single["trace"]},
           "cli": _dist_cli(device)}
    print(f"[train-dist] {json.dumps(out)}", flush=True)
    return out


def phase_train_pde(device) -> dict:
    """heat-20d and black-scholes-100d through the trainer at the paper's
    config, then the stacked Stein loss at heat-20d."""
    out = {}
    for pde, (steps, flags) in PDE_TRAIN.items():
        out[pde], res = _train_pde(device, pde, steps, flags)
        if pde == "heat-20d":
            heat = res
        print(f"[train-pde] {json.dumps(out[pde])}", flush=True)
    out["stein"] = _stein_pde(device, heat)
    print(f"[train-pde] {json.dumps({'stein': out['stein']})}", flush=True)
    return out


def phase_lm_serve(device) -> dict:
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.core import zoo
    from repro_torch.device import counter_generator, to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import Request, ServingEngine
    from repro_torch.models import transformer

    cfg = configs.get_config("qwen2.5-3b")
    B, S, new = 4, 2048, 16
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, counter_generator(0, device=device),
                                     device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in zoo.tree_leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(6000))
    prompts = prompts.to(device)

    def bound(name, got, want, rel):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not err <= rel * scale:
            raise AssertionError(f"lm-serve {name}: max|diff| {err:.3e} > "
                                 f"{rel} x max|logit| {scale:.3e}")
        return err, scale

    with torch.inference_mode():
        fa.flash_attention.launches = 0                   # main path starts
        fa.flash_attention.design_launches = dict.fromkeys(
            fa.flash_attention.design_launches, 0)
        start = torch.cuda.Event(enable_timing=True)
        mid = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = transformer.prefill(params, cfg, prompts,
                                            max_len=S + new)
        mid.record()
        torch.cuda.synchronize()
        prefill_launches = fa.flash_attention.launches
        prefill_designs = dict(fa.flash_attention.design_launches)
        step_logits, tokens = [], [logits[:, -1].argmax(-1)]
        t0 = time.perf_counter()
        for _ in range(new):
            lg, cache = transformer.decode_step(params, cfg, cache,
                                                tokens[-1][:, None])
            step_logits.append(lg)
            tokens.append(lg[:, -1].argmax(-1))
        end.record()
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
        decode_launches = fa.flash_attention.launches - prefill_launches
        first_prefill_ms = start.elapsed_time(mid)        # main path ends
        if (prefill_launches != cfg.num_layers or decode_launches != 0
                or prefill_designs["wgmma"] != cfg.num_layers):
            raise AssertionError(
                f"flash_attention launched {prefill_launches} times in the "
                f"prefill (want {cfg.num_layers}, by design "
                f"{prefill_designs}, want all wgmma) and {decode_launches} "
                "in the decode (want 0)")
        if not (torch.isfinite(logits).all().item() and all(
                torch.isfinite(lg).all().item() for lg in step_logits)):
            raise AssertionError("non-finite logits")
        if cache["pos"] != S + new:
            raise AssertionError(f"cache pos {cache['pos']} != {S + new}")
        # the same prefill with the plain attention in place of the kernel
        # (~1 GB of f32 scores a layer): the one full-width check whose
        # reference runs no flash_attention
        kernel_attention = ops.attention
        ops.attention = ref.attention_ref
        try:
            plain_logits, _ = transformer.prefill(params, cfg, prompts)
        finally:
            ops.attention = kernel_attention
        plain_err, plain_scale = bound("prefill vs plain attention",
                                       logits[:, -1], plain_logits[:, -1],
                                       2e-2)
        del plain_logits
        # the prompt plus the first greedy token through forward
        full = torch.cat([prompts, tokens[0][:, None]], dim=1)
        ref_logits = transformer.forward(params, cfg, full)
        pre_err, pre_scale = bound("prefill vs forward", logits[:, -1],
                                   ref_logits[:, S - 1], 2e-2)
        dec_err, dec_scale = bound("decode vs forward", step_logits[0][:, -1],
                                   ref_logits[:, S], 2e-2)
        del ref_logits
        # steady-state prefill time, and per decode step
        prefill_ms = _time_ms(lambda: transformer.prefill(
            params, cfg, prompts, max_len=S + new), 3, warmup=1)
        dec_cache = transformer.prefill(params, cfg, prompts,
                                        max_len=S + new)[1]
        tok = tokens[0][:, None]
        decode_ms = _time_ms(lambda: transformer.decode_step(
            params, cfg, dec_cache, tok), 10, warmup=2)
        # where the time goes: one prefill and one decode step traced
        trace = {"prefill": _profile(lambda: transformer.prefill(
                     params, cfg, prompts, max_len=S + new)),
                 "decode_step": _profile(lambda: transformer.decode_step(
                     params, cfg, dec_cache, tok))}

        # 2 layers in f32: the card against the CPU's plain path
        cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
        p2 = transformer.init_params(cfg2, counter_generator(1, device=device),
                                     device)
        toks2 = prompts[:2, :256]
        card2, _ = transformer.prefill(p2, cfg2, toks2)
        cpu2, _ = transformer.prefill(to_device(p2, torch.device("cpu")),
                                      cfg2, toks2.cpu())
        cpu_err, cpu_scale = bound("2-layer f32 card vs CPU", card2.cpu(),
                                   cpu2, 1e-4)
        del p2

        # the serving engine over the full model, twice
        req_gen = torch.Generator().manual_seed(6001)
        reqs = [torch.randint(1, cfg.vocab_size, (16,),
                              generator=req_gen).tolist() for _ in range(4)]
        runs = []
        for _ in range(2):
            engine = ServingEngine(cfg, params, slots=4, max_len=256,
                                   device=device)
            for prompt in reqs:
                engine.submit(Request(prompt, max_new_tokens=16))
            t0 = time.perf_counter()
            done = engine.run()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, [r.out for r in done]))
        if len(runs[0][1]) != 4 or any(len(o) != 16 for o in runs[0][1]):
            raise AssertionError(f"engine finished {len(runs[0][1])} "
                                 "requests, or not 16 tokens each")
        if runs[0][1] != runs[1][1]:
            raise AssertionError("a second engine on the same params gave "
                                 "other tokens")

    out = {"arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "init_s": init_s, "batch": B, "prompt_len": S, "new_tokens": new,
           "prefill_launches": prefill_launches,
           "prefill_design_launches": prefill_designs,
           "decode_launches": decode_launches,
           "first_prefill_ms": first_prefill_ms, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
           "decode_ms_per_step": decode_ms,
           "decode_wall_ms_per_step": decode_wall * 1e3 / new,
           "prefill_vs_plain_attention_max_abs": plain_err,
           "plain_attention_max_abs_logit": plain_scale,
           "prefill_vs_forward_max_abs": pre_err, "max_abs_logit": pre_scale,
           "decode_vs_forward_max_abs": dec_err,
           "decode_max_abs_logit": dec_scale,
           "card_vs_cpu_2layer_f32_max_abs": cpu_err,
           "card_vs_cpu_max_abs_logit": cpu_scale,
           "engine_wall_ms": [w * 1e3 for w, _ in runs],
           "engine_tokens": runs[0][1], "trace": trace,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[lm-serve] {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    name, count, card = phase_device()
    phase_build()
    device = repro_torch.resolve_device("cuda")
    retaken: dict = {}              # phase -> profiler windows taken again

    def run(phase, *args):
        before, windows = PROFILE_RETRIES["windows"], len(PROFILE_LAGS)
        out = phase(*args)
        retaken[phase.__name__] = PROFILE_RETRIES["windows"] - before
        lags = [x for x in PROFILE_LAGS[windows:] if x is not None]
        line = {"phase": phase.__name__,
                "profile_retries": retaken[phase.__name__],
                "device_lag_ms": [min(lags), max(lags)] if lags else None}
        print(f"[profile] {json.dumps(line)}", flush=True)
        return out

    kernel = run(phase_kernel, device)
    serve = run(phase_serve, device)
    batched = run(phase_batched, device)
    meshes = run(phase_mesh, device)
    wide = run(phase_mesh_wide, device)
    mesh_grad = run(phase_mesh_grad, device)
    trained = run(phase_train, device)
    quant_kernel = run(phase_quant_kernel, device)
    trained_q = run(phase_train_quant, device, trained["val_mse"])
    served_q = run(phase_serve_quant, device)
    flash = run(phase_flash_kernel, device)
    lm = run(phase_lm_serve, device)
    bp_kernel = run(phase_bp_kernel, device)
    trained_bp = run(phase_train_bp, device)
    trained_seq = run(phase_train_seq, device)
    trained_onn = run(phase_train_onn, device)
    served_onn = run(phase_serve_onn, device)
    run(phase_table2)
    table1 = run(phase_table1, device)
    pdes = run(phase_train_pde, device)
    spectral = run(phase_train_spectral, device)
    coeff = run(phase_train_coeff, device)
    dist = run(phase_train_dist, device)
    mesh_grad.update(run(phase_mesh_grad_wide))

    main_case = kernel["cases"][0]                       # paper spec, B=2048
    entry = {"name": "tt_contract", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/tt_contract.cu",
             "replaces": "src/repro/kernels/tt_contract.py:95",
             "launches": serve["launches"],
             "max_abs_err": main_case["max_abs_err"],
             "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
             "bound_ms": main_case["bound_ms"],
             "bound_by": main_case["bound_by"],
             "library_ms": main_case["library_ms"],
             "design": main_case["design"],
             "kernel_device_ms": main_case["kernel_device_ms"],
             "shape": "x (2048, 1024) f32, PAPER_TONN_SPEC",
             "cases": kernel["cases"]}
    main_b = batched["hidden-stencil"]
    entry_b = {"name": "tt_contract_batched", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/tt_contract.cu",
               "replaces": "src/repro/kernels/tt_contract.py:162",
               "launches": trained["launches"]["tt_contract_batched"],
               "max_abs_err": max(r["max_abs_err"] for r in batched.values()),
               "ms": main_b["ms"], "plain_ms": main_b["plain_ms"],
               "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
               "library_ms": main_b["library_ms"],
               "design": main_b["design"], "tile": main_b["tile"],
               "kernel_device_ms": main_b["kernel_device_ms"],
               "shape": "x (11, 4300, 1024) f32 per entry, PAPER_TONN_SPEC "
                        "cores (11, r, m, n, r')",
               "launches_train_pde": {
                   name: pdes[name]["launches"]["tt_contract_batched"]
                   for name in (*PDE_TRAIN, "stein")},
               "launches_train_spectral": {
                   name: spectral[name]["launches"]["tt_contract_batched"]
                   for name in SPECTRAL_TRAIN},
               "launches_train_coeff": {
                   name: coeff[name]["launches"]["tt_contract_batched"]
                   for name in COEFF_TRAIN},
               "launches_train_dist": _dist_launches(dist, "tt_contract_batched"),
               "cases": [*batched.values(), pdes["stein"]["layer0"]]}
    # B3 has two entries in one source: the grouped densification, which
    # the training path runs, and the standalone mesh, which it no longer
    # runs (0 launches there; held to its plain version in phase 6)
    main_m = meshes["densify-paper-noise"]
    alone = meshes["v16-identity"]
    entry_m = {"name": "mesh_densify_stacked", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
               "replaces": "src/repro/kernels/mesh_apply.py:93",
               "launches": trained["launches"]["mesh_densify_stacked"],
               "launches_train_pde": {
                   name: pdes[name]["launches"]["mesh_densify_stacked"]
                   for name in (*PDE_TRAIN, "stein")},
               "launches_train_spectral": {
                   name: spectral[name]["launches"]["mesh_densify_stacked"]
                   for name in SPECTRAL_TRAIN},
               "launches_train_coeff": {
                   name: coeff[name]["launches"]["mesh_densify_stacked"]
                   for name in COEFF_TRAIN},
               "launches_train_dist": _dist_launches(dist, "mesh_densify_stacked"),
               "entry_launches": {
                   name: trained["launches"][name]
                   for name in ("mesh_densify_stacked",
                                "mesh_apply_stacked")},
               "max_abs_err": max(r["max_abs_err"] for r in meshes.values()),
               "ms": main_m["ms"], "plain_ms": main_m["plain_ms"],
               "bound_ms": main_m["bound_ms"], "bound_by": main_m["bound_by"],
               "library_ms": main_m["library_ms"],
               "kernel_device_ms": main_m["kernel_device_ms"],
               "standalone_loop_ms": main_m["standalone_loop_ms"],
               "matmul_16_meshes_ms": main_m["matmul_16_meshes_ms"],
               "shape": "the 8 core matrices of TONN_ONCHIP_FUSED (4 x 16 "
                        "and 16 x 4), S = 11, noise on: one ZO step's "
                        "densification",
               "standalone": {
                   "name": "mesh_apply_stacked", "ms": alone["ms"],
                   "kernel_device_ms": alone["kernel_device_ms"],
                   "plain_ms": alone["plain_ms"],
                   "bound_ms": alone["bound_ms"],
                   "bound_by": alone["bound_by"],
                   "library_ms": alone["library_ms"],
                   "shape": "16-port rectangular mesh (16 levels), S = 11, "
                            "identity x (16, 16) shared, transposed"},
               "cases": list(meshes.values())}
    main_q = quant_kernel["hidden-stencil-int8"]
    entry_q = {"name": "tt_contract_batched_quant", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/tt_contract.cu",
               "replaces": "src/repro/kernels/tt_contract.py:250",
               "launches":
                   trained_q["launches"]["tt_contract_batched_quant"],
               "max_abs_err": max(r["max_abs_err"]
                                  for r in quant_kernel.values()),
               "ms": main_q["ms"], "plain_ms": main_q["plain_ms"],
               "bound_ms": main_q["bound_ms"], "bound_by": main_q["bound_by"],
               "library_ms": main_q["library_ms"],
               "design": main_q["design"], "tile": main_q["tile"],
               "kernel_device_ms": main_q["kernel_device_ms"],
               "kernels_per_call": main_q["kernels_per_call"],
               "shape": "x (11, 4300, 1024) f32 per entry, PAPER_TONN_SPEC "
                        "cores (11, r, m, n, r') f32, quantized int8 in "
                        "the launch, block 32",
               "cases": list(quant_kernel.values())}
    main_f = flash["a-qwen-prefill-bfloat16"]
    entry_f = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:85",
               "design": main_f["design"],
               "launches": lm["prefill_design_launches"][main_f["design"]],
               "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
               "ms": main_f["ms"], "plain_ms": main_f["plain_ms"],
               "bound_ms": main_f["bound_ms"], "bound_by": main_f["bound_by"],
               "library_ms": main_f["library_ms"],
               "shape": "q (4, 16, 2048, 128), k/v (4, 2, 2048, 128) bf16, "
                        "causal: one qwen2.5-3b prefill layer",
               "cases": list(flash.values())}
    main_g = bp_kernel["hidden-stencil"]
    entry_g = {"name": "tt_contract_grad", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/tt_contract.cu",
               "replaces": "src/repro/kernels/tt_contract.py:95 (the "
                           "backward of B2; the TPU kernel has none, JAX "
                           "differentiates its plain chain)",
               "launches": trained_bp["tt-adamw"]["launches"][
                   "tt_contract_grad"],
               "launches_train_coeff_bp": coeff["bp"]["launches"][
                   "tt_contract_grad"],
               "max_abs_err": max(r["max_abs_err"]
                                  for r in bp_kernel.values()),
               "ms": main_g["ms"], "plain_ms": main_g["plain_ms"],
               "bound_ms": main_g["bound_ms"], "bound_by": main_g["bound_by"],
               "library_ms": main_g["library_ms"],
               "kernel_device_ms": main_g["kernel_device_ms"],
               "kernels_per_call": main_g["kernels_per_call"],
               "trace_launches": main_g["trace_launches"],
               "tile": main_g["tile"],
               "dG_max_err_over_bound": max(
                   r["dG_max_err_over_bound"] for r in bp_kernel.values()),
               "shape": "x, dy (4300, 1024) f32, PAPER_TONN_SPEC, dx and "
                        "the 4 cores' gradients: the hidden layer of a BP "
                        "step at batch 100 (library: torch.autograd.grad "
                        "of x @ tt_to_full(cores).T, dx and the cores)",
               "cases": list(bp_kernel.values())}
    print(f"[serve] p50 {serve['p50_ms']:.3f} ms, p99 {serve['p99_ms']:.3f} "
          f"ms, {serve['points_per_s']:.0f} points/s over "
          f"{serve['requests']} requests on {card}", flush=True)
    zo_trace = trained["zo_step_trace"]
    print(f"[train] {trained['zo_step_ms']:.3f} ms per ZO step (CUDA "
          f"events; traced: {zo_trace['kernels_per_call']:.0f} kernels a "
          f"step, busy share {zo_trace['busy_share']}); "
          f"loss {trained['loss_first']:.4e} -> "
          f"{trained['loss_last']:.4e} over {trained['steps']} steps, val "
          f"MSE {trained['val_mse']:.4e} on {card}", flush=True)
    print(f"[train-quant] {trained_q['zo_step_ms']:.3f} ms per QAT ZO step "
          f"(CUDA events, {trained_q['quant']}); loss "
          f"{trained_q['loss_first']:.4e} -> {trained_q['loss_last']:.4e}, "
          f"val MSE {trained_q['val_mse']:.4e} (f32 run "
          f"{trained['val_mse']:.4e}); {served_q['stats']['compiles']} "
          f"programs served f32/int8/fp8 on {card}", flush=True)
    print(f"[lm-serve] {lm['arch']} bf16: prefill of {lm['batch']} x "
          f"{lm['prompt_len']} tokens {lm['prefill_ms']:.1f} ms "
          f"({lm['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{lm['decode_ms_per_step']:.2f} ms per step; flash_attention "
          f"({main_f['design']}) {main_f['ms']:.3f} ms per layer (bound "
          f"{main_f['bound_ms']:.4f} ms, SDPA {main_f['library_ms']:.4f} ms) "
          f"on {card}", flush=True)
    bp = trained_bp["tt-adamw"]
    print(f"[train-bp] tt AdamW: {bp['bp_step_ms']:.3f} ms per BP step "
          f"(CUDA events; host median {bp['host_step_ms_median']:.3f} ms); "
          f"loss {bp['loss_first']:.4e} -> {bp['loss_last']:.4e} over "
          f"{bp['steps']} steps, val MSE {bp['val_mse']:.4e}; "
          f"tt_contract_grad {main_g['ms']:.4f} ms per call (bound "
          f"{main_g['bound_ms']:.4f} ms, autograd of the dense product "
          f"{main_g['library_ms']:.4f} ms) on {card}", flush=True)
    print(f"[train-seq] {trained_seq['seq_step_ms']:.3f} ms per sequential "
          f"ZO step (CUDA events; host median "
          f"{trained_seq['host_step_ms_median']:.3f} ms), val MSE "
          f"{trained_seq['val_mse']:.4e} on {card}", flush=True)
    # row 7's two routes: route A (warp rows; on the main path layer 0's
    # 1024-port U mesh) and route B (dense; the hidden layer's meshes),
    # each against the plain version at the hidden layer's U mesh; the
    # owner walk, off the main path now, beside route A
    main_a, main_d = wide["hidden-u-warp-rows"], wide["hidden-u"]
    walk = wide["hidden-u-owner-walk"]
    shape_w = ("1024-port rectangular mesh (1024 levels, 512 slots), S = "
               "11, x (11, 4300, 1024) per entry: the hidden layer's U mesh "
               "of an onn ZO step (library: torch.bmm against the 11 "
               "unitaries made dense)")
    wide_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "kernel_device_ms", "kernel_each_ms", "rows_config")
    entry_a = {"name": "mesh_apply_stacked (warp rows, route A)",
               "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
               "replaces": "src/repro/kernels/mesh_apply.py:93 (and the "
                           "jnp gather scan of src/repro/kernels/ops.py:139 "
                           "that the wide meshes took)",
               "design": "warp_rows",
               "launches": trained_onn["launches"]["warp_rows"],
               "max_abs_err": max(r["warp_rows"]["max_abs_err"]
                                  for r in wide.values() if "warp_rows" in r),
               **{k: main_a[k] for k in wide_keys},
               "layer0_kernel_device_ms": {
                   k: wide[k]["kernel_device_ms"]
                   for k in ("u1024-shared-100", "u1024-shared-21-tr")},
               "owner_walk": {"launches": trained_onn["launches"][
                   "owner_walk"], **{k: walk[k] for k in wide_keys}},
               "shape": shape_w}
    entry_d = {"name": "mesh_apply_stacked (dense, route B)",
               "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
               "replaces": "src/repro/kernels/mesh_apply.py:93 (and the "
                           "jnp gather scan of src/repro/kernels/ops.py:139 "
                           "that the wide meshes took)",
               "design": "dense",
               "launches": trained_onn["launches"]["dense"],
               "max_abs_err": max(r["dense"]["max_abs_err"]
                                  for r in wide.values() if "dense" in r),
               **{k: main_d[k] for k in wide_keys},
               "shape": shape_w, "cases": list(wide.values())}
    entry_m["standalone"]["launches_onn"] = trained_onn["launches"][
        "resident"]
    print(f"[train-onn] {trained_onn['zo_step_ms']:.3f} ms per onn ZO step "
          f"(CUDA events; traced: "
          f"{trained_onn['zo_step_trace']['kernels_per_call']:.0f} kernels "
          f"a step, busy share {trained_onn['zo_step_trace']['busy_share']})"
          f", val MSE {trained_onn['val_mse']:.4e}; wide mesh "
          f"{main_d['ms']:.3f} ms per hidden-layer call by route B (bound "
          f"{main_d['bound_ms']:.4f} ms), {main_a['ms']:.3f} ms by route A "
          f"(bound {main_a['bound_ms']:.4f} ms), torch.bmm "
          f"{main_d['library_ms']:.4f} ms; served program "
          f"{served_onn['program_ms']:.3f} ms on {card}", flush=True)
    for pde in PDE_TRAIN:
        row = pdes[pde]
        print(f"[train-pde] {pde}: {row['zo_step_ms']:.3f} ms per ZO step "
              f"(CUDA events; hidden launch on "
              f"{row['hidden_rows_per_entry']} rows an entry, bound "
              f"{row['hidden_bound_ms']:.4f} ms); loss "
              f"{row['losses'][0]:.4e} -> {row['losses'][-1]:.4e} over "
              f"{row['steps']} steps, val MSE {row['val_mse']:.4e}, final "
              f"per-term losses {row['per_term_losses_final']} on {card}",
              flush=True)
    for label, pde in (("bs100-hidden-stencil", "black-scholes-100d"),
                       ("helm-hidden-stencil", "helmholtz-2d")):
        bs = batched[label]
        print(f"[train-pde] {pde}'s hidden launch alone "
              f"(P {bs['P']}, {bs['rows']} rows an entry): {bs['ms']:.4f} "
              f"ms (bound {bs['bound_ms']:.4f} ms, torch.bmm "
              f"{bs['library_ms']:.4f} ms) on {card}", flush=True)
    for pde, label in (("hjb-20d", "hidden-spectral"),
                       ("ns-2d", "ns-2d-hidden")):
        row, bs = spectral[pde], batched[label]
        trace = row["zo_step_trace"]
        print(f"[train-spectral] {pde} ({row['resolved_deriv']}): "
              f"{row['zo_step_ms']:.3f} ms per ZO step (CUDA events; "
              f"traced: {trace['kernels_per_call']:.0f} kernels a step, "
              f"busy share {trace['busy_share']}); hidden launch on "
              f"{row['hidden_rows_per_entry']} rows an entry {bs['ms']:.4f} "
              f"ms a call, {bs['kernel_device_ms']} ms alone (bound "
              f"{bs['bound_ms']:.4f} ms, torch.bmm {bs['library_ms']:.4f} "
              f"ms); loss {row['losses'][0]:.4e} -> {row['losses'][-1]:.4e}"
              f", val MSE {row['val_mse']:.4e} on {card}", flush=True)
    for pde in COEFF_TRAIN:
        row = coeff[pde]
        trace, srv = row["zo_step_trace"], row["served"]
        print(f"[train-coeff] {pde} (net_dim {row['net_dim']}, "
              f"{' '.join(row['coeff_spec']['names'])}): "
              f"{row['zo_step_ms']:.3f} ms per ZO step (CUDA events; "
              f"traced: {trace['kernels_per_call']:.0f} kernels a step, "
              f"busy share {trace['busy_share']}); loss "
              f"{row['losses'][0]:.4e} -> {row['losses'][-1]:.4e}, val MSE "
              f"{row['val_mse']:.4e}; served {srv['requests']} requests at "
              f"{len(srv['coeffs'])} instances by {srv['programs']}, "
              f"{srv['rebuilds_after_warmup']} rebuilds, max|served - "
              f"direct| {srv['served_vs_direct_max_abs']:.3e} on {card}",
              flush=True)
    bp = coeff["bp"]
    print(f"[train-coeff] {bp['pde']} BP (tt, hidden {bp['hidden']}, "
          f"{bp['steps']} steps): val MSE per coefficient "
          f"{max(bp['val_mse_per_coeff']):.3e} at most (tolerance "
          f"{bp['tol']:g}) on {card}", flush=True)
    st = pdes["stein"]
    print(f"[train-pde] stein {st['pde']} P {st['P']} B {st['batch']} S "
          f"{st['samples']}: {st['call_ms']:.3f} ms a stacked loss; "
          f"per-entry layer 0 {st['layer0']['ms']:.4f} ms (bound "
          f"{st['layer0']['bound_ms']:.4f} ms, torch.bmm "
          f"{st['layer0']['library_ms']:.4f} ms) on {card}", flush=True)
    # the two mesh backwards (port-only: the TPU kernel has none): the
    # grouped one on tonn's BP path, the resident one on onn's at hidden 64
    grad_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "kernel_device_ms", "kernels_per_call", "autograd_plain_ms")
    group_keys = ("design", "host_ms", "empty_launch_ms",
                  "empty_kernel_device_ms")
    main_dg = mesh_grad["densify-s1-noise"]
    entry_dg = {"name": "mesh_densify_grad", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
                "replaces": "src/repro/kernels/mesh_apply.py:93 (the "
                            "backward of B3's densification; the TPU kernel "
                            "has none, JAX differentiates its jnp scan)",
                "launches": trained_bp["tonn-noise-adamw"]["launches"][
                    "mesh_densify_grad"],
                "max_abs_err": max(r["max_abs_err"] for k, r in
                                   mesh_grad.items()
                                   if k.startswith("densify")),
                "max_err_over_bound": max(r["max_err_over_bound"]
                                          for k, r in mesh_grad.items()
                                          if k.startswith("densify")),
                **{k: main_dg[k] for k in grad_keys + group_keys},
                "s11": {k: mesh_grad["densify-s11-noise"][k]
                        for k in grad_keys + group_keys},
                "shape": "the 8 core matrices of PAPER_TONN_SPEC (4 x 16 and "
                         "16 x 4), S = 1, noise on: a tonn BP step's "
                         "densification (library: none; autograd_plain_ms "
                         "is torch.autograd.grad through the plain "
                         "densification, for scale)",
                "cases": [r for k, r in mesh_grad.items()
                          if k.startswith("densify")]}
    main_ag = mesh_grad["v21-4300-tr"]
    resident = [r for k, r in mesh_grad.items()
                if not k.startswith("densify") and r["design"] == "resident"]
    onn_t1 = next(r for r in table1.values() if r["mode"] == "onn"
                  and not r["on_chip"])
    warp_rows = [r for r in mesh_grad.values()
                 if r.get("design") == "warp_rows"]
    entry_ag = {"name": "mesh_apply_grad", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
                "replaces": "src/repro/kernels/mesh_apply.py:93 (the "
                            "backward of B3's resident design; the TPU "
                            "kernel has none, JAX differentiates its jnp "
                            "scan)",
                "launches": onn_t1["resident_backward"]["warp"],
                "launches_train_bp": {
                    label: trained_bp[label]["mesh_designs"][
                        "resident_backward"]
                    for label in ("onn-adamw", "onn-1024-adamw")},
                "max_abs_err": max(r["max_abs_err"] for r in resident),
                "max_err_over_bound": max(r["max_err_over_bound"]
                                          for r in resident),
                **{k: main_ag[k] for k in grad_keys},
                "resident_design": main_ag["resident_design"],
                "host_ms": main_ag["host_ms"],
                "p64-4300": {k: mesh_grad["p64-4300"][k]
                             for k in grad_keys + ("resident_design",
                                                   "host_ms")},
                "shape": "21-port rectangular mesh (21 levels), S = 1, "
                         "transposed, y and dy (1, 4300, 21) of a shared x: "
                         "layer 0's V mesh in Table 1's off-chip ONN row at "
                         "hidden 1024, one launch an epoch (p64-4300: the "
                         "hidden layer's U mesh of an onn BP step at hidden "
                         "64) (library: none; autograd_plain_ms is "
                         "torch.autograd.grad through the plain gather "
                         "form, for scale)",
                "cases": resident}
    main_rg = mesh_grad["u1024-100"]
    onn_wide = trained_bp["onn-1024-adamw"]
    entry_rg = {"name": "mesh_rows_grad", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
                "replaces": "src/repro/kernels/mesh_apply.py:93 (the "
                            "backward of B3's route A, and the dense "
                            "backward's walk; the TPU kernel has none, JAX "
                            "differentiates its jnp gather scan, "
                            "src/repro/kernels/ops.py:139)",
                "launches": onn_wide["mesh_designs"]["backward"][
                    "warp_rows"],
                "max_abs_err": max(r["max_abs_err"] for r in warp_rows),
                "max_err_over_bound": max(r["max_err_over_bound"]
                                          for r in warp_rows),
                **{k: main_rg[k] for k in grad_keys},
                "kernel_each_ms": main_rg["kernel_each_ms"],
                "scratch_bytes": main_rg["scratch_bytes"],
                "u1024-21": {k: mesh_grad["u1024-21"][k] for k in grad_keys},
                "hidden_4300_rows": {k: mesh_grad["p1024-4300"][k]
                                     for k in grad_keys},
                "shape": "1024-port rectangular mesh (1024 levels), S = 1, y "
                         "and dy (1, 100, 1024), x shared: layer 0's U mesh "
                         "of an onn BP step at hidden 1024, its main-path "
                         "launch (u1024-21: on the 21 identity columns; "
                         "hidden_4300_rows: the hidden layer's U mesh "
                         "handed route B's y and dy, as before the dense "
                         "backward) (library: none; autograd_plain_ms is "
                         "torch.autograd.grad through the plain gather "
                         "form, for scale; kernel_device_ms sums the trig "
                         "prologue, the walk and the columns' sum, "
                         "kernel_each_ms each)",
                "cases": warp_rows}
    main_dd = mesh_grad["dense-p1024-4300"]
    dense = [r for r in mesh_grad.values() if r.get("design") == "dense"]
    entry_dd = {"name": "mesh_dense_grad", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
                "replaces": "src/repro/kernels/mesh_apply.py:93 (the "
                            "backward of B3's route B; the TPU kernel has "
                            "none, JAX differentiates its jnp gather scan, "
                            "src/repro/kernels/ops.py:139)",
                "launches": onn_wide["mesh_designs"]["backward"]["dense"],
                "max_abs_err": max(r["max_abs_err"] for r in dense),
                "max_err_over_bound": max(r["max_err_over_bound"]
                                          for r in dense),
                **{k: main_dd[k] for k in grad_keys},
                "kernel_each_ms": main_dd["kernel_each_ms"],
                "warp_rows_same_inputs_ms": main_dd["warp_rows_ms"],
                "turns_ms": main_dd["turns_ms"],
                "layer0": {label: {k: mesh_grad[label][k] for k in grad_keys}
                           for label in ("u1024-100", "u1024-21")},
                "shape": "1024-port rectangular mesh (1024 levels), S = 1, x "
                         "and dy (1, 4300, 1024), M (1, 1024, 1024) from "
                         "route B's forward: the hidden layer's U mesh of "
                         "an onn BP step at hidden 1024 (library: none, no "
                         "one call gives dφ; autograd_plain_ms is "
                         "torch.autograd.grad through the plain gather "
                         "form, for scale; warp_rows_same_inputs_ms the "
                         "warp-rows backward on the forward's y and dy, "
                         "timed in turns; layer0: the warp-rows backward "
                         "on layer 0's U mesh, its main-path launches)",
                "cases": dense}
    entry_pg = {"name": "mesh_product_grad", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mesh_apply.cu",
                "replaces": "src/repro/kernels/mesh_apply.py:93 (the dense "
                            "backward's products dx = dy·Mᵀ and dM = "
                            "xᵀ·dy; the TPU kernel has none)",
                "launches": onn_wide["launches"]["mesh_product_grad"],
                "max_abs_err": max(max(r["products_max_abs_err"].values())
                                   for r in dense),
                "ms": main_dd["products_ms"]["both"],
                "plain_ms": sum(main_dd["library_products_ms"].values()),
                "bound_ms": main_dd["products_bound_ms"],
                "bound_by": main_dd["products_bound_by"],
                "library_ms": sum(main_dd["library_products_ms"].values()),
                "each_ms": main_dd["products_ms"],
                "library_each_ms": main_dd["library_products_ms"],
                "shape": "the two products of the dense backward at the "
                         "hidden layer's U mesh (x, dy (1, 4300, 1024), M "
                         "(1, 1024, 1024)), both in one launch (each_ms: "
                         "both and each alone); library and plain: "
                         "torch.matmul of each, f32 (TF32 off), the two "
                         "calls' times summed"}
    tonn_bp, onn_bp = trained_bp["tonn-noise-adamw"], trained_bp["onn-adamw"]
    print(f"[train-bp] tonn AdamW (noise): {tonn_bp['bp_step_ms']:.3f} ms "
          f"per BP step; onn AdamW at hidden 64: {onn_bp['bp_step_ms']:.3f} "
          f"ms; mesh_densify_grad ({main_dg['design']}) "
          f"{main_dg['ms']:.4f} ms per call, {main_dg['host_ms']:.4f} ms "
          f"of it on the host ({main_dg['kernel_device_ms']} ms alone, "
          f"bound {main_dg['bound_ms']:.6f} ms, an empty kernel "
          f"{main_dg['empty_kernel_device_ms']} ms), mesh_apply_grad "
          f"({main_ag['resident_design']}) {main_ag['ms']:.4f} ms "
          f"({main_ag['kernel_device_ms']} ms alone, bound "
          f"{main_ag['bound_ms']:.6f} ms; p64-4300 "
          f"{mesh_grad['p64-4300']['kernel_device_ms']} ms alone) on {card}",
          flush=True)
    print(f"[train-bp] onn AdamW at hidden 1024: "
          f"{onn_wide['bp_step_ms']:.3f} ms per BP step; the dense backward "
          f"{main_dd['ms']:.4f} ms per call ({main_dd['kernel_device_ms']} "
          f"ms alone, bound {main_dd['bound_ms']:.6f} ms; the warp-rows one "
          f"on the same forward {main_dd['warp_rows_ms']:.4f} ms); "
          f"mesh_rows_grad on layer 0's 100 rows "
          f"{mesh_grad['u1024-100']['ms']:.4f} ms on {card}", flush=True)
    print(json.dumps({"kernels": [entry, entry_b, entry_m, entry_q,
                                  entry_f, entry_g, entry_a, entry_d,
                                  entry_dg, entry_ag, entry_rg, entry_dd,
                                  entry_pg],
                      "profile_retries": retaken}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
