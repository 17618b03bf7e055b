#!/usr/bin/env python3
"""Smoke run of zipvoice_tpu_torch on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases (each raises on failure; nothing is caught):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from zipvoice_tpu_torch/csrc with nvcc and print
     the -Xptxas -v lines of B1's-B9's entry points (B5's both routes);
  3. hold each kernel against its plain PyTorch version on the card, in f32
     and bf16, at the main-path shapes (B=2, H=4, T in 1024/512/256 with a
     padded tail in one batch row), ragged T (288, 577), a text-encoder
     T (40) and the distill shape (B=1, T=1024, a padded tail); B1's
     probabilities also equal B6's bit for bit; print errors, kernel /
     plain / library times and the bound;
  4. build a full-width (123M) random ZipVoice model dir, a full-width
     random Vocos checkpoint and a 3 s prompt;
  5. drive the port's CLI: 3 f32 requests (~4, 8, 12 s of text) and one
     bf16 request, 16 steps with CFG; check the wavs and that every request
     launched B1 260 times and B2 520 times;
  3b. the training kernels B3, B4 and B8 against their plain versions at
     the training shapes (B=8, H=4, T in 1024/512/256/288/577/120 with one
     padded row; B3 also at H=1 with vd 384 and 144; the failsafe penalty
     and the const-attention gate each on and off; B8 at 10 s, 1 s and the
     training shape, B=8 and 1153 frames, beside the same function through
     torch.stft, cufft_ms), f32 and bf16, with times and bounds;
  3c. the fused eval kernels against their plain versions, f32 and bf16:
     B6 and B7 at the serving shapes (B=2, H=4; B7 at C 384, and 144 at
     T=40; T also 1152 and 1408), B9 against an f64 plain version (C = D =
     512 with K 31/15/7 at T 1024/512/256/288 and K 31 at T 1152, C = D =
     192 with K 9 at T=40), B5 at B=8 (H=4,
     vd 12 and H=1, vd 384, the const gate on and off; its output equal to
     B6's at vd 12 and to B7's on v[:, :, 0] at vd 384, bit for bit) and one
     gradient through rel_attention_apply (B5 forward, B3 backward) with the
     gate off and on against plain autograd, with times and bounds;
  5b. the same requests with the fused eval path on (set_fused_eval,
     set_fused_conv): the wavs checked as in phase 5 and every request
     launching B1 0, B2 260, B6 260, B7 260 and B9 520 times; then the flags
     reset and one request re-checked at the unfused pins; the median warm
     RTF of the ~8 s request fused and unfused, f32 and bf16, in turns (the
     CLI and ``synthesize`` run the pipeline's programs as CUDA graphs: a
     request's first use of a bucket runs eagerly and captures, later ones
     replay, and the launch pins count device launches either way);
  5c. f32 and bf16, unfused and fused, at the ~8 s request: the replayed
     sampler and the replayed one-program PCM16 equal the captured
     functions run eagerly on the same inputs and noise, bit for bit;
  5d. the batch-4 sampler and vocoder row by row against each row replayed
     alone in the same bucket (largest mel and PCM16 difference printed);
  5e. warm RTF of the eager composition against ``synthesize`` and
     ``synthesize_fused`` replayed, f32 and bf16, medians of 4 in turns;
  6. one full-width fm_decoder forward on the card (kernels) against the
     CPU (plain versions) on the same weights and inputs; 6b. the same with
     the fused eval path on the card against the unfused CPU forward;
     6c. one warm f32 ~8 s request, unfused and fused, its captured
     functions run eagerly, under torch.profiler (device busy share, top
     kernels, the device ms and calls of B1 and B2, and fused of B2, B6, B7
     and B9; with --profile the traces go to the output directory if
     present); 6d. the same request through ``synthesize``, replayed
     (its busy share, or that the profiler did not resolve the kernels
     inside the graph launch);
  7. one full-width compute_fm_loss backward on the card against the CPU,
     same weights and inputs, no random draws, with and without the
     regularizers; relative L2 error per parameter group;
  8. a 16-file random corpus, then the port's train CLI on the card at
     full width in bf16: 6 steps with regularizers, 5 without; finite
     losses, every parameter tensor changed, launches pinned per step (B1
     40, B2 80, B3 60 or B4 20, B8 1), warm step ms (median of the
     intervals after the first) and peak memory;
  9. one warm training step with the regularizers and one without under
     torch.profiler (device busy share, top kernels, B2's and B3's device ms
     a step, B4's without the regularizers; with --profile the traces go to
     the output directory if present);
  10. the training checkpoint, as a model dir's model.pt, drives the
     inference CLI;
  11. the serving entry point: the serve CLI's bf16 pipeline, warmed with
     batch 4 (seconds, captures, peak memory), behind a TTSServer on a free
     port: one request in the warmed bucket, four concurrent ones (one
     batch, /stats), a long_form request, a /synthesize_stream request of
     the same length and a silent prompt (400); every wav's length and
     finiteness, no capture at request time in the warmed bucket, B1 260
     and B2 520 launches a sampler call, each request's buckets and
     latency;
  12. the inference variants at full width (123M, seeded random weights,
     one emilia-layout tokens.txt with [S1]/[S2] at 360/361), each on its
     default tokenizer, steps and guidance (the G2P backend printed):
     ZipVoice-Distill through the infer CLI (8 steps, guidance 3.0
     embedded, English on the emilia tokenizer), ZipVoice-Dialog and
     ZipVoice-Dialog-Stereo through the dialog CLI (16 steps, guidance 1.5,
     split [S1]/[S2] prompts), two requests each: every wav's channel
     count and length, the launches a request (B1 132 and B2 264 for
     distill, 260 and 520 for dialog); the CLI's pipeline: the sampler and
     the one-program PCM16 replayed equal to eager bit for bit, one replay
     launching the pins, the warm RTF (median of 4); one full-width
     fm_decoder forward card vs CPU (distill with its scale embedded,
     stereo at 5F on stream 0).
  13. BigVGAN and the variants' training at full width (123M): 13a, a model
     dir from egs/zipvoice/conf/zipvoice_base_bigvgan_v2.json (bigvgan
     features) with a random full-width BigVGAN generator saved as the
     published weight-normed checkpoint under ``generator.``: two f32
     requests and one bf16 through the infer CLI (wav lengths, B1 260 / B2
     520 a request), the one-program PCM16 replayed equal to eager bit for
     bit, the warm f32 RTF (median of 4) in turns with phase 4's Vocos model
     and the vocoder's share of a request, the generator card vs CPU (f32)
     and bf16 vs f32 on ~0.5 s of mel, the bigvgan log-mel card vs CPU;
     13b, the recipes' chains through the CLIs in bf16 on a 16-file mono
     and a 16-file stereo corpus (English on the emilia and dialog
     tokenizers): egs/zipvoice/run_distill.sh's (distill stage 1, 3 steps;
     average; stage 2, 3 steps; average) and egs/zipvoice_dialog/run.sh's
     (dialog from a base checkpoint on the base vocabulary, 3 steps;
     average; stereo, 4 steps; average): finite losses, launches pinned a
     step (distill B1 72, B2 144, B4 16, B8 1; dialog and stereo B1 40, B2
     80, B3 60, B8 1), every trained tensor changed and distill's embedding
     and text encoder bit-equal, warm step ms and peak memory; the distill
     model served by the infer CLI and the stereo model by the dialog CLI
     (launches pinned); a stereo ``norm.log_scale`` (0-d) may end
     bit-equal to its start only if every step's gradient was nonzero and a
     step moved it (its rounded updates cancelled; ``_returned``); 13c, one
     full-width compute_distill_loss gradient
     and one stereo compute_fm_loss_dialog gradient card vs CPU (relative
     L2 per parameter group).
  14. data parallelism and the training CLIs' tools at full width, bf16,
     on phase 8's corpus: 14a, ``torchrun --standalone --nproc-per-node 1``
     over the train CLI with --distributed (NCCL, world size 1; this file
     is the rank, ``--ddp-worker``), 6 steps with the regularizers: finite
     losses, the launches a step at phase 8's pins, the last step profiled
     (the gradient sync's range and any NCCL kernel), the warm step ms
     beside phase 8's, and rank 0's checkpoint as a model dir (its
     parameters bit-equal to the trained ones, one f32 fm_decoder forward
     on the card against the CPU); 14b,
     NCCL's answer to two ranks on the one card (it refuses), then two
     gloo ranks sharing it (``train/dryrun.spawn``): the first batch's
     summed f32 gradient against one process's on both ranks' rows with
     the same draws (relative L2 a group <= 1e-5), 2 steps with the
     regularizers and 2 without with the parameters bit-identical after
     each, the launches a rank's step pinned, files in rank 0's exp dir
     only; 14c, one regularized step under each --remat-policy (full, all,
     dots, xprobs, xprobs_ff) at B=8, T=1024: step ms (one timed round in
     turns after a warm one), peak memory, B1/B2/B3 launches pinned, and the f32 gradients
     at T=512 against full's (and full's against itself); 14d,
     --print-diagnostics (every statistic finite) and --scan-oom (the
     state after it bit-equal to a fresh one).

  15. int8 serving, export and MFU at full width (phase 4's model dir):
     15a, nn/functional.linear_int8 on the card against the CPU (both
     modes, f32 and bf16, at full-width shapes); for --quantize int8 and
     int8-dynamic, bf16 and f32, on the ~8 s request: the model's MB before
     and after quantizing, every weight_scale f32, the launches of a request
     unfused (B1 260, B2 520) and with the fused eval path (B2, B6, B7 260
     each, B1 and B9 0: B9 is gated off by the int8 out-projection), the
     replayed sampler equal to its eager run bit for bit, the mel MSE and
     the largest PCM16 difference against the unquantized request on the
     same noise, the warm replayed RTF (median of 4) in turns with the
     unquantized pipeline; the infer CLI with --quantize int8-dynamic and
     the serve CLI with --quantize int8, one request each; 15b, in a worker
     process (``--export-worker``) started after phase 4 at low priority:
     bin/export_model (bf16 with the fused sampler at 4 steps, bf16
     int8-dynamic at 1 step, both at 256 tokens and 3072 frames, and a CPU
     export of a tiny model) as three processes, the trace and total
     seconds and each artifact's MB, then bin/infer_exported's loads of
     both modes; after 15a, on the card: its request in both modes on the
     ~8 s text (launches a request pinned: B1 68 / B2 136 fused, B1 260 /
     B2 520 in the host loop at 16 steps; a finite wav of the expected
     length), the fused exported sampler against the pipeline's own sample
     on the same inputs (relative L2 <= 1e-2), the warm RTF of the fused
     sampler replayed and of the host loop, both at 4 steps (medians of 4
     in turns), the int8-dynamic export's fused
     sampler against the int8-dynamic pipeline's sample at 1 step
     (relative L2 <= 1e-3), and the loader's refusal of the CPU export on
     the card; 15c, the MFU (utils/flops.py, against the card's dense bf16
     peak) of phase 5e's replayed bf16 request and of phase 8's warm step.
  16. egs/zipvoice/run.sh's stages 0-2 through the port's CLIs at full
     width (123M, bf16) on a raw corpus of phase 8's rows plus 16 and 48 kHz
     files, a stereo file, a segment row, a segment past its file's end and
     an unreadable row: bin/prepare_dataset with --resample-dir (kept and
     dropped counts, the resampled rows), bin/prepare_tokens (emilia) and
     bin/make_tokens over the prepared manifest; bin/compute_fbank on the
     card against --device cpu (the same shards, index, keys and shapes,
     each float16 feature within one float16 ulp plus 2e-5); the native
     wav loader built and loaded (ops/native.py; a missing library fails),
     on a B=8 batch of whole 24 kHz files equal to read_wav within 1e-6,
     and the host ms of batch_load_wav against the per-file load_audio
     loop (medians of 3); the train CLI, 3 steps with the regularizers on
     stage 1's manifest and tokens (segment rows: every batch read file by
     file, as the reference package's collator does) and on the same rows
     as whole files (every batch through batch_load_wav), finite losses,
     launches pinned at phase 8's (B1 40, B2 80, B3 60, B8 1 a step);
     PrecomputedFeatureCollator over the card's shards.
  17. the evaluation models and CLIs: a full-width UTMOS22Strong with
     seeded random weights saved as a local checkpoint (forward on two
     clips card vs CPU, relative L2 <= 1e-4 in f32, and its device ms; the
     MOS CLI on phase 5's f32 wavs), the ECAPA-TDNN head at full width over
     a stand-in SSL module (card vs CPU), the cpSIM CLI on a stereo wav with
     the tests' fake encoder, wer.score_pairs on fixed pairs.
  18. tensor and sequence parallelism: 18a, B1 and B2 on rectangular score
     tiles (Tq query rows against Tk keys, the rows' window of pe) against
     their plain versions, f32 and bf16, at B=2, H=4: Tq 1536 of Tk 3072 at
     r0 0 and 1536, Tq 256 of 1024 and Tq 20 of 40, one row's keys padded,
     with times and bounds beside phase 3's square T=1024 times; B3 and B4
     on rectangular tiles against their plain versions, f32 and bf16, B3
     with the failsafe and the const gate each on and off at (H=4, vd=12)
     and (H=1, vd=384), B4 with the failsafe on and off at H=4: Tq 512 of
     Tk 1024 at r0 0 and 512 (B=8, the SP step's stack-0 halves), Tq 1536
     of 3072 (B=2) and Tq 20 of 40 (B=8), with times and bounds beside
     phase 3b's square T=1024 times; then two
     gloo ranks sharing the card (NCCL refuses two ranks on one card,
     14b): 18b, models/zipvoice.sp_sample at full width (phase 4's
     weights, f32, TF32 off) on one request of 3072 frames (32.8 s), 16
     steps with CFG, against one process's sample on the card with the
     same noise (relative L2 <= 1e-4), each rank's launches (B1 260, B2
     520) and collectives pinned (gloo runs each on the CUDA tensors
     itself), the wall of both; 18c, tp = 2:
     one f32 step's summed gradient (B=8, T=1024, no regularizers) against
     one process's on the same rows and draws (relative L2 a group <=
     1e-5), then 2 bf16 steps with the regularizers through
     make_train_step(mesh=...): finite losses, every shard updated, B1 40
     / B2 80 / B3 60 a step, the all-reduces a step pinned, the
     feedforward shards at local shape (1536 -> 768); 18d, dp = 1 x sp = 2
     (make_dp_sp_mesh) on 18c's rows: one f32 gradient without the
     regularizers (TF32 off, torch's deterministic algorithms on both
     sides) against 18c's one-process gradient (relative L2 a group and
     a tensor <= 1e-5, the largest printed; the 0-d log_scales and the
     downsampling biases, whose gradients cancel, held by their groups),
     its launches (B1 40, B2 80,
     B4 20, 16 of B4's rectangular) and collectives pinned; on the same
     rows and draws with every balancer and whitening applied (f32), the
     statistics each takes over the seq group equal on both ranks and
     within 1e-5 relative of one process's; 2 bf16 steps
     with the regularizers through make_train_step(mesh=...), losses
     within 1e-2 relative of one process's steps from the same weights and
     seeds, both ranks' parameters bit-identical, B1 40 / B2 80 / B3 60 a
     step (48 of B3's rectangular: the fm_decoder's), each step's wall
     beside one process's.  The build's, phase 18's and the total seconds
     are printed.

Order: phases 1-9 run in this process one after another; then three jobs
start in a thread (``Background``), one after another, each a run of other
processes: 14a's torchrun, 14b's ranks and phase 18's ranks, beside phases
10-17 here; after phase 12, phase 13 starts in a process of its own
(``--phase13-worker``) beside phases 14-17.  Phase 14 checks 14a's and 14b's
runs when it reaches them, phase 18 its ranks' results, and phase 13's
output is printed after phase 17.  The times those runs print were taken
beside other work on the card and the host.

The line before the last is a JSON object with the per-kernel numbers; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
zipvoice_tpu_torch package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), used only for the bound column
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

N_STEP = 16
# text-encoder layers + steps x fm_decoder layers (one 2B CFG batch a step)
LAYERS_PER_REQUEST = 4 + N_STEP * 16
# kernel launches a request: unfused, B1 a layer and B2 in both
# SelfAttention modules; fused, B7 (NonlinAttention) and B6 (SelfAttention-1)
# a layer, B2 in SelfAttention-2 and B9 in both ConvolutionModules
UNFUSED_PER_REQUEST = {"B1": LAYERS_PER_REQUEST, "B2": 2 * LAYERS_PER_REQUEST}
FUSED_PER_REQUEST = {"B2": LAYERS_PER_REQUEST, "B6": LAYERS_PER_REQUEST,
                     "B7": LAYERS_PER_REQUEST, "B9": 2 * LAYERS_PER_REQUEST}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms over iters launches, each after an
    L2 flush (the main path finds its inputs cold at long T).  A ~1 ms
    device sleep before each start event lets the host enqueue fn's work
    ahead of the card, so the host's Python time is not counted."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def contract_bound_ms(nbytes: float, flops: float, score_flops: float, dtype_name: str):
    """bound_ms under the port's bit-equality contract: the f32 score FMAs of
    the rel-position kernels (B1, B4-B7) stay on the CUDA cores whatever the
    input type, so score_flops are priced at the f32 peak and the other
    flops at the input type's.  Reported beside bound_ms, which prices every
    operation at the input type's peak; the two agree in f32."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FLOPS[dtype_name] + score_flops / PEAK_FLOPS["float32"]) * 1e3
    return max(t_bytes, t_ops)


def check_kernels():
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, qd, pd, vd = 4, 32, 4, 12
    # (B, T, kind): B=2 is the CFG batch of one request; the distill
    # sampler runs B=1 (one request, no CFG doubling)
    cases = [(2, 1024, "main"), (2, 512, "main"), (2, 256, "main"), (2, 288, "ragged"),
             (2, 577, "ragged"), (2, 40, "text"), (1, 1024, "distill")]
    results = {"B1": {}, "B2": {}}
    for b, t, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, pq = rnd(b, t, h, qd), rnd(b, t, h, qd), rnd(b, t, h, pd)
            pe = rnd(2 * t - 1, h, pd)
            # one padded row in every case (the distill row is a request's
            # frames in its bucket)
            lens = [t - t // 3 - 1] if b == 1 else [t, t - t // 3 - 1]
            mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
                lens, device="cuda")[:, None]

            # B1: probs; the ragged text-encoder batch is B=1 at serving but
            # B=2 here keeps one padded row in every case
            out = att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=dtype)
            ref = att.rel_attention_probs_plain(q, k, pq, pe, mask, out_dtype=dtype)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            # f32: scores reach |s| ~ 30 and are summed in another order than
            # cuBLAS's; bf16: one unit in the last place of a probability <= 1
            tol = 2e-5 if dtype == torch.float32 else 8e-3
            k_ms = time_ms(lambda: att.rel_attention_probs(q, k, pq, pe, mask,
                                                           out_dtype=dtype))
            p_ms = time_ms(lambda: att.rel_attention_probs_plain(q, k, pq, pe, mask,
                                                                 out_dtype=dtype))
            nbytes = s * (2 * b * t * h * qd + b * t * h * pd + (2 * t - 1) * h * pd) \
                + b * t + s * b * h * t * t
            bnd, by = bound_ms(nbytes, 2 * b * h * t * t * (qd + pd), dn)
            cbnd = contract_bound_ms(nbytes, 0.0, 2 * b * h * t * t * (qd + pd), dn)
            # B6 computes B1's scores and softmax with the same operations:
            # its probabilities must equal B1's bit for bit
            v = rnd(b, t, h, vd)
            same_as_b6 = torch.equal(out, att.rel_attention_probs_consume(
                q, k, pq, pe, mask, v, out_dtype=dtype)[0])
            results["B1"][(b, t, dn)] = dict(abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                                          library_ms=None, bound_ms=bnd, bound_by=by,
                                          contract_bound_ms=cbnd)
            print(f"B1 rel_probs B={b} T={t} ({kind}) {dn}: max_abs_err {err:.3g} "
                  f"(tol {tol:g}) kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                  f"bound_ms {bnd:.4f} ({by}) contract_bound_ms {cbnd:.4f}, "
                  f"equal to B6's probs: {same_as_b6}", flush=True)
            if not (err <= tol and same_as_b6):
                raise AssertionError(f"B1 disagrees at B={b} T={t} {dn}: {err} > {tol} "
                                     f"or not equal to B6's ({same_as_b6})")

            # B2: probs @ v on the kernel's own probabilities
            probs = out
            o = att.rel_attention_probs_apply(probs, v)
            oref = att.rel_attention_probs_apply_plain(probs, v)
            torch.cuda.synchronize()
            scale = max(1.0, float(oref.float().abs().max()))
            err2 = float((o.float() - oref.float()).abs().max())
            tol2 = (2e-5 if dtype == torch.float32 else 8e-3) * scale
            v_hm = v.permute(0, 2, 1, 3).contiguous()  # the library's layout
            k2 = time_ms(lambda: att.rel_attention_probs_apply(probs, v))
            p2 = time_ms(lambda: att.rel_attention_probs_apply_plain(probs, v))
            l2 = time_ms(lambda: torch.matmul(probs, v_hm))
            nbytes2 = s * (b * h * t * t + 2 * b * t * h * vd)
            bnd2, by2 = bound_ms(nbytes2, 2 * b * h * t * t * vd, dn)
            results["B2"][(b, t, dn)] = dict(abs_err=err2, tol=tol2, ms=k2, plain_ms=p2,
                                          library_ms=l2, bound_ms=bnd2, bound_by=by2)
            print(f"B2 probs_apply B={b} T={t} ({kind}) {dn}: max_abs_err {err2:.3g} "
                  f"(tol {tol2:.3g}) kernel_ms {k2:.4f} plain_ms {p2:.4f} "
                  f"library_ms {l2:.4f} bound_ms {bnd2:.4f} ({by2})", flush=True)
            if not err2 <= tol2:
                raise AssertionError(f"B2 disagrees at B={b} T={t} {dn}: {err2} > {tol2}")
    return results


def _rel_inputs(gen, b, h, t, vd, dtype, scale=1.0):
    """q, k, pq, pe, mask (one padded batch row), v, g at one shape."""
    import torch

    def rnd(*shape, s=1.0):
        return (s * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

    lens = [t] * b
    lens[-1] = max(1, t - t // 3 - 1)
    mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(lens, device="cuda")[:, None]
    return (rnd(b, t, h, 32, s=scale), rnd(b, t, h, 32, s=scale), rnd(b, t, h, 4, s=scale),
            rnd(2 * t - 1, h, 4, s=scale), mask, rnd(b, t, h, vd), rnd(b, t, h, vd))


# training shapes of B3/B4: (label, B, H, T, vd); H=1 rows are the
# NonlinAttention head-0 consumer of the fm_decoder (vd 384) and the text
# encoder (vd 144)
TRAIN_ATTN_CASES = [("main", 8, 4, 1024, 12), ("main", 8, 4, 512, 12), ("main", 8, 4, 256, 12),
                    ("ragged", 8, 4, 288, 12), ("ragged", 8, 4, 577, 12),
                    ("text", 8, 4, 120, 12), ("head0", 8, 1, 1024, 384),
                    ("head0-text", 8, 1, 120, 144)]
# (penalty, const gate): the failsafe and the const-attention branch
TRAIN_ATTN_VARIANTS = [(0.0, False), (1e-2, False), (0.0, True)]


# the redesigned kernels' symbols, as torch.profiler names them
KERNEL_SYMBOLS = {"B1": ("rel_probs_kernel",), "B2": ("probs_apply_f32", "probs_apply_bf16"),
                  "B3": ("bwd_rows_kernel", "bwd_cols_kernel"), "B4": ("rel_ds_kernel",),
                  "B6": ("rel_probs_consume_kernel",), "B7": ("rel_wide_consume_kernel",),
                  "B8": ("log_mel_kernel",), "B9": ("conv_glu_kernel",)}
# the redesigned kernels' entry points, by library, whose -Xptxas -v lines
# the build prints in full
ENTRY_KERNELS = {"rel_probs": ("rel_probs_kernel",),
                 "rel_probs_consume": ("rel_probs_consume_kernel",),
                 "rel_ds": ("rel_ds_kernel",),
                 "probs_apply": ("probs_apply",),
                 "rel_apply_bwd": ("bwd_",),
                 "rel_consume_fwd": ("rel_wide_consume_kernel",),
                 "rel_apply": ("rel_apply_kernel", "rel_wide_consume_kernel"),
                 "log_mel": ("log_mel_kernel",),
                 "conv_glu": ("conv_glu_kernel",)}


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


class _Row:
    """One key's row of ``_profile_rows``, with key_averages' fields."""

    def __init__(self, key, device_type):
        self.key, self.device_type, self.count = key, device_type, 0
        self.cpu_time_total = self.self_cpu_time_total = 0.0
        self.device_time_total = self.self_device_time_total = 0.0


class _Ev:
    __slots__ = ("name", "dtype", "dev", "sync", "start", "end", "thread", "corr", "kernels",
                 "children", "parent", "device_total", "legacy")

    def __init__(self, name, dtype, dev, sync, start, end, thread, corr):
        self.name, self.dtype, self.dev, self.sync = name, dtype, dev, sync
        self.start, self.end, self.thread, self.corr = start, end, thread, corr
        self.kernels, self.children, self.parent, self.device_total = [], [], None, 0.0
        self.legacy = False


def _profile_rows(prof):
    """``prof.key_averages()`` as {key: _Row}, computed from the profiler's
    raw events by the rules key_averages applies (the same filtered names,
    asynchronous events, kernels attributed through correlation ids, CPU
    nesting per thread, duplicate parent-child nodes merged).  key_averages
    first builds a Python object for every recorded event, its shapes and
    stack with it: a training step's ~300k events cost it tens of seconds
    of host time, this pass a few.  ``_check_rows`` holds the two equal."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    device_types = (DeviceType.CUDA, DeviceType.PrivateUse1, DeviceType.XPU)
    cuda = getattr(prof.profiler, "use_device", None) == "cuda"
    names, evs, frontend, linked = {}, [], [], {}
    for k in results.events():
        raw = k.name()
        if _filter_name(raw) or getattr(k, "is_hidden_event", lambda: False)():
            continue
        if raw not in names:
            names[raw] = _rewrite_name(name=raw, with_wildcard=True)
        dt = k.device_type()
        e = _Ev(names[raw], dt, dt in device_types,
                not (k.is_async() or k.start_thread_id() != k.end_thread_id()),
                (k.start_ns() - base) / 1000, (k.end_ns() - base) / 1000,
                k.start_thread_id(), k.correlation_id())
        if cuda and e.sync and dt == DeviceType.CPU:  # a legacy CUDA range's own time
            legacy_us = getattr(k, "cuda_elapsed_us", lambda: 0)()
            if legacy_us > 0:
                e.kernels.append(legacy_us)
                e.legacy = True
        evs.append(e)
        corr = k.linked_correlation_id()
        if corr > 0:
            linked.setdefault(corr, []).append(e)
        elif corr == 0:
            frontend.append(e)
    for fe in frontend:  # kernels and runtime calls to the op that launched them
        if fe.dtype == DeviceType.CPU and fe.sync and fe.corr in linked:
            for f in linked[fe.corr]:
                if f.dev:
                    fe.kernels.append(f.end - f.start)
                elif f.dtype == DeviceType.CPU:
                    f.thread = fe.thread
    evs.sort(key=lambda e: (e.start, -e.end))
    nested = sorted((e for e in evs if e.sync and e.dtype == DeviceType.CPU),
                    key=lambda e: e.thread)
    stack, thread = [], None
    for e in nested:
        if e.thread != thread:
            stack, thread = [], e.thread
        while stack:
            parent = stack[-1]
            if e.start >= parent.end or e.end > parent.end:
                stack.pop()
            else:
                parent.children.append(e)
                e.parent = parent
                break
        stack.append(e)
    while True:  # a parent's only child of the same name merges into it
        dropped = set()
        for i, e in enumerate(evs):
            p = e.parent
            if p is not None and p.name == e.name and len(p.children) == 1:
                p.children, p.kernels = e.children, e.kernels
                for ch in e.children:
                    ch.parent = p
                dropped.add(i)
        if not dropped:
            break
        evs = [e for i, e in enumerate(evs) if i not in dropped]
    use_device = bool(getattr(prof.profiler, "use_device", None))
    for e in reversed(evs):  # children start after their parents: totals bottom-up
        if not (e.sync and use_device):
            e.device_total = 0.0
        elif e.dtype == DeviceType.CPU:
            e.device_total = sum(e.kernels) + (0.0 if e.legacy else sum(
                ch.device_total for ch in e.children))
        else:
            e.device_total = e.end - e.start
    rows = {}
    for e in evs:
        row = rows.get(e.name)
        if row is None:
            row = rows[e.name] = _Row(e.name, e.dtype)
        row.count += 1
        cpu_total = e.end - e.start if e.dtype == DeviceType.CPU else 0.0
        row.cpu_time_total += cpu_total
        row.device_time_total += e.device_total
        if e.sync and e.dtype == DeviceType.CPU:
            row.self_cpu_time_total += cpu_total - sum(ch.end - ch.start for ch in e.children)
            row.self_device_time_total += e.device_total - sum(
                ch.device_total for ch in e.children)
        elif e.sync and use_device:
            row.self_device_time_total += e.device_total
    return rows


def _check_rows(prof, rows, rel: float = 1e-6):
    """Raises unless ``rows`` (``_profile_rows``) equal key_averages' rows:
    the keys, device types and counts exactly, the times within ``rel`` of
    their largest (the sums' order differs)."""
    want = {e.key: e for e in prof.key_averages()}
    fields = ("cpu_time_total", "self_cpu_time_total", "device_time_total",
              "self_device_time_total")
    scale = {f: max([abs(getattr(e, f)) for e in want.values()] + [1.0]) for f in fields}
    bad = [k for k in set(want) | set(rows)
           if k not in want or k not in rows
           or (want[k].count, want[k].device_type) != (rows[k].count, rows[k].device_type)
           or any(abs(getattr(want[k], f) - getattr(rows[k], f)) > rel * scale[f]
                  for f in fields)]
    if bad:
        k = sorted(bad)[0]
        raise AssertionError(
            f"profiler rows differ from key_averages in {len(bad)} keys, e.g. {k!r}: "
            + (f"{vars(rows[k]) if k in rows else None} vs "
               + (str({f: getattr(want[k], f) for f in ('count', 'device_type', *fields)})
                  if k in want else "None")))


def _kernel_device_ms(events, kernel):
    """(device ms, calls) of one kernel's symbols among profiler events."""
    hits = [e for e in events if any(sym in e.key for sym in KERNEL_SYMBOLS[kernel])]
    return sum(_dev_us(e) for e in hits) / 1e3, sum(e.count for e in hits)


# B8's (label, samples, zero rows) at B=8 and 24 kHz: ~10 s and 1 s, and the
# training shape (1153 frames: the 64-frame bucket of 1152 frames, the batch
# bucket's last rows zero)
LOG_MEL_CASES = [("10 s", 240000, 0), ("1 s", 24000, 0), ("train", 1152 * 256, 3)]


def log_mel_input(gen, n, zero_rows):
    """B8's input: (8, n) audio, one row zero after 2/3 and the last
    zero_rows rows zero, reflect-padded by n_fft/2 = 512."""
    import torch

    wav = 0.1 * torch.randn((8, n), generator=gen, device="cuda")
    wav[-1, 2 * n // 3:] = 0.0
    if zero_rows:
        wav[-zero_rows:] = 0.0
    return torch.nn.functional.pad(wav[:, None, :], (512, 512), mode="reflect")[:, 0]


def log_mel_cufft(wp, fb, window):
    """B8's function through torch.stft (cuFFT), a dense mel product, the
    clamp and the log: a yardstick of several library calls, no part of the
    port (n_fft 1024, hop 256)."""
    import torch

    spec = torch.stft(wp, 1024, 256, window=window, center=False, return_complex=True)
    return torch.log(torch.clamp(spec.abs().transpose(1, 2) @ fb, min=1e-7))


def _penalty_limit(q, k, pq, pe) -> float:
    """A failsafe limit that a few hundred of these scores cross, put in a
    gap of at least 1e-3 between two |scores|, so that f32 rounding
    differences between kernel and plain version cannot flip an element."""
    import torch

    from zipvoice_tpu_torch.ops.attention import rel_scores_plain

    top = torch.topk(rel_scores_plain(q, k, pq, pe).abs().flatten(), 1000).values
    for i in range(200, 999):
        if float(top[i] - top[i + 1]) > 1e-3:
            return float(top[i] + top[i + 1]) / 2
    raise AssertionError("no gap in the top scores for the penalty limit")


def _errs(out, ref):
    """(max |out - ref|, that over max(1, max |ref|))."""
    err = float((out.float() - ref.float()).abs().max())
    return err, err / max(1.0, float(ref.float().abs().max()))


def check_training_kernels():
    """Phase 3b: B3, B4 and B8 against their plain versions on the card at
    the training shapes, f32 and bf16; returns {kernel: {case: numbers}}."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.ops import attention as att
    from zipvoice_tpu_torch.ops.melspec import fused_log_mel, fused_log_mel_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {"B3": {}, "B4": {}, "B8": {}}
    for label, b, h, t, vd in TRAIN_ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8
            q, k, pq, pe, mask, v, g = _rel_inputs(gen, b, h, t, vd, dtype, scale=1.5)
            bth = b * t * h
            in_bytes = s * (2 * bth * 32 + bth * 4 + (2 * t - 1) * h * 4) + b * t
            score_ops = 2 * b * h * t * t * 36
            limit_hi = _penalty_limit(q, k, pq, pe)
            for pen, gate in TRAIN_ATTN_VARIANTS:
                limit = limit_hi if pen else 25.0
                key = (label, t, h, vd, dn, pen, gate)
                timed_case = pen == 0.0 and not gate
                # B4 (SelfAttention shapes only: it is B1's backward)
                if h == 4 and not gate:
                    gp = torch.randn((b, h, t, t), generator=gen, device="cuda").to(dtype)
                    ds = att.rel_attention_ds(q, k, pq, pe, mask, gp, pen, limit)
                    ref = att.rel_attention_ds_plain(q, k, pq, pe, mask, gp, pen, limit)
                    torch.cuda.synchronize()
                    abs_err, err = _errs(ds, ref)
                    # relative to max(1, max |ds|); f32: scores summed in another
                    # order than cuBLAS's; bf16: ds rounded to bf16 on both sides
                    # (one unit in the last place)
                    tol = 2e-5 if dtype == torch.float32 else 8e-3
                    r = dict(abs_err=abs_err, rel_err=err, tol=tol, ms=None, plain_ms=None,
                             library_ms=None, bound_ms=None, bound_by=None)
                    if timed_case:
                        r["ms"] = time_ms(lambda: att.rel_attention_ds(q, k, pq, pe, mask, gp))
                        r["plain_ms"] = time_ms(
                            lambda: att.rel_attention_ds_plain(q, k, pq, pe, mask, gp))
                        r["bound_ms"], r["bound_by"] = bound_ms(
                            in_bytes + 2 * s * b * h * t * t, score_ops, dn)
                        r["contract_bound_ms"] = contract_bound_ms(
                            in_bytes + 2 * s * b * h * t * t, 0.0, score_ops, dn)
                    results["B4"][key] = r
                    print(f"B4 rel_ds {label} T={t} {dn} pen={pen:g}: rel_err {err:.3g} "
                          f"(tol {tol:g}), max_abs_err {abs_err:.3g}" + _times(r), flush=True)
                    if not err <= tol:
                        raise AssertionError(f"B4 disagrees at {key}: {err} > {tol}")
                    del gp, ds, ref
                # B3
                outs = att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g, pen, limit, gate)
                refs = att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g, pen,
                                                           limit, gate)
                torch.cuda.synchronize()
                pairs = {n: _errs(o, rf) for n, o, rf in zip(("dq", "dk", "dpq", "dpe", "dv"),
                                                              outs, refs)}
                errs = {n: rel for n, (_, rel) in pairs.items()}
                err = max(errs.values())
                # relative to max(1, each output's max); every output is an
                # f32 sum over T keys (dpe over B*T rows, by atomics) in
                # another order than the plain version's
                tol = 1e-4
                r = dict(abs_err=max(a for a, _ in pairs.values()), rel_err=err, tol=tol,
                         ms=None, plain_ms=None, library_ms=None, bound_ms=None, bound_by=None)
                if timed_case:
                    r["ms"] = time_ms(
                        lambda: att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g))
                    r["plain_ms"] = time_ms(
                        lambda: att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g))
                    out_bytes = 4 * (2 * bth * 32 + bth * 4 + (2 * t - 1) * h * 4 + bth * vd)
                    ops = score_ops + 2 * b * h * t * t * (2 * vd + 2 * 32 + 8)
                    r["bound_ms"], r["bound_by"] = bound_ms(
                        in_bytes + 2 * s * bth * vd + out_bytes, ops, dn)
                results["B3"][key] = r
                worst = max(errs, key=errs.get)
                print(f"B3 rel_apply_bwd {label} H={h} T={t} vd={vd} {dn} pen={pen:g} "
                      f"gate={int(gate)}: rel_err {err:.3g} ({worst}, tol {tol:g}), "
                      f"max_abs_err {r['abs_err']:.3g}" + _times(r), flush=True)
                if not err <= tol:
                    raise AssertionError(f"B3 disagrees at {key}: {errs} > {tol}")
                del outs, refs
            del q, k, pq, pe, mask, v, g
    # B8 (LOG_MEL_CASES)
    from zipvoice_tpu_torch.audio.mel import mel_filterbank

    n_fft, hop, n_mels = 1024, 256, 100
    fb = mel_filterbank(24000, n_fft, n_mels)
    # a frame's least work: the window, a real-input FFT of 1024 points
    # (2.5 N log2 N, the usual count for real data), |.| of 513 bins (3
    # each), the mel product over the filterbank's nonzeros (2 each; 1008 of
    # 513 x 100 at 100 mels, the rest multiply zeros) and 100 logs
    nnz = int(np.count_nonzero(fb))
    per_frame = n_fft + 2.5 * n_fft * 10 + 3 * (n_fft // 2 + 1) + 2 * nnz + n_mels
    fb = torch.from_numpy(fb).cuda()
    hann = torch.hann_window(n_fft, device="cuda")
    for label, n, zero_rows in LOG_MEL_CASES:
        wp = log_mel_input(gen, n, zero_rows)
        out = fused_log_mel(wp)
        ref = fused_log_mel_plain(wp)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        # log-mel: f32 FFT sums in another order than the plain DFT products;
        # 1e-3 in log is 0.1 % of the mel energy
        tol = 1e-3
        frames = out.shape[1]
        bnd, by = bound_ms(4 * wp.numel() + 4 * out.numel(), 8 * frames * per_frame, "float32")
        cufft = lambda: log_mel_cufft(wp, fb, hann)  # noqa: E731
        cufft_err = float((cufft() - ref).abs().max())
        r = dict(abs_err=err, tol=tol, ms=time_ms(lambda: fused_log_mel(wp)),
                 plain_ms=time_ms(lambda: fused_log_mel_plain(wp)), library_ms=None,
                 cufft_ms=time_ms(cufft), bound_ms=bnd, bound_by=by)
        results["B8"][(label, frames)] = r
        print(f"B8 log_mel B=8 {label} ({frames} frames, {nnz} filterbank nonzeros): "
              f"max_abs_err {err:.3g} (tol {tol:g}) cufft_ms {r['cufft_ms']:.4f} "
              f"(its err {cufft_err:.3g})" + _times(r), flush=True)
        if out.shape != (8, frames, n_mels) or not err <= tol:
            raise AssertionError(f"B8 disagrees at {label}: {err} > {tol}")
    return results


# serving shapes of B6/B7 (B=2, H=4); B7 takes the fm_decoder's
# NonlinAttention width (3D/4 = 384) and the text encoder's (144) at T=40;
# T=1152 and 1408 are the ~8 s and the longest serving buckets (more row
# blocks than SMs)
FUSED_ATTN_CASES = [(1024, "main"), (512, "main"), (256, "main"), (288, "ragged"),
                    (577, "ragged"), (40, "text"), (1152, "bucket"), (1408, "bucket")]
# B9: (C = D, K, T); the fm_decoder's kernels 31/15/7 at its stack lengths,
# the text encoder's C = 192, K = 9 at T=40, and the ~8 s bucket
CONV_CASES = [(512, kk, t) for kk in (31, 15, 7) for t in (1024, 512, 256, 288)] + [
    (192, 9, 40), (512, 31, 1152)]
# B5: (B, H, T, vd); the op's own entry point, no model path calls it; vd
# 12 takes its narrow route (B6's body), vd 384 its wide one (B7's kernel)
APPLY_CASES = [(8, 4, 1024, 12), (8, 4, 577, 12), (8, 1, 1024, 384), (8, 1, 577, 384)]


def _fused_attention_checks(gen, results):
    """Phase 3c, attention part: B6 and B7 at the serving shapes."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    b, h, qd, pd, vd = 2, 4, 32, 4, 12
    for t, kind in FUSED_ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8
            q, k, pq, pe, mask, v, _ = _rel_inputs(gen, b, h, t, vd, dtype)
            # f32: sums over T keys in another order; bf16: one unit in the
            # last place of a probability <= 1 and of the output's scale
            tol = 2e-5 if dtype == torch.float32 else 8e-3
            in_bytes = s * (2 * b * t * h * qd + b * t * h * pd + (2 * t - 1) * h * pd) + b * t

            probs, out = att.rel_attention_probs_consume(q, k, pq, pe, mask, v, out_dtype=dtype)
            ref_p, ref_o = att.rel_attention_probs_consume_plain(q, k, pq, pe, mask, v, dtype)
            same_as_b1 = torch.equal(probs, att.rel_attention_probs(q, k, pq, pe, mask,
                                                                    out_dtype=dtype))
            torch.cuda.synchronize()
            err_p = float((probs.float() - ref_p.float()).abs().max())
            abs_o, rel_o = _errs(out, ref_o)
            r = dict(abs_err=max(err_p, abs_o), rel_err=max(err_p, rel_o), tol=tol,
                     ms=time_ms(lambda: att.rel_attention_probs_consume(q, k, pq, pe, mask, v)),
                     plain_ms=time_ms(lambda: att.rel_attention_probs_consume_plain(
                         q, k, pq, pe, mask, v)), library_ms=None)
            nbytes = in_bytes + s * b * t * h * vd + s * b * h * t * t + s * b * t * h * vd
            r["bound_ms"], r["bound_by"] = bound_ms(
                nbytes, 2 * b * h * t * t * (qd + pd + vd), dn)
            r["contract_bound_ms"] = contract_bound_ms(
                nbytes, 2 * b * h * t * t * vd, 2 * b * h * t * t * (qd + pd), dn)
            results["B6"][(t, dn)] = r
            print(f"B6 probs_consume T={t} ({kind}) {dn}: probs err {err_p:.3g}, out rel_err "
                  f"{rel_o:.3g} (tol {tol:g}), probs equal B1's: {same_as_b1}" + _times(r),
                  flush=True)
            if not (r["rel_err"] <= tol and same_as_b1):
                raise AssertionError(f"B6 disagrees at T={t} {dn}: {r}, equal B1 {same_as_b1}")
            del probs, out, ref_p, ref_o

            c = 144 if kind == "text" else 384
            v0 = torch.randn((b, t, c), generator=gen, device="cuda").to(dtype)
            out = att.rel_attention_head0_consume(q, k, pq, pe, mask, v0)
            ref = att.rel_attention_head0_consume_plain(q, k, pq, pe, mask, v0)
            torch.cuda.synchronize()
            abs_o, rel_o = _errs(out, ref)
            r = dict(abs_err=abs_o, rel_err=rel_o, tol=tol,
                     ms=time_ms(lambda: att.rel_attention_head0_consume(q, k, pq, pe, mask, v0)),
                     plain_ms=time_ms(lambda: att.rel_attention_head0_consume_plain(
                         q, k, pq, pe, mask, v0)), library_ms=None)
            # head 0 of q, k, pq, pe is what the function reads
            nbytes = s * (2 * b * t * qd + b * t * pd + (2 * t - 1) * pd + 2 * b * t * c) + b * t
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 2 * b * t * t * (qd + pd + c), dn)
            r["contract_bound_ms"] = contract_bound_ms(
                nbytes, 2 * b * t * t * c, 2 * b * t * t * (qd + pd), dn)
            results["B7"][(t, c, dn)] = r
            print(f"B7 head0_consume T={t} C={c} ({kind}) {dn}: rel_err {rel_o:.3g} "
                  f"(tol {tol:g}), max_abs_err {abs_o:.3g}" + _times(r), flush=True)
            if not rel_o <= tol:
                raise AssertionError(f"B7 disagrees at T={t} C={c} {dn}: {rel_o} > {tol}")
            del q, k, pq, pe, mask, v, v0, out, ref


def _scaled_errs(out, ref):
    """(max |out - ref|, that over max |ref|)."""
    err = float((out.double() - ref.double()).abs().max())
    return err, err / float(ref.double().abs().max())


def _conv_checks(gen, results):
    """Phase 3c, B9: the kernel and its f32 plain version against an f64
    plain version (cuDNN's TF32 off for the plain conv), bf16 against the
    bf16 plain version."""
    import torch

    from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out, conv_glu_swoosh_out_plain

    b = 2
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for c, kk, t in CONV_CASES:
            w = torch.rand((c, 1, kk), generator=gen, device="cuda") * 2 / kk ** 0.5 - 1 / kk ** 0.5
            bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
            w_out = (torch.rand((c, c), generator=gen, device="cuda") * 2 - 1) / c ** 0.5
            b_out = 0.01 * torch.randn((c,), generator=gen, device="cuda")
            lens = torch.tensor([t, t - t // 3 - 1], device="cuda")
            mask = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
            proj32 = torch.randn((b, t, 2 * c), generator=gen, device="cuda")
            args = (w, bias, mask, w_out, b_out)
            ref64 = conv_glu_swoosh_out_plain(proj32.double(), *args)
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                s = torch.finfo(dtype).bits // 8
                proj = proj32.to(dtype)
                out = conv_glu_swoosh_out(proj, *args)
                plain = conv_glu_swoosh_out_plain(proj, *args)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    # relative to the scale (max |.|) of the f64 output
                    abs_err, err = _scaled_errs(out, ref64)
                    plain_err = _scaled_errs(plain, ref64)[1]
                    tol = 2e-5
                else:  # one unit in the last place of the bf16 output's scale
                    abs_err, err = _scaled_errs(out, plain)
                    plain_err = None
                    tol = 8e-3
                r = dict(abs_err=abs_err, rel_err=err, plain_rel_err=plain_err, tol=tol,
                         ms=time_ms(lambda: conv_glu_swoosh_out(proj, *args)),
                         plain_ms=time_ms(lambda: conv_glu_swoosh_out_plain(proj, *args)),
                         library_ms=None)
                r["bound_ms"], r["bound_by"] = bound_ms(
                    s * (b * t * 2 * c + c * c + b * t * c) + 4 * (c * kk + 2 * c) + b * t,
                    2 * b * t * c * (kk + c), dn)
                results["B9"][(c, kk, t, dn)] = r
                print(f"B9 conv_glu C={c} K={kk} T={t} {dn}: rel_err {err:.3g}"
                      + (f" (f32 plain {plain_err:.3g}) against f64" if plain_err is not None
                         else " against the bf16 plain version")
                      + f" (tol {tol:g}), max_abs_err {abs_err:.3g}" + _times(r), flush=True)
                if not (err <= tol and (plain_err is None or plain_err <= tol)):
                    raise AssertionError(f"B9 disagrees at C={c} K={kk} T={t} {dn}: {r}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _apply_checks(gen, results):
    """Phase 3c, B5: forward against its plain version, and with the gate
    closed against B6 (narrow vd) or B7 on v[:, :, 0] (H=1, wide vd) bit for
    bit; returns the launches of one forward + backward through
    rel_attention_apply, the op's entry point, and the gradients' worst
    relative error against plain autograd, gate off and on."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    for b, h, t, vd in APPLY_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8
            q, k, pq, pe, mask, v, _ = _rel_inputs(gen, b, h, t, vd, dtype)
            tol = 2e-5 if dtype == torch.float32 else 8e-3
            for gate in (False, True):
                out = att.rel_attention_apply(q, k, pq, pe, mask, v, const_gate=gate)
                ref = att.rel_attention_apply_plain(q, k, pq, pe, mask, v, const_gate=gate)
                torch.cuda.synchronize()
                abs_err, err = _errs(out, ref)
                r = dict(abs_err=abs_err, rel_err=err, tol=tol, ms=None, plain_ms=None,
                         library_ms=None, bound_ms=None, bound_by=None)
                same = None
                if not gate:
                    # the route's kernel on the same inputs: B6 (narrow) or B7
                    if vd <= 64:
                        twin, same_as = att.rel_attention_probs_consume(
                            q, k, pq, pe, mask, v)[1], "B6"
                    else:
                        twin, same_as = att.rel_attention_head0_consume(
                            q, k, pq, pe, mask, v[:, :, 0].contiguous())[:, :, None], "B7"
                    same = torch.equal(out, twin)
                    r["equal_" + same_as] = same
                    del twin
                    r["ms"] = time_ms(lambda: att.rel_attention_apply(q, k, pq, pe, mask, v))
                    r["plain_ms"] = time_ms(
                        lambda: att.rel_attention_apply_plain(q, k, pq, pe, mask, v))
                    bth = b * t * h
                    nbytes = s * (2 * bth * 32 + bth * 4 + (2 * t - 1) * h * 4 + 2 * bth * vd) \
                        + b * t
                    r["bound_ms"], r["bound_by"] = bound_ms(
                        nbytes, 2 * b * h * t * t * (32 + 4 + vd), dn)
                    r["contract_bound_ms"] = contract_bound_ms(
                        nbytes, 2 * b * h * t * t * vd, 2 * b * h * t * t * (32 + 4), dn)
                results["B5"][(b, h, t, vd, dn, gate)] = r
                print(f"B5 rel_apply B={b} H={h} T={t} vd={vd} {dn} gate={int(gate)}: rel_err "
                      f"{err:.3g} (tol {tol:g}), max_abs_err {abs_err:.3g}"
                      + ("" if same is None else f", equal to {same_as}'s: {same}") + _times(r),
                      flush=True)
                if not (err <= tol and same is not False):
                    raise AssertionError(f"B5 disagrees at B={b} H={h} T={t} vd={vd} {dn} "
                                         f"gate={gate}: {err} > {tol} or equal {same}")
            del q, k, pq, pe, mask, v, out, ref

    # the op's path: one forward + backward through rel_attention_apply
    # (B5, then B3), f32, against plain autograd, the const gate off and on
    # (the plain const branch leaves q, k, pq, pe without a gradient: zero)
    q, k, pq, pe, mask, v, g = _rel_inputs(gen, 8, 4, 577, 12, torch.float32)
    counters = _counters()
    grad_err = 0.0
    for gate in (False, True):
        xs = [x.clone().requires_grad_() for x in (q, k, pq, pe, v)]
        ys = [x.clone().requires_grad_() for x in (q, k, pq, pe, v)]
        for c in counters.values():
            c.launches = 0
        (att.rel_attention_apply(*xs[:4], mask, xs[4], const_gate=gate) * g).sum().backward()
        torch.cuda.synchronize()
        gate_launches = {name: c.launches for name, c in counters.items()}
        (att.rel_attention_apply_plain(*ys[:4], mask, ys[4], const_gate=gate) * g).sum().backward()
        err = max(_errs(x.grad, torch.zeros_like(y) if y.grad is None else y.grad)[1]
                  for x, y in zip(xs, ys))
        print(f"B5 + B3 through rel_attention_apply, B=8 H=4 T=577 f32 gate={int(gate)}: "
              f"gradients' worst rel_err {err:.3g} (tol 1e-4) against plain autograd; "
              f"launches {gate_launches}", flush=True)
        if gate_launches["B5"] != 1 or gate_launches["B3"] != 1 or not err <= 1e-4:
            raise AssertionError(f"rel_attention_apply gradient (gate {gate}): {err}, "
                                 f"launches {gate_launches}")
        grad_err = max(grad_err, err)
        if not gate:
            launches = gate_launches
    return launches, grad_err


def check_fused_kernels():
    """Phase 3c: B6, B7, B9 and B5 against their plain versions on the card;
    returns ({kernel: {case: numbers}}, the op path's launches, the op
    path's gradient error)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {"B5": {}, "B6": {}, "B7": {}, "B9": {}}
    _fused_attention_checks(gen, results)
    _conv_checks(gen, results)
    launches, grad_err = _apply_checks(gen, results)
    return results, launches, grad_err


def _times(r) -> str:
    if r["ms"] is None:
        return ""
    line = (f" kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    if "contract_bound_ms" in r:
        line += f" contract_bound_ms {r['contract_bound_ms']:.4f}"
    return line


def make_assets(root: Path):
    """Phase 4: full-width random model dir, Vocos checkpoint, 3 s prompt."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, save_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.tokenizer import write_token_file

    chars = "_ abcdefghijklmnopqrstuvwxyz,.'"
    write_token_file({c: i for i, c in enumerate(chars)}, str(root / "tokens.txt"))
    cfg = ZipVoiceConfig(vocab_size=len(chars), pad_id=0)
    save_model_json(root / "model.json", cfg, FeatureConfig())
    model = init_zipvoice(cfg, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    torch.save({"model": model.state_dict()}, root / "model.pt")
    del model
    torch.save(init_vocos(VocosConfig(), torch.Generator().manual_seed(1)),
               root / "vocos.bin")
    sr = 24000
    tt = np.arange(3 * sr) / sr
    rng = np.random.default_rng(0)
    prompt = (0.08 * np.sin(2 * np.pi * 220 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
              + 0.01 * rng.standard_normal(tt.shape)).astype(np.float32)
    write_wav(root / "prompt.wav", prompt, sr)
    return n_params


PROMPT_TEXT = "this is a short prompt sentence for the smoke run"
BASE = "the quick brown fox jumps over the lazy dog, and then it runs away. "
TEXTS = {"r4s": BASE[:60], "r8s": (BASE * 2)[:120], "r12s": (BASE * 3)[:180]}


def expected_samples(text: str, prompt_samples: int) -> int:
    """(gen_len - 1) * hop, with gen_len from the token-ratio duration."""
    import numpy as np

    from zipvoice_tpu_torch.audio.mel import compute_num_frames
    from zipvoice_tpu_torch.models.zipvoice import predict_features_lens

    pf = compute_num_frames(prompt_samples, 256)
    total = predict_features_lens(np.array([pf]), np.array([len(PROMPT_TEXT)]),
                                  np.array([len(text)]))[0]
    return (int(total) - pf - 1) * 256


class _FusedEval:
    """Within the block: the fused eval path (set_fused_eval,
    set_fused_conv) on; both flags off again on exit."""

    def __enter__(self):
        from zipvoice_tpu_torch.nn import zipformer as zf

        zf.set_fused_eval(True)
        zf.set_fused_conv(True)
        return self

    def __exit__(self, *exc):
        from zipvoice_tpu_torch.nn import zipformer as zf

        zf.set_fused_eval(False)
        zf.set_fused_conv(False)
        return False


def run_cli(root: Path, names, dtype: str, card: str, model_dir: Path = None,
            fused: bool = False, vocoder: Path = None, extra=()):
    """Phase 5 helper: one CLI run over `names` (with the model dir `root`,
    or `model_dir`, and phase 4's Vocos or the checkpoint `vocoder`; the
    fused eval path on when `fused`; `extra` CLI arguments); returns its
    metrics and launches after checking the wavs and the per-request kernel
    launches."""
    import contextlib

    import numpy as np

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin.infer_zipvoice import main as cli_main

    tag = f"{dtype}_fused" if fused else dtype
    if vocoder is not None:
        tag = f"{tag}_{vocoder.stem}"
    if extra:
        tag = f"{tag}_{'_'.join(a.strip('-') for a in extra)}"
    lst = root / f"list_{tag}.tsv"
    lst.write_text("".join(f"{n}\t{PROMPT_TEXT}\t{root / 'prompt.wav'}\t{TEXTS[n]}\n"
                           for n in names))
    out_dir = root / f"out_{tag}"
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    with _FusedEval() if fused else contextlib.nullcontext():
        metrics = cli_main([
            "--model-dir", str(model_dir or root),
            "--vocoder-path", str(vocoder or root / "vocos.bin"),
            "--tokenizer", "simple", "--test-list", str(lst), "--res-dir", str(out_dir),
            "--num-step", str(N_STEP), "--guidance-scale", "1.0", "--dtype", dtype,
            "--device", "cuda", *extra,
        ])
    launches = {k: c.launches for k, c in counters.items()}
    per_request = FUSED_PER_REQUEST if fused else UNFUSED_PER_REQUEST
    want = {k: per_request.get(k, 0) * len(names) for k in counters}
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected {want}")
    for n, m in zip(names, metrics):
        wav, sr = read_wav(out_dir / f"{n}.wav")
        exp = expected_samples(TEXTS[n], 3 * 24000)
        if sr != 24000 or wav.shape != (1, exp) or not np.isfinite(wav).all():
            raise AssertionError(f"{n} {dtype}: wav {wav.shape} sr {sr}, want (1, {exp})")
        print(f"request {n} {tag}: {m['wav_seconds']:.2f} s audio, "
              f"rtf {m['rtf']:.4f} (model {m['rtf_no_vocoder']:.4f}, vocoder "
              f"{m['rtf_vocoder']:.4f}) on {card}", flush=True)
    return metrics, launches


def check_forward_against_cpu(root: Path, fused: bool = False, model_dir: Path = None):
    """Phase 6: one full-width fm_decoder velocity on the card (kernels) and
    on the CPU (plain versions, unfused), same weights and inputs, T=256
    with a padded tail, of the model dir `root` (or `model_dir`); 6b
    (`fused`): the card runs the fused eval path."""
    import contextlib

    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.zipvoice import forward_fm_decoder

    model = load_model_dir(str(model_dir or root), tokenizer_name="simple").model.eval()
    g = torch.Generator().manual_seed(3)
    b, t, f = 2, 256, model.cfg.feat_dim
    xt, tc, sc = (torch.randn((b, t, f), generator=g) for _ in range(3))
    mask = torch.arange(t)[None, :] >= torch.tensor([t, 200])[:, None]
    with torch.no_grad():
        ref = forward_fm_decoder(model, 0.3, xt, tc, sc, mask)
        model = model.cuda()
        with _FusedEval() if fused else contextlib.nullcontext():
            out = forward_fm_decoder(model, 0.3, xt.cuda(), tc.cuda(), sc.cuda(),
                                     mask.cuda()).cpu()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    kind = "fused card vs unfused CPU" if fused else "card vs CPU"
    print(f"fm_decoder forward, {kind}: max_abs_err {err:.3g} "
          f"(|ref| max {scale:.3g}, tol {1e-3 * scale:.3g})", flush=True)
    if not err <= 1e-3 * scale:
        raise AssertionError(f"fm_decoder {kind}: {err}")
    return err


class _NoDraws:
    """Within the block: no random draw reaches the loss.  The condition
    mask is a fixed span, the pos-emb dropout an identity, every gate of
    the training contexts closed, and the schedules' random rates are 0
    (``schedules``)."""

    def __enter__(self):
        from zipvoice_tpu_torch.models import zipvoice as zv
        from zipvoice_tpu_torch.nn import regularizers as reg
        from zipvoice_tpu_torch.nn import zipformer as zf

        def fixed_span(features_lens, max_len, generator, mask_percent=(0.7, 1.0)):
            import torch

            seq = torch.arange(max_len, device=features_lens.device)[None, :]
            return (seq >= 10) & (seq < 10 + (features_lens[:, None] * 0.8).long())

        self.saved = [(zv, "condition_time_mask", zv.condition_time_mask),
                      (reg, "dropout_shared", reg.dropout_shared),
                      (zf.TrainCtx, "gate", zf.TrainCtx.gate)]
        zv.condition_time_mask = fixed_span
        reg.dropout_shared = lambda x, *a, **k: x
        zf.TrainCtx.gate = lambda self, prob: False
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    @staticmethod
    def schedules(cfg):
        from zipvoice_tpu_torch.train.schedules import zipvoice_schedules

        out = {}
        for key, s in zipvoice_schedules(100.0, cfg).items():
            out[key] = dict(s, dropout=0.0, attention_skip_rate=0.0, conv_skip_rate=0.0,
                            ff2_skip_rate=0.0, ff3_skip_rate=0.0,
                            layerdrop=tuple(tuple(0.0 for _ in st) for st in s["layerdrop"]))
        return out


@contextlib.contextmanager
def _deterministic():
    """Within the block: torch's deterministic algorithms, so that an f32
    gradient reproduces bit for bit on the card.  Otherwise the backwards
    of the text condition's gather and of the upsampling's
    repeat_interleave add by atomics in any order, and 18d's nearly
    cancelling gradients (0-d log_scales, downsampling biases) read that
    order as relative errors of up to 1e-5 between two runs of one process
    (``tools/sp_gradient_noise.py``).  cuBLAS runs on one stream here,
    where it reproduces without a workspace setting; its warning is
    muted."""
    import warnings

    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=r"Deterministic behavior was enabled.*CuBLAS")
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


class _RegStats:
    """Within the block: every balancer and whitening applied (their gates
    forced open, the host draws still made), and the statistics each takes
    in the backward recorded in call order (``summary``): a balancer's
    per-channel mean squares (``nn/regularizers.balancer_stats``) summed,
    a whitening's metric."""

    def __enter__(self):
        from zipvoice_tpu_torch.nn import regularizers as reg

        self.saved = [(reg, n, getattr(reg, n))
                      for n in ("balancer", "whiten", "balancer_stats", "whitening_metric")]
        balancer, whiten, stats, metric = (fn for _, _, fn in self.saved)
        self.records = {"balancer": [], "whiten": []}

        def recorded_stats(*a, **k):
            uv, mean, n = stats(*a, **k)
            self.records["balancer"].append(uv.sum().detach())
            return uv, mean, n

        def recorded_metric(*a, **k):
            m = metric(*a, **k)
            self.records["whiten"].append(m.detach())
            return m

        reg.balancer = lambda x, gate, **k: balancer(x, True, **k)
        reg.whiten = lambda x, gate, **k: whiten(x, True, **k)
        reg.balancer_stats = recorded_stats
        reg.whitening_metric = recorded_metric
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def summary(self):
        return {k: [float(v) for v in vs] for k, vs in self.records.items()}


def _param_group(name: str) -> str:
    parts = name.split(".")
    if parts[0] == "fm_decoder" and parts[1] == "encoders":
        return ".".join(parts[:3])
    return parts[0]


def check_gradient_against_cpu(root: Path):
    """Phase 7: one full-width compute_fm_loss backward on the card
    (kernels) and on the CPU (plain versions), same weights and inputs, f32,
    no random draws: with the regularizer schedules (B1 + B3) and without
    (B1 + B4 + B2).  Returns {path: {group: relative L2 error}}."""
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.zipvoice import compute_fm_loss

    model = load_model_dir(str(root), tokenizer_name="simple").model
    cfg = model.cfg
    g = torch.Generator().manual_seed(5)
    b, t, s = 2, 256, 48
    tokens = torch.randint(1, cfg.vocab_size, (b, s + 1), generator=g)
    tokens[:, -1] = 0
    tokens_lens = torch.tensor([s, s - 11])
    features = 0.5 * torch.randn((b, t, cfg.feat_dim), generator=g)
    features_lens = torch.tensor([t, t - 57])
    noise = torch.randn((b, t, cfg.feat_dim), generator=g)
    tt = torch.tensor([0.3, 0.8]).reshape(b, 1, 1)
    inputs = (tokens, tokens_lens, features, features_lens, noise, tt)
    out = {}
    with _NoDraws() as nd:
        for path, scheds in (("regularizers", nd.schedules(cfg)), ("no-regularizers", None)):
            grads = {}
            for dev in ("cpu", "cuda"):
                model = model.to(dev)
                model.zero_grad()
                loss = compute_fm_loss(model, *(x.to(dev) for x in inputs), 0,
                                       schedules=scheds)
                loss.backward()
                grads[dev] = {n: q.grad.detach().cpu() for n, q in model.named_parameters()}
            groups = {}
            for n, gc in grads["cpu"].items():
                d2, r2 = groups.get(_param_group(n), (0.0, 0.0))
                groups[_param_group(n)] = (d2 + float(((grads["cuda"][n] - gc) ** 2).sum()),
                                           r2 + float((gc ** 2).sum()))
            out[path] = {k: (d / max(r, 1e-30)) ** 0.5 for k, (d, r) in groups.items()}
            worst = max(out[path].values())
            print(f"gradient card vs CPU ({path}): relative L2 per group "
                  + ", ".join(f"{k} {v:.2e}" for k, v in out[path].items())
                  + f"; worst {worst:.2e} (tol 1e-3)", flush=True)
            # f32 on both sides; sums over T keys and 20 layers in another
            # order (dpe by atomics), through the balancer-free backward
            if not worst <= 1e-3:
                raise AssertionError(f"gradient card vs CPU ({path}): {out[path]}")
    model.zero_grad(set_to_none=True)
    return out


def make_corpus(root: Path, n: int = 16):
    """16 random-noise wavs of 2-12 s at 24 kHz, a TSV manifest."""
    import numpy as np

    from zipvoice_tpu_torch.audio.wav import write_wav

    d = root / "corpus"
    d.mkdir()
    rng = np.random.default_rng(7)
    lines = []
    for i in range(n):
        sec = rng.uniform(2.0, 12.0)
        wav = (0.05 * rng.standard_normal(int(sec * 24000))).astype(np.float32)
        write_wav(d / f"utt{i}.wav", wav, 24000)
        lines.append(f"utt{i}\t{(BASE * 3)[: int(15 * sec)]}\t{d / f'utt{i}.wav'}")
    (d / "train.tsv").write_text("\n".join(lines) + "\n")
    return d / "train.tsv"


# per training step: B1 forward + rematerialized recompute in all 20 layers
# (4 text encoder, 16 fm_decoder), B2 in both SelfAttention consumers of each
# (forward + recompute), B3 in the three consumers of each layer (with
# regularizers), B4 once a layer (without), B8 once a batch
LAYERS = 4 + 16
PER_STEP = {"B1": 2 * LAYERS, "B2": 4 * LAYERS, "B3": 3 * LAYERS, "B4": LAYERS, "B8": 1}


def _counters():
    from zipvoice_tpu_torch.utils.graphs import launch_counters

    return launch_counters()


def run_training(root: Path, manifest: Path, card: str, regularizers: bool, steps: int):
    """Phase 8: the port's train CLI on the card at full width, bf16.
    Checks finite losses, that every parameter changed and the per-step
    launches; returns (launches per step, launches, warm step ms, peak
    memory GiB, exp dir, result)."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.bin.train_zipvoice import main as train_main

    exp = root / ("exp_reg" if regularizers else "exp_noreg")
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = train_main([
        "--device", "cuda", "--train-manifest", str(manifest),
        "--token-file", str(root / "tokens.txt"), "--tokenizer", "simple",
        "--model-config", str(root / "model.json"), "--exp-dir", str(exp),
        "--num-epochs", "1", "--num-steps-per-epoch", str(steps),
        "--max-duration", "100", "--log-interval", "1",
        "--dtype", "bfloat16", *([] if regularizers else ["--no-regularizers"]),
    ])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = len(res["steps"])
    want = {k: PER_STEP.get(k, 0) * n for k in counters}
    if regularizers:
        want["B4"] = 0
    else:
        want["B3"] = 0
    if n != steps or launches != want:
        raise AssertionError(f"training launches {launches} over {n} steps, want {want}")
    losses = [loss for _, loss in res["steps"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    trainer = res["trainer"]
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice

    init = init_zipvoice(trainer.model.cfg, torch.Generator(device="cuda").manual_seed(42),
                         device="cuda")
    same = [n for (n, p), q in zip(trainer.model.named_parameters(), init.parameters())
            if torch.equal(p, q)]
    total = sum(1 for _ in init.parameters())
    changed = total - len(same)
    del init
    if same:
        raise AssertionError(f"{len(same)} of {total} parameter tensors unchanged: {same[:20]}")
    # step intervals after the first (which builds the kernels' workspaces
    # and warms the allocator); one epoch, so no checkpoint save falls inside
    ends = [t for t, _ in res["steps"]]
    step_ms = float(np.median(np.diff(ends)[1:] if n > 2 else np.diff(ends))) * 1e3
    kind = "regularizers" if regularizers else "no-regularizers"
    per_step = {k: v / n for k, v in launches.items()}
    print(f"training ({kind}, bf16, full width): {n} steps, losses "
          f"{[round(x, 4) for x in losses]}, {changed}/{total} parameter tensors changed, "
          f"warm step {step_ms:.1f} ms (median of {max(n - 2, 1)} intervals), peak memory "
          f"{peak_gib:.2f} GiB, launches {launches} ({per_step} a step) on {card}", flush=True)
    return per_step, launches, step_ms, peak_gib, exp, res


def profile_train_step(res, manifest: Path, card: str, regularizers: bool = True):
    """Phase 9: one warm training step (bf16; the trainer of `res` runs with
    or without the regularizers) under torch.profiler: device busy share,
    the device ms and calls of B2 and B3 (with the regularizers) or B4
    (without), and the kernels that take the most device time; with
    --profile the trace goes to the output directory if present.  Returns (wall s,
    device busy s, {kernel: (device ms, calls)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zipvoice_tpu_torch.data.dataset import (
        DurationBucketSampler,
        OnDeviceFbankCollator,
        read_tsv_manifest,
    )
    from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer

    trainer = res["trainer"]
    tok = SimpleTokenizer(str(Path(trainer.opts.exp_dir) / "tokens.txt"))
    from zipvoice_tpu_torch.config import FeatureConfig

    collate = OnDeviceFbankCollator(tok, FeatureConfig(), device="cuda")
    sampler = DurationBucketSampler(read_tsv_manifest(manifest), max_duration=100.0, seed=3)
    # the longest batch: the training shape that bounds the step
    batch = collate(sampler.pessimistic_batches(1)[0])
    float(trainer.step_and_log(batch)["loss"])  # warm at this shape
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        float(trainer.step_and_log(batch)["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0

    rows = _profile_rows(prof).values()
    events = sorted((e for e in rows if e.device_type == DeviceType.CUDA), key=_dev_us,
                    reverse=True)
    busy = sum(_dev_us(e) for e in events) / 1e6
    b, t = batch["features"].shape[:2]
    kind = "regularizers" if regularizers else "no-regularizers"
    dev = {k: _kernel_device_ms(events, k) for k in (("B3", "B2") if regularizers else ("B4",))}
    print(f"profile train step ({kind}, bf16, B={b} T={t}): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%); "
          + ", ".join(f"{k} {ms:.3f} ms in {n} kernel calls ({100 * ms / 1e3 / busy:.1f}% of "
                      "busy)" for k, (ms, n) in dev.items())
          + f" on {card}", flush=True)
    for e in events[:15]:
        print(f"  {_dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    # the host side: operators by their own CPU time
    host = sorted((e for e in rows if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host: {sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms of operator "
          f"self time in {sum(e.count for e in host)} calls; the most:")
    for e in host[:12]:
        print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    out = REPO / "chiprun_out"
    if "--profile" in sys.argv[1:] and out.is_dir():
        prof.export_chrome_trace(str(out / f"trace_train_step_{kind}.json"))
    return wall, busy, dev


def check_checkpoint_serves(root: Path, exp: Path, card: str):
    """Phase 10: the training checkpoint as a model dir's model.pt drives the
    inference CLI (one f32 request, pinned launches, a finite wav)."""
    ckpts = sorted(exp.glob("epoch-*.pt"))
    ckpts[-1].rename(exp / "model.pt")  # moved, not copied: disk writes are bounded
    metrics, _ = run_cli(root, ["r4s"], "float32", card, model_dir=exp)
    return metrics


def _r8s_pipeline(root: Path, dtype: str, model_dir: Path = None, vocoder: Path = None):
    """The CLI's pipeline for the model dir (`root`, or `model_dir` with
    the vocoder checkpoint `vocoder`) and the ~8 s request's kwargs."""
    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline, get_parser

    args = get_parser().parse_args([
        "--model-dir", str(model_dir or root), "--vocoder-path",
        str(vocoder or root / "vocos.bin"), "--tokenizer", "simple", "--dtype", dtype,
        "--device", "cuda"])
    pipeline, _, _ = build_pipeline(args)
    prompt, sr = read_wav(root / "prompt.wav")
    kw = dict(text=TEXTS["r8s"], prompt_text=PROMPT_TEXT, prompt_wav=prompt,
              prompt_sr=sr, num_step=N_STEP, guidance_scale=1.0)
    return pipeline, kw


def compare_fused_rtf(root: Path, card: str):
    """Phase 5b: warm RTF of the ~8 s request with the fused eval path off
    and on, f32 and bf16: one warm request of each, then 8 in turns (off,
    on, on, off, twice); returns {dtype: {"unfused"|"fused": median}}."""
    import contextlib

    import numpy as np

    out = {}
    for dtype in ("float32", "bfloat16"):
        pipeline, kw = _r8s_pipeline(root, dtype)

        def rtf(fused):
            with _FusedEval() if fused else contextlib.nullcontext():
                return pipeline.synthesize(**kw).metrics["rtf"]

        rtf(False)
        rtf(True)
        runs = {False: [], True: []}
        for fused in (False, True, True, False) * 2:
            runs[fused].append(rtf(fused))
        out[dtype] = {"unfused": float(np.median(runs[False])),
                      "fused": float(np.median(runs[True]))}
        print(f"rtf r8s {dtype}: unfused {out[dtype]['unfused']:.5f} "
              f"{[round(x, 5) for x in runs[False]]}, fused {out[dtype]['fused']:.5f} "
              f"{[round(x, 5) for x in runs[True]]} (medians of 4 warm requests in turns) "
              f"on {card}", flush=True)
        del pipeline
    return out


def eager_synthesize(pipeline, kw):
    """The composition that ``synthesize`` runs, with the captured functions
    called eagerly (no graph): tokens, prompt fbank, the sampler, the
    vocoder and the PCM16 readback.  Returns (wall s, wav seconds)."""
    import torch

    t0 = time.monotonic()
    tok = pipeline.tokenizer.texts_to_token_ids
    pf, _ = pipeline.prompt_features(kw["prompt_wav"], kw["prompt_sr"])
    s = pipeline._prepare_sample_inputs(tok([kw["text"]])[0], tok([kw["prompt_text"]])[0],
                                        pf, 1.0, 666)
    with torch.no_grad():
        mel = pipeline._sample_fn(N_STEP, 1.0, 0.5).fn(*s.args)
        pcm = pipeline._vocode_i16_fn().fn(mel)[0].cpu()
    wall = time.monotonic() - t0
    samples = (s.gen_lens[0] - 1) * pipeline.vocos_cfg.hop_length
    if pcm.shape[-1] < samples:
        raise AssertionError(f"eager pcm {tuple(pcm.shape)} shorter than {samples}")
    return wall, samples / pipeline.feat_cfg.sampling_rate


def profile_request(root: Path, card: str, fused: bool = False, replayed: bool = False):
    """Phase 6c: one warm f32 ~8 s request (the fused eval path on when
    `fused`) under torch.profiler, the captured functions run eagerly; 6d
    (`replayed`): the same request through ``synthesize``, its graphs
    replayed.  Prints the device busy share, the summed device time and
    calls of B1 and B2 (fused: B2, B6, B7 and B9) and the kernels that take
    the most device time; with --profile the trace goes to the output
    directory if present.  Returns {kernel: (device ms, calls)}, the device
    busy ms and the wall ms."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    pipeline, kw = _r8s_pipeline(root, "float32")

    def request():
        if replayed:
            res = pipeline.synthesize(**kw)
            return res.metrics["t"], res.metrics["wav_seconds"]
        return eager_synthesize(pipeline, kw)

    with _FusedEval() if fused else contextlib.nullcontext():
        request()  # warm (and, replayed, captured)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            _, secs = request()
            wall = time.monotonic() - t0

    from torch.autograd import DeviceType

    rows = _profile_rows(prof)
    if replayed:  # few host events: key_averages is cheap here, and holds the rows
        _check_rows(prof, rows)
    # device-side entries only (CPU ops repeat their kernels' time)
    events = sorted((e for e in rows.values() if e.device_type == DeviceType.CUDA),
                    key=_dev_us, reverse=True)
    busy = sum(_dev_us(e) for e in events) / 1e6
    dev = {k: _kernel_device_ms(events, k)
           for k in (("B2", "B6", "B7", "B9") if fused else ("B1", "B2"))}
    tag = ("r8s_f32_fused" if fused else "r8s_f32") + ("_replayed" if replayed else "_eager")
    if replayed and not any(n for _, n in dev.values()):
        print(f"profile {tag}: wall {wall * 1e3:.1f} ms; the profiler did not resolve the "
              f"kernels inside the graph launch ({len(events)} device entries, "
              f"{busy * 1e3:.1f} ms) on {card}", flush=True)
        return dev, None, wall * 1e3
    print(f"profile {tag}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%), rtf {wall / secs:.4f}; "
          + ", ".join(f"{k} {ms:.3f} ms in {n} kernel calls" for k, (ms, n) in dev.items())
          + f" on {card}", flush=True)
    for e in events[:15]:
        print(f"  {_dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    out = REPO / "chiprun_out"
    if "--profile" in sys.argv[1:] and out.is_dir():
        prof.export_chrome_trace(str(out / f"trace_{tag}.json"))
    return dev, busy * 1e3, wall * 1e3


def _r8s_inputs(pipeline, kw, text=None, seed=666):
    tok = pipeline.tokenizer.texts_to_token_ids
    pf, _ = pipeline.prompt_features(kw["prompt_wav"], kw["prompt_sr"])
    return pipeline._prepare_batch([tok([text or kw["text"]])[0]], [tok([kw["prompt_text"]])[0]],
                                   [pf], 1.0, seed)


def _diff(a, b):
    """(largest |a - b| as float, bitwise equal)."""
    import torch

    return float((a.float() - b.float()).abs().max()), bool(torch.equal(a, b))


def check_graphs(root: Path, card: str):
    """Phases 5c-5e, f32 and bf16, on the ~8 s request (r8s):
    5c. the replayed sampler and the replayed one-program PCM16 against the
        captured functions run eagerly on the same inputs and noise,
        unfused and with the fused eval path: bit for bit (tolerance 0: a
        replay runs the captured kernels on the same inputs, and no kernel
        of the path uses atomics);
    5d. the batch-4 sampler and vocoder, 4 requests of one bucket with their
        own seeds, row by row against each request replayed alone (printed:
        the batch changes the matrix shapes that cuBLAS and cuDNN see);
    5e. warm RTF of the eager composition against ``synthesize`` and
        ``synthesize_fused`` replayed, medians of 4 in turns.
    Returns {dtype: {...}}."""
    import contextlib

    import numpy as np
    import torch

    out = {}
    for dtype in ("float32", "bfloat16"):
        pipeline, kw = _r8s_pipeline(root, dtype)
        s = _r8s_inputs(pipeline, kw)
        res = out[dtype] = {}
        for fused in (False, True):
            with _FusedEval() if fused else contextlib.nullcontext():
                for name, prog in (("sample", pipeline._sample_fn(N_STEP, 1.0, 0.5)),
                                   ("sample_pcm", pipeline._sample_pcm_fn(N_STEP, 1.0, 0.5))):
                    first = prog(*s.args)  # eager, then captured
                    replayed = prog(*s.args)
                    with torch.no_grad():
                        eager = prog.fn(*s.args)
                    err, same = _diff(replayed, eager)
                    first_same = _diff(first, eager)[1]
                    tag = f"{name} {dtype}{' fused' if fused else ''}"
                    unit = "mel" if name == "sample" else "PCM16 counts"
                    print(f"replay vs eager {tag}: max |diff| {err:.3g} {unit}, bitwise "
                          f"{same} (first call bitwise {first_same}) on {card}", flush=True)
                    if not (same and first_same and torch.isfinite(eager.float()).all()):
                        raise AssertionError(f"replay differs from eager: {tag}: {err}")
                    res[tag] = err

        # 5d: four requests of one bucket (texts of the r8s length)
        texts = [(BASE * 3)[7 * i: 7 * i + len(kw["text"])] for i in range(4)]
        seeds = [11, 12, 13, 14]
        tok = pipeline.tokenizer.texts_to_token_ids
        pf, _ = pipeline.prompt_features(kw["prompt_wav"], kw["prompt_sr"])
        p_tok = tok([kw["prompt_text"]])[0]
        batch = pipeline._prepare_batch([tok([t])[0] for t in texts], [p_tok] * 4, [pf] * 4,
                                        1.0, 0, seeds)
        sample, vocode = pipeline._sample_fn(N_STEP, 1.0, 0.5), pipeline._vocode_i16_fn()
        sample(*batch.args)
        mel4 = sample(*batch.args)
        vocode(mel4)
        pcm4 = vocode(mel4)
        mel_err, pcm_err, bitwise = 0.0, 0.0, True
        for i, (text, seed) in enumerate(zip(texts, seeds)):
            one = pipeline._prepare_batch([tok([text])[0]], [p_tok], [pf], 1.0, 0, [seed])
            if (one.args[0].shape[1] != batch.args[0].shape[1]
                    or one.noise.shape[1] != batch.noise.shape[1]):
                raise AssertionError("batch rows left the single request's bucket")
            mel1 = sample(*one.args)
            pcm1 = vocode(mel1)
            e1, b1 = _diff(mel4[i], mel1[0])
            e2, b2 = _diff(pcm4[i], pcm1[0])
            mel_err, pcm_err, bitwise = max(mel_err, e1), max(pcm_err, e2), bitwise and b1 and b2
        if not torch.isfinite(mel4.float()).all():
            raise AssertionError(f"batch-4 mel not finite ({dtype})")
        print(f"batch-4 rows vs batch-1 replays {dtype} (B=4, s_pad "
              f"{batch.args[0].shape[1]}, t_pad {batch.noise.shape[1]}): max |diff| mel "
              f"{mel_err:.3g}, PCM16 {pcm_err:.0f} counts, bitwise {bitwise} on {card}",
              flush=True)
        res["batch4"] = dict(mel=mel_err, pcm=pcm_err, bitwise=bitwise)

        # 5e: eager composition against synthesize and synthesize_fused replayed
        def synth(mode):
            if mode == "eager":
                wall, secs = eager_synthesize(pipeline, kw)
                return wall / secs
            fn = pipeline.synthesize if mode == "replay" else pipeline.synthesize_fused
            return fn(**kw).metrics["rtf"]

        for mode in ("eager", "replay", "fused"):
            synth(mode)
        runs = {"eager": [], "replay": [], "fused": []}
        for order in (("eager", "replay", "fused"), ("fused", "replay", "eager")) * 2:
            for mode in order:
                runs[mode].append(synth(mode))
        med = {m: float(np.median(v)) for m, v in runs.items()}
        res["rtf"] = med
        print(f"rtf r8s {dtype}: eager {med['eager']:.5f} "
              f"{[round(x, 5) for x in runs['eager']]}, synthesize replayed "
              f"{med['replay']:.5f} {[round(x, 5) for x in runs['replay']]}, "
              f"synthesize_fused replayed {med['fused']:.5f} "
              f"{[round(x, 5) for x in runs['fused']]} (medians of 4 warm requests in turns; "
              f"{pipeline.captures} graphs captured) on {card}", flush=True)
        del pipeline
    return out


SERVE_PROMPT_TEXT = "slow prompt text"
LONG_TEXT = (BASE * 7)[:440]


def serve_on_card(root: Path, card: str):
    """Phase 11: the serving entry point on the card.  The serve CLI's
    pipeline (bf16, its default) is warmed with batch 4, a TTSServer on a
    free port answers one request in the warmed bucket, four concurrent
    ones (batched, /stats), a long_form request, a /synthesize_stream
    request and a silent prompt (400).  Checks every wav's length and
    finiteness, that the warmed-bucket requests captured nothing and their
    launches (B1 260 and B2 520 a sampler call); prints each request's
    buckets and latency.  Returns the launches and the numbers."""
    import base64
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav, read_wav_bytes, wav_bytes
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline
    from zipvoice_tpu_torch.bin.serve import get_parser
    from zipvoice_tpu_torch.serve.server import TTSServer

    args = get_parser().parse_args([
        "--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
        "--tokenizer", "simple", "--max-batch", "4", "--device", "cuda"])
    pipeline, num_step, gs = build_pipeline(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pipeline.warmup(num_step=num_step, guidance_scale=gs, batch_sizes=(args.max_batch,))
    warm_s = time.monotonic() - t0
    warmed = pipeline.captures
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve warmup ({args.dtype}, batch_sizes=({args.max_batch},)): {warm_s:.1f} s, "
          f"{warmed} graphs captured, max_memory_allocated {peak:.2f} GiB on {card}", flush=True)

    # the bucket warmup() captures: 10 s, 64 tokens, a quarter of each as prompt
    _, s_w, t_w = pipeline._buckets(64, 16, int(10.0 * pipeline.feat_cfg.frame_rate) // 4, 1.0)
    prompt, sr = read_wav(root / "prompt.wav")
    pf_frames = int(pipeline.prompt_features(prompt, sr)[0].shape[0])
    n_prompt = len(SERVE_PROMPT_TEXT)
    lengths = [n for n in range(1, 200)
               if pipeline._buckets(n, n_prompt, pf_frames, 1.0)[1:] == (s_w, t_w)]
    if len(lengths) < 5:
        raise AssertionError(f"only {lengths} text lengths land in ({s_w}, {t_w})")
    texts = [(BASE * 2)[i: i + n] for i, n in enumerate(lengths[:5])]
    hop = pipeline.vocos_cfg.hop_length

    def payload(text, prompt_text=SERVE_PROMPT_TEXT, wav=prompt, **extra):
        return {"text": text, "prompt_text": prompt_text,
                "prompt_wav_b64": base64.b64encode(wav_bytes(wav, sr)).decode(),
                "seed": 7, **extra}

    srv = TTSServer(pipeline, port=0, max_batch=4, max_wait_ms=200.0, num_step=num_step,
                    guidance_scale=gs)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def post(path, body, timeout=600):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                     data=json.dumps(body).encode(), method="POST")
        t = time.monotonic()
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            data = resp.read()
        return data, time.monotonic() - t

    def stats():
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=30) as r:
            return json.loads(r.read())

    def check_wav(data, text, what):
        wav, wsr = read_wav_bytes(data)
        total, s_pad, t_pad = pipeline._buckets(len(text), n_prompt, pf_frames, 1.0)
        want = (total - pf_frames - 1) * hop
        if wsr != sr or wav.shape != (1, want) or not np.isfinite(wav).all():
            raise AssertionError(f"{what}: wav {wav.shape} at {wsr}, want (1, {want})")
        return s_pad, t_pad, want / sr

    counters = _counters()
    try:
        for c in counters.values():
            c.launches = 0
        data, lat = post("/synthesize", payload(texts[0]))
        s_pad, t_pad, secs = check_wav(data, texts[0], "single request")
        single = {k: c.launches for k, c in counters.items()}
        print(f"serve single request: s_pad {s_pad}, t_pad {t_pad} (warmed {s_w}, {t_w}), "
              f"{secs:.2f} s audio, latency {lat * 1e3:.1f} ms, launches B1 {single['B1']} "
              f"B2 {single['B2']} on {card}", flush=True)

        before = stats()
        results = [None] * 4

        def hit(i):
            results[i] = post("/synthesize", payload(texts[1 + i], seed=20 + i))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError("a concurrent request did not finish")
        after = stats()
        batches = after["batches"] - before["batches"]
        for i, (data, lat) in enumerate(results):
            s_pad, t_pad, secs = check_wav(data, texts[1 + i], f"batched request {i}")
            print(f"serve concurrent request {i}: s_pad {s_pad}, t_pad {t_pad}, {secs:.2f} s "
                  f"audio, latency {lat * 1e3:.1f} ms", flush=True)
        launched = {k: c.launches for k, c in counters.items()}
        want = {k: UNFUSED_PER_REQUEST.get(k, 0) * (1 + batches) for k in counters}
        print(f"serve batch: 4 requests in {batches} batch(es) (/stats requests "
              f"{after['requests'] - before['requests']}), launches {launched}, captures "
              f"at request time {pipeline.captures - warmed} on {card}", flush=True)
        if batches >= 4 or after["requests"] - before["requests"] != 4 or launched != want:
            raise AssertionError(f"batching: {batches} batches, launches {launched}, "
                                 f"want {want}")
        if pipeline.captures != warmed:
            raise AssertionError(f"warmed-bucket requests captured "
                                 f"{pipeline.captures - warmed} graphs")

        data, lat = post("/synthesize", payload(LONG_TEXT, PROMPT_TEXT, long_form=True))
        long_wav, _ = read_wav_bytes(data)
        chunks = len(pipeline._long_form_plan(LONG_TEXT, 20.0))
        print(f"serve long_form request: {chunks} chunks, {long_wav.shape[-1] / sr:.2f} s "
              f"audio, latency {lat * 1e3:.1f} ms", flush=True)
        data, lat = post("/synthesize_stream", payload(LONG_TEXT, PROMPT_TEXT))
        pcm = np.frombuffer(data[44:], dtype="<i2")
        print(f"serve stream request: {pcm.size / sr:.2f} s audio, latency "
              f"{lat * 1e3:.1f} ms", flush=True)
        if (chunks < 2 or data[:4] != b"RIFF" or pcm.size != long_wav.shape[-1]
                or not np.isfinite(long_wav).all()):
            raise AssertionError(f"long form {long_wav.shape} vs stream {pcm.size} samples, "
                                 f"{chunks} chunks")
        try:
            post("/synthesize", payload(texts[0], wav=np.zeros_like(prompt)))
            raise AssertionError("a silent prompt was served")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        print(f"serve silent prompt: HTTP 400; /stats {stats()} on {card}", flush=True)
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    launches = {k: c.launches for k, c in counters.items()}
    return launches, dict(warmup_s=warm_s, captures=warmed, peak_gib=peak, batches=batches)


# the variants (phase 12): 16 fm_decoder layers a step, 4 text-encoder
# layers a request; distill makes one batch-B call a step (no CFG), the
# dialog models one 2B CFG batch a step
DISTILL_STEPS, DIALOG_STEPS = 8, 16
VARIANT_PINS = {
    "zipvoice_distill": {"B1": 4 + DISTILL_STEPS * 16, "B2": 2 * (4 + DISTILL_STEPS * 16)},
    "zipvoice_dialog": {"B1": 4 + DIALOG_STEPS * 16, "B2": 2 * (4 + DIALOG_STEPS * 16)},
}
VARIANT_PINS["zipvoice_dialog_stereo"] = VARIANT_PINS["zipvoice_dialog"]
VARIANT_SEEDS = {"zipvoice_distill": 2, "zipvoice_dialog": 3, "zipvoice_dialog_stereo": 4}
DIALOG_PROMPTS = ("this is the first speaker", "and this is the second one")
DIALOG_TEXT = ("[S1] the quick brown fox jumps over the lazy dog. "
               "[S2] and then it runs away, far away from here.")


def make_variant_assets(root: Path):
    """Phase 12 assets: a full-width (123M) model dir a variant with seeded
    random weights, sharing one emilia-layout tokens.txt (the espeak block,
    filler tokens, [S1]/[S2] at 360/361 as in the released dialog
    vocabulary) and the base model.json; two 1.5 s split prompts."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, save_model_json
    from zipvoice_tpu_torch.models.dialog import init_zipvoice_dialog
    from zipvoice_tpu_torch.models.distill import distill_config
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
    from zipvoice_tpu_torch.text.tokenizer import write_token_file

    token2id = dict(VENDORED_ESPEAK_MAP)
    token2id.update({f"<filler{i}>": i for i in range(len(token2id), 360)})
    token2id.update({"[S1]": 360, "[S2]": 361})
    cfg = ZipVoiceConfig(vocab_size=len(token2id), pad_id=0)
    dirs = {}
    for name, seed in VARIANT_SEEDS.items():
        d = root / name
        d.mkdir()
        write_token_file(token2id, str(d / "tokens.txt"))
        save_model_json(d / "model.json", cfg, FeatureConfig())
        g = torch.Generator().manual_seed(seed)
        if name == "zipvoice_distill":
            model = init_zipvoice(distill_config(cfg), g)
        else:
            model = init_zipvoice_dialog(cfg, stereo=name.endswith("stereo"), generator=g)
        torch.save({"model": model.state_dict()}, d / "model.pt")
        del model
        dirs[name] = d
    sr = 24000
    tt = np.arange(int(1.5 * sr)) / sr
    rng = np.random.default_rng(5)
    for i, f0 in enumerate((180.0, 260.0)):
        wav = (0.08 * np.sin(2 * np.pi * f0 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 4 * tt))
               + 0.01 * rng.standard_normal(tt.shape)).astype(np.float32)
        write_wav(root / f"speaker{i + 1}.wav", wav, sr)
    return dirs


def _variant_argv(name: str, d: Path, root: Path):
    """The CLI arguments of a variant: its model dir, the Vocos checkpoint,
    f32 on the card, every sampling default the model's."""
    return ["--model-name", name, "--model-dir", str(d), "--vocoder-path",
            str(root / "vocos.bin"), "--device", "cuda"]


def _variant_requests(name: str, root: Path):
    """(test-list lines, [(text, prompt text, prompt samples)]): distill
    takes two English requests on the 3 s prompt (the second in the first
    one's buckets); dialog two requests with split [S1]/[S2] prompts."""
    if name == "zipvoice_distill":
        rows = [("d0", TEXTS["r8s"]), ("d1", TEXTS["r8s"][:-3])]
        lines = "".join(f"{n}\t{PROMPT_TEXT}\t{root / 'prompt.wav'}\t{t}\n" for n, t in rows)
        return lines, [(n, t, PROMPT_TEXT, 3 * 24000) for n, t in rows]
    p1, p2 = DIALOG_PROMPTS
    rows = [("g0", DIALOG_TEXT), ("g1", DIALOG_TEXT[:-6] + ".")]
    lines = "".join(f"{n}\t{p1}\t{root / 'speaker1.wav'}\t{p2}\t{root / 'speaker2.wav'}"
                    f"\t{t}\n" for n, t in rows)
    return lines, [(n, t, f"[S1]{p1}[S2]{p2}", 3 * 24000) for n, t in rows]


def run_variant_cli(name: str, d: Path, root: Path, card: str):
    """Phase 12a: a variant's CLI (infer_zipvoice for distill,
    infer_zipvoice_dialog for the dialog models) over two requests with
    its default tokenizer (emilia; dialog), steps and guidance.  Checks
    each wav's channel count and length and the launches a request;
    returns the launches and the requests' RTF."""
    import numpy as np

    from zipvoice_tpu_torch.audio.mel import compute_num_frames
    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin import infer_zipvoice, infer_zipvoice_dialog
    from zipvoice_tpu_torch.io.model_dir import MODEL_REGISTRY
    from zipvoice_tpu_torch.models.zipvoice import predict_features_lens
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    lines, reqs = _variant_requests(name, root)
    lst = root / f"list_{name}.tsv"
    lst.write_text(lines)
    out_dir = root / f"out_{name}"
    cli = infer_zipvoice if name == "zipvoice_distill" else infer_zipvoice_dialog
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    metrics = cli.main(_variant_argv(name, d, root)
                       + ["--test-list", str(lst), "--res-dir", str(out_dir)])
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: VARIANT_PINS[name].get(k, 0) * len(reqs) for k in counters}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
    tok = get_tokenizer(MODEL_REGISTRY[name]["tokenizer"], str(d / "tokens.txt"))
    channels = 2 if name.endswith("stereo") else 1
    for (n, text, prompt_text, prompt_samples), m in zip(reqs, metrics):
        pf = compute_num_frames(prompt_samples, 256)
        n_p, n_t = (len(tok.texts_to_token_ids([x])[0]) for x in (prompt_text, text))
        total = int(predict_features_lens(np.array([pf]), np.array([n_p]),
                                          np.array([n_t]))[0])
        want_shape = (channels, (total - pf - 1) * 256)
        wav, sr = read_wav(out_dir / f"{n}.wav")
        if sr != 24000 or wav.shape != want_shape or not np.isfinite(wav).all():
            raise AssertionError(f"{name} {n}: wav {wav.shape} at {sr}, want {want_shape}")
        print(f"variant {name} request {n}: {n_t} tokens, {wav.shape[0]} channel(s), "
              f"{m['wav_seconds']:.2f} s audio, rtf {m['rtf']:.4f} on {card}", flush=True)
    return launches, [m["rtf"] for m in metrics]


def check_variant_graphs(name: str, d: Path, root: Path, card: str):
    """Phase 12b: the variant's pipeline (the CLI's, f32): the sampler and
    the one-program PCM16 replayed equal the captured functions run eagerly
    on the same inputs and noise, bit for bit; one replay of the sampler
    launches the pins; the median warm RTF of ``synthesize`` (4 after one
    warm).  Returns (replay launches, median RTF)."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin import infer_zipvoice, infer_zipvoice_dialog
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline

    cli = infer_zipvoice if name == "zipvoice_distill" else infer_zipvoice_dialog
    args = cli.get_parser().parse_args(_variant_argv(name, d, root))
    pipeline, num_step, gs = build_pipeline(args)
    _, reqs = _variant_requests(name, root)
    _, text, prompt_text, _ = reqs[0]
    if name == "zipvoice_distill":
        prompt, sr = read_wav(root / "prompt.wav")
    else:
        a = argparse.Namespace(prompt_wav=None, prompt_text_1=DIALOG_PROMPTS[0],
                               prompt_wav_1=str(root / "speaker1.wav"),
                               prompt_text_2=DIALOG_PROMPTS[1],
                               prompt_wav_2=str(root / "speaker2.wav"))
        prompt_text, prompt = infer_zipvoice_dialog.load_merged_prompt(
            a, 24000, name.endswith("stereo"))
        sr = 24000
    tokens, prompt_tokens, pf, _ = pipeline._request_inputs(text, prompt_text, prompt, sr,
                                                            0.1, None)
    s = pipeline._prepare_batch([tokens], [prompt_tokens], [pf], 1.0, 666)
    counters = _counters()
    replay_launches = None
    for prog_name, prog in (("sample", pipeline._sample_fn(num_step, gs, 0.5)),
                            ("sample_pcm", pipeline._sample_pcm_fn(num_step, gs, 0.5))):
        first = prog(*s.args)  # eager, then captured
        for c in counters.values():
            c.launches = 0
        replayed = prog(*s.args)
        if prog_name == "sample":
            replay_launches = {k: c.launches for k, c in counters.items()}
        with torch.no_grad():
            eager = prog.fn(*s.args)
        err, same = _diff(replayed, eager)
        first_same = _diff(first, eager)[1]
        print(f"variant {name} replay vs eager {prog_name}: shape {tuple(eager.shape)}, "
              f"max |diff| {err:.3g}, bitwise {same} (first call bitwise {first_same}) "
              f"on {card}", flush=True)
        if not (same and first_same and torch.isfinite(eager.float()).all()):
            raise AssertionError(f"{name}: replay differs from eager ({prog_name}): {err}")
    want = {k: VARIANT_PINS[name].get(k, 0) for k in counters}
    if replay_launches != want:
        raise AssertionError(f"{name}: a replay launched {replay_launches}, want {want}")
    kw = dict(text=text, prompt_text=prompt_text, prompt_wav=prompt, prompt_sr=sr,
              num_step=num_step, guidance_scale=gs)
    pipeline.synthesize(**kw)
    rtfs = [pipeline.synthesize(**kw).metrics["rtf"] for _ in range(4)]
    med = float(np.median(rtfs))
    print(f"variant {name} warm rtf {med:.5f} {[round(x, 5) for x in rtfs]} (median of 4, "
          f"{num_step} steps, guidance {gs}, {pipeline.captures} graphs captured) on {card}",
          flush=True)
    del pipeline
    return replay_launches, med


def check_variant_forward(name: str, d: Path):
    """Phase 12c: one full-width fm_decoder velocity of the variant on the
    card (kernels) against the CPU (plain versions), same weights and
    inputs, T=256 with a padded tail: distill with its guidance scale
    embedded (3.0), dialog at 3F, stereo at 5F (stream 0, 2F out)."""
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.zipvoice import forward_fm_decoder

    model = load_model_dir(str(d), model_name=name).model.eval()
    g = torch.Generator().manual_seed(6)
    b, t, f = 2, 256, model.cfg.feat_dim
    c = 2 if name.endswith("stereo") else 1
    xt, sc = (torch.randn((b, t, c * f), generator=g) for _ in range(2))
    tc = torch.randn((b, t, f), generator=g)
    mask = torch.arange(t)[None, :] >= torch.tensor([t, 200])[:, None]
    gs = 3.0 if name == "zipvoice_distill" else None
    with torch.no_grad():
        ref = forward_fm_decoder(model, 0.3, xt, tc, sc, mask, guidance_scale=gs)
        model = model.cuda()
        out = forward_fm_decoder(model, 0.3, xt.cuda(), tc.cuda(), sc.cuda(), mask.cuda(),
                                 guidance_scale=gs).cpu()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"variant {name} fm_decoder forward card vs CPU: out {tuple(out.shape)}, "
          f"max_abs_err {err:.3g} (|ref| max {scale:.3g}, tol {1e-3 * scale:.3g})", flush=True)
    if out.shape != (b, t, c * f) or not err <= 1e-3 * scale:
        raise AssertionError(f"{name} fm_decoder card vs CPU: {tuple(out.shape)}, {err}")
    return err


def run_variants(root: Path, card: str):
    """Phase 12: ZipVoice-Distill, ZipVoice-Dialog and ZipVoice-Dialog-Stereo
    at full width through their CLIs (12a), their pipelines' graphs (12b)
    and one fm_decoder forward card vs CPU (12c).  Returns {name: {...}}."""
    import torch

    from zipvoice_tpu_torch.text.tokenizer import active_g2p_backend

    print(f"G2P backend for en-us: {active_g2p_backend('en-us')}", flush=True)
    t0 = time.monotonic()
    dirs = make_variant_assets(root)
    print(f"variant assets: {sorted(dirs)} in {time.monotonic() - t0:.1f} s", flush=True)
    out = {}
    for name, d in dirs.items():
        launches, cli_rtf = run_variant_cli(name, d, root, card)
        replay_launches, rtf = check_variant_graphs(name, d, root, card)
        err = check_variant_forward(name, d)
        out[name] = dict(launches=launches, replay_launches=replay_launches,
                         cli_rtf=cli_rtf, rtf=rtf, fwd_err=err)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 13: the BigVGAN vocoder (13a) and the variants' training recipes (13b)
# ---------------------------------------------------------------------------

BIGVGAN_CONF = REPO / "egs" / "zipvoice" / "conf" / "zipvoice_base_bigvgan_v2.json"
TEXT_LAYERS, FM_LAYERS = 4, 16
# a distill step (either stage): the teacher's text encoder once and its two
# fm_decoder hops without autograd (B1 a layer, B2 twice), the student's text
# encoder without autograd, its fm_decoder hop with autograd and no
# regularizers (B1 forward + recompute, B2 both, B4 once a layer), B8 a batch
DISTILL_PER_STEP = {"B1": 2 * TEXT_LAYERS + 2 * FM_LAYERS + 2 * FM_LAYERS,
                    "B2": 2 * (2 * TEXT_LAYERS + 2 * FM_LAYERS + 2 * FM_LAYERS),
                    "B4": FM_LAYERS, "B8": 1}
# a dialog or stereo step: the base step with the regularizers on its widths
# (the stereo batch's 3B fbank rows in one B8 launch)
DIALOG_PER_STEP = {k: v for k, v in PER_STEP.items() if k != "B4"}
RECIPE_STEPS = {"distill stage 1": 3, "distill stage 2": 3, "dialog": 3, "stereo": 4}


def make_bigvgan_assets(root: Path):
    """13a assets: a model dir from the repo's bigvgan configuration
    (``egs/zipvoice/conf/zipvoice_base_bigvgan_v2.json``, the published
    widths with bigvgan features) with seeded random full-width weights
    and phase 4's character tokens, and a random full-width BigVGAN
    generator (``BigVGANConfig()``) saved as the published checkpoint:
    weight-normed convs (weight_v = w, weight_g = |w|), the snake
    parameters under ``.act.``, every key under ``generator.``.  Returns
    (model dir, generator checkpoint, generator parameters)."""
    import torch

    from zipvoice_tpu_torch.audio.bigvgan import BigVGANConfig, init_bigvgan
    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    d = root / "bigvgan_model"
    d.mkdir()
    shutil.copy(BIGVGAN_CONF, d / "model.json")
    shutil.copy(root / "tokens.txt", d / "tokens.txt")
    tok = get_tokenizer("simple", str(d / "tokens.txt"))
    cfg, feat = load_model_json(d / "model.json", vocab_size=tok.vocab_size, pad_id=tok.pad_id)
    if feat.type != "bigvgan":
        raise AssertionError(f"{BIGVGAN_CONF} has {feat.type!r} features")
    model = init_zipvoice(cfg, torch.Generator().manual_seed(13))
    torch.save({"model": model.state_dict()}, d / "model.pt")
    del model
    gen = init_bigvgan(BigVGANConfig(), torch.Generator().manual_seed(14))
    sd = {}
    for k, v in gen.state_dict().items():
        if k.endswith(".weight"):
            sd[f"generator.{k}_v"] = v
            sd[f"generator.{k}_g"] = torch.sqrt(torch.sum(v.double() ** 2, dim=(1, 2),
                                                          keepdim=True)).float()
        elif k.endswith(("alpha", "beta")):
            head, name = k.rsplit(".", 1)
            sd[f"generator.{head}.act.{name}"] = v
        else:
            sd[f"generator.{k}"] = v
    path = root / "bigvgan_generator.pt"
    torch.save(sd, path)
    return d, path, sum(p.numel() for p in gen.parameters())


def check_bigvgan_decode(gen_path: Path, card: str):
    """13a: the generator on ~0.5 s of mel (47 frames) on the card against
    the CPU, f32 (cuDNN's convolutions at PyTorch's defaults), and the card
    in bf16 (as the pipeline casts the vocoder) against the card in f32.
    Returns (f32 error, bf16 error) in wave units (full scale 1)."""
    import torch

    from zipvoice_tpu_torch.audio.bigvgan import bigvgan_decode, build_bigvgan
    from zipvoice_tpu_torch.bin.infer_zipvoice import load_vocoder_params

    params = load_vocoder_params(str(gen_path), "bigvgan")
    mel = torch.randn((1, 47, 100), generator=torch.Generator().manual_seed(15)) * 2.0 - 4.0
    with torch.no_grad():
        ref = bigvgan_decode(build_bigvgan(params), mel)
        out = bigvgan_decode(build_bigvgan({k: v.cuda() for k, v in params.items()}),
                             mel.cuda())
        out16 = bigvgan_decode(build_bigvgan({k: v.cuda().bfloat16()
                                              for k, v in params.items()}),
                               mel.cuda().bfloat16())
    err = float((out.cpu() - ref).abs().max())
    err16 = float((out16.float() - out).abs().max())
    clipped = float((ref.abs() >= 1.0).float().mean())
    print(f"bigvgan decode card vs CPU (f32, 47 frames -> {ref.shape[-1]} samples, "
          f"{100 * clipped:.1f}% at the clamp; cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}): max_abs_err {err:.3g} (tol 1e-2); bf16 vs f32 "
          f"on the card {err16:.3g}, |wave| max {float(ref.abs().max()):.3g} on {card}",
          flush=True)
    if ref.shape != (1, 47 * 256) or not err <= 1e-2 or not torch.isfinite(out16).all():
        raise AssertionError(f"bigvgan decode card vs CPU: {tuple(ref.shape)}, {err}, {err16}")
    return err, err16


def check_bigvgan_log_mel(card: str):
    """13a: the bigvgan log-mel of 10 s of audio at B=2 on the card against
    the CPU (both the f32 DFT product; tolerance 1e-3 on log values)."""
    import torch

    from zipvoice_tpu_torch.audio.mel import bigvgan_log_mel
    from zipvoice_tpu_torch.config import FeatureConfig

    cfg = FeatureConfig(type="bigvgan")
    wav = 0.1 * torch.randn((2, 240000), generator=torch.Generator().manual_seed(16))
    ref = bigvgan_log_mel(wav, cfg)
    out = bigvgan_log_mel(wav.cuda(), cfg).cpu()
    err = float((out - ref).abs().max())
    print(f"bigvgan log-mel card vs CPU (B=2, 10 s, {tuple(ref.shape)}): max_abs_err "
          f"{err:.3g} (tol 1e-3) on {card}", flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"bigvgan log-mel card vs CPU: {err}")
    return err


def run_bigvgan(root: Path, card: str):
    """Phase 13a: a bigvgan model dir through the infer CLI (two f32
    requests, one bf16; launches pinned at the base request's B1 260 / B2
    520), the one-program PCM16 replayed equal to its eager run bit for
    bit, the warm f32 RTF of the ~8 s request (median of 4) in turns with
    phase 4's Vocos model dir and the vocoder's share of the request, the
    generator and the bigvgan log-mel card vs CPU.  Returns a dict."""
    import numpy as np
    import torch

    t0 = time.monotonic()
    d, gen_path, n_gen = make_bigvgan_assets(root)
    print(f"bigvgan assets: {n_gen / 1e6:.1f}M-parameter generator in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    metrics, launches = run_cli(root, ["r4s", "r8s"], "float32", card, model_dir=d,
                                vocoder=gen_path)
    run_cli(root, ["r8s"], "bfloat16", card, model_dir=d, vocoder=gen_path)

    pipeline, kw = _r8s_pipeline(root, "float32", model_dir=d, vocoder=gen_path)
    if pipeline.vocoder != "bigvgan":
        raise AssertionError(f"the bigvgan model dir built a {pipeline.vocoder} pipeline")
    s = _r8s_inputs(pipeline, kw)
    counters = _counters()
    prog = pipeline._sample_pcm_fn(N_STEP, 1.0, 0.5)
    first = prog(*s.args)  # eager, then captured
    for c in counters.values():
        c.launches = 0
    replayed = prog(*s.args)
    replay_launches = {k: c.launches for k, c in counters.items()}
    with torch.no_grad():
        eager = prog.fn(*s.args)
    err, same = _diff(replayed, eager)
    first_same = _diff(first, eager)[1]
    print(f"bigvgan replay vs eager sample_pcm f32: shape {tuple(eager.shape)}, max |diff| "
          f"{err:.3g} PCM16 counts, bitwise {same} (first call bitwise {first_same}) on {card}",
          flush=True)
    if not (same and first_same):
        raise AssertionError(f"bigvgan: replay differs from eager: {err}")
    want = {k: UNFUSED_PER_REQUEST.get(k, 0) for k in counters}
    if replay_launches != want:
        raise AssertionError(f"bigvgan: a replay launched {replay_launches}, want {want}")

    vocos, vkw = _r8s_pipeline(root, "float32")
    rtf, vocos_rtf, share = [], [], []
    pipeline.synthesize(**kw)
    vocos.synthesize(**vkw)
    for _ in range(4):
        m = pipeline.synthesize(**kw).metrics
        rtf.append(m["rtf"])
        share.append(m["t_vocoder"] / m["t"])
        vocos_rtf.append(vocos.synthesize(**vkw).metrics["rtf"])
    med = {k: float(np.median(v)) for k, v in
           (("bigvgan", rtf), ("vocos", vocos_rtf), ("share", share))}
    print(f"bigvgan warm rtf {med['bigvgan']:.5f} {[round(x, 5) for x in rtf]} against Vocos "
          f"{med['vocos']:.5f} {[round(x, 5) for x in vocos_rtf]} (r8s f32, medians of 4 in "
          f"turns); the vocoder's share of a bigvgan request {100 * med['share']:.1f}% on {card}",
          flush=True)
    del pipeline, vocos
    gc.collect()
    torch.cuda.empty_cache()
    dec_err, dec_err16 = check_bigvgan_decode(gen_path, card)
    mel_err = check_bigvgan_log_mel(card)
    return dict(launches=launches, cli_rtf=[m["rtf"] for m in metrics], rtf=med["bigvgan"],
                vocos_rtf=med["vocos"], share=med["share"], decode_err=dec_err,
                decode_err_bf16=dec_err16, mel_err=mel_err)


DIALOG_CORPUS = ["[S1] the quick brown fox jumps. [S2] over the lazy dog it goes.",
                 "[S1] and then it runs away. [S2] far away from here, it says.",
                 "[S1] how are you today? [S2] fine, thank you, and you?",
                 "[S1] this is a test of the dialog. [S2] it works as it should."]


def make_recipe_assets(root: Path):
    """13b assets: phase 12's emilia-layout tokens.txt (the dialog
    vocabulary, [S1]/[S2] at 360/361) and the base vocabulary (the same
    layout without its 28 dialog rows, 334), the base model.json, a
    full-width base checkpoint on the base vocabulary (seeded random
    weights, ``save_checkpoint``), a 16-file mono corpus of English text
    and a 16-file stereo corpus of [S1]/[S2] turns, 2-6 s each."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, save_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
    from zipvoice_tpu_torch.text.tokenizer import write_token_file
    from zipvoice_tpu_torch.train.checkpoint import save_checkpoint

    rd = root / "recipes"
    rd.mkdir()
    token2id = dict(VENDORED_ESPEAK_MAP)
    token2id.update({f"<filler{i}>": i for i in range(len(token2id), 360)})
    token2id.update({"[S1]": 360, "[S2]": 361})
    write_token_file(token2id, str(rd / "tokens_dialog.txt"))
    write_token_file({t: i for t, i in token2id.items() if i < 334}, str(rd / "tokens_base.txt"))
    save_model_json(rd / "model.json", ZipVoiceConfig(), FeatureConfig())
    base = init_zipvoice(ZipVoiceConfig(vocab_size=334, pad_id=0),
                         torch.Generator().manual_seed(16))
    save_checkpoint(str(rd / "base.pt"), base)
    del base
    rng = np.random.default_rng(17)
    for kind, channels in (("mono", 1), ("stereo", 2)):
        lines = []
        for i in range(16):
            sec = rng.uniform(2.0, 6.0)
            wav = (0.05 * rng.standard_normal((channels, int(sec * 24000)))).astype(np.float32)
            path = rd / f"{kind}{i}.wav"
            write_wav(path, wav, 24000)
            text = ((BASE * 2)[7 * i: 7 * i + int(15 * sec)] if kind == "mono"
                    else DIALOG_CORPUS[i % 4])
            lines.append(f"{kind}{i}\t{text}\t{path}")
        (rd / f"{kind}.tsv").write_text("\n".join(lines) + "\n")
    return rd


def _recipe_args(rd: Path, manifest: str, tokens: str, exp: Path, steps: int):
    return ["--device", "cuda", "--train-manifest", str(rd / manifest),
            "--token-file", str(rd / tokens), "--model-config", str(rd / "model.json"),
            "--exp-dir", str(exp), "--num-iters", str(steps), "--max-duration", "100",
            # a checkpoint every half of the steps: the last step's and an
            # older one are what the average reads; a full-width checkpoint
            # with the optimizer state is ~2.5 GB, and the whole run must
            # keep its disk writes under 45 GiB
            "--save-every-n", str(steps // 2), "--keep-last-k", "2", "--average-period", "1",
            "--log-interval", "1", "--dtype", "bfloat16"]


class _StepTimer:
    """Within the block: each distill step and each trainer step timed on
    the host clock, the device synchronized at both ends (``ms``).  The
    recipes save checkpoints between steps, which the intervals between
    steps would include."""

    def __enter__(self):
        import torch

        from zipvoice_tpu_torch.train import distill_step, trainer

        self.ms = []

        def timed(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.ms.append((time.monotonic() - t0) * 1e3)
                return out
            return run

        make, step = distill_step.make_distill_train_step, trainer.Trainer.train_step
        self.saved = [(distill_step, "make_distill_train_step", make),
                      (trainer.Trainer, "train_step", step)]
        distill_step.make_distill_train_step = lambda *a, **k: timed(make(*a, **k))
        trainer.Trainer.train_step = timed(step)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def _run_recipe_step(name: str, main_fn, argv, per_step, card: str):
    """One training CLI run of a recipe: finite losses, the launches pinned
    per step, warm step ms (the step alone, median of the steps after the
    first) and peak memory.  Returns (result, {"launches", "step_ms",
    "peak_gib"})."""
    import numpy as np
    import torch

    steps = RECIPE_STEPS[name]
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with _StepTimer() as timer:
        res = main_fn(argv)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(res["steps"])
    want = {k: per_step.get(k, 0) * n for k in counters}
    if n != steps or launches != want:
        raise AssertionError(f"{name}: launches {launches} over {n} steps, want {want}")
    losses = [x for _, x in res["steps"]]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    step_ms = float(np.median(timer.ms[1:]))
    print(f"recipe {name} (bf16, full width): {n} steps, losses "
          f"{[round(x, 4) for x in losses]}, launches a step "
          f"{ {k: v // n for k, v in launches.items() if v} }, warm step {step_ms:.1f} ms "
          f"{[round(x, 1) for x in timer.ms]} (the step alone, median after the first), "
          f"peak memory {peak:.2f} GiB on {card}", flush=True)
    return res, dict(launches={k: v // n for k, v in launches.items()}, step_ms=step_ms,
                     peak_gib=peak)


def _average(exp: Path, steps: int) -> str:
    from zipvoice_tpu_torch.bin import generate_averaged_model

    return generate_averaged_model.main(["--exp-dir", str(exp), "--iter", str(steps),
                                         "--avg", "1", "--out", str(exp / "model.pt")])


class _ScalarSteps:
    """Within the block: for each 0-d parameter of every ScaledAdam step,
    whether its gradient was nonzero and whether the step moved it
    (``steps[name]``, a (nonzero gradient, moved) pair a step)."""

    def __enter__(self):
        import torch

        from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam

        self.steps = {}
        self._orig = orig = ScaledAdam.step

        def step(opt, lr):
            scalars = [(n, p) for n, p in zip(opt.names, opt.params) if p.ndim == 0]
            before = [(p.detach().clone(), p.grad is not None and bool(p.grad != 0))
                      for _, p in scalars]
            out = orig(opt, lr)
            for (n, p), (b, g) in zip(scalars, before):
                self.steps.setdefault(n, []).append((g, not torch.equal(p.detach(), b)))
            return out

        ScaledAdam.step = step
        return self

    def __exit__(self, *exc):
        from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam

        ScaledAdam.step = self._orig
        return False


def _returned(key: str, steps) -> bool:
    """A BiasNorm ``norm.log_scale`` (0-d) may end bit-equal to its start
    only if every step's gradient was nonzero and a step moved it: ScaledAdam
    moves a scalar by ~lr/100 a step (8 ulps at 1.0 for LR 1e-4), and when
    the gradient's sign alternates (the stereo recipe alternates its two
    objectives a batch) the rounded updates can sum to zero, as they do in
    the reference package's optimizer (tests/test_torch_regularizers.py)."""
    rec = steps.get(key) if steps else None
    return (key.endswith("norm.log_scale") and bool(rec)
            and all(g for g, _ in rec) and any(m for _, m in rec))


def _check_changed(name: str, model, initial, frozen=(), scalar_steps=None):
    """Every parameter tensor moved from ``initial`` (a state_dict), except
    the prefixes ``frozen``, which stay bit-equal, and a ``norm.log_scale``
    whose steps (``scalar_steps``, from _ScalarSteps) moved it back to its
    start (``_returned``)."""
    import torch

    moved, stuck, returned = [], [], []
    for k, v in model.state_dict().items():
        same = torch.equal(v, initial[k].to(v.device))
        if frozen and k.startswith(frozen):
            if not same:
                moved.append(k)
        elif same:
            (returned if _returned(k, scalar_steps) else stuck).append(k)
    if moved or stuck:
        raise AssertionError(f"{name}: frozen tensors moved {moved[:10]}; trained tensors "
                             f"unchanged {stuck[:10]}")
    print(f"recipe {name}: every trained tensor changed"
          + (f", {', '.join(frozen)} bit-equal" if frozen else "")
          + "".join(f"; {k} moved and returned to its start bit for bit (a nonzero "
                    f"gradient every step, moved at steps "
                    f"{[i + 1 for i, (_, m) in enumerate(scalar_steps[k]) if m]})"
                    for k in returned), flush=True)


def run_recipes(root: Path, card: str):
    """Phase 13b: ``egs/zipvoice/run_distill.sh``'s chain (stage 1, 3
    steps; average; stage 2, 3 steps; average) and
    ``egs/zipvoice_dialog/run.sh``'s (dialog, 3 steps; average; stereo, 4
    steps; average) through the CLIs at full width in bf16, each run's
    losses, launches a step, trained tensors, step ms and peak memory; the
    distill model served by the infer CLI and the stereo model by the
    dialog CLI (launches a request pinned).  Returns {run: {...}}."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin import (
        infer_zipvoice,
        infer_zipvoice_dialog,
        train_zipvoice_dialog,
        train_zipvoice_dialog_stereo,
        train_zipvoice_distill,
    )
    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.models.dialog import (
        duplicate_projections_stereo,
        extend_vocab_params,
        init_zipvoice_dialog,
    )
    from zipvoice_tpu_torch.models.distill import init_zipvoice_distill
    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint

    t0 = time.monotonic()
    rd = make_recipe_assets(root)
    print(f"recipe assets in {time.monotonic() - t0:.1f} s", flush=True)
    base = load_checkpoint(str(rd / "base.pt"))["model"]
    out = {}
    # the CLIs' fresh weights come from the default seed, 42, on the card
    gen = lambda: torch.Generator(device="cuda").manual_seed(42)  # noqa: E731

    res, out["distill stage 1"] = _run_recipe_step(
        "distill stage 1", train_zipvoice_distill.main,
        _recipe_args(rd, "mono.tsv", "tokens_base.txt", rd / "distill_s1", 3)
        + ["--teacher-checkpoint", str(rd / "base.pt")], DISTILL_PER_STEP, card)
    cfg, _ = load_model_json(rd / "model.json", vocab_size=334, pad_id=0)
    initial = dict(init_zipvoice_distill(cfg, gen(), device="cuda").state_dict())
    initial.update(base)
    _check_changed("distill stage 1", res["student"], initial, ("embed.", "text_encoder."))
    del res
    s1 = _average(rd / "distill_s1", 3)
    res, out["distill stage 2"] = _run_recipe_step(
        "distill stage 2", train_zipvoice_distill.main,
        _recipe_args(rd, "mono.tsv", "tokens_base.txt", rd / "distill_s2", 3)
        + ["--teacher-checkpoint", s1, "--distill-stage", "second"], DISTILL_PER_STEP, card)
    s1_sd = load_checkpoint(s1)["model"]
    _check_changed("distill stage 2", res["student"], s1_sd, ("embed.", "text_encoder."))
    ema = load_checkpoint(str(rd / "distill_s2" / "checkpoint-3.pt"))["model_ema"]
    if ema is None or sorted(ema) != sorted(s1_sd):
        raise AssertionError("distill stage 2: checkpoint-3.pt holds no full model_ema")
    del res, ema
    _average(rd / "distill_s2", 3)

    res, out["dialog"] = _run_recipe_step(
        "dialog", train_zipvoice_dialog.main,
        _recipe_args(rd, "stereo.tsv", "tokens_dialog.txt", rd / "dialog", 3)
        + ["--checkpoint", str(rd / "base.pt")], DIALOG_PER_STEP, card)
    dcfg, _ = load_model_json(rd / "model.json", vocab_size=362, pad_id=0)
    fresh = init_zipvoice_dialog(dcfg, device="cuda", generator=gen()).state_dict()
    _check_changed("dialog", res["trainer"].model, extend_vocab_params(fresh, base))
    del res
    d_avg = _average(rd / "dialog", 3)
    with _ScalarSteps() as scalar_steps:
        res, out["stereo"] = _run_recipe_step(
            "stereo", train_zipvoice_dialog_stereo.main,
            _recipe_args(rd, "stereo.tsv", "tokens_dialog.txt", rd / "stereo", 4)
            + ["--checkpoint", d_avg], DIALOG_PER_STEP, card)
    fresh = init_zipvoice_dialog(dcfg, stereo=True, device="cuda", generator=gen()).state_dict()
    loaded = duplicate_projections_stereo(load_checkpoint(d_avg)["model"], dcfg.feat_dim)
    _check_changed("stereo", res["trainer"].model, extend_vocab_params(fresh, loaded),
                   scalar_steps=scalar_steps.steps)
    del res, fresh, loaded
    _average(rd / "stereo", 4)
    gc.collect()
    torch.cuda.empty_cache()

    # the recipes' models serve: distill through the infer CLI, stereo
    # through the dialog CLI (one request each, launches pinned)
    counters = _counters()
    for name, cli, argv in (
            ("zipvoice_distill", infer_zipvoice,
             ["--model-dir", str(rd / "distill_s2"), "--prompt-wav", str(root / "prompt.wav"),
              "--prompt-text", PROMPT_TEXT, "--text", TEXTS["r8s"]]),
            ("zipvoice_dialog_stereo", infer_zipvoice_dialog,
             ["--model-dir", str(rd / "stereo"), "--prompt-text-1", DIALOG_PROMPTS[0],
              "--prompt-wav-1", str(root / "speaker1.wav"), "--prompt-text-2",
              DIALOG_PROMPTS[1], "--prompt-wav-2", str(root / "speaker2.wav"),
              "--text", DIALOG_TEXT])):
        for c in counters.values():
            c.launches = 0
        wav_path = rd / f"served_{name}.wav"
        metrics = cli.main(["--model-name", name, "--vocoder-path", str(root / "vocos.bin"),
                            "--device", "cuda", "--res-wav-path", str(wav_path), *argv])
        launches = {k: c.launches for k, c in counters.items()}
        want = {k: VARIANT_PINS[name].get(k, 0) for k in counters}
        wav, sr = read_wav(wav_path)
        channels = 2 if name.endswith("stereo") else 1
        if launches != want or wav.shape[0] != channels or not np.isfinite(wav).all():
            raise AssertionError(f"serving the {name} recipe model: launches {launches} "
                                 f"(want {want}), wav {wav.shape}")
        print(f"recipe model {name} served: {wav.shape[0]} channel(s), "
              f"{metrics[0]['wav_seconds']:.2f} s audio, rtf {metrics[0]['rtf']:.4f}, "
              f"launches {launches['B1']}/{launches['B2']} B1/B2 on {card}", flush=True)
        out[f"served {name}"] = dict(launches=launches, rtf=metrics[0]["rtf"])
    return out


def check_variant_gradients_against_cpu(root: Path):
    """Phase 13c: one full-width compute_distill_loss gradient (stage
    first: the base model as teacher, its copy with a fresh guidance-scale
    embedding as student) and one stereo compute_fm_loss_dialog gradient
    (2F features through stream 0, se_weight 1, the regularizer schedules
    with every gate closed) on the card (kernels: B1 + B2 + B4; B1 + B3)
    against the CPU (plain versions), f32, the draws pinned; relative L2
    error per parameter group.  Returns {loss: {group: error}}."""
    import torch

    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.models import dialog as dialog_mod
    from zipvoice_tpu_torch.models import distill as distill_mod
    from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint

    base_sd = load_checkpoint(str(root / "recipes" / "base.pt"))["model"]
    cfg = ZipVoiceConfig(vocab_size=334, pad_id=0)
    with torch.device("meta"):
        teacher = ZipVoiceModel(cfg)
    teacher = load_into(teacher, base_sd)
    student = distill_mod.init_zipvoice_distill(cfg, torch.Generator().manual_seed(19))
    with torch.no_grad():
        for k, v in student.state_dict().items():
            if k in base_sd:
                v.copy_(base_sd[k])
    g = torch.Generator().manual_seed(20)
    b, t, s, f = 2, 256, 48, cfg.feat_dim
    tokens = torch.randint(1, 334, (b, s + 1), generator=g)
    tokens[:, -1] = 0
    tokens_lens = torch.tensor([s, s - 11])
    features_lens = torch.tensor([t, t - 57])
    features = 0.5 * torch.randn((b, t, f), generator=g)
    noise = torch.randn((b, t, f), generator=g)
    scales = torch.tensor([0.7, 1.6]).reshape(b, 1, 1)
    stereo_cfg = ZipVoiceConfig(vocab_size=362, pad_id=0)
    stereo = dialog_mod.init_zipvoice_dialog(stereo_cfg, stereo=True,
                                             generator=torch.Generator().manual_seed(21))
    st_tokens = tokens.clone()
    st_tokens[:, 0], st_tokens[:, 20] = 360, 361
    st_features = 0.5 * torch.randn((b, t, 2 * f), generator=g)
    st_noise = torch.randn((b, t, 2 * f), generator=g)
    tt = torch.tensor([0.3, 0.8]).reshape(b, 1, 1)

    def distill_grads(dev):
        student.to(dev).zero_grad()
        teacher.to(dev)
        loss, _ = distill_mod.compute_distill_loss(
            student, teacher, tokens.to(dev), tokens_lens.to(dev), features.to(dev),
            features_lens.to(dev), 0, 0.3, 0.2, 0.15, stage="first")
        loss.backward()
        return {n: q.grad.detach().cpu() for n, q in student.named_parameters()
                if q.grad is not None}

    def stereo_grads(dev, scheds):
        stereo.to(dev).zero_grad()
        loss = dialog_mod.compute_fm_loss_dialog(
            stereo, st_tokens.to(dev), tokens_lens.to(dev), st_features.to(dev),
            features_lens.to(dev), st_noise.to(dev), tt.to(dev), 0, se_weight=1.0,
            stereo=True, schedules=scheds)
        loss.backward()
        return {n: q.grad.detach().cpu() for n, q in stereo.named_parameters()
                if q.grad is not None}

    saved = [(distill_mod, "draw_noise_and_scale", distill_mod.draw_noise_and_scale),
             (dialog_mod, "condition_time_mask_suffix", dialog_mod.condition_time_mask_suffix)]
    distill_mod.draw_noise_and_scale = lambda seed, x, stage: (
        noise.to(x.device, x.dtype), scales.to(x.device, x.dtype))

    def fixed_suffix(features_lens, max_len, generator, mask_percent=(0.5, 1.0)):
        seq = torch.arange(max_len, device=features_lens.device)[None, :]
        return (seq >= (features_lens[:, None] * 0.4).long()) & (seq < features_lens[:, None])

    dialog_mod.condition_time_mask_suffix = fixed_suffix
    out = {}
    try:
        with _NoDraws() as nd:
            runs = (("distill (stage first)", distill_grads),
                    ("stereo dialog (regularizers)",
                     lambda dev: stereo_grads(dev, nd.schedules(stereo_cfg))))
            for label, fn in runs:
                grads = {dev: fn(dev) for dev in ("cpu", "cuda")}
                if sorted(grads["cpu"]) != sorted(grads["cuda"]):
                    raise AssertionError(f"{label}: the card and the CPU train other tensors")
                groups = {}
                for n, gc_ in grads["cpu"].items():
                    d2, r2 = groups.get(_param_group(n), (0.0, 0.0))
                    groups[_param_group(n)] = (
                        d2 + float(((grads["cuda"][n] - gc_) ** 2).sum()),
                        r2 + float((gc_ ** 2).sum()))
                out[label] = {k: (d / max(r, 1e-30)) ** 0.5 for k, (d, r) in groups.items()}
                worst = max(out[label].values())
                print(f"gradient card vs CPU ({label}): relative L2 per group "
                      + ", ".join(f"{k} {v:.2e}" for k, v in out[label].items())
                      + f"; worst {worst:.2e} (tol 1e-3)", flush=True)
                if not worst <= 1e-3:
                    raise AssertionError(f"gradient card vs CPU ({label}): {out[label]}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for m in (student, teacher, stereo):
        m.to("cpu")
    return out


def run_phase13(root: Path, card: str):
    """Phase 13 (13a, 13b, 13c) with its wall time."""
    t0 = time.monotonic()
    bigvgan = run_bigvgan(root, card)
    recipes = run_recipes(root, card)
    grads = check_variant_gradients_against_cpu(root)
    print(f"phase 13: {time.monotonic() - t0:.1f} s on {card}", flush=True)
    return bigvgan, recipes, grads


def _phase13_worker(root: str, card: str) -> int:
    """Phase 13 in a process of its own (``--phase13-worker``), its results
    into ``phase13.json``."""
    sys.path.insert(0, str(REPO))
    root = Path(root)
    bigvgan, recipes, grads = run_phase13(root, card)
    (root / "phase13.json").write_text(json.dumps(
        {"bigvgan": bigvgan, "recipes": recipes, "grads": grads}, default=float))
    return 0


def start_phase13(root: Path, card: str):
    """Starts ``_phase13_worker`` beside phases 14-17 (its assets, phase
    4's and 12's, exist by then; it writes only under its own names);
    returns (Popen, log path, start time)."""
    log = root / "phase13.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--phase13-worker", str(root),
             card], cwd=REPO, stdout=f, stderr=subprocess.STDOUT, text=True,
            preexec_fn=_die_with_parent)
    return proc, log, time.monotonic()


def finish_phase13(p13, root: Path, timeout: float = 900.0):
    """Waits for ``start_phase13``'s process, prints its output and
    returns run_phase13's (bigvgan, recipes, grads); a failed process fails
    the phase."""
    proc, log, t_start = p13
    t0 = time.monotonic()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    print(log.read_text(), end="", flush=True)
    print(f"phase 13 ran in a process of its own beside phases 14-17: "
          f"{time.monotonic() - t_start:.1f} s, waited {time.monotonic() - t0:.1f} s for it",
          flush=True)
    if rc != 0:
        raise AssertionError(f"phase 13's process exited {rc}")
    res = json.loads((root / "phase13.json").read_text())
    return res["bigvgan"], res["recipes"], res["grads"]


# ---------------------------------------------------------------------------
# Phase 14: data parallelism across processes (14a, 14b), the remat policies
# (14c), and the diagnostics and scan-oom CLIs (14d)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("full", "all", "dots", "xprobs", "xprobs_ff")
# a regularized step's B1, B2 and B3 launches under each policy: "all"
# recomputes no layer; "xprobs" and "xprobs_ff" keep B2's outputs (its entry
# point is a custom op the policy saves) and recompute B1's probabilities;
# "dots" recomputes both, as "full" does
PER_STEP_BY_POLICY = {
    "full": {"B1": 2 * LAYERS, "B2": 4 * LAYERS, "B3": 3 * LAYERS},
    "all": {"B1": LAYERS, "B2": 2 * LAYERS, "B3": 3 * LAYERS},
    "dots": {"B1": 2 * LAYERS, "B2": 4 * LAYERS, "B3": 3 * LAYERS},
    "xprobs": {"B1": 2 * LAYERS, "B2": 2 * LAYERS, "B3": 3 * LAYERS},
    "xprobs_ff": {"B1": 2 * LAYERS, "B2": 2 * LAYERS, "B3": 3 * LAYERS},
}
DDP_STEPS = 6


def _train_argv(root: Path, manifest: Path, exp: Path, steps: int, *extra):
    """Phase 8's train CLI arguments (full width, bf16, regularizers)."""
    return ["--device", "cuda", "--train-manifest", str(manifest),
            "--token-file", str(root / "tokens.txt"), "--tokenizer", "simple",
            "--model-config", str(root / "model.json"), "--exp-dir", str(exp),
            "--num-epochs", "1", "--num-steps-per-epoch", str(steps),
            "--max-duration", "100", "--log-interval", "1", "--dtype", "bfloat16", *extra]


def _ddp_worker(out: str, argv) -> int:
    """14a, a rank inside torchrun: the train CLI's main with --distributed
    (NCCL from torchrun's environment), the kernel launches counted and its
    last step profiled; the results, with a digest of the trained
    parameters, into ``out``/rank-R.json."""
    import hashlib
    import os

    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zipvoice_tpu_torch.bin.train_zipvoice import main as train_main
    from zipvoice_tpu_torch.train.trainer import Trainer

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    steps = int(argv[argv.index("--num-steps-per-epoch") + 1])
    step_and_log = Trainer.step_and_log
    prof_res = {}

    def profiled(self, batch, *a, **k):
        if self.batch_idx_train + 1 < steps:
            return step_and_log(self, batch, *a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            m = step_and_log(self, batch, *a, **k)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        averages = _profile_rows(prof).values()
        events = [e for e in averages if e.device_type == DeviceType.CUDA]
        sync = [e for e in averages if e.key == "all_reduce_gradients"]
        prof_res.update(
            backend=dist.get_backend(), world=dist.get_world_size(), wall_ms=wall * 1e3,
            busy_ms=sum(_dev_us(e) for e in events) / 1e3,
            nccl={e.key: [_dev_us(e) / 1e3, e.count] for e in events
                  if "nccl" in e.key.lower()},
            # the sync's range: the flatten, the all-reduce and the views back
            sync_device_ms=sum(getattr(e, "device_time_total", None)
                               or getattr(e, "cuda_time_total", 0) for e in sync) / 1e3,
            sync_host_ms=sum(e.cpu_time_total for e in sync) / 1e3,
            features=list(torch.as_tensor(batch["features"]).shape))
        return m

    Trainer.step_and_log = profiled
    res = train_main(argv)
    torch.cuda.synchronize()
    digest = hashlib.blake2b()
    for p in res["trainer"].model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    (Path(out) / f"rank-{os.environ['RANK']}.json").write_text(json.dumps({
        "digest": digest.hexdigest(),
        "losses": [loss for _, loss in res["steps"]], "ends": [t for t, _ in res["steps"]],
        "launches": {k: c.launches for k, c in counters.items()},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **prof_res}))
    return 0


def distributed_cli_job(root: Path, manifest: Path) -> float:
    """14a's run, a background job: ``torchrun --standalone
    --nproc-per-node 1`` over the train CLI with --distributed (NCCL, world
    size 1), DDP_STEPS steps with the regularizers, its rank's results in
    ``root``/ddp.  Returns the run's seconds."""
    out = root / "ddp"
    out.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", str(Path(__file__).resolve()), "--ddp-worker", str(out),
           *_train_argv(root, manifest, root / "exp_ddp", DDP_STEPS, "--distributed")]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, preexec_fn=_die_with_parent)
    try:
        stdout, stderr = proc.communicate(timeout=420)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train CLI exit {proc.returncode}:\n"
                             f"{stdout[-3000:]}\n{stderr[-3000:]}")
    return time.monotonic() - t0


def run_distributed_cli(root: Path, card: str, single_ms: float, wall: float):
    """14a's checks on ``distributed_cli_job``'s run (``wall`` seconds):
    finite losses, the launches a step at phase 8's pins, the NCCL
    all-reduce's device time in the last (profiled) step and the warm step
    ms beside phase 8's single-process step; then the checkpoint rank 0
    wrote, as a model dir (``check_distributed_checkpoint``).  Returns the
    results."""
    import numpy as np

    exp = root / "exp_ddp"
    out = root / "ddp"
    res = json.loads((out / "rank-0.json").read_text())
    n = len(res["losses"])
    want = {k: PER_STEP.get(k, 0) * n for k in res["launches"]}
    want["B4"] = 0
    if n != DDP_STEPS or res["launches"] != want:
        raise AssertionError(f"distributed CLI: {n} steps, launches {res['launches']}, "
                             f"want {want}")
    if not np.all(np.isfinite(res["losses"])):
        raise AssertionError(f"distributed CLI: non-finite losses {res['losses']}")
    if res["backend"] != "nccl" or res["world"] != 1:
        raise AssertionError(f"distributed CLI: backend {res['backend']}, world {res['world']}")
    # warm intervals: after the first, before the profiled last step
    res["step_ms"] = float(np.median(np.diff(res["ends"])[1:-1])) * 1e3
    res["nccl_ms"] = sum(ms for ms, _ in res["nccl"].values())
    print(f"14a distributed train CLI (torchrun, NCCL, world 1, bf16, full width): {n} "
          f"steps in {wall:.1f} s, losses {[round(x, 4) for x in res['losses']]}, launches "
          f"{ {k: v / n for k, v in res['launches'].items()} } a step, warm step "
          f"{res['step_ms']:.1f} ms (phase 8's single process {single_ms:.1f} ms), profiled "
          f"step (features {res['features']}) wall {res['wall_ms']:.1f} ms, busy "
          f"{res['busy_ms']:.1f} ms, NCCL all-reduce {res['nccl_ms']:.3f} ms device "
          f"({res['nccl'] or 'no nccl kernel in the trace'}), the gradient sync's range "
          f"{res['sync_device_ms']:.3f} ms device / {res['sync_host_ms']:.1f} ms host, peak "
          f"{res['peak_gib']:.2f} GiB on {card}", flush=True)
    res["checkpoint_err"] = check_distributed_checkpoint(root, exp, res["digest"], card)
    return res


def check_distributed_checkpoint(root: Path, exp: Path, digest: str, card: str) -> float:
    """14a's checkpoint (rank 0's epoch-*.pt, moved to model.pt beside the
    model.json and tokens.txt the CLI wrote) loads through
    ``load_model_dir``: its parameters bit-equal to the trained ones (the
    rank's digest), and one f32 fm_decoder forward on the card against the
    CPU (phase 6's check).  Returns that forward's error."""
    import hashlib

    from zipvoice_tpu_torch.io.model_dir import load_model_dir

    ckpts = sorted(exp.glob("epoch-*.pt"))
    ckpts[-1].rename(exp / "model.pt")  # moved, not copied: disk writes are bounded
    model = load_model_dir(str(exp), tokenizer_name="simple").model
    h = hashlib.blake2b()
    for p in model.parameters():
        h.update(p.detach().numpy().tobytes())
    if h.hexdigest() != digest:
        raise AssertionError(f"{ckpts[-1].name}: parameters differ from the trained ones")
    del model
    err = check_forward_against_cpu(root, model_dir=exp)
    print(f"14a checkpoint {ckpts[-1].name} as a model dir: parameters bit-equal to the "
          f"trained ones, f32 fm_decoder forward card vs CPU max_abs_err {err:.3g} on {card}",
          flush=True)
    return err


def _nccl_probe_worker():
    """14b's probe: two NCCL ranks on the one card."""
    _die_with_parent()
    import os

    import torch
    import torch.distributed as dist

    from zipvoice_tpu_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = "0"
    mesh.init_from_env("cuda")
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"nccl accepted: rank {mesh.rank()} sum {x.tolist()}", flush=True)
    mesh.shutdown()


def _two_ranks_worker(root: str, manifest: str, out: str, steps: int):
    """14b, one of two ranks sharing the card over gloo: the gradient of
    its first batch (f32, no regularizers, its own draws kept) summed over
    the ranks; then ``steps`` Trainer steps with the regularizers and
    ``steps`` without (bf16), the parameters' digests compared across the
    ranks after every step, the launches counted; rank 0's exp dir only
    may hold files."""
    import hashlib
    import itertools
    import os

    _die_with_parent()

    import torch
    import torch.distributed as dist

    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.data.dataset import (
        DurationBucketSampler,
        OnDeviceFbankCollator,
        read_tsv_manifest,
    )
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig, draw_t_and_noise
    from zipvoice_tpu_torch.train.trainer import Trainer, TrainerOptions

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    dev = mesh.init_from_env("cuda", backend="gloo")
    r, n = mesh.rank(), mesh.world_size()
    root, out = Path(root), Path(out)
    tok = SimpleTokenizer(str(root / "tokens.txt"))
    cfg, fcfg = load_model_json(root / "model.json", vocab_size=tok.vocab_size,
                                pad_id=tok.pad_id)
    model = zv.init_zipvoice(cfg, torch.Generator(device=dev).manual_seed(42), device=dev)
    mesh.broadcast_module(model)
    sampler = DurationBucketSampler(read_tsv_manifest(manifest), max_duration=100.0, seed=42,
                                    process_index=r, process_count=n)
    sampler.set_epoch(1)
    collate = OnDeviceFbankCollator(tok, fcfg, device=dev, pad_id=cfg.pad_id)
    utts = list(itertools.islice(sampler, 1 + 2 * steps))

    b0 = {k: torch.as_tensor(v).to(dev) for k, v in collate(utts[0]).items()}
    t, noise, k_loss = draw_t_and_noise(7, b0["features"])
    masks = []
    drawn = zv.condition_time_mask
    zv.condition_time_mask = lambda *a, **k: masks.append(drawn(*a, **k)) or masks[-1]
    try:
        loss = zv.compute_fm_loss(model, b0["tokens"], b0["tokens_lens"], b0["features"],
                                  b0["features_lens"], noise, t, k_loss)
    finally:
        zv.condition_time_mask = drawn
    loss.backward()
    (total,) = mesh.all_reduce_gradients(list(model.parameters()), [loss.detach()])
    keep = {"batch": {k: v.cpu() for k, v in b0.items()}, "t": t.cpu(), "noise": noise.cpu(),
            "mask": masks[0].cpu(), "loss": float(total)}
    if r == 0:
        keep["grads"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    torch.save(keep, out / f"draws-{r}.pt")
    model.zero_grad(set_to_none=True)

    counters = _counters()
    res = {}
    for regs, part in ((True, utts[1:1 + steps]), (False, utts[1 + steps:])):
        trainer = Trainer(cfg, model, ScaledAdam(model.named_parameters()),
                          TrainConfig(compute_dtype="bfloat16", use_regularizers=regs),
                          TrainerOptions(exp_dir=str(out / f"exp-{r}"), save_every_n=10**9,
                                         log_interval=1, frame_rate=fcfg.frame_rate,
                                         max_duration=100.0))
        for c in counters.values():
            c.launches = 0
        losses, same = [], []
        for batch in part:
            losses.append(float(trainer.step_and_log(collate(batch))["loss"]))
            h = hashlib.blake2b()
            for p in model.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
            digests = [None] * n
            dist.all_gather_object(digests, h.hexdigest())
            same.append(len(set(digests)) == 1)
        res["regularizers" if regs else "no-regularizers"] = {
            "losses": losses, "identical": same,
            "launches": {k: c.launches / len(part) for k, c in counters.items()}}
    # one checkpoint, without the optimizer state (disk writes are bounded)
    trainer.save(str(out / f"exp-{r}" / "last.pt"), with_opt=False)
    (out / f"ranks-{r}.json").write_text(json.dumps(res))
    mesh.shutdown()


def _concat_rows(parts, key, pad=0):
    """The ranks' (B, T, ...) tensors along the batch, padded in every
    other dim to the largest."""
    import torch

    xs = [p[key] for p in parts]
    shape = [max(x.shape[d] for x in xs) for d in range(1, xs[0].dim())]
    out = []
    for x in xs:
        y = torch.full((x.shape[0], *shape), pad, dtype=x.dtype)
        y[(slice(None),) + tuple(slice(0, s) for s in x.shape[1:])] = x
        out.append(y)
    return torch.cat(out)


TWO_RANK_STEPS = 2


def two_ranks_job(root: Path, manifest: Path):
    """14b's runs, a background job: NCCL's answer to two ranks on one
    card, then two gloo ranks on it (``_two_ranks_worker``, TWO_RANK_STEPS
    steps with the regularizers and as many without), their results in
    ``root``/two_ranks.  Returns (NCCL's answer, its seconds, the gloo
    run's seconds)."""
    from zipvoice_tpu_torch.train.dryrun import spawn

    here = str(Path(__file__).resolve().parent)  # the workers import this file
    t0 = time.monotonic()
    try:
        spawn("chip_smoke:_nccl_probe_worker", 2, {}, timeout=60, path=[here])
        nccl = "accepted two ranks on one card"
    except RuntimeError as ex:  # the refusal this probe expects
        lines = [ln for ln in str(ex).splitlines()
                 if "uplicate" in ln or "nvalid" in ln or "outlived" in ln]
        nccl = "refused: " + (lines[0].strip()[:300] if lines else str(ex)[-300:])
    probe_s = time.monotonic() - t0
    out = root / "two_ranks"
    out.mkdir()
    t0 = time.monotonic()
    spawn("chip_smoke:_two_ranks_worker", 2,
          {"root": str(root), "manifest": str(manifest), "out": str(out),
           "steps": TWO_RANK_STEPS}, timeout=480, path=[here])
    return nccl, probe_s, time.monotonic() - t0


def check_two_ranks(root: Path, card: str, nccl: str, probe_s: float, wall: float):
    """14b's checks on ``two_ranks_job``'s runs: the summed gradient of the
    first batch equals one process's gradient on the two ranks' batches
    together with the same draws (relative L2 per parameter group <= 1e-5,
    f32), the parameters bit-identical across the ranks after every step,
    the launches a step per rank at the pins, and only rank 0's exp dir
    holding files.  Returns the results."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.models import zipvoice as zv

    print(f"14b NCCL, two ranks on one card: {nccl} ({probe_s:.1f} s)", flush=True)
    steps = TWO_RANK_STEPS
    out = root / "two_ranks"
    ranks = [json.loads((out / f"ranks-{r}.json").read_text()) for r in range(2)]
    for kind in ("regularizers", "no-regularizers"):
        a, b = ranks[0][kind], ranks[1][kind]
        if not (all(a["identical"]) and all(b["identical"])):
            raise AssertionError(f"two ranks ({kind}): parameters differ after a step: "
                                 f"{a['identical']}")
        if a["losses"] != b["losses"] or not np.all(np.isfinite(a["losses"])):
            raise AssertionError(f"two ranks ({kind}): losses {a['losses']} / {b['losses']}")
        want = {k: float(PER_STEP.get(k, 0)) for k in a["launches"]}
        want["B4" if kind == "regularizers" else "B3"] = 0.0
        for r, res in enumerate((a, b)):
            if res["launches"] != want:
                raise AssertionError(f"two ranks ({kind}) rank {r}: launches a step "
                                     f"{res['launches']}, want {want}")
    written = {r: sorted(p.name for p in (out / f"exp-{r}").iterdir()) for r in range(2)}
    if "last.pt" not in written[0] or written[1]:
        raise AssertionError(f"two ranks: files written {written}")

    draws = [torch.load(out / f"draws-{r}.pt") for r in range(2)]
    batches = [d["batch"] for d in draws]
    inputs = {k: _concat_rows(batches, k) for k in ("tokens", "features")}
    for k in ("tokens_lens", "features_lens"):
        inputs[k] = torch.cat([b[k] for b in batches])
    noise = _concat_rows([{"x": d["noise"]} for d in draws], "x")
    t = torch.cat([d["t"] for d in draws])
    mask = _concat_rows([{"x": d["mask"]} for d in draws], "x", pad=False)
    model = zv.init_zipvoice(_model_cfg(root), torch.Generator(device="cuda").manual_seed(42),
                             device="cuda")
    drawn = zv.condition_time_mask
    zv.condition_time_mask = lambda *a, **k: mask.to("cuda")
    try:
        loss = zv.compute_fm_loss(model, *(inputs[k].to("cuda") for k in (
            "tokens", "tokens_lens", "features", "features_lens")), noise.to("cuda"), t.to("cuda"), 0)
    finally:
        zv.condition_time_mask = drawn
    loss.backward()
    groups = {}
    for name, p in model.named_parameters():
        g = p.grad.cpu()
        d2, r2 = groups.get(_param_group(name), (0.0, 0.0))
        groups[_param_group(name)] = (d2 + float(((draws[0]["grads"][name] - g) ** 2).sum()),
                                      r2 + float((g ** 2).sum()))
    errs = {k: (d / max(r, 1e-30)) ** 0.5 for k, (d, r) in groups.items()}
    worst = max(errs.values())
    loss_err = abs(draws[0]["loss"] - float(loss.detach())) / abs(float(loss.detach()))
    if not (worst <= 1e-5 and loss_err <= 1e-5):
        raise AssertionError(f"two ranks: summed gradient vs one process: {errs}, loss "
                             f"{draws[0]['loss']} vs {float(loss)}")
    del model
    print(f"14b two gloo ranks on one card (bf16 steps, full width): {steps} steps with the "
          f"regularizers and {steps} without in {wall:.1f} s, parameters bit-identical "
          f"after every step, losses {ranks[0]['regularizers']['losses']} / "
          f"{ranks[0]['no-regularizers']['losses']}, launches a step per rank "
          f"{ranks[0]['regularizers']['launches']} / {ranks[0]['no-regularizers']['launches']}, "
          f"only rank 0 wrote ({written[0]}); the first batch's summed f32 gradient vs one "
          f"process on both ranks' rows (T {[b['features'].shape[1] for b in batches]}): worst "
          f"relative L2 a group {worst:.2e} (tol 1e-5), loss {loss_err:.2e} on {card}",
          flush=True)
    return {"nccl": nccl, "ranks": ranks, "grad_err": worst}


def _policy_batch(cfg, b: int = 8, t: int = 1024, s: int = 160):
    import torch

    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (b, s), generator=g)
    tokens_lens = torch.randint(s // 2, s - 1, (b,), generator=g)
    tokens[torch.arange(s)[None, :] >= tokens_lens[:, None]] = 0
    return {"tokens": tokens, "tokens_lens": tokens_lens,
            "features": 0.5 * torch.randn((b, t, cfg.feat_dim), generator=g),
            "features_lens": torch.randint(t - 160, t + 1, (b,), generator=g)}


def compare_remat_policies(root: Path, card: str, rounds: int = 1):
    """14c: the five --remat-policy choices on one regularized bf16 step at
    B=8, T=1024 (full width): step ms (median of ``rounds``, the policies in
    turns after a warm round; one round since phase 18 took its time), peak memory and the B1/B2/B3 launches a step
    (pinned); then one f32 gradient under each at B=8, T=512 against
    full's (bit-equal tensors counted, the largest relative L2; "full"
    against a second run of itself).  Returns {policy: results}."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.nn import zipformer as zf
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    cfg = _model_cfg(root)
    model = zv.init_zipvoice(cfg, torch.Generator(device="cuda").manual_seed(42),
                             device="cuda")
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="bfloat16"))
    batch = _policy_batch(cfg)
    scheds = zipvoice_schedules(1000.0, cfg)
    counters = _counters()
    res = {p: {"ms": [], "peak_gib": 0.0} for p in REMAT_POLICIES}
    try:
        for rnd in range(rounds + 1):
            for pol in REMAT_POLICIES:
                zf.set_remat_policy(pol)
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                float(step(batch, 5, rnd + 1, 0.0, scheds)["loss"])
                torch.cuda.synchronize()
                ms = (time.monotonic() - t0) * 1e3
                launches = {k: counters[k].launches for k in ("B1", "B2", "B3")}
                if launches != PER_STEP_BY_POLICY[pol]:
                    raise AssertionError(f"remat {pol}: launches {launches}, want "
                                         f"{PER_STEP_BY_POLICY[pol]}")
                res[pol]["launches"] = launches
                res[pol]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                if rnd:
                    res[pol]["ms"].append(ms)
        del step
        gc.collect()
        torch.cuda.empty_cache()
        inputs = {k: v.to("cuda") for k, v in _policy_batch(cfg, t=512).items()}
        gen = torch.Generator().manual_seed(12)
        noise = torch.randn(inputs["features"].shape, generator=gen).to("cuda")
        t = torch.rand((8, 1, 1), generator=gen).to("cuda")

        def f32_grads():
            model.zero_grad(set_to_none=True)
            loss = zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"],
                                      inputs["features"], inputs["features_lens"], noise, t,
                                      9, condition_drop_ratio=0.2, schedules=scheds)
            loss.backward()
            return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

        def against(g, ref):
            equal = sum(torch.equal(v, ref[n]) for n, v in g.items())
            rel = max(float(torch.linalg.vector_norm(v - ref[n]))
                      / max(float(torch.linalg.vector_norm(ref[n])), 1e-30)
                      for n, v in g.items())
            return {"bit_equal": f"{equal}/{len(ref)}", "max_rel_l2": rel}

        # "full" twice first: what two backwards of one policy differ by
        zf.set_remat_policy("full")
        ref = f32_grads()
        res["full"].update(against(f32_grads(), ref))
        for pol in REMAT_POLICIES[1:]:
            zf.set_remat_policy(pol)
            res[pol].update(against(f32_grads(), ref))
    finally:
        zf.set_remat_policy("full")
    for pol, r in res.items():
        r["step_ms"] = float(np.median(r["ms"]))
    print("14c remat policies (one regularized bf16 step, B=8 T=1024, full width; "
          f"{rounds} timed round(s) in turns after a warm one): "
          + "; ".join(f"{p} {r['step_ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB, launches "
                      f"{r['launches']}, f32 gradient vs full's: {r['bit_equal']} tensors "
                      f"bit-equal, max relative L2 {r['max_rel_l2']:.2e}"
                      for p, r in res.items()) + f" on {card}", flush=True)
    model.zero_grad(set_to_none=True)
    return res


def _model_cfg(root: Path):
    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(str(root / "tokens.txt"))
    return load_model_json(root / "model.json", vocab_size=tok.vocab_size,
                           pad_id=tok.pad_id)[0]


def check_diagnostics_and_scan_oom(root: Path, manifest: Path, card: str):
    """14d: the train CLI's --print-diagnostics on the card (every tap's
    statistics finite; its wall time), then --scan-oom with no epoch after
    it: one step on the largest batch (B1 launched a step's count) and the
    state bit-equal to a fresh one (weights of the same seed, a fresh
    ScaledAdam's state, no step, no hours).  Returns the results."""
    import contextlib
    import io
    import math

    import torch

    from zipvoice_tpu_torch.bin.train_zipvoice import main as train_main
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam

    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        if train_main(_train_argv(root, manifest, root / "exp_diag", 1,
                                  "--print-diagnostics")) is not None:
            raise AssertionError("--print-diagnostics trained")
    diag_s = time.monotonic() - t0
    rows = [ln for ln in buf.getvalue().splitlines() if ln and not ln.startswith(" ")]
    bad = []
    for ln in rows:
        nums = [float(x) for x in re_numbers(ln.split(" ", 1)[1])]
        if not all(math.isfinite(x) for x in nums):
            bad.append(ln.split()[0])
    taps = [ln.split()[0] for ln in rows if ln.split()[0].startswith("encoders.")]
    attn = [ln for ln in rows if ln.split()[0].endswith("self_attn_weights")]
    if bad or len(attn) != 16 or not all("attn_entropy=" in ln for ln in attn):
        raise AssertionError(f"diagnostics: non-finite {bad[:10]}, {len(attn)} attention taps")

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.monotonic()
    res = train_main(_train_argv(root, manifest, root / "exp_scan", 1, "--scan-oom")
                     + ["--num-epochs", "0"])
    torch.cuda.synchronize()
    scan_s = time.monotonic() - t0
    trainer = res["trainer"]
    fresh = init_zipvoice(trainer.model.cfg, torch.Generator(device="cuda").manual_seed(42),
                          device="cuda")
    differ = [n for (n, p), q in zip(trainer.model.named_parameters(), fresh.parameters())
              if not torch.equal(p, q)]
    opt, ref = trainer.opt, ScaledAdam(fresh.named_parameters())
    differ += [f"opt.{n}.{k}" for n, st, rst in zip(opt.names, opt.state, ref.state)
               for k in st if not torch.equal(st[k], rst[k])]
    differ += [f"opt.{k}" for k in ("model_norms", "model_norm_threshold")
               if not torch.equal(getattr(opt, k), getattr(ref, k))]
    if (trainer.batch_idx_train, trainer.seen_seconds, opt.step_count) != (0, 0.0, 0):
        differ.append("counters")
    if differ or counters["B1"].launches != PER_STEP["B1"]:
        raise AssertionError(f"scan-oom: state differs {differ[:10]}, B1 launches "
                             f"{counters['B1'].launches}")
    del fresh, res, trainer
    print(f"14d --print-diagnostics on the card: {len(rows)} tensors ({len(taps)} backbone "
          f"taps, {len(attn)} attention taps with entropy), every statistic finite, "
          f"{diag_s:.1f} s; --scan-oom: one step on the largest batch (launches "
          f"{ {k: c.launches for k, c in counters.items()} }) and the state bit-equal to a "
          f"fresh one, {scan_s:.1f} s on {card}", flush=True)
    return {"diag_s": diag_s, "scan_s": scan_s, "tensors": len(rows)}


def re_numbers(text: str):
    import re

    return re.findall(r"-?(?:\d+\.\d*|\d+)(?:e[-+]?\d+)?|nan|inf", text)


class Background:
    """Jobs that run other processes (14a's torchrun, 14b's ranks, phase
    18's ranks), one after another in a thread of this process, beside
    the phases that follow their start; ``result`` waits for a job and
    returns its value or raises its error.  After a failed job the later
    ones do not start.  Their processes die with the thread (their own
    ``_die_with_parent``, 14a's launcher by ``preexec_fn``)."""

    def __init__(self, jobs):
        import threading

        self.jobs = dict(jobs)
        self.done = {name: threading.Event() for name in self.jobs}
        self.out = {}
        self.t0 = time.monotonic()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        failed = None
        for name, fn in self.jobs.items():
            t0 = time.monotonic()
            if failed is None:
                try:
                    self.out[name] = (True, fn(), t0, time.monotonic())
                except BaseException as ex:  # handed to the phase that reads it
                    failed = name
                    self.out[name] = (False, ex, t0, time.monotonic())
            else:
                self.out[name] = (False, AssertionError(f"not started: {failed} failed"),
                                  t0, t0)
            self.done[name].set()

    def result(self, name: str):
        t0 = time.monotonic()
        self.done[name].wait()
        ok, value, start, end = self.out[name]
        print(f"background {name}: {end - start:.1f} s from {start - self.t0:.1f} s after the "
              f"jobs' start; waited {time.monotonic() - t0:.1f} s for it", flush=True)
        if not ok:
            raise value
        return value


def run_phase14(root: Path, manifest: Path, card: str, single_ms: float, bg: Background):
    """Phase 14 (14a-14d) with its wall time: 14a's and 14b's runs are
    ``bg``'s jobs, checked here after 14c and 14d (while they finish)."""
    t0 = time.monotonic()
    policies = compare_remat_policies(root, card)
    tools = check_diagnostics_and_scan_oom(root, manifest, card)
    ddp = run_distributed_cli(root, card, single_ms, bg.result("14a"))
    two = check_two_ranks(root, card, *bg.result("14b"))
    print(f"phase 14: {time.monotonic() - t0:.1f} s on {card}", flush=True)
    return ddp, two, policies, tools


# ---------------------------------------------------------------------------
# Phase 15: int8 serving (15a), export and exported-model inference (15b),
# model-FLOPs utilization (15c)
# ---------------------------------------------------------------------------

QUANT_MODES = ("int8", "int8-dynamic")
# a request with the fused eval path on under int8: B6, B7 and SelfAttention-2's
# B2 as without int8; B9 gated off (the ConvolutionModule's out_proj is int8)
INT8_FUSED_PER_REQUEST = {"B2": LAYERS_PER_REQUEST, "B6": LAYERS_PER_REQUEST,
                          "B7": LAYERS_PER_REQUEST}
# linear_int8 on the card against its CPU result: (M, K, N) of the full
# width's serving shapes (CFG batch 2 x 1024 frames through an fm_decoder
# feed-forward's two linears; 2 x 192 tokens into a text-encoder one)
INT8_LINEAR_SHAPES = ((2048, 512, 1536), (2048, 1536, 512), (384, 192, 512))
# the exported fused sampler's steps: 4 of the recipe's 16, a cut of depth.
# torch.export has no loop, so the steps unroll (about 4k graph nodes a
# step), and the trace, save and load of the 16-step program took 7 minutes
# of the host (250 s and 177 s): 15b's exports and loads run in a worker
# process started after phase 4, beside phases 5-15a, and must be done by then
EXPORT_STEPS = 4
# the int8-dynamic export's steps: one shows that its programs compute what
# the int8-dynamic pipeline computes
EXPORT_STEPS_INT8 = 1


def _export_pins(steps: int):
    layers = 4 + steps * 16
    return {"B1": layers, "B2": 2 * layers}


EXPORT_FUSED_PER_REQUEST = _export_pins(EXPORT_STEPS)
# an exported fused sampler against the pipeline's own sample on the same
# inputs (relative L2): bf16 at 16 steps; int8-dynamic at 1 step, where the
# check prints the export's own quantization error against the float model
# beside it
EXPORT_REL_L2 = 1e-2
EXPORT_INT8_REL_L2 = 1e-3


def _launched(counters):
    return {k: c.launches for k, c in counters.items()}


def _pins(per_request, counters, n=1):
    return {k: per_request.get(k, 0) * n for k in counters}


def _zero(counters):
    for c in counters.values():
        c.launches = 0


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _quantized_pipeline(root: Path, dtype: str, mode: str):
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline, get_parser

    args = get_parser().parse_args([
        "--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
        "--tokenizer", "simple", "--dtype", dtype, "--device", "cuda", "--quantize", mode])
    return build_pipeline(args)[0]


def check_linear_int8_against_cpu(card: str):
    """15a: ``nn/functional.linear_int8`` on the card (``torch.mm`` with an
    f32 output for bf16, ``torch._int_mm`` for int8-dynamic) against its
    CPU result on the same inputs, f32 and bf16, both modes, at
    INT8_LINEAR_SHAPES.  Weight-only f32: within 1e-5 of the largest
    |value| (the sum's order); bf16: each value within one bf16 rounding
    (2**-7 of it) plus 1e-5 of the largest; dynamic: the int8 rows and
    their scales equal, the output within 1e-6 of the largest.  Returns
    the worst error over the largest |value| for each (mode, dtype)."""
    import torch

    from zipvoice_tpu_torch.nn.functional import linear_int8, quantize_rows
    from zipvoice_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator().manual_seed(11)
    worst = {}
    for m, k, n in INT8_LINEAR_SHAPES:
        w_q, w_s = quantize_weight(torch.randn((n, k), generator=g) * 0.05)
        x32 = torch.randn((m, k), generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for mode in QUANT_MODES:
                dynamic = mode == "int8-dynamic"
                ref = linear_int8(x, w_q, w_s, dynamic=dynamic).float()
                out = linear_int8(x.cuda(), w_q.cuda(), w_s.cuda(),
                                  dynamic=dynamic).float().cpu()
                diff = (out - ref).abs()
                scale = float(ref.abs().max())
                if dynamic:
                    (qc, sc), (qr, sr) = quantize_rows(x.cuda()), quantize_rows(x)
                    ok = (torch.equal(qc.cpu(), qr) and torch.equal(sc.cpu(), sr)
                          and float(diff.max()) <= 1e-6 * scale)
                elif dtype == torch.float32:
                    ok = float(diff.max()) <= 1e-5 * scale
                else:
                    ok = bool((diff <= 2**-7 * ref.abs() + 1e-5 * scale).all())
                key = (mode, str(dtype).split(".")[-1])
                worst[key] = max(worst.get(key, 0.0), float(diff.max()) / scale)
                if not ok:
                    raise AssertionError(f"linear_int8 {key} at (M, K, N) {(m, k, n)}: card vs "
                                         f"CPU max |diff| {float(diff.max()):.3g} (|ref| max "
                                         f"{scale:.3g})")
    print("15a linear_int8 card vs CPU at (M, K, N) " + str(list(INT8_LINEAR_SHAPES)) + ": "
          + ", ".join(f"{mode} {dt} {e:.3g}" for (mode, dt), e in worst.items())
          + f" (max |diff| over max |ref|) on {card}", flush=True)
    return worst


def run_int8_serving(root: Path, card: str):
    """15a: linear_int8 on the card against the CPU; then for int8 and
    int8-dynamic, bf16 and f32: the model's MB before and after quantizing;
    the launches of a request unfused (B1 260, B2 520) and fused (B2, B6, B7
    260 each; B9 gated off); the replayed sampler equal to its eager run bit
    for bit; the mel MSE and the largest PCM16 difference against the
    unquantized request on the same inputs and noise; the warm replayed
    RTF, medians of 4 in turns with the unquantized pipeline.  Then the
    infer CLI with --quantize int8-dynamic and the serve CLI with
    --quantize int8, one request each.  Returns {(dtype, mode): {...}}, the
    CLI's and the server's launches and the bf16 request's (token, frame)
    buckets."""
    import base64
    import threading
    import urllib.request

    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav, read_wav_bytes, wav_bytes
    from zipvoice_tpu_torch.bin.serve import build_server, get_parser
    from zipvoice_tpu_torch.ops.quant import QuantizedLinear, quantized_bytes

    check_linear_int8_against_cpu(card)
    counters = _counters()
    out = {}
    for dtype in ("bfloat16", "float32"):
        base, kw = _r8s_pipeline(root, dtype)
        s = _r8s_inputs(base, kw)
        gen = s.gen_lens[0]
        base_mel = base._sample_fn(N_STEP, 1.0, 0.5)(*s.args)[0, :gen]
        vocode = base._vocode_i16_fn()
        base_pcm = vocode(base._sample_fn(N_STEP, 1.0, 0.5)(*s.args))
        for mode in QUANT_MODES:
            q = _quantized_pipeline(root, dtype, mode)
            scales = {m.weight_scale.dtype for m in q.model.modules()
                      if isinstance(m, QuantizedLinear)}
            if scales != {torch.float32}:
                raise AssertionError(f"{dtype} {mode}: weight_scale dtypes {scales}")
            r = out[(dtype, mode)] = dict(
                mb_before=quantized_bytes(base.model) / 1e6,
                mb_after=quantized_bytes(q.model) / 1e6)
            for fused in (False, True):
                _zero(counters)
                with _FusedEval() if fused else contextlib.nullcontext():
                    res = q.synthesize(**kw)  # first use of its buckets: eager, captured
                got = _launched(counters)
                want = _pins(INT8_FUSED_PER_REQUEST if fused else UNFUSED_PER_REQUEST,
                             counters)
                if got != want or not np.isfinite(res.wav).all():
                    raise AssertionError(f"{dtype} {mode} fused={fused}: launches {got}, "
                                         f"want {want}")
                r["fused_launches" if fused else "launches"] = got
            prog = q._sample_fn(N_STEP, 1.0, 0.5)
            prog(*s.args)
            replayed = prog(*s.args)
            with torch.no_grad():
                eager = prog.fn(*s.args)
            if not torch.equal(replayed, eager):
                raise AssertionError(f"{dtype} {mode}: replay differs from eager by "
                                     f"{_diff(replayed, eager)[0]}")
            mel = replayed[0, :gen]
            pcm = q._vocode_i16_fn()(replayed)
            if not torch.isfinite(mel.float()).all():
                raise AssertionError(f"{dtype} {mode}: mel not finite")
            r["mel_mse"] = float(((mel.float() - base_mel.float()) ** 2).mean())
            r["pcm_max_diff"] = float((pcm.int() - base_pcm.int()).abs().max())

            runs = {"float": [], mode: []}
            base.synthesize(**kw)
            q.synthesize(**kw)
            for tag in ("float", mode, mode, "float") * 2:
                runs[tag].append((base if tag == "float" else q).synthesize(**kw).metrics["rtf"])
            r["rtf"] = float(np.median(runs[mode]))
            r["rtf_float"] = float(np.median(runs["float"]))
            print(f"15a {dtype} {mode}: model {r['mb_before']:.1f} -> {r['mb_after']:.1f} MB, "
                  f"launches a request {r['launches']} (fused {r['fused_launches']}), replay = "
                  f"eager bitwise, mel MSE vs float {r['mel_mse']:.3g}, PCM16 max diff "
                  f"{r['pcm_max_diff']:.0f} counts, warm replayed rtf {r['rtf']:.5f} "
                  f"{[round(x, 5) for x in runs[mode]]} against float {r['rtf_float']:.5f} "
                  f"{[round(x, 5) for x in runs['float']]} (medians of 4 in turns) on {card}",
                  flush=True)
            del q, prog
        if dtype == "bfloat16":
            buckets = (s.tokens_padded.shape[1], s.noise.shape[1])
        del base
        gc.collect()
        torch.cuda.empty_cache()

    # the infer CLI, int8-dynamic (f32, the unfused pins)
    metrics, cli_launches = run_cli(root, ["r4s"], "float32", card,
                                    extra=("--quantize", "int8-dynamic"))
    # the serve CLI, int8 (bf16, its default), one request
    srv = build_server(get_parser().parse_args([
        "--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
        "--tokenizer", "simple", "--device", "cuda", "--port", "0", "--quantize", "int8"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        prompt, sr = read_wav(root / "prompt.wav")
        body = json.dumps({"text": TEXTS["r4s"], "prompt_text": PROMPT_TEXT,
                           "prompt_wav_b64": base64.b64encode(wav_bytes(prompt, sr)).decode()})
        _zero(counters)
        t0 = time.monotonic()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/synthesize",
                                     data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            data = resp.read()
        lat = time.monotonic() - t0
        serve_launches = _launched(counters)
        wav, _ = read_wav_bytes(data)
        want = expected_samples(TEXTS["r4s"], 3 * 24000)
        if (wav.shape != (1, want) or not np.isfinite(wav).all()
                or serve_launches != _pins(UNFUSED_PER_REQUEST, counters)):
            raise AssertionError(f"int8 server: wav {wav.shape} (want {want}), launches "
                                 f"{serve_launches}")
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    print(f"15a CLIs: infer --quantize int8-dynamic f32 rtf {metrics[0]['rtf']:.4f}, launches "
          f"{cli_launches}; serve --quantize int8 (bf16) one request in {lat * 1e3:.1f} ms "
          f"(first use: eager and captured), launches {serve_launches} on {card}", flush=True)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out, cli_launches, serve_launches, buckets


def _tiny_model_dir(root: Path) -> Path:
    """A model dir of a narrow two-layer ZipVoice (phase 4's tokens): the
    CPU export, which only has to exist for the loader's refusal."""
    import torch

    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, save_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice

    d = root / "tiny_model"
    d.mkdir()
    shutil.copy(root / "tokens.txt", d / "tokens.txt")
    cfg = ZipVoiceConfig(
        vocab_size=len((root / "tokens.txt").read_text().splitlines()), pad_id=0,
        fm_decoder_downsampling_factor=(1,), fm_decoder_num_layers=(1,),
        fm_decoder_cnn_module_kernel=(9,), fm_decoder_feedforward_dim=64,
        fm_decoder_num_heads=2, fm_decoder_dim=32, text_encoder_num_layers=1,
        text_encoder_feedforward_dim=64, text_encoder_num_heads=2, text_encoder_dim=32,
        time_embed_dim=32, text_embed_dim=32, query_head_dim=8, value_head_dim=8,
        pos_head_dim=4, pos_dim=32)
    save_model_json(d / "model.json", cfg, FeatureConfig())
    torch.save({"model": init_zipvoice(cfg, torch.Generator().manual_seed(0)).state_dict()},
               d / "model.pt")
    return d


def _die_with_parent():
    """In a child before exec: SIGKILL when the process that started it
    ends (prctl PR_SET_PDEATHSIG), so no worker outlives the script."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def start_exports(root: Path):
    """15b's three export CLI runs as processes started together: bf16
    (EXPORT_STEPS steps) and bf16 int8-dynamic (EXPORT_STEPS_INT8) at the
    default static sizes (256 tokens, 3072 frames) on the card, and a CPU
    export of a tiny model (for the loader's refusal).  Returns {name:
    (Popen, log path, out dir)}."""
    import os

    runs = {
        "bf16": (root, ["--num-step", str(EXPORT_STEPS)]),
        "int8-dynamic": (root, ["--quantize", "int8-dynamic",
                                "--num-step", str(EXPORT_STEPS_INT8)]),
        "cpu": (_tiny_model_dir(root), ["--device", "cpu", "--num-step", "1",
                                        "--max-tokens", "32", "--max-frames", "128"]),
    }
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = {}
    for name, (model_dir, extra) in runs.items():
        out = root / f"export_{name}"
        log = root / f"export_{name}.log"
        cmd = [sys.executable, "-m", "zipvoice_tpu_torch.bin.export_model",
               "--model-dir", str(model_dir), "--out-dir", str(out), "--dtype", "bfloat16",
               *extra]
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                            stderr=subprocess.STDOUT,
                                            preexec_fn=_die_with_parent), log, out)
    return procs


def finish_exports(procs, card: str, timeout: float = 900.0):
    """Waits for start_exports' processes; checks each wrote its three
    programs and prints its trace and total seconds and each artifact's MB.
    Returns {name: {"trace_s", "total_s", "mb": {program: MB}, "dir"}}."""
    import re

    out = {}
    try:
        for name, (proc, log, d) in procs.items():
            rc = proc.wait(timeout=timeout)
            text = log.read_text()
            if rc != 0:
                raise AssertionError(f"export {name} exited {rc}:\n{text[-3000:]}")
            trace = re.search(r"traced .* in ([0-9.]+) s", text)
            total = re.search(r"done: .* in ([0-9.]+) s", text)
            mb = {p: (d / f"{p}.pt2").stat().st_size / 1e6
                  for p in ("text_model", "fm_decoder_step", "sampler_fused")}
            out[name] = dict(trace_s=float(trace.group(1)), total_s=float(total.group(1)),
                             mb=mb, dir=str(d))
            print(f"15b export {name}: traced in {out[name]['trace_s']:.1f} s, traced and "
                  f"saved in {out[name]['total_s']:.1f} s; "
                  + ", ".join(f"{p} {v:.1f} MB" for p, v in mb.items()) + f" on {card}",
                  flush=True)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _exported_argv(root: Path, export_dir: str, mode: str):
    return ["--export-dir", export_dir, "--model-dir", str(root), "--tokenizer", "simple",
            "--vocoder-path", str(root / "vocos.bin"), "--mode", mode,
            "--num-step", str(N_STEP), "--prompt-wav", str(root / "prompt.wav"),
            "--prompt-text", PROMPT_TEXT, "--text", TEXTS["r8s"],
            "--res-wav-path", str(root / f"exported_{mode}.wav"), "--device", "cuda"]


def load_exported_runs(root: Path, exports, card: str):
    """15b before its turn on the card: ``bin/infer_exported.load`` of both
    modes over the bf16 export (the fused program with EXPORT_STEPS
    steps), the int8-dynamic export's fused program with the int8-dynamic
    pipeline it is held against, and the loader's refusal of the CPU
    export.  Returns the loaded state and the seconds."""
    from zipvoice_tpu_torch.bin import infer_exported

    t0 = time.monotonic()
    state = {}
    for mode in ("fused", "host-loop"):
        args = infer_exported.get_parser().parse_args(
            _exported_argv(root, exports["bf16"]["dir"], mode))
        state[mode] = (args, *infer_exported.load(args))
    state["int8-dynamic"] = (
        infer_exported.ExportedSampler(exports["int8-dynamic"]["dir"], "cuda"),
        _quantized_pipeline(root, "bfloat16", "int8-dynamic"))
    cpu_art = Path(exports["cpu"]["dir"]) / "fm_decoder_step.pt2"
    try:
        infer_exported.load_exported(cpu_art, "cuda")
        raise AssertionError("a CPU-exported artifact loaded for the card")
    except ValueError as e:
        print(f"15b the loader refuses the CPU export on the card: {e}", flush=True)
    return state, time.monotonic() - t0


def run_exported(root: Path, state, card: str):
    """15b on the card: bin/infer_exported's request in both modes on the
    ~8 s text (the fused exported sampler, EXPORT_STEPS steps, captured then
    replayed; the host loop at 16), launches a request pinned (the host
    loop's at B1 260 / B2 520), a finite wav of the expected length; the
    fused sampler against the pipeline's own ``sample`` on the same inputs
    (relative L2 <= EXPORT_REL_L2); the warm RTF of each mode at
    EXPORT_STEPS steps (medians of 4 in turns); the int8-dynamic export's fused sampler (EXPORT_STEPS_INT8
    steps) pinned and against the int8-dynamic pipeline's ``sample`` at as
    many steps (relative L2 <= EXPORT_INT8_REL_L2), beside its error against
    the float model's.  Returns the numbers."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin import infer_exported
    from zipvoice_tpu_torch.models import zipvoice as zv

    counters = _counters()
    res = {}
    for mode in ("fused", "host-loop"):
        args, sampler, pipe = state[mode]
        _zero(counters)
        t0 = time.monotonic()
        r = infer_exported.run(args, sampler, pipe)
        wall = time.monotonic() - t0
        got = _launched(counters)
        want = _pins(EXPORT_FUSED_PER_REQUEST if mode == "fused" else UNFUSED_PER_REQUEST,
                     counters)
        samples = expected_samples(TEXTS["r8s"], 3 * 24000)
        if got != want or r["wav"].shape != (samples,) or not np.isfinite(r["wav"]).all():
            raise AssertionError(f"exported {mode}: launches {got} (want {want}), wav "
                                 f"{r['wav'].shape} (want {samples})")
        res[mode] = dict(launches=got, first_s=wall)
        print(f"15b infer_exported {mode}: first request {wall:.1f} s ("
              + ("eager, then captured" if mode == "fused" else "eager")
              + f"), launches {got}, {r['wav_seconds']:.2f} s audio on {card}", flush=True)

    # the fused exported sampler against the pipeline's own sample
    _, sampler, pipe = state["fused"]
    prompt, sr = read_wav(root / "prompt.wav")
    tok = pipe.tokenizer.texts_to_token_ids
    pf, _ = pipe.prompt_features(prompt, sr)
    args, _ = sampler.inputs(tok([TEXTS["r8s"]])[0], tok([PROMPT_TEXT])[0], pf, 1.0, 0, 5)
    args = (*args[:5], args[5].to(sampler.dtype))
    x1 = sampler.fused(*args)
    with torch.no_grad():  # the pipeline's f32 weights in bf16, as the export casts them
        ref_model = copy.deepcopy(pipe.model).to(torch.bfloat16)

        def sample(model, steps):
            return zv.sample(model, *args, num_step=steps, guidance_scale=1.0, t_shift=0.5)

        ref = sample(ref_model, EXPORT_STEPS)
    err, same = _diff(x1, ref)
    rel = _rel_l2(x1, ref)
    print(f"15b exported fused sampler vs the pipeline's sample (bf16, {EXPORT_STEPS} steps, "
          f"T={sampler.t_max}): max |diff| {err:.3g}, relative L2 {rel:.3g} (limit "
          f"{EXPORT_REL_L2}), bitwise {same} on {card}", flush=True)
    if not rel <= EXPORT_REL_L2:
        raise AssertionError(f"exported sampler vs sample: relative L2 {rel}")

    # warm RTF, fused replayed and host loop, both at EXPORT_STEPS steps, in turns
    kw = dict(text=TEXTS["r8s"], prompt_text=PROMPT_TEXT, prompt_wav=prompt, prompt_sr=sr,
              num_step=EXPORT_STEPS)
    runs = {"fused": [], "host-loop": []}
    for mode in ("fused", "host-loop", "host-loop", "fused") * 2:
        _, s_, p_ = state[mode]
        runs[mode].append(infer_exported.synthesize(s_, p_, **kw)["rtf"])
    for mode in runs:
        res[mode]["rtf"] = float(np.median(runs[mode]))
    print(f"15b exported warm rtf at {EXPORT_STEPS} steps: fused replayed "
          f"{res['fused']['rtf']:.5f} {[round(x, 5) for x in runs['fused']]}, host loop {res['host-loop']['rtf']:.5f} "
          f"{[round(x, 5) for x in runs['host-loop']]} (medians of 4 in turns; the programs "
          f"and the vocoder at {sampler.t_max} frames) on {card}", flush=True)

    # the int8-dynamic export's fused sampler against the int8-dynamic
    # pipeline's sample (and, for scale, the float model's)
    q, q_pipe = state["int8-dynamic"]
    _zero(counters)
    x1q = q.fused(*args)
    got = _launched(counters)
    if (got != _pins(_export_pins(EXPORT_STEPS_INT8), counters)
            or not torch.isfinite(x1q.float()).all()):
        raise AssertionError(f"int8-dynamic export: launches {got}")
    with torch.no_grad():
        ref_q = sample(q_pipe.model, EXPORT_STEPS_INT8)
        ref_f = sample(ref_model, EXPORT_STEPS_INT8)
    err_q, same_q = _diff(x1q, ref_q)
    rel_q, rel_f = _rel_l2(x1q, ref_q), _rel_l2(x1q, ref_f)
    res["int8-dynamic"] = dict(launches=got, rel_l2=rel_q, rel_l2_float=rel_f)
    print(f"15b int8-dynamic exported fused sampler ({EXPORT_STEPS_INT8} step): launches {got}; "
          f"vs the int8-dynamic pipeline's sample max |diff| {err_q:.3g}, relative L2 "
          f"{rel_q:.3g} (limit {EXPORT_INT8_REL_L2}), bitwise {same_q}; vs the float model's "
          f"relative L2 {rel_f:.3g} on {card}", flush=True)
    if not rel_q <= EXPORT_INT8_REL_L2:
        raise AssertionError(f"int8-dynamic export vs the int8-dynamic pipeline: relative L2 "
                             f"{rel_q}")
    return res


def _export_worker(root: str, card: str) -> int:
    """15b in a process of its own (``--export-worker``): the exports, then
    the loads; it writes ``export_ready.json`` and waits for a line on
    stdin, which the script sends after 15a, when the card is free; then
    the checks on the card into ``export_result.json``."""
    sys.path.insert(0, str(REPO))
    root = Path(root)
    t0 = time.monotonic()
    exports = finish_exports(start_exports(root), card)
    export_s = time.monotonic() - t0
    state, load_s = load_exported_runs(root, exports, card)
    (root / "export_ready.json").write_text(json.dumps(
        dict(exports=exports, export_s=export_s, load_s=load_s)))
    if sys.stdin.readline().strip() != "go":
        return 1
    t0 = time.monotonic()
    res = run_exported(root, state, card)
    res["run_s"] = time.monotonic() - t0
    (root / "export_result.json").write_text(json.dumps(res))
    return 0


def start_export_worker(root: Path, card: str):
    """Starts ``_export_worker`` at low priority beside the phases that
    follow phase 4; returns (Popen, log path)."""
    import os

    def child():
        _die_with_parent()
        os.nice(10)

    log = root / "export_worker.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--export-worker", str(root),
             card], cwd=REPO, stdin=subprocess.PIPE, stdout=f,
            stderr=subprocess.STDOUT, text=True, preexec_fn=child)
    return proc, log


def finish_export_worker(worker, root: Path, timeout: float = 900.0):
    """Waits for the worker's loads, prints its output so far, gives it the
    card, waits for its checks and prints the rest.  Returns its exports
    and its results; a worker that exited or failed fails the phase."""
    proc, log = worker
    ready = root / "export_ready.json"
    t0 = time.monotonic()
    while not ready.exists():
        if proc.poll() is not None or time.monotonic() - t0 > timeout:
            raise AssertionError(f"export worker: exit {proc.poll()} before its loads "
                                 f"finished:\n{log.read_text()[-4000:]}")
        time.sleep(1.0)
    waited = time.monotonic() - t0
    head = log.read_text()
    print(head, end="", flush=True)
    info = json.loads(ready.read_text())
    print(f"15b worker: exports {info['export_s']:.1f} s and loads {info['load_s']:.1f} s "
          f"beside phases 5-15a; phase 15 waited {waited:.1f} s for them", flush=True)
    proc.stdin.write("go\n")
    proc.stdin.flush()
    rc = proc.wait(timeout=timeout)
    print(log.read_text()[len(head):], end="", flush=True)
    if rc != 0:
        raise AssertionError(f"export worker exited {rc}")
    return info["exports"], json.loads((root / "export_result.json").read_text())


def _train_batches(root: Path, manifest: Path, steps: int):
    """(B, T, S) of the first `steps` batches of phase 8's train CLI run
    (its sampler and collator, seeded as the CLI seeds them)."""
    from zipvoice_tpu_torch.bin._train_common import build_data
    from zipvoice_tpu_torch.bin.train_zipvoice import get_parser
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer

    args = get_parser().parse_args([
        "--train-manifest", str(manifest), "--token-file", str(root / "tokens.txt"),
        "--tokenizer", "simple", "--model-config", str(root / "model.json"),
        "--exp-dir", str(root / "unused"), "--max-duration", "100", "--device", "cuda"])
    tok = SimpleTokenizer(str(root / "tokens.txt"))
    sampler, collate, _ = build_data(args, tok, FeatureConfig(), tok.pad_id, "cuda",
                                     skip_dev=True)
    sampler.set_epoch(1)
    shapes = []
    for utts in sampler:
        batch = collate(utts)
        shapes.append((*batch["features"].shape[:2], batch["tokens"].shape[1]))
        if len(shapes) == steps:
            break
    return shapes


def run_mfu(root: Path, manifest: Path, card: str, replay_rtf: float, s_pad: int,
            t_pad: int, step_ms: float, steps: int):
    """15c: model-FLOPs utilization (utils/flops.py, against the card's
    dense bf16 peak) of phase 5e's replayed bf16 ~8 s request (the sampler's
    16 CFG steps and the vocoder at its token and frame buckets) and of
    phase 8's warm step (the mean FLOPs of the steps its median interval
    covers, at their padded shapes)."""
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.utils import flops

    cfg = load_model_dir(str(root), tokenizer_name="simple").model_cfg
    name = torch.cuda.get_device_name(0)
    req_flops = (flops.sampler_flops(cfg, t_pad, s_pad, N_STEP)
                 + flops.vocos_fwd_flops(t_pad, feat_dim=cfg.feat_dim))
    req_s = replay_rtf * expected_samples(TEXTS["r8s"], 3 * 24000) / 24000
    shapes = _train_batches(root, manifest, steps)
    warm = shapes[2:] if len(shapes) > 2 else shapes
    step_flops = sum(flops.train_step_flops(cfg, b, t, s) for b, t, s in warm) / len(warm)
    out = dict(request_tflop=req_flops / 1e12, request_s=req_s,
               request_mfu=flops.mfu(req_flops, req_s, name),
               step_tflop=step_flops / 1e12, step_s=step_ms / 1e3,
               step_mfu=flops.mfu(step_flops, step_ms / 1e3, name),
               peak_tflops=flops.peak_bf16_tflops(name), shapes=shapes)
    print(f"15c MFU against {out['peak_tflops']:.0f} TFLOP/s (bf16 dense): replayed bf16 r8s "
          f"request {out['request_tflop']:.2f} TFLOP in {req_s * 1e3:.1f} ms, MFU "
          f"{out['request_mfu']:.4f} (s_pad {s_pad}, t_pad {t_pad}); warm train step "
          f"{out['step_tflop']:.2f} TFLOP (batches (B, T, S) {warm}) in {step_ms:.1f} ms, MFU "
          f"{out['step_mfu']:.4f} on {card}", flush=True)
    return out


def run_phase15(root: Path, manifest: Path, card: str, replay_rtf: float, step_ms: float,
                steps: int, worker):
    """Phase 15 (15a-15c) with its wall time; 15b's worker exported and
    loaded beside the phases before it."""
    t0 = time.monotonic()
    int8, cli_launches, serve_launches, (s_pad, t_pad) = run_int8_serving(root, card)
    exports, exported = finish_export_worker(worker, root)
    mfu = run_mfu(root, manifest, card, replay_rtf, s_pad, t_pad, step_ms, steps)
    print(f"phase 15: {time.monotonic() - t0:.1f} s on {card}", flush=True)
    return dict(int8=int8, cli_launches=cli_launches, serve_launches=serve_launches,
                exports=exports, exported=exported, mfu=mfu)


# ---------------------------------------------------------------------------
# Phase 16: egs/zipvoice/run.sh's stages 0-2 through the port's CLIs, with
# the native wav loader; phase 17: the evaluation models and CLIs
# ---------------------------------------------------------------------------

PREP_STEPS = 3


def make_raw_corpus(root: Path, manifest: Path) -> Path:
    """16a: a raw corpus of phase 8's rows plus two 16 kHz and two 48 kHz
    files, a stereo file, a 5-column segment row, a segment past its file's
    end and an unreadable row (the last two dropped by stage 0)."""
    import numpy as np

    from zipvoice_tpu_torch.audio.wav import write_wav

    d = root / "prep"
    d.mkdir()
    rows = manifest.read_text().splitlines()
    wav0, wav1 = (row.split("\t")[2] for row in rows[:2])
    rng = np.random.default_rng(16)
    for i, (sr, ch, sec) in enumerate([(16000, 1, 3.0), (16000, 1, 5.0), (48000, 1, 2.5),
                                       (48000, 1, 4.0), (24000, 2, 4.0)]):
        path = d / f"extra{i}.wav"
        write_wav(path, (0.05 * rng.standard_normal((ch, int(sec * sr)))).astype(np.float32), sr)
        rows.append(f"extra{i}\t{(BASE * 2)[9 * i: 9 * i + int(15 * sec)]}\t{path}")
    rows.append(f"segment\t{BASE[:25]}\t{wav0}\t0.5\t2.0")
    rows.append(f"past_end\t{BASE[:25]}\t{wav1}\t1.0\t60.0")
    (d / "broken.wav").write_bytes(b"RIFF0000WAVEjunk")
    rows.append(f"broken\t{BASE[:25]}\t{d / 'broken.wav'}")
    (d / "raw.tsv").write_text("\n".join(rows) + "\n")
    return d


def check_fbank_card_vs_cpu(d: Path, manifest: Path, card: str):
    """16d: bin/compute_fbank on the card and with --device cpu on the same
    manifest: the same shard names, index, keys and shapes, each float16
    feature within one float16 ulp plus 2e-5 of the CPU's (the ulp alone
    is reported).  Returns (card dir, largest difference, elements beyond
    one ulp, seconds on the card)."""
    import numpy as np

    from zipvoice_tpu_torch.bin import compute_fbank

    t0 = time.monotonic()
    argv = ["--manifest", str(manifest), "--shard-size", "8"]
    compute_fbank.main(argv + ["--output-dir", str(d / "fbank_cuda"), "--device", "cuda"])
    card_s = time.monotonic() - t0
    compute_fbank.main(argv + ["--output-dir", str(d / "fbank_cpu"), "--device", "cpu"])
    names = sorted(p.name for p in (d / "fbank_cuda").iterdir())
    if names != sorted(p.name for p in (d / "fbank_cpu").iterdir()):
        raise AssertionError(f"compute_fbank: card and CPU shards differ: {names}")
    index = "custom_train_feats.tsv"
    if (d / "fbank_cuda" / index).read_text() != (d / "fbank_cpu" / index).read_text():
        raise AssertionError("compute_fbank: card and CPU indexes differ")
    worst, beyond_ulp, n = 0.0, 0, 0
    for name in names:
        if not name.endswith(".npz"):
            continue
        a_all, b_all = np.load(d / "fbank_cuda" / name), np.load(d / "fbank_cpu" / name)
        if a_all.files != b_all.files:
            raise AssertionError(f"compute_fbank {name}: keys {a_all.files} vs {b_all.files}")
        for uid in a_all.files:
            a, b = a_all[uid], b_all[uid]
            if a.shape != b.shape or a.dtype != np.float16:
                raise AssertionError(f"compute_fbank {uid}: {a.shape} {a.dtype} vs {b.shape}")
            ulp = np.maximum(np.spacing(np.abs(a)), np.spacing(np.abs(b))).astype(np.float32)
            diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
            if not (diff <= ulp + 2e-5).all():
                raise AssertionError(f"compute_fbank {uid}: card vs CPU {diff.max():.3g} beyond "
                                     "one float16 ulp plus 2e-5")
            worst = max(worst, float(diff.max()))
            beyond_ulp += int((diff > ulp).sum())
            n += diff.size
    print(f"compute_fbank: {len(names) - 1} shards, card vs CPU largest difference {worst:.3g} "
          f"({beyond_ulp} of {n} features beyond one float16 ulp), {card_s:.2f} s on the card "
          f"(the wavs read and resampled on the host) on {card}", flush=True)
    return d / "fbank_cuda", worst, beyond_ulp, card_s


def check_native_loader(manifest: Path, card: str):
    """16e: the port's native library loads (no numpy path on the card's
    machine); on a B=8 batch of whole 24 kHz files batch_load_wav equals
    the read_wav path within 1e-6; the host ms of batch_load_wav and of the
    per-file load_audio loop, medians of 3 in turns."""
    import os

    import numpy as np

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.data.dataset import OnDeviceFbankCollator, read_tsv_manifest
    from zipvoice_tpu_torch.ops import native

    if not native.available():
        raise AssertionError("native io library did not build or load")
    utts = read_tsv_manifest(manifest)[:8]
    paths = [u.wav_path for u in utts]
    ref = [read_wav(p) for p in paths]
    max_len = max(w.shape[-1] for w, _ in ref)
    audio, lens = native.batch_load_wav(paths, 24000, max_len)
    err = 0.0
    for i, (w, sr) in enumerate(ref):
        if sr != 24000 or lens[i] != w.shape[-1]:
            raise AssertionError(f"native loader: {paths[i]} {lens[i]} samples, want "
                                 f"{w.shape[-1]} at {sr} Hz")
        err = max(err, float(np.abs(audio[i, : lens[i]] - w[0]).max()))
    if err > 1e-6:
        raise AssertionError(f"native loader vs read_wav: {err:.3g} > 1e-6")
    col = OnDeviceFbankCollator(None, FeatureConfig(), device="cpu")
    ms = {"native": [], "per-file": []}
    for _ in range(3):
        t0 = time.perf_counter()
        native.batch_load_wav(paths, 24000, max_len)
        ms["native"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        [col.load_audio(u) for u in utts]
        ms["per-file"].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    secs = sum(w.shape[-1] for w, _ in ref) / 24000
    print(f"native loader: {native.library_path().name} loaded; B=8 whole 24 kHz files "
          f"({secs:.1f} s of audio) equal to read_wav within {err:.3g}; host ms "
          f"batch_load_wav {med['native']:.2f}, per-file load_audio {med['per-file']:.2f} "
          f"(medians of 3, {os.cpu_count()} host cores) beside {card}", flush=True)
    return med, err


class _CountLoads:
    """Within the block: the calls of native.batch_load_wav and of
    OnDeviceFbankCollator.load_audio (``native``, ``per_file``)."""

    def __enter__(self):
        from zipvoice_tpu_torch.data.dataset import OnDeviceFbankCollator
        from zipvoice_tpu_torch.ops import native

        self.native = self.per_file = 0
        self._saved = (native.batch_load_wav, OnDeviceFbankCollator.load_audio)
        load, per_file = self._saved

        def counted_native(*a, **k):
            self.native += 1
            return load(*a, **k)

        def counted_per_file(col, utt):
            self.per_file += 1
            return per_file(col, utt)

        native.batch_load_wav = counted_native
        OnDeviceFbankCollator.load_audio = counted_per_file
        return self

    def __exit__(self, *exc):
        from zipvoice_tpu_torch.data.dataset import OnDeviceFbankCollator
        from zipvoice_tpu_torch.ops import native

        native.batch_load_wav, OnDeviceFbankCollator.load_audio = self._saved
        return False


def run_prep_training(root: Path, d: Path, manifest: Path, tokens: Path, tag: str, card: str):
    """16f: the train CLI as stage 2 runs it (emilia tokenizer, offline
    tokens), PREP_STEPS steps with the regularizers in bf16 at full width:
    finite losses, phase 8's launches a step; returns (launches a step,
    loads, warm step ms)."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.bin.train_zipvoice import main as train_main

    counters = _counters()
    _zero(counters)
    exp = d / f"exp_{tag}"
    with _CountLoads() as loads:
        res = train_main([
            "--device", "cuda", "--train-manifest", str(manifest), "--token-file", str(tokens),
            "--tokenizer", "emilia", "--model-config", str(root / "model.json"),
            "--exp-dir", str(exp), "--num-epochs", "1", "--num-steps-per-epoch",
            str(PREP_STEPS), "--max-duration", "100", "--log-interval", "1",
            "--dtype", "bfloat16"])
    torch.cuda.synchronize()
    launches = _launched(counters)
    n = len(res["steps"])
    want = {k: PER_STEP.get(k, 0) * n for k in counters}
    want["B4"] = 0
    losses = [x for _, x in res["steps"]]
    if n != PREP_STEPS or launches != want:
        raise AssertionError(f"stage 2 ({tag}): launches {launches} over {n} steps, want {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"stage 2 ({tag}): non-finite loss {losses}")
    ends = [t for t, _ in res["steps"]]
    step_ms = float(np.median(np.diff(ends))) * 1e3
    vocab = res["trainer"].model.embed.weight.shape[0]
    del res
    shutil.rmtree(exp, ignore_errors=True)
    print(f"stage 2 ({tag}): {n} steps, losses {[round(x, 4) for x in losses]}, vocabulary "
          f"{vocab}, launches a step {({k: v // n for k, v in launches.items() if v})}, "
          f"batch_load_wav calls {loads.native}, per-file load_audio calls {loads.per_file}, "
          f"step {step_ms:.1f} ms (median interval) on {card}", flush=True)
    return {k: v // n for k, v in launches.items()}, (loads.native, loads.per_file), step_ms


def run_phase16(root: Path, manifest: Path, card: str):
    """Phase 16: stages 0-2 of egs/zipvoice/run.sh through the port's CLIs
    on a raw corpus (16a-16b prepare_dataset with --resample-dir, 16c
    prepare_tokens with the emilia tokenizer and make_tokens over the
    prepared manifest, 16d compute_fbank card vs CPU, 16e the native
    loader, 16f the train CLI, 16g PrecomputedFeatureCollator over 16d's
    shards).  Stage 2's manifest has segment rows (start and end, as stage
    0 writes every row), which the collator crops file by file, as the
    reference package's does; the same rows as whole files with their
    offline tokens (4 columns) take the native loader in every batch."""
    import numpy as np

    from zipvoice_tpu_torch.bin import make_tokens, prepare_dataset, prepare_tokens
    from zipvoice_tpu_torch.data.dataset import PrecomputedFeatureCollator, read_tsv_manifest
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    t0 = time.monotonic()
    d = make_raw_corpus(root, manifest)
    n_raw = len((d / "raw.tsv").read_text().splitlines())
    prep = prepare_dataset.main(["--tsv-path", str(d / "raw.tsv"), "--output-dir", str(d),
                                 "--resample-dir", str(d / "resampled")])
    if (prep["kept"], prep["dropped"]) != (n_raw - 2, 2):
        raise AssertionError(f"prepare_dataset: kept {prep['kept']} dropped {prep['dropped']} "
                             f"of {n_raw}, want {n_raw - 2} and 2")
    utts = read_tsv_manifest(prep["manifest"])
    resampled = [u.uid for u in utts if "/resampled/" in u.wav_path]
    if resampled != ["extra0", "extra1", "extra2", "extra3"]:
        raise AssertionError(f"prepare_dataset: resampled {resampled}")
    tok_tsv = prepare_tokens.main(["--manifest", prep["manifest"], "--output",
                                   str(d / "custom_train_tokens.tsv"), "--tokenizer", "emilia"])
    tokens = Path(make_tokens.main(["--manifest", prep["manifest"], "--tokenizer", "emilia",
                                    "--output", str(d / "tokens_emilia.txt")]))
    tok_utts = read_tsv_manifest(tok_tsv)
    n_tokens = len(tokens.read_text().splitlines())
    if len(tok_utts) != len(utts) or not all(u.token_strs for u in tok_utts):
        raise AssertionError("prepare_tokens: rows without tokens")
    print(f"stages 0-1: prepare_dataset kept {prep['kept']} and dropped {prep['dropped']} of "
          f"{n_raw} rows ({len(resampled)} resampled to 24 kHz), prepare_tokens (emilia) "
          f"{len(tok_utts)} rows, make_tokens {n_tokens} tokens in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    feats_dir, fbank_err, beyond_ulp, fbank_s = check_fbank_card_vs_cpu(
        d, Path(prep["manifest"]), card)
    loader_ms, loader_err = check_native_loader(manifest, card)

    seg_launches, seg_loads, seg_ms = run_prep_training(root, d, Path(tok_tsv), tokens,
                                                        "custom_train_tokens.tsv", card)
    if seg_loads[0] != 0 or seg_loads[1] < PREP_STEPS:
        raise AssertionError(f"stage 2: segment rows loaded {seg_loads} (native, per file)")
    whole = d / "custom_train_tokens_whole.tsv"
    whole.write_text("".join(f"{u.uid}\t{u.text}\t{u.wav_path}\t{' '.join(u.token_strs)}\n"
                             for u in tok_utts if u.uid != "segment"))
    launches, loads, step_ms = run_prep_training(root, d, whole, tokens, "whole files", card)
    if loads[0] < PREP_STEPS or loads[1] != 0:
        raise AssertionError(f"stage 2 on whole files: loads {loads} (native, per file): the "
                             "native path was not taken in every batch")

    tokenizer = get_tokenizer("emilia", str(tokens))
    col = PrecomputedFeatureCollator(tokenizer, str(feats_dir / "custom_train_feats.tsv"),
                                     str(feats_dir))
    batch = col(tok_utts[:8])
    first = np.load(feats_dir / "custom_train_feats_00000.npz")[tok_utts[0].uid]
    if (batch["features_lens"][0] != first.shape[0]
            or not np.array_equal(batch["features"][0, : first.shape[0]],
                                  first.astype(np.float32) * 0.1)):
        raise AssertionError("PrecomputedFeatureCollator: row 0 is not its shard's features")
    secs = time.monotonic() - t0
    print(f"phase 16: {secs:.1f} s on {card}", flush=True)
    return dict(launches=launches, segment_launches=seg_launches, loads=loads,
                segment_loads=seg_loads, step_ms=step_ms, segment_step_ms=seg_ms,
                loader_ms=loader_ms, loader_err=loader_err, fbank_err=fbank_err,
                fbank_beyond_ulp=beyond_ulp, fbank_s=fbank_s, seconds=secs)


class _StandInSSL:
    """Phase 17's stand-in for WavLM-large (the card's machine has no
    transformers): ``config.num_hidden_layers`` and, for a (B, T) wave, 25
    seeded (B, T // 320, 1024) hidden states, the same on every device."""

    def __new__(cls):
        import types

        import torch

        class SSL(torch.nn.Module):
            config = types.SimpleNamespace(num_hidden_layers=24)

            def forward(self, wave, output_hidden_states=True):
                g = torch.Generator().manual_seed(170)
                shape = (25, wave.shape[0], wave.shape[1] // 320, 1024)
                states = torch.randn(shape, generator=g).to(wave.device)
                return types.SimpleNamespace(hidden_states=tuple(states))

        return SSL()


def run_phase17(root: Path, card: str):
    """Phase 17: the evaluation models and CLIs.  A full-width UTMOS22Strong
    with seeded random weights saved as a local checkpoint: its forward on
    two 3 s clips card vs CPU (relative L2 <= 1e-4, f32) and its ms on the
    card, the MOS CLI on phase 5's f32 wavs (a finite score a wav); the
    ECAPA-TDNN head at full width (feat_dim 1024, channels 512, emb_dim
    256) over a stand-in SSL module, card vs CPU; the cpSIM CLI on a stereo
    conversation with the tests' fake encoder; wer.score_pairs on fixed
    transcript pairs."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav, resample, write_wav
    from zipvoice_tpu_torch.eval import cpsim, mos, sim, wer
    from zipvoice_tpu_torch.eval.models.ecapa_tdnn_wavlm import ECAPA_TDNN_WavLM
    from zipvoice_tpu_torch.eval.models.utmos import UTMOS22Strong

    t0 = time.monotonic()
    d = root / "eval"
    d.mkdir()
    torch.manual_seed(17)
    utmos = UTMOS22Strong().eval()
    torch.save(utmos.state_dict(), d / "utmos22_strong.pt")
    wav_dir = root / "out_float32"
    clips = [resample(read_wav(p)[0][:, : 3 * 24000], 24000, 16000)[0]
             for p in sorted(wav_dir.glob("*.wav"))[:2]]
    wave = torch.from_numpy(np.stack(clips))
    with torch.no_grad():
        ref = utmos(wave)
        utmos.cuda()
        out = utmos(wave.cuda())
        utmos_ms = time_ms(lambda: utmos(wave.cuda()), iters=5)
    utmos_err = _rel_l2(out.cpu(), ref)
    if not torch.isfinite(out).all() or utmos_err > 1e-4:
        raise AssertionError(f"UTMOS card vs CPU relative L2 {utmos_err:.3g} > 1e-4 ({out})")
    del utmos
    res = mos.main(["--wav-dir", str(wav_dir), "--checkpoint", str(d / "utmos22_strong.pt"),
                    "--out", str(d / "utmos.tsv"), "--device", "cuda"])
    n_wavs = len(list(wav_dir.glob("*.wav")))
    lines = (d / "utmos.tsv").read_text().strip().split("\n")
    if len(lines) != n_wavs + 1 or not all(np.isfinite([s for _, s in res["rows"]])):
        raise AssertionError(f"MOS CLI: {lines}")

    torch.manual_seed(18)
    head = ECAPA_TDNN_WavLM(feat_dim=1024, channels=512, emb_dim=256, ssl=_StandInSSL()).eval()
    wave = torch.from_numpy(np.random.default_rng(17).standard_normal((2, 48000))
                            .astype(np.float32) * 0.1)
    with torch.no_grad():
        ref = head(wave)
        cpu_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            head(wave)
            cpu_ms.append((time.perf_counter() - t1) * 1e3)
        ecapa_cpu_ms = float(np.median(cpu_ms))
        head.cuda()
        out = head(wave.cuda())
        ecapa_ms = time_ms(lambda: head(wave.cuda()), iters=5)
    ecapa_err = _rel_l2(out.cpu(), ref)
    if out.shape != (2, 256) or not torch.isfinite(out).all() or ecapa_err > 1e-4:
        raise AssertionError(f"ECAPA card vs CPU relative L2 {ecapa_err:.3g} > 1e-4")
    del head

    sr = 24000
    t = np.arange(sr) / sr
    spk = [np.sin(2 * np.pi * f * t).astype(np.float32) for f in (220, 1760)]
    (d / "gen").mkdir()
    write_wav(d / "gen" / "c0.wav", np.stack([spk[1], spk[0]]), sr)
    write_wav(d / "p1.wav", spk[0][None, :], sr)
    write_wav(d / "p2.wav", spk[1][None, :], sr)
    (d / "list.tsv").write_text(f"c0\tt1\tt2\t{d / 'p1.wav'}\t{d / 'p2.wav'}\ttext\n")

    class FakeEncoder:
        """tests/test_eval.py's spectral-centroid embedding."""

        def __init__(self, *a, **k):
            pass

        def embed(self, w, rate):
            spec = np.abs(np.fft.rfft(np.asarray(w, np.float64).ravel()[:4096]))
            c = (spec * np.arange(spec.size)).sum() / (spec.sum() + 1e-9)
            return np.array([1.0, c / 1000.0])

    saved = sim.SpeakerEncoder
    sim.SpeakerEncoder = FakeEncoder
    try:
        cp = cpsim.main(["--wav-dir", str(d / "gen"), "--test-list", str(d / "list.tsv"),
                         "--prompt-mode", "split", "--device", "cuda"])
    finally:
        sim.SpeakerEncoder = saved
    if not cp["cpSIM"] > 0.99:
        raise AssertionError(f"cpSIM CLI: {cp}")
    scores = wer.score_pairs([("u0", "hello world", "hello world"),
                              ("u1", "a b c d", "a x c d")], "en")
    if abs(scores["wer_avg"] - 0.125) > 1e-12 or abs(scores["wer"] - 1 / 6) > 1e-12:
        raise AssertionError(f"score_pairs: {scores}")
    secs = time.monotonic() - t0
    print(f"phase 17: UTMOS22-strong (full width) card vs CPU relative L2 {utmos_err:.3g}, "
          f"forward {utmos_ms:.2f} ms on the card (B=2, 3 s at 16 kHz); MOS CLI "
          f"{res['UTMOS']:.3f} over {n_wavs} wavs; ECAPA head (1024/512/256) card vs CPU "
          f"{ecapa_err:.3g}, forward {ecapa_ms:.2f} ms on the card, {ecapa_cpu_ms:.1f} ms on the "
          f"host's CPU (median of 3; B=2, 3 s, stand-in SSL); cpSIM {cp['cpSIM']:.4f}; "
          f"WER {scores['wer']:.4f}; {secs:.1f} s on {card}", flush=True)
    return dict(utmos_err=utmos_err, utmos_ms=utmos_ms, ecapa_err=ecapa_err, ecapa_ms=ecapa_ms,
                ecapa_cpu_ms=ecapa_cpu_ms, mos=res["UTMOS"], cpsim=cp["cpSIM"], seconds=secs)


def _variant_extras(results, variants, key):
    """B1's / B2's launches a request of each variant (replayed) and its
    times at the distill shape (B=1, H=4, T=1024, f32)."""
    case = results[key][(1, 1024, "float32")]
    return {"launches_per_distill_request": variants["zipvoice_distill"]["replay_launches"][key],
            "launches_per_dialog_request": variants["zipvoice_dialog"]["replay_launches"][key],
            "launches_per_dialog_stereo_request":
                variants["zipvoice_dialog_stereo"]["replay_launches"][key],
            "distill_shape_ms": case["ms"], "distill_shape_plain_ms": case["plain_ms"],
            "distill_shape_bound_ms": case["bound_ms"]}


def _phase14_launches(ddp, two_ranks, policies, key):
    """A kernel's launches a step in phase 14: a distributed CLI step
    (14a), a rank's step of two on one card (14b, regularizers) and a step
    under each remat policy (14c)."""
    return {"launches_per_distributed_step": ddp["launches"][key] / DDP_STEPS,
            "launches_per_two_rank_step": two_ranks["ranks"][0]["regularizers"]["launches"][key],
            "launches_per_train_step_by_policy": {p: r["launches"][key]
                                                   for p, r in policies.items()}}


def _phase18_extras(p18, key):
    """A kernel's phase-18 numbers: each rectangular case of 18a (its
    error, kernel, plain, library and bound ms; B3 and B4 timed without the
    failsafe and the gate), the launches of a rank's sequence-parallel
    request (18b, B1 and B2), of a rank's tensor-parallel step (18c) and of
    a rank's sequence-parallel training step (18d: the f32 step without the
    regularizers, a bf16 step with them), and of those its rectangular
    ones."""
    if key in ("B1", "B2"):
        rect = {f"Tq={tq} Tk={tk} r0={r0} {dn}": (tq, r) for (tq, tk, r0, dn), r in
                p18["rect"][key].items()}
    else:
        rect = {f"Tq={tq} Tk={tk} r0={r0} H={h} vd={vd} {dn}": (tq, r)
                for (tq, tk, r0, h, vd, dn, pen, gate), r in p18["rect_train"][key].items()
                if r["ms"] is not None}
    every = (p18["rect"] if key in ("B1", "B2") else p18["rect_train"])[key].values()
    out = {"rectangular": {name: {
        "max_abs_err": r["abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
        for name, (_, r) in rect.items()},
        "rectangular_max_abs_err": max(r["abs_err"] for r in every),
        "launches_per_tp_step": p18["ranks"][0]["tp_steps"][-1]["launches"].get(key, 0)}
    if key in ("B1", "B2"):
        out["launches_per_sp_request_rank"] = p18["ranks"][0]["sp"]["launches"][key]
    sp = p18["sp_train"]["ranks"][0]
    out["launches_per_sp_step_rank"] = {
        "f32 no regularizers": sp["grad"]["launches"].get(key, 0),
        "bf16 regularizers": sp["steps"][-1]["launches"].get(key, 0)}
    if key in ("B3", "B4"):
        out["rectangular_launches_per_sp_step_rank"] = {
            "f32 no regularizers": sp["grad"]["rect"][key],
            "bf16 regularizers": sp["steps"][-1]["rect"][key]}
    return out


def _phase15_launches(p15, key):
    """A kernel's launches a request in phase 15: int8 serving unfused and
    with the fused eval path (bf16 int8 and int8-dynamic), and the exported
    programs (the fused sampler and the host loop at 16 steps, the
    int8-dynamic fused sampler at 1)."""
    int8 = {f"{mode} {dtype}": r for (dtype, mode), r in p15["int8"].items()}
    ex = p15["exported"]
    return {"launches_per_int8_request": {k: r["launches"][key] for k, r in int8.items()},
            "launches_per_int8_fused_request": {k: r["fused_launches"][key]
                                                for k, r in int8.items()},
            "launches_per_exported_request": {m: ex[m]["launches"][key]
                                              for m in ("fused", "host-loop", "int8-dynamic")}}


# ---------------------------------------------------------------------------
# Phase 18: B1 and B2 on rectangular score tiles (18a), the
# sequence-parallel sampler (18b) and a tensor-parallel training step (18c)
# ---------------------------------------------------------------------------

# (Tq, Tk, r0, kind): query rows [r0, r0 + Tq) of a T = Tk problem against
# every key; the 18b request's two halves at stack 0 (B=2 is its CFG
# batch), a quarter of a 1024-frame one with a padded key tail, and a
# text-encoder-sized one
RECT_CASES = [(1536, 3072, 0, "first half"), (1536, 3072, 1536, "second half"),
              (256, 1024, 384, "quarter"), (20, 40, 20, "text")]
SP_FRAMES = 3072  # 32.8 s at 93.75 frames a second, beyond the 30 s cap
SP_RANKS = 2
SP_TOL = 1e-4  # relative L2 of the SP output against one process's, f32 without TF32
TP_STEPS = 2
SP_TRAIN_STEPS = 2  # 18d's bf16 steps with the regularizers


def check_rect_kernels(square, card: str):
    """18a: B1 and B2 on rectangular tiles against their plain versions on
    the same inputs, f32 and bf16, at (B=2, H=4) (RECT_CASES; one batch
    row's keys padded), with their times and bounds beside the square
    T=1024 times of phase 3 (``square``)."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(18)
    b, h, qd, pd, vd = 2, 4, 32, 4, 12
    results = {"B1": {}, "B2": {}}
    for tq, tk, r0, kind in RECT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, pq, pe, v = rnd(b, tk, h, qd), rnd(b, tk, h, qd), rnd(b, tk, h, pd), \
                rnd(2 * tk - 1, h, pd), rnd(b, tk, h, vd)
            mask = torch.arange(tk, device="cuda")[None, :] >= torch.tensor(
                [tk, tk - tk // 3 - 1], device="cuda")[:, None]
            rows = slice(r0, r0 + tq)
            qr, pqr = q[:, rows].contiguous(), pq[:, rows].contiguous()
            pw = pe[tk - r0 - tq: 2 * tk - 1 - r0].contiguous()
            out = att.rel_attention_probs(qr, k, pqr, pw, mask, out_dtype=dtype)
            ref = att.rel_attention_probs_plain(qr, k, pqr, pw, mask, out_dtype=dtype)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = 2e-5 if dtype == torch.float32 else 8e-3  # phase 3's
            k_ms = time_ms(lambda: att.rel_attention_probs(qr, k, pqr, pw, mask,
                                                           out_dtype=dtype))
            p_ms = time_ms(lambda: att.rel_attention_probs_plain(qr, k, pqr, pw, mask,
                                                                 out_dtype=dtype))
            nbytes = s * (b * tq * h * qd + b * tk * h * qd + b * tq * h * pd
                          + (tq + tk - 1) * h * pd) + b * tk + s * b * h * tq * tk
            bnd, by = bound_ms(nbytes, 2 * b * h * tq * tk * (qd + pd), dn)
            results["B1"][(tq, tk, r0, dn)] = dict(abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                                                   library_ms=None, bound_ms=bnd, bound_by=by)
            sq = square["B1"][(2, 1024, dn)]["ms"]
            print(f"18a B1 rel_probs rectangular Tq={tq} of Tk={tk} (r0={r0}, {kind}) {dn}: "
                  f"max_abs_err {err:.3g} (tol {tol:g}) kernel_ms {k_ms:.4f} plain_ms "
                  f"{p_ms:.4f} bound_ms {bnd:.4f} ({by}); square T=1024 kernel_ms {sq:.4f} "
                  f"(phase 3) on {card}", flush=True)
            if not err <= tol:
                raise AssertionError(f"B1 rectangular disagrees at Tq={tq} Tk={tk} r0={r0} "
                                     f"{dn}: {err} > {tol}")

            o = att.rel_attention_probs_apply(out, v)
            oref = att.rel_attention_probs_apply_plain(out, v)
            torch.cuda.synchronize()
            scale = max(1.0, float(oref.float().abs().max()))
            err2 = float((o.float() - oref.float()).abs().max())
            tol2 = (2e-5 if dtype == torch.float32 else 8e-3) * scale
            v_hm = v.permute(0, 2, 1, 3).contiguous()
            k2 = time_ms(lambda: att.rel_attention_probs_apply(out, v))
            p2 = time_ms(lambda: att.rel_attention_probs_apply_plain(out, v))
            l2 = time_ms(lambda: torch.matmul(out, v_hm))
            nbytes2 = s * (b * h * tq * tk + b * tk * h * vd + b * tq * h * vd)
            bnd2, by2 = bound_ms(nbytes2, 2 * b * h * tq * tk * vd, dn)
            results["B2"][(tq, tk, r0, dn)] = dict(abs_err=err2, tol=tol2, ms=k2, plain_ms=p2,
                                                   library_ms=l2, bound_ms=bnd2, bound_by=by2)
            sq2 = square["B2"][(2, 1024, dn)]["ms"]
            print(f"18a B2 probs_apply rectangular Tq={tq} of Tk={tk} (r0={r0}, {kind}) {dn}: "
                  f"max_abs_err {err2:.3g} (tol {tol2:.3g}) kernel_ms {k2:.4f} plain_ms "
                  f"{p2:.4f} library_ms {l2:.4f} bound_ms {bnd2:.4f} ({by2}); square T=1024 "
                  f"kernel_ms {sq2:.4f} (phase 3) on {card}", flush=True)
            if not err2 <= tol2:
                raise AssertionError(f"B2 rectangular disagrees at Tq={tq} Tk={tk} r0={r0} "
                                     f"{dn}: {err2} > {tol2}")
            del q, k, pq, pe, v, out, ref, o, oref, v_hm
    return results


# B3's and B4's rectangular tiles (Tq, Tk, r0, B, kind): the SP training
# step's stack-0 halves (B=8 at T=1024 over two ranks), 18a's long tile and
# a text-encoder-sized one; B3 at (H=4, vd=12) and (H=1, vd=384), B4 at H=4
RECT_TRAIN_CASES = [(512, 1024, 0, 8, "stack-0 first half"),
                    (512, 1024, 512, 8, "stack-0 second half"),
                    (1536, 3072, 1536, 2, "second half"), (20, 40, 20, 8, "text")]
RECT_TRAIN_HEADS = [(4, 12), (1, 384)]


def check_rect_training_kernels(square, card: str):
    """18a: B3 and B4 on rectangular tiles against their plain versions on
    the same inputs, f32 and bf16, B3 with the failsafe and the const gate
    each on and off, B4 with the failsafe on and off (RECT_TRAIN_CASES, one
    batch row's keys padded, 3b's input scale), with their times and bounds
    beside phase 3b's square T=1024 times (``square``)."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(181)
    results = {"B3": {}, "B4": {}}
    for tq, tk, r0, b, kind in RECT_TRAIN_CASES:
        for h, vd in RECT_TRAIN_HEADS:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                s = torch.finfo(dtype).bits // 8
                q, k, pq, pe, mask, v, _ = _rel_inputs(gen, b, h, tk, vd, dtype, scale=1.5)
                rows = slice(r0, r0 + tq)
                q, pq = q[:, rows].contiguous(), pq[:, rows].contiguous()
                pe = pe[tk - r0 - tq: 2 * tk - 1 - r0].contiguous()
                g = torch.randn((b, tq, h, vd), generator=gen, device="cuda").to(dtype)
                in_bytes = (s * (b * tq * h * 36 + b * tk * h * 32 + (tq + tk - 1) * h * 4)
                            + b * tk)
                score_ops = 2 * b * h * tq * tk * 36
                limit_hi = _penalty_limit(q, k, pq, pe)
                for pen, gate in TRAIN_ATTN_VARIANTS:
                    limit = limit_hi if pen else 25.0
                    key = (tq, tk, r0, h, vd, dn, pen, gate)
                    timed = pen == 0.0 and not gate
                    if h == 4 and not gate:
                        gp = torch.randn((b, h, tq, tk), generator=gen, device="cuda").to(dtype)
                        ds = att.rel_attention_ds(q, k, pq, pe, mask, gp, pen, limit)
                        ref = att.rel_attention_ds_plain(q, k, pq, pe, mask, gp, pen, limit)
                        torch.cuda.synchronize()
                        abs_err, err = _errs(ds, ref)
                        tol = 2e-5 if dtype == torch.float32 else 8e-3  # 3b's
                        r = dict(abs_err=abs_err, rel_err=err, tol=tol, ms=None, plain_ms=None,
                                 library_ms=None, bound_ms=None, bound_by=None)
                        if timed:
                            r["ms"] = time_ms(lambda: att.rel_attention_ds(q, k, pq, pe, mask,
                                                                           gp))
                            r["plain_ms"] = time_ms(
                                lambda: att.rel_attention_ds_plain(q, k, pq, pe, mask, gp))
                            r["bound_ms"], r["bound_by"] = bound_ms(
                                in_bytes + 2 * s * b * h * tq * tk, score_ops, dn)
                        results["B4"][key] = r
                        sq = square["B4"][("main", 1024, 4, 12, dn, 0.0, False)]["ms"]
                        print(f"18a B4 rel_ds rectangular Tq={tq} of Tk={tk} (r0={r0}, {kind}) "
                              f"B={b} {dn} pen={pen:g}: rel_err {err:.3g} (tol {tol:g}), "
                              f"max_abs_err {abs_err:.3g}" + _times(r)
                              + (f"; square B=8 T=1024 kernel_ms {sq:.4f} (3b)" if timed else "")
                              + f" on {card}", flush=True)
                        if not err <= tol:
                            raise AssertionError(f"B4 rectangular disagrees at {key}: {err}")
                        del gp, ds, ref
                    outs = att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g, pen, limit,
                                                         gate)
                    refs = att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g, pen,
                                                               limit, gate)
                    torch.cuda.synchronize()
                    pairs = {n: _errs(o, rf) for n, o, rf in
                             zip(("dq", "dk", "dpq", "dpe", "dv"), outs, refs)}
                    errs = {n: rel for n, (_, rel) in pairs.items()}
                    err = max(errs.values())
                    tol = 1e-4  # 3b's
                    r = dict(abs_err=max(a for a, _ in pairs.values()), rel_err=err, tol=tol,
                             ms=None, plain_ms=None, library_ms=None, bound_ms=None,
                             bound_by=None)
                    if timed:
                        r["ms"] = time_ms(
                            lambda: att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g))
                        r["plain_ms"] = time_ms(
                            lambda: att.rel_attention_consume_bwd_plain(q, k, pq, pe, mask, v, g))
                        out_bytes = 4 * (b * tq * h * 36 + b * tk * h * 32
                                         + (tq + tk - 1) * h * 4 + b * tk * h * vd)
                        ops = score_ops + 2 * b * h * tq * tk * (2 * vd + 2 * 32 + 8)
                        r["bound_ms"], r["bound_by"] = bound_ms(
                            in_bytes + s * (b * tk + b * tq) * h * vd + out_bytes, ops, dn)
                    results["B3"][key] = r
                    label = "main" if h == 4 else "head0"
                    sq = square["B3"][(label, 1024, h, vd, dn, 0.0, False)]["ms"]
                    worst = max(errs, key=errs.get)
                    print(f"18a B3 rel_apply_bwd rectangular Tq={tq} of Tk={tk} (r0={r0}, {kind}) "
                          f"B={b} H={h} vd={vd} {dn} pen={pen:g} gate={int(gate)}: rel_err "
                          f"{err:.3g} ({worst}, tol {tol:g}), max_abs_err {r['abs_err']:.3g}"
                          + _times(r)
                          + (f"; square B=8 T=1024 kernel_ms {sq:.4f} (3b)" if timed else "")
                          + f" on {card}", flush=True)
                    if not err <= tol:
                        raise AssertionError(f"B3 rectangular disagrees at {key}: {errs}")
                    del outs, refs
                del q, k, pq, pe, mask, v, g
    return results


def _sp_request(cfg, frames: int = SP_FRAMES):
    """18b's request: one utterance of ``frames`` frames, a 3 s prompt,
    ~400 tokens, from a fixed seed (host tensors)."""
    import torch

    g = torch.Generator().manual_seed(18)
    s, t, f = 400, frames, cfg.feat_dim
    tokens = torch.randint(1, cfg.vocab_size, (1, s + 1), generator=g)
    tokens[:, s] = cfg.pad_id  # the extra pad of pad_labels
    return {"tokens": tokens,
            "tokens_lens": torch.tensor([s]),
            "prompt_features": 0.1 * torch.randn((1, t, f), generator=g),
            "prompt_features_lens": torch.tensor([281]),
            "features_lens": torch.tensor([t]),
            "noise": torch.randn((1, t, f), generator=g)}


SP_ORDER = ("tokens", "tokens_lens", "prompt_features", "prompt_features_lens", "features_lens",
            "noise")


def _tp_inputs(cfg, seed: int = 19):
    """18c's rows (phase 14c's B=8, T=1024 batch) and the f32 step's
    draws (noise, t) from ``seed``."""
    import torch

    batch = _policy_batch(cfg)
    g = torch.Generator().manual_seed(seed)
    return batch, torch.randn(batch["features"].shape, generator=g), \
        torch.rand((batch["features"].shape[0], 1, 1), generator=g)


def _phase18_worker(root: str, out: str):
    """One of two gloo ranks sharing the card: 18b, sp_sample over both
    ranks (f32, TF32 off; a warm call, then a timed one with the launches
    and collectives counted); 18c, tp = 2 over both ranks: one f32 step's
    summed gradient without the regularizers (the rows, noise and t given),
    gathered, then TP_STEPS bf16 steps with the regularizers through
    make_train_step(mesh=...), launches and collectives counted a step."""
    import hashlib
    import os

    _die_with_parent()

    import torch
    import torch.distributed as dist

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    dev = mesh.init_from_env("cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = mesh.rank()
    out = Path(out)
    counters = _counters()
    res = {}

    model = load_model_dir(root, tokenizer_name="simple").model.eval().to(dev)
    cfg = model.cfg
    x = {k: v.to(dev) for k, v in _sp_request(cfg).items()}
    seq = mesh.make_seq_mesh()
    args = [x[k] for k in SP_ORDER]
    zv.sp_sample(model, seq, *args, num_step=N_STEP)  # warm
    _zero(counters)
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    y = zv.sp_sample(model, seq, *args, num_step=N_STEP)
    torch.cuda.synchronize()
    res["sp"] = {"wall_s": time.monotonic() - t0, "launches": _launched(counters),
                 "collectives": dict(mesh.COUNTS), "backend": dist.get_backend(),
                 "device": str(y.device)}
    if r == 0:
        torch.save(y.cpu(), out / "sp_out.pt")
    del model, x, args, y
    torch.cuda.empty_cache()

    model = load_model_dir(root, tokenizer_name="simple").model.to(dev)
    tp = mesh.make_mesh(n_data=1, n_model=2)
    mesh.shard_module(model, mesh.tp_param_shardings(model), tp)
    opt = ScaledAdam(model.named_parameters())
    batch, noise, t = _tp_inputs(cfg)
    inputs = {k: v.to(dev) for k, v in batch.items()}
    with mesh.use_mesh(tp):
        loss = zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"],
                                  inputs["features"], inputs["features_lens"], noise.to(dev),
                                  t.to(dev), 9)
        loss.backward()
        (loss,) = mesh.all_reduce_gradients(opt.params, [loss.detach()])
    grads = {}
    for name, p in model.named_parameters():
        shard = getattr(p, "tp_shard", None)
        grads[name] = (p.grad if shard is None else torch.cat(
            mesh._all_gather(p.grad, shard.size, shard.group), dim=p.tp_dim)).cpu()
    if r == 0:
        torch.save({"grads": grads, "loss": float(loss)}, out / "tp_grads.pt")
    del grads
    opt.zero_grad()
    res["ff_shapes"] = {n: list(p.shape) for n, p in model.named_parameters()
                        if n.startswith("fm_decoder.encoders.0.layers.0.feed_forward2.")}
    res["n_ff"] = sum(1 for m in model.modules() if hasattr(m, "tp_shard"))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.backends.cuda.matmul.allow_tf32 = True
    step = make_train_step(model, opt, TrainConfig(compute_dtype="bfloat16"), mesh=tp)
    scheds = zipvoice_schedules(1000.0, cfg)
    steps = []
    for i in range(TP_STEPS):
        _zero(counters)
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(step(batch, 30 + i, i + 1, 0.0, scheds)["loss"])
        torch.cuda.synchronize()
        steps.append({"loss": loss, "ms": (time.monotonic() - t0) * 1e3,
                      "launches": _launched(counters), "collectives": dict(mesh.COUNTS)})
    res["tp_steps"] = steps
    res["unchanged"] = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    res["split"] = [n for n, p in model.named_parameters() if hasattr(p, "tp_shard")]
    digest = hashlib.blake2b()
    for n, p in model.named_parameters():
        if not hasattr(p, "tp_shard"):
            digest.update(p.detach().cpu().numpy().tobytes())
    res["replicated_digest"] = digest.hexdigest()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, opt, step
    torch.cuda.empty_cache()
    res["sp_train"] = _sp_training(root, out, dev, counters)
    (out / f"phase18-{r}.json").write_text(json.dumps(res))
    mesh.shutdown()


def _sp_training(root: str, out: Path, dev, counters):
    """18d on one rank of a dp = 1 x sp = 2 mesh (make_dp_sp_mesh): one f32
    gradient without the regularizers (TF32 off, ``_deterministic``) on
    18c's rows, noise and t, synced (rank 0 saves it); the regularizers' statistics on the same
    rows and draws (``_RegStats``); then SP_TRAIN_STEPS bf16 steps with the
    regularizers through make_train_step(mesh=...); the launches, the (Tq,
    Tk) of every B3 and B4 launch and the collectives counted each time."""
    import hashlib

    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.ops import attention as att
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    tiles = []
    entry = att._entry

    def recording(symbol):  # the (Tq, Tk) of every B3 and B4 launch
        fn = entry(symbol)
        at = {"zv_rel_apply_bwd": 14, "zv_rel_ds": 8}.get(symbol)
        if at is None:
            return fn
        return lambda *a: tiles.append(("B3" if at == 14 else "B4", a[at], a[at + 1])) or fn(*a)

    def counted():
        got = {"launches": _launched(counters), "collectives": dict(mesh.COUNTS),
               "rect": {k: sum(1 for n, tq, tk in tiles if n == k and tq != tk)
                        for k in ("B3", "B4")}}
        _zero(counters)
        mesh.reset_counts()
        tiles.clear()
        return got

    att._entry = recording
    model = load_model_dir(root, tokenizer_name="simple").model.to(dev)
    cfg = model.cfg
    sp = mesh.make_dp_sp_mesh(1, SP_RANKS)
    replicated = zv.seq_replicated_params(model)
    batch, noise, t = _tp_inputs(cfg)
    inputs = {k: v.to(dev) for k, v in batch.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counted()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with _deterministic(), mesh.use_mesh(sp):
        loss = zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"],
                                  inputs["features"], inputs["features_lens"], noise.to(dev),
                                  t.to(dev), 9)
        loss.backward()
        (loss,) = mesh.all_reduce_gradients(list(model.parameters()), [loss.detach()],
                                            replicated)
    torch.cuda.synchronize()
    res = {"grad": dict(counted(), wall_s=time.monotonic() - t0, loss=float(loss))}
    if mesh.rank() == 0:
        torch.save({n: p.grad.cpu() for n, p in model.named_parameters()}, out / "sp_grads.pt")
    model.zero_grad(set_to_none=True)
    # the same rows and draws with every balancer and whitening applied
    # (TF32 still off): the statistics they take over the seq group
    scheds = zipvoice_schedules(1000.0, cfg)
    with _RegStats() as stats, mesh.use_mesh(sp):
        zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"], inputs["features"],
                           inputs["features_lens"], noise.to(dev), t.to(dev), 9,
                           schedules=scheds).backward()
    res["reg_stats"] = stats.summary()
    model.zero_grad(set_to_none=True)
    counted()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="bfloat16"), mesh=sp)
    res["steps"] = []
    for i in range(SP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(step(batch, 50 + i, i + 1, 0.0, scheds)["loss"])
        torch.cuda.synchronize()
        res["steps"].append(dict(counted(), loss=loss, ms=(time.monotonic() - t0) * 1e3))
    digest = hashlib.blake2b()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    res["digest"] = digest.hexdigest()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    att._entry = entry
    return res


def phase18_job(root: Path) -> float:
    """Phase 18's ranks, a background job: two gloo ranks sharing the card
    (``_phase18_worker``: 18b, 18c, 18d), their results in
    ``root``/phase18.  Returns their seconds."""
    from zipvoice_tpu_torch.train.dryrun import spawn

    out = root / "phase18"
    out.mkdir()
    here = str(Path(__file__).resolve().parent)  # the workers import this file
    t0 = time.monotonic()
    spawn("chip_smoke:_phase18_worker", SP_RANKS, {"root": str(root), "out": str(out)},
          timeout=600, path=[here])
    return time.monotonic() - t0


def run_phase18(root: Path, card: str, square, bg: Background):
    """Phase 18 (module docstring): 18a on this process; 18b, 18c and 18d
    in two gloo ranks sharing the card (``phase18_job``, ``bg``'s), each
    against one process on the card here."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules

    t_phase = time.monotonic()
    rect = check_rect_kernels(square, card)
    rect_train = check_rect_training_kernels(square, card)
    rect_s = time.monotonic() - t_phase
    out = root / "phase18"
    workers_s = bg.result("18")
    ranks = [json.loads((out / f"phase18-{r}.json").read_text()) for r in range(SP_RANKS)]

    # 18b: one process's sample on the card, same request and noise
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model_dir(str(root), tokenizer_name="simple").model.eval().cuda()
    cfg = model.cfg
    x = {k: v.cuda() for k, v in _sp_request(cfg).items()}
    with torch.no_grad():
        zv.sample(model, *(x[k] for k in SP_ORDER), num_step=N_STEP)  # warm
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ref = zv.sample(model, *(x[k] for k in SP_ORDER), num_step=N_STEP)
        torch.cuda.synchronize()
    one_s = time.monotonic() - t0
    y = torch.load(out / "sp_out.pt")
    sp_err = _rel_l2(y, ref.cpu())
    want = {"B1": UNFUSED_PER_REQUEST["B1"], "B2": UNFUSED_PER_REQUEST["B2"]}
    fm_layers, stacks = sum(cfg.fm_decoder_num_layers), len(cfg.fm_decoder_num_layers)
    # a step: an all-gather of k, of both SelfAttention values and of the
    # NonlinAttention values a layer and of the key mask a stack, two halos
    # a layer; one all-gather of the output
    want_coll = {"all_reduce": 0, "all_gather": (4 * fm_layers + stacks) * N_STEP + 1,
                 "halo": 2 * fm_layers * N_STEP}
    for r, res in enumerate(ranks):
        got = {k: res["sp"]["launches"].get(k, 0) for k in want}
        if got != want or res["sp"]["collectives"] != want_coll:
            raise AssertionError(f"18b rank {r}: launches {got} (want {want}), collectives "
                                 f"{res['sp']['collectives']} (want {want_coll})")
    if not (torch.isfinite(y).all() and tuple(y.shape) == tuple(ref.shape)
            and sp_err <= SP_TOL):
        raise AssertionError(f"18b sp_sample vs one process: relative L2 {sp_err} > {SP_TOL} "
                             f"or shape {tuple(y.shape)} / not finite")
    print(f"18b sequence-parallel sampler (full width, f32, TF32 off): one request of "
          f"{SP_FRAMES} frames ({SP_FRAMES / 93.75:.1f} s), {N_STEP} steps with CFG, over "
          f"{SP_RANKS} gloo ranks sharing the card: relative L2 against one process's sample "
          f"{sp_err:.3g} (tol {SP_TOL:g}); launches a rank {ranks[0]['sp']['launches']}; "
          f"collectives a rank {ranks[0]['sp']['collectives']}, each run by "
          f"{ranks[0]['sp']['backend']} on {ranks[0]['sp']['device']} tensors, none through "
          f"host copies (18c's all-reduces too; 14b's broadcast); wall "
          f"{ranks[0]['sp']['wall_s']:.2f} s "
          f"(rank 1 {ranks[1]['sp']['wall_s']:.2f} s) against one process's "
          f"{one_s:.2f} s on {card}", flush=True)
    del model, x, ref, y

    # 18c: one process's f32 gradient on the same rows and draws (18d's
    # reference too, reproducible)
    model = load_model_dir(str(root), tokenizer_name="simple").model.cuda()
    batch, noise, t = _tp_inputs(cfg)
    inputs = {k: v.cuda() for k, v in batch.items()}
    with _deterministic():
        loss = zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"],
                                  inputs["features"], inputs["features_lens"], noise.cuda(),
                                  t.cuda(), 9)
        loss.backward()
    one_grads = {name: p.grad.cpu() for name, p in model.named_parameters()}
    one_loss = float(loss.detach())
    model.zero_grad(set_to_none=True)
    with _RegStats() as stats:  # 18d's statistics in one process
        zv.compute_fm_loss(model, inputs["tokens"], inputs["tokens_lens"], inputs["features"],
                           inputs["features_lens"], noise.cuda(), t.cuda(), 9,
                           schedules=zipvoice_schedules(1000.0, cfg)).backward()
    one_stats = stats.summary()
    tpg = torch.load(out / "tp_grads.pt")
    groups = {}
    for name, g in one_grads.items():
        d2, r2 = groups.get(_param_group(name), (0.0, 0.0))
        groups[_param_group(name)] = (d2 + float(((tpg["grads"][name] - g) ** 2).sum()),
                                      r2 + float((g ** 2).sum()))
    errs = {k: (d / max(r, 1e-30)) ** 0.5 for k, (d, r) in groups.items()}
    worst = max(errs.values())
    loss_err = abs(tpg["loss"] - one_loss) / abs(one_loss)
    del model, inputs
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    if not (worst <= 1e-5 and loss_err <= 1e-5):
        raise AssertionError(f"18c tp=2 gradient vs one process: {errs}, loss {loss_err}")
    want = {k: float(PER_STEP.get(k, 0)) for k in ("B1", "B2", "B3", "B4")}
    want["B4"] = 0.0
    for r, res in enumerate(ranks):
        n_ff = res["n_ff"]
        # every fm_decoder and text-encoder stack holds >= 2 layers, so each
        # layer is rematerialized: a feedforward's forward all-reduce runs
        # twice and its backward one once; the replicated gradients'
        # average over the model group; ScaledAdam's two whole-tensor sums
        want_coll = {"all_reduce": 3 * n_ff + 3, "all_gather": 0, "halo": 0}
        for st in res["tp_steps"]:
            got = {k: float(st["launches"].get(k, 0)) for k in want}
            if got != want or st["collectives"] != want_coll or not np.isfinite(st["loss"]):
                raise AssertionError(f"18c rank {r}: step {st}, want launches {want} and "
                                     f"collectives {want_coll}")
        # every shard moves; a replicated tensor may keep its value only if
        # it is a linear_pos weight, whose gradient is zero in a step whose
        # pos_emb_skip gate (a host draw, the same in one process) zeroes pq
        stuck = [n for n in res["unchanged"]
                 if n in res["split"] or not n.endswith("linear_pos.weight")]
        if stuck:
            raise AssertionError(f"18c rank {r}: tensors not updated {stuck[:5]}")
        if res["ff_shapes"] != {
                "fm_decoder.encoders.0.layers.0.feed_forward2.in_proj.weight": [768, 512],
                "fm_decoder.encoders.0.layers.0.feed_forward2.in_proj.bias": [768],
                "fm_decoder.encoders.0.layers.0.feed_forward2.out_proj.weight": [512, 768],
                "fm_decoder.encoders.0.layers.0.feed_forward2.out_proj.bias": [512]}:
            raise AssertionError(f"18c rank {r}: feedforward shards {res['ff_shapes']}")
    if ([s["loss"] for s in ranks[0]["tp_steps"]] != [s["loss"] for s in ranks[1]["tp_steps"]]
            or ranks[0]["replicated_digest"] != ranks[1]["replicated_digest"]):
        raise AssertionError("18c: the ranks' losses or replicated parameters differ")
    print(f"18c tensor-parallel training (full width, tp=2 over {SP_RANKS} gloo ranks sharing "
          f"the card): the f32 step's summed gradient (B=8, T=1024, no regularizers) against "
          f"one process's on the same rows and draws: worst relative L2 a group {worst:.2e} "
          f"(tol 1e-5), loss {loss_err:.2e}; {TP_STEPS} bf16 steps with the regularizers: "
          f"losses {[round(s['loss'], 4) for s in ranks[0]['tp_steps']]}, step ms "
          f"{[round(s['ms'], 1) for s in ranks[0]['tp_steps']]}, launches a step "
          f"{ranks[0]['tp_steps'][-1]['launches']}, collectives a step "
          f"{ranks[0]['tp_steps'][-1]['collectives']} ({ranks[0]['n_ff']} split feedforwards), "
          f"the replicated parameters bit-identical on both ranks, every one of the "
          f"{len(ranks[0]['split'])} shards updated (replicated tensors "
          f"unchanged, their pq zeroed by the pos_emb_skip gate in both steps: "
          f"{ranks[0]['unchanged']}), feed_forward2 shards {ranks[0]['ff_shapes']}, peak "
          f"{ranks[0]['peak_gib']:.2f} GiB a rank; workers {workers_s:.1f} s on {card}",
          flush=True)
    sp_train = check_sp_training(root, out, card, cfg, ranks, one_grads, one_loss, one_stats)
    seconds = time.monotonic() - t_phase
    print(f"phase 18: {seconds:.1f} s (18a {rect_s:.1f} s, workers {workers_s:.1f} s) on {card}",
          flush=True)
    return {"rect": rect, "rect_train": rect_train, "ranks": ranks, "sp_err": sp_err,
            "sp_one_s": one_s, "tp_grad_err": worst, "sp_train": sp_train, "seconds": seconds}


# 18d's tensors whose gradient cancels by construction: a BiasNorm's 0-d
# log_scale (sum(g * y) over normalized y) and a downsampling's softmax
# bias (its entries' gradients sum to zero).  At phase 4's weights they
# cancel to 1/1500-1/12000 of their terms, so any other f32 order of the
# sums beneath moves them by 1e-5 relative and more: two runs of one
# process in the card's default mode differ by up to 1.36e-05 on a
# log_scale, the SP order reads 1.51e-05 on it and 1.05e-04 on a bias at
# other draws (tools/sp_gradient_noise.py).  They are held within their
# groups.
CANCELLING = (".norm.log_scale", ".downsample.bias")

# 18d's launches a rank's step: every layer as in phase 8 (B1 forward and
# recompute, B2 in both SelfAttention consumers twice, B3 in the three
# consumers or B4 once a layer); the fm_decoder's layers on rectangular
# tiles (a rank's T / 2 rows against all T keys), the text encoder's square
FM_LAYERS = 16


def check_sp_training(root: Path, out: Path, card: str, cfg, ranks, one_grads, one_loss,
                      one_stats):
    """18d: the ranks' synced f32 SP gradient against one process's
    (``one_grads``, 18c's on the same rows and draws; relative L2 a group
    and a tensor <= 1e-5, the CANCELLING tensors held by their groups
    alone), the launches, rectangular tiles and collectives of a rank's
    step pinned; the regularizers' statistics over the seq group
    (``_RegStats``, f32) equal on both ranks, and each within 1e-5
    relative of one process's (``one_stats``); SP_TRAIN_STEPS bf16
    regularized steps against one process's from the same weights with
    the same seeds (losses within 1e-2 relative), both ranks' parameters
    bit-identical; the wall of a rank's step beside one process's."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    spg = torch.load(out / "sp_grads.pt")
    errs = {n: float((spg[n] - g).norm()) / max(float(g.norm()), float(spg[n].norm()), 1e-30)
            for n, g in one_grads.items()}
    groups = {}
    for n, g in one_grads.items():
        d2, r2 = groups.get(_param_group(n), (0.0, 0.0))
        groups[_param_group(n)] = (d2 + float(((spg[n] - g) ** 2).sum()),
                                   r2 + float((g ** 2).sum()))
    group_errs = {k: (d / max(r, 1e-30)) ** 0.5 for k, (d, r) in groups.items()}
    worst_group = max(group_errs, key=group_errs.get)
    held = {n: e for n, e in errs.items() if not n.endswith(CANCELLING)}
    worst = max(held, key=held.get)
    cancelling = max((n for n in errs if n not in held), key=errs.get)
    sp = [r["sp_train"] for r in ranks]
    loss_err = abs(sp[0]["grad"]["loss"] - one_loss) / abs(one_loss)
    if not (held[worst] <= 1e-5 and group_errs[worst_group] <= 1e-5 and loss_err <= 1e-5):
        raise AssertionError(f"18d SP gradient vs one process: worst tensor {worst} "
                             f"{held[worst]}, worst group {worst_group} "
                             f"{group_errs[worst_group]}, loss {loss_err}")
    # a step without the regularizers: B4 once a layer, B1 twice, B2 four
    # times; collectives: a layer's four all-gathers (k, three values) and
    # two halos, each again in its recompute, their adjoints in the
    # backward (four all-reduces, two halos); a stack's key-mask gather; the
    # text condition's slices gathered in the backward; the loss normalizer
    # and the gradient sum
    stacks = len(cfg.fm_decoder_num_layers)
    want_grad = {"launches": {"B1": PER_STEP["B1"], "B2": PER_STEP["B2"], "B3": 0,
                              "B4": PER_STEP["B4"]}, "rect": {"B3": 0, "B4": FM_LAYERS},
                 "collectives": {"all_gather": 8 * FM_LAYERS + stacks + 1,
                                 "all_reduce": 4 * FM_LAYERS + 2, "halo": 6 * FM_LAYERS}}
    want_step = {"launches": {"B1": PER_STEP["B1"], "B2": PER_STEP["B2"], "B3": PER_STEP["B3"],
                              "B4": 0}, "rect": {"B3": 3 * FM_LAYERS, "B4": 0}}
    for r, res in enumerate(sp):
        got = {"launches": {k: res["grad"]["launches"].get(k, 0) for k in ("B1", "B2", "B3",
                                                                          "B4")},
               "rect": res["grad"]["rect"], "collectives": res["grad"]["collectives"]}
        if got != want_grad:
            raise AssertionError(f"18d rank {r}: the f32 gradient's {got}, want {want_grad}")
        for st in res["steps"]:
            got = {"launches": {k: st["launches"].get(k, 0) for k in ("B1", "B2", "B3", "B4")},
                   "rect": st["rect"]}
            if got != want_step or not np.isfinite(st["loss"]):
                raise AssertionError(f"18d rank {r}: a step's {got} (loss {st['loss']}), "
                                     f"want {want_step}")
    if ([s["loss"] for s in sp[0]["steps"]] != [s["loss"] for s in sp[1]["steps"]]
            or sp[0]["digest"] != sp[1]["digest"]):
        raise AssertionError("18d: the ranks' losses or parameters differ")
    # the statistics a call: the same calls in both runs, their backward
    # order not compared (sorted; two near-equal values that swap stay
    # within the tolerance); a rank's own would differ by percents
    stat_errs = {}
    for kind, one in one_stats.items():
        got = sp[0]["reg_stats"][kind]
        if not one or len(got) != len(one) or got != sp[1]["reg_stats"][kind]:
            raise AssertionError(f"18d {kind} statistics: {len(got)} calls a rank (equal on "
                                 f"both: {got == sp[1]['reg_stats'][kind]}), {len(one)} in one "
                                 f"process")
        stat_errs[kind] = max(abs(a - b) / abs(b) for a, b in zip(sorted(got), sorted(one)))
    if not max(stat_errs.values()) <= 1e-5:
        raise AssertionError(f"18d regularizer statistics vs one process: {stat_errs}")

    # one process's bf16 steps from the same weights, rows and seeds
    model = load_model_dir(str(root), tokenizer_name="simple").model.cuda()
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="bfloat16"))
    batch, _, _ = _tp_inputs(cfg)
    scheds = zipvoice_schedules(1000.0, cfg)
    one = []
    for i in range(SP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(step(batch, 50 + i, i + 1, 0.0, scheds)["loss"])
        torch.cuda.synchronize()
        one.append({"loss": loss, "ms": (time.monotonic() - t0) * 1e3})
    del model, step
    torch.cuda.empty_cache()
    step_errs = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(sp[0]["steps"], one)]
    if not max(step_errs) <= 1e-2:
        raise AssertionError(f"18d bf16 steps vs one process: losses "
                             f"{[s['loss'] for s in sp[0]['steps']]} vs "
                             f"{[s['loss'] for s in one]}")
    print(f"18d sequence-parallel training (full width, dp=1 x sp={SP_RANKS} over gloo ranks "
          f"sharing the card, 18c's rows B=8 T=1024): the f32 step's synced gradient (no "
          f"regularizers, TF32 off, deterministic algorithms) against one process's: largest "
          f"relative L2 a group {group_errs[worst_group]:.3g} ({worst_group}) and a tensor "
          f"{held[worst]:.3g} ({worst}; tol 1e-5 each), of a cancelling tensor "
          f"{errs[cancelling]:.3g} ({cancelling}; held by its group), loss {loss_err:.2e}; "
          f"launches "
          f"{sp[0]['grad']['launches']}, rectangular {sp[0]['grad']['rect']}, collectives "
          f"{sp[0]['grad']['collectives']}, wall {sp[0]['grad']['wall_s']:.2f} s; every "
          f"balancer's and whitening's statistics (f32, gates open) equal on both ranks and "
          f"within {stat_errs['balancer']:.2e} / {stat_errs['whiten']:.2e} relative of one "
          f"process's ({len(one_stats['balancer'])} balancers, {len(one_stats['whiten'])} "
          f"whitenings; tol 1e-5); "
          f"{SP_TRAIN_STEPS} bf16 steps with the regularizers: losses "
          f"{[round(s['loss'], 5) for s in sp[0]['steps']]} against one process's "
          f"{[round(s['loss'], 5) for s in one]} (relative {max(step_errs):.2e}, tol 1e-2), "
          f"launches a step {sp[0]['steps'][-1]['launches']}, rectangular "
          f"{sp[0]['steps'][-1]['rect']}, collectives {sp[0]['steps'][-1]['collectives']}, "
          f"both ranks' parameters bit-identical; step ms a rank "
          f"{[round(s['ms'], 1) for s in sp[0]['steps']]} (rank 1 "
          f"{[round(s['ms'], 1) for s in sp[1]['steps']]}) against one process's "
          f"{[round(s['ms'], 1) for s in one]}; peak {sp[0]['peak_gib']:.2f} GiB a rank on "
          f"{card}", flush=True)
    return {"grad_err": held[worst], "worst": worst, "group_err": group_errs[worst_group],
            "cancelling_err": errs[cancelling], "one_steps": one, "ranks": sp,
            "step_err": max(step_errs), "stat_errs": stat_errs}


def _kernel_entry(results, key, name, src, replaces, launches, main_key, shape, **extra):
    case = results[key][main_key]
    every = results[key].values()
    if all("rel_err" in r for r in every):
        extra["max_rel_err"] = max(r["rel_err"] for r in every)
    if "contract_bound_ms" in case:
        extra["contract_bound_ms"] = case["contract_bound_ms"]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "max_abs_err": max(r["abs_err"] for r in every),
        "ms": case["ms"], "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
        "bound_by": case["bound_by"], "library_ms": case["library_ms"], "shape": shape,
        **extra,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "zipvoice_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout that holds zipvoice_tpu_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from zipvoice_tpu_torch.ops import build

    t_start = time.monotonic()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.monotonic()
    logs = build.build_all()
    build_s = time.monotonic() - t0
    print(f"kernel build: {build_s:.1f} s for {sorted(logs)}", flush=True)
    print("kernel build seconds a process: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(build.SECONDS.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, log in logs.items():
        # every entry point of the redesigned B1-B9 with its registers,
        # shared memory and spills; the other kernels' register lines
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            full = any(k in entry for k in ENTRY_KERNELS.get(name, ()))
            if ("registers" in line or "spill" in line
                    or (full and "Compiling entry" in line)):
                print(f"  {name}: {line.strip()}")

    results = check_kernels()
    results.update(check_training_kernels())
    fused_results, apply_launches, apply_grad_err = check_fused_kernels()
    results.update(fused_results)

    build.BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="smoke-", dir=build.BUILD))
    worker = p13 = None
    try:
        t0 = time.monotonic()
        n_params = make_assets(root)
        print(f"assets: {n_params / 1e6:.1f}M-parameter model in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        worker = start_export_worker(root, card)
        metrics, serve_launches = run_cli(root, list(TEXTS), "float32", card)
        run_cli(root, ["r8s"], "bfloat16", card)
        fused_metrics, fused_launches = run_cli(root, list(TEXTS), "float32", card,
                                                fused=True)
        run_cli(root, ["r8s"], "bfloat16", card, fused=True)
        run_cli(root, ["r4s"], "float32", card)  # the flags reset: the unfused pins again
        rtf_ab = compare_fused_rtf(root, card)
        graph_res = check_graphs(root, card)
        fwd_err = check_forward_against_cpu(root)
        fused_fwd_err = check_forward_against_cpu(root, fused=True)
        unfused_dev, unfused_busy, unfused_wall = profile_request(root, card)
        fused_dev, fused_busy, fused_wall = profile_request(root, card, fused=True)
        replayed_busy = {f: profile_request(root, card, fused=f, replayed=True)[1:]
                         for f in (False, True)}
        grad_err = check_gradient_against_cpu(root)
        # the pipelines above (and their graph pools) sit in reference
        # cycles: free them before the training phases
        gc.collect()
        torch.cuda.empty_cache()
        manifest = make_corpus(root)
        reg_step, reg_launches, reg_ms, reg_gib, exp, res = run_training(
            root, manifest, card, True, 6)
        noreg_step, noreg_launches, noreg_ms, noreg_gib, _, noreg_res = run_training(
            root, manifest, card, False, 5)
        wall, busy, reg_dev = profile_train_step(res, manifest, card)
        del res
        _, noreg_busy, noreg_dev = profile_train_step(noreg_res, manifest, card, False)
        del noreg_res
        print(f"phases 1-9: {time.monotonic() - t_start:.1f} s on {card}", flush=True)
        # the runs of other processes that phases 14 and 18 check start
        # here, one after another, beside phases 10-17
        bg = Background({"14a": lambda: distributed_cli_job(root, manifest),
                         "14b": lambda: two_ranks_job(root, manifest),
                         "18": lambda: phase18_job(root)})
        check_checkpoint_serves(root, exp, card)
        server_launches, serve_res = serve_on_card(root, card)
        gc.collect()
        torch.cuda.empty_cache()
        variants = run_variants(root, card)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phases 1-12: {time.monotonic() - t_start:.1f} s on {card}", flush=True)
        p13 = start_phase13(root, card)
        ddp, two_ranks, policies, _ = run_phase14(root, manifest, card, reg_ms, bg)
        gc.collect()
        torch.cuda.empty_cache()
        p15 = run_phase15(root, manifest, card, graph_res["bfloat16"]["rtf"]["replay"],
                          reg_ms, 6, worker)
        gc.collect()
        torch.cuda.empty_cache()
        p16 = run_phase16(root, manifest, card)
        p17 = run_phase17(root, card)
        gc.collect()
        torch.cuda.empty_cache()
        bigvgan, recipes, variant_grads = finish_phase13(p13, root)
        p18 = run_phase18(root, card, results, bg)
    finally:
        for proc in (worker and worker[0], p13 and p13[0]):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)

    n_req = len(TEXTS)
    kernels = [
        _kernel_entry(results, "B1", "rel_attention_probs", "zipvoice_tpu_torch/csrc/rel_probs.cu",
                      "zipvoice_tpu/ops/attention.py:979", serve_launches["B1"],
                      (2, 1024, "float32"), "B=2 H=4 T=1024 f32",
                      launches_per_request=serve_launches["B1"] // n_req,
                      launches_server=server_launches["B1"],
                      launches_per_train_step=reg_step["B1"],
                      launches_per_bigvgan_request=bigvgan["launches"]["B1"] // 2,
                      launches_per_distill_step=recipes["distill stage 1"]["launches"]["B1"],
                      launches_per_dialog_step=recipes["dialog"]["launches"]["B1"],
                      launches_per_prep_train_step=p16["launches"]["B1"],
                      **_phase18_extras(p18, "B1"),
                      **_phase14_launches(ddp, two_ranks, policies, "B1"),
                      **_phase15_launches(p15, "B1"),
                      **_variant_extras(results, variants, "B1")),
        _kernel_entry(results, "B2", "rel_attention_probs_apply",
                      "zipvoice_tpu_torch/csrc/probs_apply.cu",
                      "zipvoice_tpu/ops/attention.py:1110", serve_launches["B2"],
                      (2, 1024, "float32"), "B=2 H=4 T=1024 f32",
                      launches_per_request=serve_launches["B2"] // n_req,
                      launches_per_fused_request=fused_launches["B2"] // n_req,
                      launches_server=server_launches["B2"],
                      launches_per_train_step=reg_step["B2"],
                      launches_per_bigvgan_request=bigvgan["launches"]["B2"] // 2,
                      launches_per_distill_step=recipes["distill stage 1"]["launches"]["B2"],
                      launches_per_dialog_step=recipes["dialog"]["launches"]["B2"],
                      launches_per_prep_train_step=p16["launches"]["B2"],
                      **_phase18_extras(p18, "B2"),
                      **_phase14_launches(ddp, two_ranks, policies, "B2"),
                      **_phase15_launches(p15, "B2"),
                      **_variant_extras(results, variants, "B2")),
        _kernel_entry(results, "B3", "rel_attention_consume_bwd",
                      "zipvoice_tpu_torch/csrc/rel_apply_bwd.cu",
                      "zipvoice_tpu/ops/attention.py:694", reg_launches["B3"],
                      ("main", 1024, 4, 12, "float32", 0.0, False), "B=8 H=4 T=1024 vd=12 f32",
                      launches_per_train_step=reg_step["B3"],
                      launches_per_dialog_step=recipes["dialog"]["launches"]["B3"],
                      launches_per_stereo_step=recipes["stereo"]["launches"]["B3"],
                      launches_per_prep_train_step=p16["launches"]["B3"],
                      **_phase18_extras(p18, "B3"),
                      **_phase14_launches(ddp, two_ranks, policies, "B3")),
        _kernel_entry(results, "B4", "rel_attention_ds", "zipvoice_tpu_torch/csrc/rel_ds.cu",
                      "zipvoice_tpu/ops/attention.py:209", noreg_launches["B4"],
                      ("main", 1024, 4, 12, "float32", 0.0, False), "B=8 H=4 T=1024 f32",
                      launches_per_train_step=noreg_step["B4"],
                      launches_per_distill_step=recipes["distill stage 1"]["launches"]["B4"],
                      launches_per_two_rank_step=two_ranks["ranks"][0]["no-regularizers"][
                          "launches"]["B4"],
                      **_phase18_extras(p18, "B4")),
        _kernel_entry(results, "B5", "rel_attention_apply",
                      "zipvoice_tpu_torch/csrc/rel_apply.cu",
                      "zipvoice_tpu/ops/attention.py:643", apply_launches["B5"],
                      (8, 4, 1024, 12, "float32", False), "B=8 H=4 T=1024 vd=12 f32",
                      launches_per_call=apply_launches["B5"],
                      grad_max_rel_err=apply_grad_err,
                      wide_route_ms=results["B5"][(8, 1, 1024, 384, "float32", False)]["ms"],
                      wide_route_bound_ms=results["B5"][(8, 1, 1024, 384, "float32", False)][
                          "bound_ms"]),
        _kernel_entry(results, "B6", "rel_attention_probs_consume",
                      "zipvoice_tpu_torch/csrc/rel_probs_consume.cu",
                      "zipvoice_tpu/ops/attention.py:1224", fused_launches["B6"],
                      (1024, "float32"), "B=2 H=4 T=1024 vd=12 f32",
                      launches_per_fused_request=fused_launches["B6"] // n_req,
                      **_phase15_launches(p15, "B6")),
        _kernel_entry(results, "B7", "rel_attention_head0_consume",
                      "zipvoice_tpu_torch/csrc/rel_consume_fwd.cu",
                      "zipvoice_tpu/ops/attention.py:1297", fused_launches["B7"],
                      (1024, 384, "float32"), "B=2 T=1024 C=384 f32",
                      launches_per_fused_request=fused_launches["B7"] // n_req,
                      **_phase15_launches(p15, "B7")),
        _kernel_entry(results, "B8", "fused_log_mel", "zipvoice_tpu_torch/csrc/log_mel.cu",
                      "zipvoice_tpu/ops/melspec.py:122", reg_launches["B8"],
                      next(k for k in results["B8"] if k[0] == "10 s"), "B=8 10 s (938 frames)",
                      launches_per_train_step=reg_step["B8"],
                      launches_per_stereo_step=recipes["stereo"]["launches"]["B8"],
                      launches_per_prep_train_step=p16["launches"]["B8"],
                      launches_per_distributed_step=ddp["launches"]["B8"] / DDP_STEPS,
                      cufft_ms=next(r["cufft_ms"] for k, r in results["B8"].items()
                                    if k[0] == "10 s")),
        _kernel_entry(results, "B9", "conv_glu_swoosh_out", "zipvoice_tpu_torch/csrc/conv_glu.cu",
                      "zipvoice_tpu/ops/convglu.py:143", fused_launches["B9"],
                      (512, 31, 1024, "float32"), "B=2 T=1024 C=D=512 K=31 f32",
                      launches_per_fused_request=fused_launches["B9"] // n_req,
                      **_phase15_launches(p15, "B9")),
    ]
    missing = [k["name"] for k in kernels if not k["launches"]]
    missing += [f"{k} (server)" for k in ("B1", "B2") if not server_launches[k]]
    missing += [f"{k} ({name})" for name, v in variants.items() for k in ("B1", "B2")
                if not v["launches"][k]]
    missing += [f"{k} (bigvgan)" for k in ("B1", "B2") if not bigvgan["launches"][k]]
    missing += [f"{k} (stage 2)" for k in ("B1", "B2", "B3", "B8") if not p16["launches"][k]]
    missing += [f"{k} ({name})" for name, v in recipes.items()
                for k in (("B1", "B2", "B4", "B8") if name.startswith("distill")
                          else ("B1", "B2", "B3", "B8") if not name.startswith("served")
                          else ("B1", "B2")) if not v["launches"][k]]
    if missing:
        raise AssertionError(f"kernels not launched on their paths: {missing}")
    for dtype, r in graph_res.items():
        print(f"graphs {dtype}: replay vs eager bitwise (unfused and fused); batch-4 rows vs "
              f"batch-1 max |diff| mel {r['batch4']['mel']:.3g}, PCM16 "
              f"{r['batch4']['pcm']:.0f}; r8s rtf eager {r['rtf']['eager']:.5f}, synthesize "
              f"replayed {r['rtf']['replay']:.5f}, synthesize_fused replayed "
              f"{r['rtf']['fused']:.5f} on {card}", flush=True)
    busy_line = []
    for f, (busy_ms, wall_ms) in replayed_busy.items():
        eager_busy, eager_wall = ((fused_busy, fused_wall) if f else (unfused_busy, unfused_wall))
        tag = "fused" if f else "unfused"
        busy_line.append(
            f"{tag} eager {100 * eager_busy / eager_wall:.1f}% of {eager_wall:.1f} ms, replayed "
            + ("not resolved by the profiler" if busy_ms is None
               else f"{100 * busy_ms / wall_ms:.1f}% of {wall_ms:.1f} ms"))
    print("device busy share of the profiled r8s f32 request: " + "; ".join(busy_line)
          + f"; server: warmup {serve_res['warmup_s']:.1f} s, {serve_res['captures']} graphs, "
          f"peak {serve_res['peak_gib']:.2f} GiB, 4 concurrent requests in "
          f"{serve_res['batches']} batch(es) on {card}", flush=True)
    rtf = [round(m["rtf"], 5) for m in metrics]
    fused_rtf = [round(m["rtf"], 5) for m in fused_metrics]
    worst_grad = max(max(v.values()) for v in grad_err.values())
    print(f"f32 rtf per request {rtf} (fused {fused_rtf}); r8s warm rtf unfused/fused: "
          + ", ".join(f"{d} {v['unfused']:.5f}/{v['fused']:.5f}" for d, v in rtf_ab.items())
          + f"; fm_decoder card-vs-cpu err {fwd_err:.3g} (fused {fused_fwd_err:.3g}); "
          f"gradient card-vs-cpu worst relative L2 {worst_grad:.3g}; train step "
          f"{reg_ms:.1f} ms (regularizers) / {noreg_ms:.1f} ms (no regularizers), "
          f"busy {100 * busy / wall:.1f}%, peak {max(reg_gib, noreg_gib):.2f} GiB; "
          f"device ms a request: busy {unfused_busy:.1f} unfused / {fused_busy:.1f} fused, "
          f"B1 {unfused_dev['B1'][0]:.3f} and B2 {unfused_dev['B2'][0]:.3f} unfused; "
          f"fused B2 {fused_dev['B2'][0]:.3f}, B6 {fused_dev['B6'][0]:.3f}, "
          f"B7 {fused_dev['B7'][0]:.3f}, B9 {fused_dev['B9'][0]:.3f}; "
          f"B3 {reg_dev['B3'][0]:.3f} a step, B4 {noreg_dev['B4'][0]:.3f} a step without "
          f"the regularizers ({100 * noreg_dev['B4'][0] / 1e3 / noreg_busy:.1f}% of busy); "
          f"total {time.monotonic() - t_start:.1f} s on {card}", flush=True)
    print("variants: " + "; ".join(
        f"{name} warm rtf {v['rtf']:.5f} (CLI {[round(x, 4) for x in v['cli_rtf']]}), "
        f"B1 {v['replay_launches']['B1']} B2 {v['replay_launches']['B2']} a replayed "
        f"request, fm_decoder card-vs-cpu err {v['fwd_err']:.3g}"
        for name, v in variants.items()) + f" on {card}", flush=True)
    print(f"bigvgan: warm rtf {bigvgan['rtf']:.5f} (Vocos {bigvgan['vocos_rtf']:.5f}), vocoder "
          f"{100 * bigvgan['share']:.1f}% of a request, decode card-vs-cpu "
          f"{bigvgan['decode_err']:.3g} (bf16 vs f32 {bigvgan['decode_err_bf16']:.3g}), log-mel "
          f"{bigvgan['mel_err']:.3g}; recipes: "
          + "; ".join(f"{name} {v['step_ms']:.1f} ms a step, peak {v['peak_gib']:.2f} GiB"
                      for name, v in recipes.items() if "step_ms" in v)
          + "; gradient card-vs-cpu worst relative L2 "
          + ", ".join(f"{k} {max(v.values()):.3g}" for k, v in variant_grads.items())
          + f" on {card}", flush=True)
    ex, mfu = p15["exported"], p15["mfu"]
    print("int8 serving: " + "; ".join(
        f"{mode} {dtype} {r['mb_before']:.1f} -> {r['mb_after']:.1f} MB, rtf {r['rtf']:.5f} "
        f"(float {r['rtf_float']:.5f}), mel MSE {r['mel_mse']:.3g}, PCM16 max diff "
        f"{r['pcm_max_diff']:.0f}" for (dtype, mode), r in p15["int8"].items())
        + "; export: " + "; ".join(
            f"{name} {e['total_s']:.1f} s, sampler_fused {e['mb']['sampler_fused']:.1f} MB"
            for name, e in p15["exports"].items())
        + f"; exported rtf at {EXPORT_STEPS} steps fused {ex['fused']['rtf']:.5f}, host loop "
        f"{ex['host-loop']['rtf']:.5f}; MFU request {mfu['request_mfu']:.4f}, train step "
        f"{mfu['step_mfu']:.4f} on {card}", flush=True)
    print(f"data preparation: stage 2 step {p16['segment_step_ms']:.1f} ms on the segment rows "
          f"(per-file loads), {p16['step_ms']:.1f} ms on whole files (native loads); the "
          f"native loader {p16['loader_ms']['native']:.2f} ms against "
          f"{p16['loader_ms']['per-file']:.2f} ms per file for B=8; compute_fbank card vs CPU "
          f"{p16['fbank_err']:.3g}; evaluation: UTMOS {p17['utmos_ms']:.2f} ms, ECAPA head "
          f"{p17['ecapa_ms']:.2f} ms on the card ({p17['ecapa_cpu_ms']:.1f} ms on the CPU); "
          f"phases 16-17 {p16['seconds'] + p17['seconds']:.1f} s; total "
          f"{time.monotonic() - t_start:.1f} s on {card}", flush=True)
    spt = p18["sp_train"]
    print(f"parallelism: 18b sp_sample over {SP_RANKS} ranks relative L2 {p18['sp_err']:.3g} "
          f"against one process, wall {p18['ranks'][0]['sp']['wall_s']:.2f} s against "
          f"{p18['sp_one_s']:.2f} s; 18c tp=2 gradient worst relative L2 a group "
          f"{p18['tp_grad_err']:.2e}; 18d sp=2 training gradient largest relative L2 a "
          f"group {spt['group_err']:.3g}, a tensor {spt['grad_err']:.3g} (a cancelling one "
          f"{spt['cancelling_err']:.3g}), bf16 step ms a rank "
          f"{[round(x['ms'], 1) for x in spt['ranks'][0]['steps']]} against one process's "
          f"{[round(x['ms'], 1) for x in spt['one_steps']]}; kernel build {build_s:.1f} s, "
          f"phase 18 {p18['seconds']:.1f} s; total {time.monotonic() - t_start:.1f} s on "
          f"{card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:  # 14a's rank, under torchrun
        sys.exit(_ddp_worker(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--export-worker"]:  # 15b, started by main
        sys.exit(_export_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase13-worker"]:  # phase 13, started by main
        sys.exit(_phase13_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
