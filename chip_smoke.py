"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA GPU

Phases (any failure exits non-zero; no phase catches its own failure;
results go to lines before the last; each phase prints its wall):

1. card: ``nvidia-smi`` name and power limit;
2. build: compile the six kernels of ``src/repro_torch/csrc/``
   (``bitserial_gemm.cu``, ``bitserial_gemm_a4.cu``, ``quant_gemm.cu``,
   ``flash_attention.cu``, ``minmax_rows.cu``, ``requant_rows.cu``) with
   nvcc, one process per source, in parallel,
   and print each one's registers and spills;
3. each kernel against its plain torch version on the card: the 8-bit
   bit-serial kernel at random ragged shapes (n_bits 1..8, signed and
   unsigned planes, with and without the occupancy mask, int32 and float32
   epilogues), at shapes ragged against its 128x64x64 tile, at split-K
   shapes (M 1, 2, 17; K 2048, 2593; all four x/plane signedness pairs),
   at int32 sums that wrap (|sum| < 2^53, where the plain version's
   float64 products are exact) and at the full-width Inception shapes,
   printing each shape's split-K factor; the W4A4 kernel at random ragged
   shapes (n_bits 1..4, odd and even K, signed and unsigned, masked or
   not, both epilogues), at split-K shapes (M 1, 2, 17; K 2048, 2593; all
   four nibble/plane signedness pairs, the mixed ones through the launch
   helper against the 8-bit plain version on the widened nibbles; masked
   too), at rows of K2 bytes off a 16-byte boundary, at K < 2*K2 - 1, and
   at the full-width 4-bit shapes; the W8A8 ``quant_matmul`` kernel at
   random ragged shapes, at split-K shapes (M 1..65 at K = 3584), at the
   LM's linear shapes and at the PTQ head (4x3584x152064), each with bias
   and without; all three bit-equal.  ``flash_attention`` at
   random ragged (B, H, Hkv, Tq, Tk, D), causal and not, at Tq and Tk
   ragged against the bf16 kernel's query and KV tiles on both sides, at
   every head size, at B*H = 224, with outputs near cancellation (V whose
   columns sum to zero), and at the four served prompts' shapes, float32
   (rtol = atol = 1e-5) and bfloat16 (rtol = 2^-7, one bf16 ulp; atol =
   1e-5), and at the 21 served shapes of the audio, vision, MoE and
   hybrid families (MHA 32/32 and GQA 25/5 at D = 64; GQA 48/8, MHA
   16/16, GQA 56/8 at D = 128); the build phase prints the tiles each
   flash route runs; ``minmax_rows`` (the §IV-D min/max) against its
   plain version, the bit-serial walk, at the 94 convolutions' output
   shapes at batch 4 (``bits=32``, signed), byte-identical (the largest
   difference printed), one launch count a call; ``requant_rows`` (the
   §IV-D requantization of a batch) against its plain version at the 94
   convolutions' output shapes and Mixed_7c's four branches (into their
   slices of the block's 2048 channels) at batch 4, bytes and live counts
   identical, one launch a call;
4. full-width Inception v3 (299 px, 1001 classes, seeded random weights)
   served by ``NCServingEngine(max_batch=2)``: 4 requests, finite logits,
   each byte-identical to a standalone ``nc_forward`` of its image, the
   ``gemm`` backend native with 0 delegations and the kernel launched,
   ``minmax_rows`` 94 times a batch's forward (one a convolution) and
   ``requant_rows`` 144 times (one a convolution and a concatenated
   branch);
5. the 4-bit path at full width: ``nc_conv2d`` with 4-bit QuantParams at
   three full-width conv layers' shapes (batch 2) and ``nc_fc`` at
   2048 -> 1001, through the ``gemm`` backend; the W4A4 kernel launched and
   the 8-bit kernel not; outputs, cycles and ``ConvStats`` byte-identical
   with the W4A4 route swapped for its plain version;
6. full-width integrity and compressed: one checked, compressed batch-2
   ``nc_forward`` without faults (logits equal phase 4's), then
   ``NCServingEngine(integrity=True, compressed=True)`` inside
   ``faults.inject(seed=7,filter=0.05,act=0.01,compute=0.01,stuck=3)`` on 2
   of phase 4's images: none failed or degraded, logits byte-identical to
   phase 4's, ``detected == corrupt_attempts`` with faults injected; prints
   the fault ledger, the checksum and re-execution cycles, the CSR bytes
   and the wall time;
7. one batch-2 full-width forward with the kernels and one with
   kernel 1, ``minmax_rows`` and ``requant_rows`` swapped for their plain versions: logits, every layer report and the reports'
   ``NCForwardReport.summary()`` tables byte-identical (the table printed);
   the correlation with the float forward is printed for information;
   then the forward's
   split into pack / dot / min-max tree / requant / other, read from the
   program's own spans (``repro_torch.tracing``); then, at full width on
   phase 4's first B images: ``apply(quant=True)`` against ``apply()``
   (correlation above 0.98 per image) and phase 4's emulated logits
   against ``apply(quant=True)`` (above 0.95); ``nc_forward(x,
   stream_chunk=1)``, its logits byte-identical to phase 4's and every
   conv/fc layer's ``filter_loads`` equal to the chunk count, its wall
   beside the unchunked forward's; a fleet of two ``NCServingEngine``s
   (``XEON_E5_35MB`` and its 4-slice scaling, ``max_batch=2``) behind
   ``Orchestrator(router="latency")`` serving phase 4's 4 images, every
   request completed, SLO and dispatch identities held, every routed
   logit row byte-identical to phase 4's, dispatches and kernel launches
   printed per engine;
7b. ``bitserial-ops``: the §III ops (add, sub, multiply, MAC into a 24-bit
   accumulator, ReLU of the 9-bit difference, max, selective copy) over the
   35 MB LLC's 1,032,192 compute bit lines, flat and row-aligned as 3584
   rows of K = 288, on a dense 8-bit operand set and on one whose
   multiplier has 90% of its 32-lane words zero and a dead top plane: words
   bit-equal to the same calls on CPU tensors and unchanged with
   ``ZERO_SKIP`` off, values equal to integer arithmetic, cycles equal to
   the closed forms (9 and 102 at n = 8), ``SKIP_STATS`` equal to the CPU
   run's, the sparse multiply and MAC eliding words and planes; then
   ``bitserial_dot`` over 3584 rows of K = 288 and ``nc_dot`` at the FC's
   1001 rows of K = 2048 at 8 and 4 bits through ``walk`` and ``gemm``
   (values equal to x . w, cycles equal; gemm launches the 8-bit kernel,
   then the W4A4 one, counted into the kernels line); then phase 4's first
   image through a batch-1 full-width ``nc_forward(engine="walk")`` beside
   ``engine="gemm"``: logits byte-identical, reports equal, every layer's
   ``ConvStats`` equal but ``engine_words_*`` (nonzero on walk, 0 on gemm),
   no kernel launched by the walk, and ``Conv2d_1a_3x3`` and the FC run
   again on CPU tensors giving the card's output, ``ConvStats`` and
   ``SKIP_STATS``; the walls, the words elided and the peak memory printed;
8. full-width Qwen2-7B (28 layers, d_model 3584, 28 query heads over 4 KV
   heads, bf16, seeded random weights) served by ``ServingEngine(
   max_batch=4, max_len=2112)``: 4 requests with prompts of 37, 512, 1000
   and 2048 tokens, 16 new tokens each; none failed, 28 x 4 = 112
   flash-attention launches, each request's prefill logits bit-equal to a
   standalone ``prefill``, whose 28 attention calls (the served inputs)
   are each held against the plain version as in phase 3; a standalone
   batch-1 ``decode_step`` loop fed the served tokens gives logits within
   0.125 of every served decode step's, and the same token unless its
   top-2 logit margin is below 0.25; prints the prefill wall, the served
   attention calls' device time (CUDA events around each) and its share
   of the prefill wall, decode tokens/s and peak device memory; then the
   same 4 requests served from the int8 KV cache (``kv_dtype="int8"``)
   and held the same way, with prefill logits bit-equal to the bf16
   cache's run, the prefill caches' int8 payload and scales equal to
   ``kv_quantize`` of the bf16 caches on the CPU and the attention caches
   exactly (1 + 4/hd)/2 of the bf16 ones' bytes (the decode logits' and
   tokens' distance from the bf16 run printed, not held); then the same 4
   requests, held the same way, served by musicgen-large, internvl2-26b,
   moonshot-v1-16b-a3b (einsum impl), arctic-480b (2 of its 35 layers),
   mamba2-2.7b (no attention: 0 flash launches) and hymba-1.5b (its 3
   global layers through the flash kernel, 25/5 heads of 64, the 29
   sliding-window layers through the torch banded prefill and 1024-slot
   ring caches, checked; a fifth request of 1020 tokens decodes across
   the ring's wrap; its bf16 GEMMs round differently at batch 1 and 4, so
   its served decode is held bit-equal to a loop at the served batch
   shape and, in float32, within 0.00125 of a batch-1 loop; then its int8
   KV cache as Qwen2-7B's), at full width,
   one model on the card at a time, drawn on the card from a seed; the
   flash launches are the full-attention layers times the requests; for
   the MoE models the
   standalone decode loop replays the served expert choices and the
   capacity drops they imply, and every replayed choice must be the top-k
   of the served router probabilities, which must lie within 0.005 of the
   loop's own, with at most 5% of the routings swapped; two faults planted
   in arctic's served routing (a row shift of the top-k and of the router
   probabilities at batch > 1) must each fail those checks; internvl2-26b also
   prefills stub embeddings at the 4 lengths (attention held against the
   plain version) and the table's rows of a prompt (bit-equal to its
   prefill by tokens); moonshot's scatter impl is held against the einsum
   impl layer by layer within their rounding bound and on one prefill's
   logits within 0.5;
9. full-width post-training quantization: ``CalibrationStats`` over every
   linear site's input from the float prefills of the served prompts,
   ``quantize_lm_params``, then W8A8 ``QuantizedLinear`` at all 28 x 7
   layer linears on the 512-token prompt's captured inputs plus the head
   on the prompts' last positions (at least 197 quant_matmul launches), each
   bit-equal to the plain version, with the mean relative error against the
   bf16 product per site class; layer 0's 7 linears at 4 bits through
   ``bitserial_linear`` (the bit-serial kernel with signed planes, 7
   launches), each kernel result bit-equal to the plain version's;
10. training, one model on the card at a time (no kernel runs here: the
    reference trains through no Pallas kernel, and under grad the port's
    attention takes the scan, as the reference differentiates it):
    ``train-grad``, float32 olmo-1b at full width with 2 of its 16
    layers, ``lm_loss`` and its gradients at batch 2 x 256 on the card and
    on the CPU from the same parameters, each leaf within 1e-4 of its max
    |g|, every attention leaf's gradient non-zero, 0 flash_attention
    launches; ``train``, full-width olmo-1b (16 layers, bf16, 1.18 B
    parameters, tied embeddings) at batch 4 x 1024 with
    ``default_microbatches`` (2): every leaf moved by one step, then
    ``train()`` for 4 steps with a checkpoint every 2, its step-4
    checkpoint restored bit-equal to the returned state, ``train()``
    resumed to 6 (steps 4 and 5, the iterator at 4) and the same 6 steps
    run straight through in a fresh directory, the resumed losses within
    rtol 1e-4 of the straight run's; prints the step wall, tokens/s, peak
    memory and the share of the bf16 dense peak (6 N tokens / (wall x 989
    TFLOP/s)); ``train-compress``, two rounds of ``error_feedback_update``
    on one microbatch's full-width gradients, the new error feedback g +
    ef - recon within float32 rounding, and the bytes sent;
    ``train-q8``, 3 steps with int8 moments (at most 2.1 bytes a
    parameter) and ``_q8_pack`` on the card bit-equal to the CPU's;
    ``train-overfit``, 16 steps of ``AdamW(lr=1e-3)`` on one batch, the
    loss falling by at least 1 nat; ``train-hybrid``, full-width
    hymba-1.5b (32 layers) at batch 2 x 1024, gradients finite and every
    attention and mixer leaf's non-zero, then 2 steps, losses finite;
11. the distributed layer (``phase_distributed``, at most 180 s): on a
    1 x 1 ``DeviceMesh`` of a one-rank NCCL world, ``dist-train``, full-width
    bf16 olmo-1b at batch 4 x 1024 through ``build_sharded_step`` (DTensor
    parameters, optimizer state and batch; ``remat_none``, phase 10's
    policy), its gradients held against the unsharded ``value_and_grad``'s
    (each leaf within 1e-4 of its max |g|), 6 steps in turns with the
    unsharded ``make_train_step``'s (losses within rtol 1e-4, parameters
    within 1e-4 of each leaf's update), bit-equality printed, the step
    analysed (``analyze_step``) and priced on ``H100_SXM`` beside its
    median device wall (steps 2-6), its ``model_flops / (wall x peak)``
    held against the twin's; then ``train(mesh=)`` runs phase 10's
    straight run on the mesh (losses within rtol 1e-4 of phase 10's) and
    its share of the peak is held against phase 10's (two shares at most
    the sum of their spreads apart, each spread from its own walls alone);
    then the dry run of olmo-1b x
    train_4k and moonshot-v1-16b-a3b x decode_32k on a (16, 16) mesh of a
    fake 256-rank world starts (``python -m repro_torch.launch.dryrun``,
    one subprocess a cell on the host, waited for last, beside phase 12's
    ``multipod_dryrun``, started with them; each must exit 0
    with ``"ok": true``; peak bytes a device, FLOPs, bytes, collectives by
    kind, the dominant roofline term and the sharding fallbacks printed)
    while ``dist-serve`` runs full-width qwen2-7b's 4 prompts through the
    sharded prefill (bit-equal to ``prefill``; its attention through
    ``local_map`` into the flash kernel, 28 launches a prompt, added to
    the kernels line) and 16 sharded decode steps a prompt (within 0.125
    of ``decode_step``), the longest prefill analysed and priced;
12. ``examples``: the examples of ``repro_torch.examples`` at the
    reference examples' sizes, three in this process on the card through
    their functions: ``quickstart`` (§III add and multiply bit-exact at 9
    and 102 cycles, the simulator's 4.72 ms / 18.3x / 7.7x, the W8A8 and
    8/4/2-bit bit-serial GEMMs at 128 x 256 x 128, each relative error
    equal to the same demo's through the plain versions on the card);
    ``serve_quantized --neural-cache`` on the reduced Inception under
    ``seed=7,filter=0.1,compute=0.05``, compressed, warmup re-plan (every
    request's logits byte-identical to a standalone ``nc_forward``,
    and to one with the kernels swapped for their plain versions,
    ``detected == corrupt_attempts``, none failed); the LM demo (reduced
    qwen2-7b in fp32, W8 and W4, 64 tokens a run, its prefills through the
    flash kernel, each served attention call held against the plain
    version on its q, k, v, the fp32 tokens held to a batch-1 loop by
    phase 8's rule); ``train_lm`` (the 76.1 M olmo-family config in
    float32, 300 steps of 8 x 256, checkpoints every 100 steps, the loss
    improved); then ``multipod_dryrun`` is waited for: its command line
    (qwen2-7b x train_4k on the (2, 16, 16) mesh of a fake 512-rank world,
    about 170 s of host work) runs in a host subprocess started in phase
    11 after the timed train steps, and its record must carry peak bytes,
    ``fits_hbm`` and the dominant term; each example's wall and tok/s or
    step/s printed beside the card;
13. ``paper``: the paper's evaluation through ``repro_torch.benchmarks``:
    ``paper-repro``, the ``paper_repro`` example in this process (its 65
    lines printed; the headline rows, Fig 13's 4722.8920 us, Fig 15's
    18.3x / 7.7x, Fig 16's 12.6x / 2.2x and Table IV's 4.72 / 4.20 / 3.81
    ms, held to the reference's text; modeled Xeon-cache times, not the
    card's); ``lm-nc``, one ``lm_neural_cache`` row per registered arch;
    ``sched``, ``sched_breakdown`` with its two measured inputs taken on
    the card (the calibration wall, the batch-4 dense forward of the
    50%-pruned ``reduced_config()``, min of 3 in turns with the sparse
    schedule's, logits byte-identical; the serial and overlapped batch-4
    walls of the reduced stem on the 1/4-scale array, 5 a side in turns)
    printed beside the card with every wall, each of the four measuring
    forwards' logits byte-identical to the same forward through the plain
    versions, every gate of the reference held (the measured pair by the
    in-turns rule of ``overlap_gate``) and the emulation SLO rows printed;
    ``replay``, ``traffic_replay.run_quick()``
    with its router and accounting gates, then the real fleet at full
    width: three ``NCServingEngine`` sockets (``socket-35MB``,
    ``scaled(7)``, ``scaled(4)``) behind the latency router serving phase
    4's 4 images with phase 4's weights (drawn again from its seed), every
    routed logit row byte-identical to phase 4's served logits, which one
    batch-4 full-width ``nc_forward`` with the kernels swapped for their
    plain versions must reproduce byte for byte (phase 7 runs only the
    first B images); the fleet's kernel launches held to that forward's
    GEMM count times the batches the sockets ran, and added to the
    kernels line with the ``sched`` forwards';
14. times on the card: each kernel and one PyTorch call at its shapes
    (``torch.matmul`` on float64 copies for the bit-serial kernels,
    ``torch._int_mm`` plus the epilogue for quant_matmul,
    ``scaled_dot_product_attention`` on KV repeated to H heads for
    flash_attention) as device time, 20 calls captured in one CUDA graph
    and replayed between CUDA events (the host's launch overhead is
    printed apart as the eager time), and the plain version eagerly,
    beside the bound; then ``quant_matmul`` at the PTQ head,
    ``flash_attention`` at the families' 21 served shapes and
    ``bitserial_matmul`` at the 4-bit PTQ sites' shapes (signed planes,
    n_bits 4, float epilogue) on lines of their own, outside the kernels
    line's sums; ``minmax_rows`` at batch 64 on the three largest
    convolution outputs beside its bound (bytes), the walk and
    ``torch.aminmax`` of the int32 low words; ``requant_rows`` at batch 64
    on the same three outputs beside its bound (9 bytes an element) and
    its plain version (CUDA events around eager calls); then each kernel's
    registers a thread and spill bytes from its build report;
15. one JSON line listing the six kernels (launches summed over every
    path that ran them: the Inception serving, stream-chunk and fleet runs,
    the 8-bit ``nc_dot``, the examples' quickstart and Neural Cache
    serving and phase 13's forwards and real fleet for
    ``bitserial_matmul``, the 4-bit path and the 4-bit
    ``nc_dot`` for ``bitserial_matmul_a4``, the PTQ and the quickstart for
    ``quant_matmul``, the seven served LMs, the two int8-cache runs, the
    sharded prefills and the LM demo for ``flash_attention``, and the
    Inception serving, stream-chunk and fleet runs, the examples' Neural
    Cache serving and phase 13's forwards and real fleet for
    ``minmax_rows`` and ``requant_rows``, each counted from zero just
    before its run and the full-width ones held to 94 launches a forward,
    one a convolution (144 for ``requant_rows``, with the 50 branches);
    ``max_abs_err`` is each kernel's largest measured difference from its
    plain version), then the card line, then
    ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import pathlib
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
H100_INT8_OPS_S = 1979e12  # dense int8 tensor-core rate, H100 SXM data sheet
B = 2  # main-path batch of the timed and compared forwards
# (name, M, K, N) of the main path's GEMMs at batch B (full width); the
# 4-bit path runs the W4A4 kernel at the same shapes
MAIN_SHAPES = [("Conv2d_2b_3x3", B * 21609, 288, 64),
               ("Conv2d_4a_3x3", B * 5041, 720, 192),
               ("Mixed_6a_b0_0", B * 289, 2592, 384),
               ("FullyConnected", B, 2048, 1001)]
# the three conv layers' input sides, channels, filter size, filters,
# stride and padding (inception.FULL) behind MAIN_SHAPES
CONV_LAYERS = [("Conv2d_2b_3x3", 147, 32, 3, 64, 1, "SAME"),
               ("Conv2d_4a_3x3", 73, 80, 3, 192, 1, "VALID"),
               ("Mixed_6a_b0_0", 35, 288, 3, 384, 2, "VALID")]
FAULT_PROFILE = "seed=7,filter=0.05,act=0.01,compute=0.01,stuck=3"
# the sources of src/repro_torch/csrc/ that cuda_build.build_all compiles
KERNELS = ("bitserial_gemm", "bitserial_gemm_a4", "quant_gemm",
           "flash_attention", "minmax_rows", "requant_rows")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (floats compared as integers)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(ity), b.view(ity))
    return torch.equal(a, b)


FULL_CONVS = 94  # convolutions of inception.FULL: one min/max launch each
# minmax_rows launches of the main-path runs, by path, each counted from a
# zero set just before it (phase 3's hold, phase 7's comparison and phase
# 14's times are checks, not main-path runs, and stay out)
MINMAX_BY_PATH: dict[str, int] = {}


def _minmax():
    """The min/max kernel's wrapper, whose ``launches`` the main-path
    phases set to 0 where they set ``bitserial_matmul``'s."""
    from repro_torch.kernels import minmax_rows as mm
    return mm.minmax_rows


def _minmax_take(path: str, dev, forwards: int | None = None) -> int:
    """The min/max kernel's launches since ``path``'s zero set, added to
    ``MINMAX_BY_PATH``; with ``forwards`` (full-width forwards the path
    ran on ``dev``) held on the card to one launch a convolution,
    ``FULL_CONVS`` a forward (CPU tensors take the walk and launch
    nothing)."""
    n = _minmax().launches
    if (forwards is not None and dev.type == "cuda"
            and n != FULL_CONVS * forwards):
        raise AssertionError(f"{path}: {n} minmax_rows launches for "
                             f"{forwards} full-width forwards, want "
                             f"{FULL_CONVS} a forward")
    MINMAX_BY_PATH[path] = MINMAX_BY_PATH.get(path, 0) + n
    return n


FULL_BRANCHES = 50  # branch outputs inception.FULL concatenates
# requant_rows launches of the main-path runs, by path, counted as the
# min/max kernel's are
REQUANT_BY_PATH: dict[str, int] = {}


def _requant():
    """The requantization kernel's wrapper, whose ``launches`` the
    main-path phases set to 0 with the min/max kernel's."""
    from repro_torch.kernels import requant_rows as rq
    return rq.requant_rows


def _requant_take(path: str, dev, forwards: int | None = None) -> int:
    """The requantization kernel's launches since ``path``'s zero set,
    added to ``REQUANT_BY_PATH``; with ``forwards`` held on the card to one
    launch a convolution and a concatenated branch, ``FULL_CONVS +
    FULL_BRANCHES`` a forward (CPU tensors take the plain version)."""
    n = _requant().launches
    want = FULL_CONVS + FULL_BRANCHES
    if forwards is not None and dev.type == "cuda" and n != want * forwards:
        raise AssertionError(f"{path}: {n} requant_rows launches for "
                             f"{forwards} full-width forwards, want {want} "
                             f"a forward")
    REQUANT_BY_PATH[path] = REQUANT_BY_PATH.get(path, 0) + n
    return n


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events around ``reps``)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Mean device time of ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph and replayed ``rounds`` times between CUDA events, so that
    the host's cost of each call (a wrapper's checks and launch) is not
    counted.  The wrappers launch on the current stream, which capture
    makes the graph's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * rounds)


def _bitserial_compare(bsm, x, planes, what, **kw):
    """Hold ``bitserial_matmul`` bit-equal to its plain version on the
    same operands (both epilogues unless ``out_dtype`` is given); returns
    the largest absolute difference."""
    worst = 0.0
    dtypes = ((kw.pop("out_dtype"),) if "out_dtype" in kw
              else (torch.int32, torch.float32))
    for out_dtype in dtypes:
        got = bsm.bitserial_matmul(x, planes, out_dtype=out_dtype, **kw)
        want = bsm.bitserial_matmul_plain(x, planes, out_dtype=out_dtype,
                                          **kw)
        torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs().max().item()
        if not bits_equal(got, want):
            raise AssertionError(f"kernel != plain at {what} out={out_dtype}"
                                 f": max diff {diff}")
        worst = max(worst, diff)
    return worst


def phase_kernel(bsm, dev) -> float:
    """Kernel against plain at random and main-path shapes; returns the
    largest absolute difference (launches here are not main-path counts)."""
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    cases = []
    for i, (M, K, N) in enumerate([(1, 1, 1), (7, 33, 5), (65, 31, 129),
                                   (130, 257, 67), (64, 64, 64),
                                   (3, 600, 200), (257, 1000, 130),
                                   (100, 520, 300)]):
        n_bits = 1 + i % 8
        for signed in (False, True):
            for masked in (False, True):
                for x_dtype in (torch.uint8, torch.int8):
                    cases.append((M, K, N, n_bits, signed, masked, x_dtype))
    for M, K, N, n_bits, signed, masked, x_dtype in cases:
        x = torch.randint(0, 256, (M, K), generator=g, dtype=torch.int64)
        x = x.to(torch.uint8).view(x_dtype).to(dev)
        planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                               dtype=torch.int64).to(torch.uint8).to(dev)
        w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
        mask = None
        if masked:
            full = bsm.plane_block_mask(planes, n_bits, 48, 80)
            drop = torch.rand(full.shape, generator=g) < 0.3
            mask = torch.where(drop.to(dev), torch.zeros_like(full), full)
        worst = max(worst, _bitserial_compare(
            bsm, x, planes, f"M,K,N={M, K, N} n_bits={n_bits} signed={signed}"
            f" mask={masked} x={x_dtype}", x_scale=0.37, w_scale=w_scale,
            plane_mask=mask, n_bits=n_bits, signed=signed, block_k=48,
            block_n=80))
    log(f"[kernel] {len(cases) * 2} random cases equal to the plain version")
    # shapes ragged against the 128x64x64 tile, and split-K shapes, with
    # all four x/plane signedness pairs; the split shapes masked too
    n = 0
    edges = [(129, 193, 65), (383, 130, 191), (127, 65, 63)]
    splits = [(M, K, N) for M in (1, 2, 17) for K in (2048, 2593)
              for N in (1001, 300)]
    for i, (M, K, N) in enumerate(edges + splits):
        n_bits = 8 - i % 4
        for x_dtype in (torch.uint8, torch.int8):
            for signed in (False, True):
                x = torch.randint(0, 256, (M, K), generator=g,
                                  dtype=torch.int64)
                x = x.to(torch.uint8).view(x_dtype).to(dev)
                planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                                       dtype=torch.int64).to(torch.uint8)
                planes = planes.to(dev)
                w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
                kw = dict(n_bits=n_bits, signed=signed, block_k=48,
                          block_n=80)
                what = (f"M,K,N={M, K, N} n_bits={n_bits} x={x_dtype} "
                        f"signed={signed} split={bsm.split_k(M, N, K)[0]}")
                worst = max(worst, _bitserial_compare(
                    bsm, x, planes, what, x_scale=0.37, w_scale=w_scale,
                    **kw))
                n += 2
                if (M, K, N) in splits:
                    full = bsm.plane_block_mask(planes, n_bits, 48, 80)
                    drop = torch.rand(full.shape, generator=g) < 0.3
                    mask = torch.where(drop.to(dev), torch.zeros_like(full),
                                       full)
                    worst = max(worst, _bitserial_compare(
                        bsm, x, planes, what + " masked", x_scale=0.37,
                        w_scale=w_scale, plane_mask=mask, **kw))
                    n += 2
    log(f"[kernel] {n} cases ragged against the kernel's tile or split "
        f"along K (splits "
        f"{sorted({bsm.split_k(M, N, K)[0] for M, K, N in splits})}) equal "
        f"to the plain version")
    # int32 sums past 2^31 wrap, split along K and not; all-ones operands
    # keep the plain version's float64 plane products exact (< 2^53)
    for M, K, N in ((3, 40000, 5), (1030, 34000, 1300)):
        x = torch.full((M, K), 255, dtype=torch.uint8, device=dev)
        planes = torch.full((K, N), 255, dtype=torch.uint8, device=dev)
        top = 255 * 255 * K
        if not 2 ** 31 < top < 2 ** 53:
            raise AssertionError(f"wrap case {M, K, N} does not wrap")
        _bitserial_compare(bsm, x, planes, f"wrap {M}x{K}x{N}", n_bits=8,
                           out_dtype=torch.int32, signed=False)
        log(f"[kernel] {M}x{K}x{N}: int32 sum {top} wraps, equal to the "
            f"plain version (split {bsm.split_k(M, N, K)[0]})")
    for name, M, K, N in MAIN_SHAPES:
        x = torch.randint(0, 256, (M, K), generator=g).to(torch.uint8).to(dev)
        planes = torch.randint(0, 256, (K, N), generator=g).to(torch.uint8).to(dev)
        _bitserial_compare(bsm, x, planes, f"{name} {M}x{K}x{N}", n_bits=8,
                           out_dtype=torch.int32, signed=False)
        log(f"[kernel] {name} {M}x{K}x{N}: int32 equal to the plain version "
            f"(split {bsm.split_k(M, N, K)[0]})")
    return worst


def phase_kernel_a4(bsm, dev) -> float:
    """The W4A4 kernel against its plain version at random and full-width
    4-bit shapes; returns the largest absolute difference."""
    g = torch.Generator().manual_seed(3)
    worst = 0.0
    cases = []
    for i, (M, K, N) in enumerate([(1, 1, 1), (7, 33, 5), (65, 31, 129),
                                   (130, 257, 67), (64, 64, 64),
                                   (3, 600, 200), (257, 1001, 130),
                                   (100, 520, 300)]):
        n_bits = 1 + i % 4
        for signed in (False, True):
            for masked in (False, True):
                cases.append((M, K, N, n_bits, signed, masked))
    for M, K, N, n_bits, signed, masked in cases:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                               dtype=torch.int64).to(torch.uint8).to(dev)
        w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
        mask = None
        if masked:
            full = bsm.plane_block_mask(planes, n_bits, 48, 80)
            drop = torch.rand(full.shape, generator=g) < 0.3
            mask = torch.where(drop.to(dev), torch.zeros_like(full), full)
        kw = dict(n_bits=n_bits, signed=signed, block_k2=24, block_n=80)
        for out_dtype in (torch.int32, torch.float32):
            got = bsm.bitserial_matmul_a4(xp, planes, 0.37, w_scale, mask,
                                          out_dtype=out_dtype, **kw)
            want = bsm.bitserial_matmul_a4_plain(xp, planes, 0.37, w_scale,
                                                 mask, out_dtype=out_dtype,
                                                 **kw)
            torch.cuda.synchronize()
            diff = (got.double() - want.double()).abs().max().item()
            if not bits_equal(got, want):
                raise AssertionError(
                    f"a4 kernel != plain at M,K,N={M, K, N} n_bits={n_bits} "
                    f"signed={signed} mask={masked} out={out_dtype}: max "
                    f"diff {diff}")
            worst = max(worst, diff)
    log(f"[kernel-a4] {len(cases) * 2} random cases equal to the plain "
        f"version")
    # split-K shapes with all four x/plane signedness pairs, the split
    # shapes masked too; rows of K2 bytes off a 16-byte boundary outside
    # the main shapes; K < 2*K2 - 1 (nibbles past K meet no weight row)
    n = 0
    splits = [(M, K, N) for M in (1, 2, 17) for K in (2048, 2593)
              for N in (1001, 300)]
    edges = [(333, 200, 100, 130), (129, 214, 107, 65), (7, 301, 200, 77),
             (2, 1500, 1300, 1001), (130, 1000, 517, 70)]
    cases = [(M, K, (K + 1) // 2, N) for M, K, N in splits] + edges
    for i, (M, K, K2, N) in enumerate(cases):
        n_bits = 4 - i % 4
        xp = torch.randint(0, 256, (M, K2), generator=g).to(torch.uint8)
        xp = xp.to(dev)
        planes = torch.randint(0, 1 << n_bits, (K, N), generator=g,
                               dtype=torch.int64).to(torch.uint8).to(dev)
        w_scale = (torch.rand(N, generator=g) + 0.5).to(dev)
        what = (f"M,K,K2,N={M, K, K2, N} n_bits={n_bits} split="
                f"{bsm.split_k(M, N, K)[0]}")
        for x_signed in (False, True):
            for signed in (False, True):
                worst = max(worst, _a4_compare(
                    bsm, xp, planes, K, x_signed, signed, w_scale, n_bits,
                    f"{what} x_signed={x_signed} signed={signed}"))
                n += 2
            if (M, K, N) in splits:
                full = bsm.plane_block_mask(planes, n_bits, 48, 80)
                drop = torch.rand(full.shape, generator=g) < 0.3
                mask = torch.where(drop.to(dev), torch.zeros_like(full),
                                   full)
                kw = dict(n_bits=n_bits, signed=x_signed, block_k2=24,
                          block_n=80)
                for out_dtype in (torch.int32, torch.float32):
                    got = bsm.bitserial_matmul_a4(xp, planes, 0.37, w_scale,
                                                  mask, out_dtype=out_dtype,
                                                  **kw)
                    want = bsm.bitserial_matmul_a4_plain(
                        xp, planes, 0.37, w_scale, mask, out_dtype=out_dtype,
                        **kw)
                    torch.cuda.synchronize()
                    if not bits_equal(got, want):
                        raise AssertionError(f"a4 kernel != plain at {what} "
                                             f"signed={x_signed} masked")
                    n += 1
    log(f"[kernel-a4] {n} cases split along K (splits "
        f"{sorted({bsm.split_k(M, N, K)[0] for M, K, N in splits})}, all "
        f"four signedness pairs), with K2 off a 16-byte boundary or K < "
        f"2*K2 - 1, equal to the plain version")
    for name, M, K, N in MAIN_SHAPES:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 16, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=4, out_dtype=torch.int32, signed=False)
        got = bsm.bitserial_matmul_a4(xp, planes, **kw)
        want = bsm.bitserial_matmul_a4_plain(xp, planes, **kw)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"a4 kernel != plain at {name} {M}x{K}x{N}")
        log(f"[kernel-a4] {name} {M}x{K}x{N}: int32 equal to the plain "
            f"version (split {bsm.split_k(M, N, K)[0]})")
    return worst


def _a4_compare(bsm, xp, planes, K, x_signed, signed, w_scale, n_bits, what):
    """Hold the W4A4 kernel with nibble signedness ``x_signed`` and plane
    signedness ``signed`` bit-equal to the plain version, both epilogues;
    returns the largest absolute difference.  ``bitserial_matmul_a4``
    passes one flag for both, so a mixed pair goes through the launcher
    helper and is held against the 8-bit plain version on the widened
    nibbles (the same function)."""
    worst = 0.0
    b = xp.to(torch.int64)
    lo, hi = b & 0xF, b >> 4
    if x_signed:
        lo, hi = (lo ^ 8) - 8, (hi ^ 8) - 8
    x8 = torch.stack([lo, hi], dim=-1).reshape(b.shape[0], -1)[:, :K]
    x8 = x8.to(torch.int8 if x_signed else torch.uint8).contiguous()
    for out_dtype in (torch.int32, torch.float32):
        kw = dict(n_bits=n_bits, out_dtype=out_dtype, signed=signed)
        if x_signed == signed:
            got = bsm.bitserial_matmul_a4(xp, planes, 0.37, w_scale, **kw)
        else:
            got = bsm._launch_a4(xp, planes, 0.37, w_scale, None,
                                 x_signed=x_signed, block_k2=bsm.DEFAULT_BK2,
                                 block_n=bsm.DEFAULT_BN, **kw)
        want = bsm.bitserial_matmul_plain(x8, planes, 0.37, w_scale, **kw)
        torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs().max().item()
        if not bits_equal(got, want):
            raise AssertionError(f"a4 kernel != plain at {what} out="
                                 f"{out_dtype}: max diff {diff}")
        worst = max(worst, diff)
    return worst


def phase_serve(inception, serve, backends, bsm, params, images, dev, cfg):
    engine = serve.NCServingEngine(params, cfg, max_batch=2, device=dev)
    for i, img in enumerate(images):
        engine.submit(serve.NCRequest(rid=i, image=img))
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    backends.dispatch_stats_clear()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul.launches
    batches = engine.stats()["batch_histogram"]
    mm_launches = _minmax_take("serve", dev, sum(batches.values()))
    rq_launches = _requant_take("serve", dev, sum(batches.values()))
    gemm = backends.dispatch_stats()["gemm"]
    log(f"[serve] {len(done)} full-width requests in {wall:.2f} s "
        f"(batches {batches}); gemm dispatch {gemm}; kernel launches "
        f"{launches}; minmax_rows launches {mm_launches} ({FULL_CONVS} a "
        f"forward); requant_rows launches {rq_launches} "
        f"({FULL_CONVS + FULL_BRANCHES} a forward)")
    if len(done) != len(images) or engine.failed:
        raise AssertionError(f"served {len(done)} of {len(images)}: "
                             f"{engine.errors}")
    if any(r.degraded for r in done):
        raise AssertionError("a batch left the emulation (degraded)")
    if gemm["native"] == 0 or gemm["fallback"] != 0:
        raise AssertionError(f"gemm backend dispatch {gemm}")
    if launches == 0:
        raise AssertionError("the kernel was not launched on the main path")
    for r in done:
        if r.logits.shape != (cfg.classes,) or not bool(torch.isfinite(r.logits).all()):
            raise AssertionError(f"request {r.rid}: bad logits")
        alone, _ = inception.nc_forward(params, images[r.rid], config=cfg,
                                        device=dev)
        if not bits_equal(r.logits, alone):
            raise AssertionError(f"request {r.rid}: served logits differ "
                                 f"from a standalone nc_forward")
    log("[serve] every request's logits byte-identical to standalone "
        "nc_forward")
    return launches, wall, {r.rid: r.logits for r in done}


def _exact_plain(bsm):
    """``ops.bitserial_matmul_exact`` with both kernels swapped for their
    plain versions (the gemm backend reaches the kernels through it); its
    ``calls`` counts the GEMMs it was asked for."""
    def exact(x_q, planes, *, n_bits, w4a4=False):
        exact.calls += 1
        fn = (bsm.bitserial_matmul_a4_plain if w4a4
              else bsm.bitserial_matmul_plain)
        return fn(x_q, planes, 1.0, None, n_bits=n_bits,
                  out_dtype=torch.int32, signed=False)
    exact.calls = 0
    return exact


def _four_bit_calls(nc_layers, qmod, dev):
    """The 4-bit path at full width: ``nc_conv2d`` at CONV_LAYERS (batch B)
    and ``nc_fc`` at 2048 -> 1001 with 4-bit operands and QuantParams built
    as the reference's backend conformance suite builds them.  Returns each
    call's (output, cycles, stats)."""
    g = torch.Generator().manual_seed(4)
    x_qp = qmod.QuantParams(scale=float(np.float32(1 / 16)), zero_point=1,
                            bits=4)
    w_qp = qmod.QuantParams(scale=float(np.float32(0.05)), zero_point=8,
                            bits=4)
    outs = []
    for name, H, C, R, M, stride, pad in CONV_LAYERS:
        x = torch.randint(0, 16, (B, H, H, C), generator=g).to(torch.uint8)
        w = torch.randint(0, 16, (R, R, C, M), generator=g).to(torch.uint8)
        outs.append(nc_layers.nc_conv2d(
            x.to(dev), w.to(dev), [x_qp] * B, w_qp, stride, padding=pad,
            engine="gemm", return_stats=True))
    x = torch.randint(0, 16, (B, 2048), generator=g).to(torch.uint8)
    w = torch.randint(0, 16, (2048, 1001), generator=g).to(torch.uint8)
    outs.append(nc_layers.nc_fc(x.to(dev), w.to(dev), [x_qp] * B, w_qp,
                                engine="gemm", return_stats=True))
    torch.cuda.synchronize()
    return outs


def phase_four_bit(nc_layers, qmod, ops, backends, bsm, dev):
    """The 4-bit path through the W4A4 kernel; returns its launch count."""
    bsm.bitserial_matmul.launches = 0
    bsm.bitserial_matmul_a4.launches = 0
    backends.dispatch_stats_clear()
    t0 = time.perf_counter()
    outs = _four_bit_calls(nc_layers, qmod, dev)
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul_a4.launches
    launches8 = bsm.bitserial_matmul.launches
    gemm = backends.dispatch_stats()["gemm"]
    log(f"[4-bit] 3 full-width convs + FC at batch {B} in {wall:.2f} s; "
        f"gemm dispatch {gemm}; a4 kernel launches {launches}, 8-bit "
        f"kernel launches {launches8}")
    if gemm["native"] == 0 or gemm["fallback"] != 0:
        raise AssertionError(f"gemm backend dispatch {gemm}")
    if launches == 0 or launches8 != 0:
        raise AssertionError("the 4-bit path did not run the W4A4 kernel "
                             "alone")
    real = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    before = bsm.bitserial_matmul_a4.launches
    try:
        plain = _four_bit_calls(nc_layers, qmod, dev)
    finally:
        ops.bitserial_matmul_exact = real
    if bsm.bitserial_matmul_a4.launches != before:
        raise AssertionError("the plain 4-bit run launched the kernel")
    names = [c[0] for c in CONV_LAYERS] + ["FullyConnected"]
    for name, (o, c, st), (po, pc, pst), (_, M, K, N) in zip(
            names, outs, plain, MAIN_SHAPES):
        if not bits_equal(o, po) or c != pc or st != pst:
            raise AssertionError(f"4-bit {name}: kernel != plain")
        if st.lanes != M * K * N:
            raise AssertionError(f"4-bit {name}: {st.lanes} lanes, want "
                                 f"{M}x{K}x{N}")
    log("[4-bit] outputs, cycles and ConvStats byte-identical to the plain "
        "W4A4 route")
    return launches


def phase_faulted_serve(inception, serve, faults, nc_layers, backends, bsm,
                        params, images, clean, dev, cfg):
    """Full-width checked, compressed serving under an active fault
    profile; returns (wall, re-executed passes)."""
    sums = dict(verify_passes=0, reexec_passes=0, faults_detected=0,
                integrity_cycles=0, reexec_cycles=0, csr_payload_bytes=0,
                csr_index_bytes=0)
    real = nc_layers.nc_conv2d

    def counted(*a, **k):
        res = real(*a, **k)
        if k.get("return_stats"):
            for key in sums:
                sums[key] += getattr(res[2], key)
        return res

    engine = serve.NCServingEngine(params, cfg, max_batch=2, integrity=True,
                                   compressed=True, device=dev)
    # the checked, compressed forward with no fault scope: every pass
    # verified, none re-run (the cost of checking alone)
    x = torch.from_numpy(np.stack(images)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = inception.nc_forward(params, x, config=cfg,
                                     wpack=engine.wpack, integrity=True,
                                     compressed=True, device=dev)
    torch.cuda.synchronize()
    checked_wall = time.perf_counter() - t0
    for i in range(len(images)):
        if not bits_equal(logits[i], clean[i]):
            raise AssertionError(f"image {i}: checked, compressed logits "
                                 f"differ from the clean run's")
    log(f"[faults] checked, compressed batch-{len(images)} nc_forward "
        f"without faults: {checked_wall:.2f} s, logits byte-identical to "
        f"the clean run's")
    for i, img in enumerate(images):
        engine.submit(serve.NCRequest(rid=i, image=img))
    nc_layers.nc_conv2d = counted
    bsm.bitserial_matmul.launches = 0
    bsm.bitserial_matmul_a4.launches = 0
    backends.dispatch_stats_clear()
    try:
        with faults.inject(faults.FaultProfile.parse(FAULT_PROFILE)) as fs:
            t0 = time.perf_counter()
            done = engine.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        nc_layers.nc_conv2d = real
    fst = fs.stats()
    log(f"[faults] {len(done)} full-width requests, integrity + compressed, "
        f"under {FAULT_PROFILE} in {wall:.2f} s; gemm dispatch "
        f"{backends.dispatch_stats()['gemm']}; kernel launches "
        f"{bsm.bitserial_matmul.launches}")
    log(f"[faults] ledger: {fst}")
    log(f"[faults] verify passes {sums['verify_passes']}, re-executed passes "
        f"{sums['reexec_passes']}, detected {sums['faults_detected']}; "
        f"checksum cycles {sums['integrity_cycles']}, re-execution cycles "
        f"{sums['reexec_cycles']}; CSR payload {sums['csr_payload_bytes']} B,"
        f" index {sums['csr_index_bytes']} B; engine stats "
        f"failed={engine.stats()['failed']} "
        f"degraded={engine.stats()['degraded_batches']} "
        f"retries={engine.stats()['retries']}")
    if len(done) != len(images) or engine.failed or engine.queue:
        raise AssertionError(f"served {len(done)} of {len(images)}: "
                             f"{engine.errors}")
    if any(r.degraded for r in done):
        raise AssertionError("a faulted batch left the emulation (degraded)")
    if fst["injected"] == 0 or fst["detected"] != fst["corrupt_attempts"]:
        raise AssertionError(f"fault ledger {fst}: silent corruption or "
                             f"nothing injected")
    if not fst["quarantined_slices"]:
        raise AssertionError("the stuck slice was never quarantined")
    if bsm.bitserial_matmul.launches == 0:
        raise AssertionError("the checked path did not launch the kernel")
    for r in done:
        if not bits_equal(r.logits, clean[r.rid]):
            raise AssertionError(f"request {r.rid}: faulted logits differ "
                                 f"from the clean run's")
    log("[faults] every request's logits byte-identical to the clean "
        "serving run; detected == corrupt_attempts")
    return wall, sums["reexec_passes"]


def phase_plain_forward(inception, ops, bsm, mm, params, x, dev, cfg):
    wpack = inception.prepare_conv_weights(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, rk = inception.nc_forward(params, x, config=cfg, wpack=wpack,
                                  device=dev)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    from repro_torch.kernels import requant_rows as rq

    saved = ops.bitserial_matmul_exact, ops.minmax_rows, ops.requant_rows
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    ops.minmax_rows = mm.minmax_rows_plain
    ops.requant_rows = rq.requant_rows_plain
    launches = (bsm.bitserial_matmul.launches, mm.minmax_rows.launches,
                rq.requant_rows.launches)
    try:
        t0 = time.perf_counter()
        lp, rp = inception.nc_forward(params, x, config=cfg, wpack=wpack,
                                      device=dev)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        ops.bitserial_matmul_exact, ops.minmax_rows, ops.requant_rows = saved
    if (bsm.bitserial_matmul.launches, mm.minmax_rows.launches,
            rq.requant_rows.launches) != launches:
        raise AssertionError("the plain forward launched a kernel")
    if not bits_equal(lk, lp):
        raise AssertionError("full-width logits: kernel != plain")
    if rk != rp:
        raise AssertionError("full-width layer reports: kernel != plain")
    if rk.summary() != rp.summary():
        raise AssertionError("full-width report summaries: kernel != plain")
    log(f"[forward] the kernel forward's NCForwardReport.summary(), equal "
        f"to the plain forward's:\n{rk.summary()}")
    if lk.shape != (x.shape[0], cfg.classes) or not bool(torch.isfinite(lk).all()):
        raise AssertionError("full-width logits not finite")
    ref = inception.apply(params, x, config=cfg)
    corr = np.corrcoef(lk.double().cpu().numpy().ravel(),
                       ref.double().cpu().numpy().ravel())[0, 1]
    log(f"[forward] batch {x.shape[0]} full width: kernel {t_kernel:.2f} s, "
        f"plain {t_plain:.2f} s; logits and {len(rk.layers)} layer reports "
        f"byte-identical; corr(emulated, float) = {corr:.4f} (information)")
    return t_kernel, wpack


MINMAX_B = 4  # the batch of the min/max kernel's hold (the engine's default)
MINMAX_TIME_B = 64  # the batch of its times (the benchmark's cells)


def _minmax_operands(K: int, batch: int, g) -> torch.Tensor:
    """int64 ``[batch, K]`` on the card: random int32 low words under
    random high bits, which the main path's ``bits=32`` mask drops."""
    return torch.randint(-(1 << 40), 1 << 40, (batch, K), generator=g,
                         device=g.device, dtype=torch.int64)


def _conv_outputs(inception):
    """``(name, K)`` of the 94 convolutions of ``inception.FULL``: the
    values per image that each one's min/max reads."""
    return [(s.name, s.E * s.E * s.M)
            for s in inception.inception_v3_specs(inception.FULL)
            if s.kind == "conv"]


def phase_minmax(inception, mm, dev) -> int:
    """The min/max kernel against its plain version (the bit-serial walk,
    on the card too) at the 94 convolutions' output shapes at batch
    ``MINMAX_B``, with the main path's ``bits=32, signed=True``: mins and
    maxs byte-identical, one count a call.  Returns the largest absolute
    difference of a kernel value from the walk's (launches here are not
    main-path counts)."""
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = _conv_outputs(inception)
    if len(shapes) != FULL_CONVS:
        raise AssertionError(f"{len(shapes)} convolutions, want {FULL_CONVS}")
    before = mm.minmax_rows.launches
    worst = 0
    for name, K in shapes:
        x = _minmax_operands(K, MINMAX_B, g)
        got = mm.minmax_rows(x, 32, True)
        want = mm.minmax_rows_plain(x, 32, True)
        worst = max(worst, *(int((a - b).abs().max()) for a, b in
                             zip(got, want)))
        if not all(bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"minmax_rows at {name} [{MINMAX_B}, {K}]: "
                                 f"kernel != walk, max diff {worst}")
    launches = mm.minmax_rows.launches - before
    if launches != len(shapes):
        raise AssertionError(f"minmax_rows: {launches} launches for "
                             f"{len(shapes)} calls")
    log(f"[minmax] kernel == walk at the {len(shapes)} convolutions' output "
        f"shapes at batch {MINMAX_B} ({sum(k for _, k in shapes)} values an "
        f"image), {launches} launches, max diff {worst}")
    return worst


def phase_times_minmax(inception, mm, dev):
    """The min/max kernel's device time at batch ``MINMAX_TIME_B`` on the
    three largest convolution outputs, beside its bound (the int64 values
    read once and two int64 a row written, at 3.35 TB/s), the walk's time
    and ``torch.aminmax`` of the int32 low words (the same function at
    ``bits=32, signed=True``) as the yardstick."""
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for name, K in sorted(_conv_outputs(inception), key=lambda r: -r[1])[:3]:
        x = _minmax_operands(K, MINMAX_TIME_B, g)
        ms = graph_ms(lambda: mm.minmax_rows(x, 32, True))
        eager_ms = cuda_ms(lambda: mm.minmax_rows(x, 32, True))
        plain_ms = cuda_ms(lambda: mm.minmax_rows_plain(x, 32, True), reps=1,
                           warmup=1)
        lib_ms = graph_ms(lambda: torch.aminmax(x.to(torch.int32), dim=1))
        lib = torch.aminmax(x.to(torch.int32), dim=1)
        if not all(torch.equal(a, b.to(torch.int64)) for a, b in
                   zip(mm.minmax_rows(x, 32, True), lib)):
            raise AssertionError(f"torch.aminmax yardstick disagrees at "
                                 f"{name}")
        bound = _bound(8 * MINMAX_TIME_B * K + 16 * MINMAX_TIME_B, 0, 1.0)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **bound))
        log(f"[time-minmax] {name} [{MINMAX_TIME_B}, {K}] (chunks "
            f"{mm.minmax_chunks(MINMAX_TIME_B, K)}): kernel {ms:.4f} ms "
            f"(eager {eager_ms:.4f} ms), {bound['bound_ms'] / ms:.1%} of the "
            f"bound {bound['bound_ms']:.5f} ms (bytes), walk {plain_ms:.2f} "
            f"ms, torch.aminmax int32 {lib_ms:.4f} ms")
    return rows


REQUANT_B = 4  # the batch of the requantization kernel's hold


def _requant_case(rq, x, Ctot, offset, g):
    """The requantization kernel and its plain version on ``x`` ``[B, P,
    C]`` into ``Ctot`` channels at ``offset``, with seeded per-image
    parameters (multipliers 1e-9 to 3, zero points 0 to 255): outputs and
    live counts byte-identical, one launch; returns the largest output
    difference."""
    B, P, C = x.shape
    reals = torch.exp(torch.empty(B).uniform_(math.log(1e-9), math.log(3.0),
                                              generator=g))
    from repro_torch.core import quantize as q

    mult, shift = q.fixed_point_multiplier_rows(reals)
    zps = torch.randint(0, 256, (2, B), generator=g)
    in_zp = zps[0] if x.dtype == torch.uint8 else 0
    got = torch.zeros((B, P, Ctot), dtype=torch.uint8, device=x.device)
    want = got.clone()
    before = rq.requant_rows.launches
    live = rq.requant_rows(x, got, in_zp, mult, shift, zps[1], offset, True)
    want_live = rq.requant_rows_plain(x, want, in_zp, mult, shift, zps[1],
                                      offset, True)
    torch.cuda.synchronize()
    worst = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    if rq.requant_rows.launches != before + 1:
        raise AssertionError("requant_rows: not one launch a call")
    if not (bits_equal(got, want) and bits_equal(live, want_live)):
        raise AssertionError(f"requant_rows at [{B}, {P}, {C}] -> {Ctot} at "
                             f"{offset}: kernel != plain, max diff {worst}")
    return worst


def _requant_operands(K: int, batch: int, g) -> torch.Tensor:
    """int64 ``[batch, K]`` on the card: post-ReLU staging, non-negative
    int32 values."""
    return torch.randint(0, 1 << 31, (batch, K), generator=g,
                         device=g.device, dtype=torch.int64)


def phase_requant(inception, rq, dev) -> int:
    """The requantization kernel against its plain version at the 94
    convolutions' output shapes at batch ``REQUANT_B`` and at Mixed_7c's
    four branches into the block's 2048 channels: bytes and live counts
    identical, one launch a call.  Returns the largest difference."""
    g = torch.Generator(device=dev).manual_seed(9)
    gh = torch.Generator().manual_seed(9)
    specs = [s for s in inception.inception_v3_specs(inception.FULL)
             if s.kind == "conv"]
    worst = 0
    for s in specs:
        x = _requant_operands(s.E * s.E * s.M, REQUANT_B, g)
        worst = max(worst, _requant_case(
            rq, x.view(REQUANT_B, s.E * s.E, s.M), s.M, 0, gh))
    offset = 0
    for C in (320, 768, 768, 192):
        y = torch.randint(0, 256, (REQUANT_B, 64, C), generator=g,
                          device=dev, dtype=torch.uint8)
        worst = max(worst, _requant_case(rq, y, 2048, offset, gh))
        offset += C
    log(f"[requant] kernel == plain at the {len(specs)} convolutions' "
        f"output shapes and Mixed_7c's 4 branches at batch {REQUANT_B}, "
        f"live counts equal, one launch a call, max diff {worst}")
    return worst


def phase_times_requant(inception, rq, dev):
    """The requantization kernel's device time at batch 64 on the three
    largest convolution outputs, beside its bound (9 bytes an element: the
    int64 read once, the uint8 written once, at 3.35 TB/s) and the plain
    version's time (CUDA events around eager calls: each call's parameter
    copy is in it, and the host runs ahead of the card).  No library call
    computes it: the kernels line's library time is the plain version's
    torch chain."""
    g = torch.Generator(device=dev).manual_seed(10)
    from repro_torch.core import quantize as q

    rows = []
    outs = sorted(((s.name, s.E * s.E, s.M)
                   for s in inception.inception_v3_specs(inception.FULL)
                   if s.kind == "conv"), key=lambda r: -r[1] * r[2])[:3]
    B = MINMAX_TIME_B
    for name, P, C in outs:
        x = _requant_operands(P * C, B, g).view(B, P, C)
        out = torch.empty((B, P, C), dtype=torch.uint8, device=dev)
        mult, shift = q.fixed_point_multiplier_rows(
            torch.full((B,), 1e-7, dtype=torch.float32))
        ms = cuda_ms(lambda: rq.requant_rows(x, out, 0, mult, shift, 3,
                                             live=True), reps=20)
        plain_ms = cuda_ms(lambda: rq.requant_rows_plain(
            x, out, 0, mult, shift, 3, live=True), reps=2, warmup=1)
        bound = _bound(9 * B * P * C, 0, 1.0)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=plain_ms, **bound))
        log(f"[time-requant] {name} [{B}, {P}, {C}] ({rq.requant_blocks(B, P * C)}"
            f" blocks a row): kernel {ms:.4f} ms, "
            f"{bound['bound_ms'] / ms:.1%} of the bound "
            f"{bound['bound_ms']:.5f} ms (bytes), plain {plain_ms:.3f} ms")
    return rows


def phase_split(inception, params, x, wpack, dev, cfg):
    """Full-width forward split into five stages by the program's own spans
    (``repro_torch.tracing``): pack (``layer.pack``: the filters' copy to
    the card, quantization, im2col and word packing), dot, the min/max
    tree (``minmax.tree``), requant (``epilogue.requant`` and the blocks'
    ``concat``) and the rest of the forward.  A span holds the host's time
    in its call, not the device work it leaves queued: each stage excludes
    the device tail after its calls, which the next host sync charges to
    the stage that makes it."""
    from repro_torch import tracing

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.session():
        inception.nc_forward(params, x, config=cfg, wpack=wpack, device=dev)
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    spans = tracing.last_session().totals()

    def span_s(*names):
        return sum(spans[n]["total_s"] for n in names if n in spans)

    split = {"pack": span_s("layer.pack"), "dot": span_s("dot"),
             "minmax tree": span_s("minmax.tree"),
             "requant": span_s("epilogue.requant", "concat")}
    split["other"] = total - sum(split.values())
    log(f"[split] batch {x.shape[0]} full-width forward {total:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    return split


def phase_inception_quant(inception, params, x, served, cfg):
    """Full-width float forwards at batch B: ``apply(quant=True)`` against
    ``apply()`` (correlation above 0.98 per image, the reference's bar for
    8-bit quantized inference) and phase 4's emulated logits against
    ``apply(quant=True)`` (above 0.95, the reference's bar for the
    emulation)."""
    lq = inception.apply(params, x, quant=True, config=cfg)
    lf = inception.apply(params, x, config=cfg)
    if lq.shape != (x.shape[0], cfg.classes) or not bool(
            torch.isfinite(lq).all()):
        raise AssertionError("apply(quant=True): bad logits")
    for i in range(x.shape[0]):
        q, f = lq[i].double().cpu().numpy(), lf[i].double().cpu().numpy()
        e = served[i].double().cpu().numpy()
        c_qf, c_eq = np.corrcoef(q, f)[0, 1], np.corrcoef(e, q)[0, 1]
        log(f"[inception-quant] image {i}: corr(quant, float) = {c_qf:.5f} "
            f"(bar 0.98), corr(emulated, quant) = {c_eq:.5f} (bar 0.95); "
            f"argmax quant {int(np.argmax(q))}, float {int(np.argmax(f))}, "
            f"emulated {int(np.argmax(e))}")
        if not c_qf > 0.98:
            raise AssertionError(f"image {i}: corr(quant, float) {c_qf}")
        if not c_eq > 0.95:
            raise AssertionError(f"image {i}: corr(emulated, quant) {c_eq}")


def phase_stream_chunk(inception, bsm, params, x, served, t_forward, dev,
                       cfg):
    """Full-width ``nc_forward(x, stream_chunk=1)`` at batch B: logits
    byte-identical to phase 4's batch-B serving forward, ``filter_loads``
    of every conv and FC layer equal to the chunk count; returns the
    bitserial_matmul launches of the run."""
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, report = inception.nc_forward(params, x, config=cfg,
                                          stream_chunk=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul.launches
    n_chunks = x.shape[0]
    _minmax_take("stream-chunk", dev, n_chunks)  # a forward a chunk
    _requant_take("stream-chunk", dev, n_chunks)  # a forward a chunk
    loads = {lr.filter_loads for lr in report.layers
             if lr.kind in ("conv", "fc")}
    log(f"[stream-chunk] batch {x.shape[0]} full width, stream_chunk=1: "
        f"{wall:.2f} s against the unchunked forward's {t_forward:.2f} s "
        f"(phase 7); filter_loads per conv/fc layer {sorted(loads)} for "
        f"{n_chunks} chunks; bitserial_matmul launches {launches}")
    for i in range(x.shape[0]):
        if not bits_equal(logits[i], served[i]):
            raise AssertionError(f"image {i}: stream_chunk logits differ "
                                 f"from phase 4's batch forward")
    if loads != {n_chunks}:
        raise AssertionError(f"filter_loads {sorted(loads)}, want "
                             f"{n_chunks} for every conv/fc layer")
    if report.batch != x.shape[0] or launches == 0:
        raise AssertionError(f"report batch {report.batch}, launches "
                             f"{launches}")
    log("[stream-chunk] logits byte-identical to phase 4's batch forward")
    return launches


def phase_fleet(serve, orchestrator, geometry, bsm, params, images, served,
                dev, cfg):
    """Two full-width NCServingEngines on the one card behind
    ``Orchestrator(router="latency")``: phase 4's images served, every
    request completed and neither failed nor degraded, the SLO identity and
    the dispatch count identity held, every routed logit row byte-identical
    to phase 4's.  Returns the bitserial_matmul launches of the run."""
    engines = [
        serve.NCServingEngine(params, cfg, max_batch=2, name="socket-35MB",
                              device=dev),
        serve.NCServingEngine(params, cfg, max_batch=2, name="socket-10MB",
                              geom=geometry.XEON_E5_35MB.scaled(
                                  4, "xeon-10MB"), device=dev)]
    per_engine = {e.name: 0 for e in engines}

    def counting(engine):
        real = engine._forward

        def forward(*a, **k):
            n = bsm.bitserial_matmul.launches
            out = real(*a, **k)
            per_engine[engine.name] += bsm.bitserial_matmul.launches - n
            return out
        return forward

    for e in engines:
        e._forward = counting(e)
    orch = orchestrator.Orchestrator(engines, slo_ms=1e7, router="latency")
    for i, img in enumerate(images):
        orch.submit(serve.NCRequest(rid=i, image=img))
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = orch.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.bitserial_matmul.launches
    s = orch.stats()
    _minmax_take("fleet", dev, sum(s["batch_histogram"].values()))
    _requant_take("fleet", dev, sum(s["batch_histogram"].values()))
    log(f"[fleet] {len(done)} full-width requests over "
        f"{[e.name for e in engines]} (batch caps "
        f"{[e.batch_cap for e in engines]}) in {wall:.2f} s; dispatched "
        f"{s['dispatched']}, batches {s['batch_histogram']}, routes "
        f"{[(d.engine, d.admit, d.reason) for d in orch.decisions]}; "
        f"bitserial_matmul launches {per_engine} (total {launches})")
    if len(done) != len(images) or s["failed"] or orch.pending:
        raise AssertionError(f"fleet served {len(done)} of {len(images)}")
    if any(r.degraded for r in done):
        raise AssertionError("a fleet batch left the emulation (degraded)")
    if s["slo_hits"] + s["slo_misses"] != s["completed"] + s["failed"]:
        raise AssertionError(f"SLO identity broken: {s}")
    if sum(s["dispatched"].values()) != sum(s["batch_histogram"].values()):
        raise AssertionError(f"dispatch identity broken: {s}")
    if launches == 0 or sum(per_engine.values()) != launches:
        raise AssertionError(f"fleet launches {per_engine}, {launches}")
    for r in done:
        if not bits_equal(r.logits, served[r.rid]):
            raise AssertionError(f"request {r.rid}: routed logits differ "
                                 f"from phase 4's")
    log("[fleet] every routed logit row byte-identical to phase 4's; "
        "hits + misses == completed + failed; dispatches == batches")
    return launches


# ---------------------------------------------------------------------------
# bitserial-ops: the §III arithmetic across the LLC's compute bit lines, the
# dots, and one full-width forward on the walk backend
# ---------------------------------------------------------------------------
OPS_K = 288  # Conv2d_2b's reduce width: 3584 rows of it fill the 35 MB LLC
FC_DOT = (1001, 2048)  # the FC's rows and reduce width
OPS_SPARSE = 0.9  # share of the sparse multiplier's 32-lane words zeroed
# closed forms at n = 8 (§III): add/sub n + 1, multiply n^2 + 5n - 2, MAC
# with a 24-bit accumulator mul + add(24), ReLU of the 9-bit difference
# n + 1, max add + n + 1, selective copy n + 1; the dot adds the log tree
# over 288 lanes, widening 24 -> 33 bits (move w + add w + 1 a step)
OPS_CYCLES = {"add": 9, "sub": 9, "multiply": 102, "mac": 102 + 25,
              "relu": 10, "max": 9 + 9, "selective_copy": 9}
DOT_CYCLES = 102 + 25 + sum(2 * w + 1 for w in range(24, 33))


def _ops_operands(lanes: int, sparse: bool) -> dict:
    """Seeded 8-bit operands over ``lanes`` lanes (CPU int64): ``a`` and
    ``b``, a 24-bit accumulator and a copy mask; the sparse set zeroes
    OPS_SPARSE of ``b``'s 32-lane words and its top plane, so that the
    multiply elides words and planes."""
    g = torch.Generator().manual_seed(20 + int(sparse))
    ops = {"a": torch.randint(0, 256, (lanes,), generator=g),
           "b": torch.randint(0, 256, (lanes,), generator=g),
           "acc": torch.randint(0, 1 << 16, (lanes,), generator=g),
           "mask": torch.randint(0, 2, (lanes,), generator=g)}
    if sparse:
        dead = torch.rand(-(-lanes // 32), generator=g) < OPS_SPARSE
        ops["b"][dead.repeat_interleave(32)[:lanes]] = 0
        ops["b"] &= 0x7F
    return ops


def _ops_run(bitserial, ops, layout: str, dev) -> dict:
    """Every §III op once on ``dev``: {op: (PackedPlanes, cycles,
    SKIP_STATS snapshot)}; ``layout`` "flat" packs ``lanes`` flat, "rows"
    row-aligned as [lanes / OPS_K, OPS_K]."""
    shape = (-1, OPS_K) if layout == "rows" else (-1,)

    def pack(x, n):
        return bitserial.pack_values(x.to(dev).reshape(shape), n,
                                     row_align=layout == "rows")

    a, b, acc = pack(ops["a"], 8), pack(ops["b"], 8), pack(ops["acc"], 24)
    mask = ops["mask"].to(dev).reshape(shape)
    calls = {"add": lambda: bitserial.bitserial_add(a, b),
             "sub": lambda: bitserial.bitserial_sub(a, b),
             "multiply": lambda: bitserial.bitserial_multiply(a, b),
             "mac": lambda: bitserial.bitserial_mac(acc, a, b),
             "max": lambda: bitserial.bitserial_max(a, b),
             "selective_copy": lambda: bitserial.selective_copy(a, b, mask)}
    out = {}
    for name, call in calls.items():
        bitserial.SKIP_STATS.reset()
        pp, cycles = call()
        out[name] = (pp, cycles, bitserial.SKIP_STATS.snapshot())
    bitserial.SKIP_STATS.reset()
    pp, cycles = bitserial.bitserial_relu(out["sub"][0])
    out["relu"] = (pp, cycles, bitserial.SKIP_STATS.snapshot())
    return out


def _ops_expected(ops) -> dict:
    a, b, acc, mask = ops["a"], ops["b"], ops["acc"], ops["mask"]
    return {"add": a + b, "sub": (a - b) & 0x1FF, "multiply": a * b,
            "mac": (acc + a * b) & 0xFFFFFF, "relu": torch.clamp_min(a - b, 0),
            "max": torch.maximum(a, b),
            "selective_copy": torch.where(mask.bool(), b, a)}


def phase_ops_full_width(bitserial, lanes, dev):
    """The §III ops over ``lanes`` lanes (the LLC's compute bit lines), flat
    and row-aligned, on a dense and a sparse operand set: words bit-equal
    to the same calls on CPU tensors, values equal to integer arithmetic,
    cycles equal to the closed forms, ``SKIP_STATS`` equal to the CPU
    run's, and ``ZERO_SKIP`` off giving the same words; on the sparse set
    the multiply and the MAC must elide words and planes."""
    for sparse in (False, True):
        ops = _ops_operands(lanes, sparse)
        want = _ops_expected(ops)
        for layout in ("flat", "rows"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = _ops_run(bitserial, ops, layout, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            host = _ops_run(bitserial, ops, layout, "cpu")
            bitserial.ZERO_SKIP = False
            try:
                plain = _ops_run(bitserial, ops, layout, dev)
            finally:
                bitserial.ZERO_SKIP = True
            tag = f"{'sparse' if sparse else 'dense'} {layout}"
            for name, (pp, cycles, snap) in card.items():
                words = pp.words.cpu()
                if pp.words.device.type != torch.device(dev).type:
                    raise AssertionError(f"{name} {tag}: left the device")
                if not torch.equal(words, host[name][0].words):
                    raise AssertionError(f"{name} {tag}: words differ from "
                                         f"the CPU run's")
                if not torch.equal(words, plain[name][0].words.cpu()):
                    raise AssertionError(f"{name} {tag}: ZERO_SKIP off "
                                         f"changes the words")
                vals = bitserial.unpack_values(pp).cpu().reshape(-1)
                if not torch.equal(vals, want[name]):
                    raise AssertionError(f"{name} {tag}: values differ "
                                         f"from integer arithmetic")
                if cycles != OPS_CYCLES[name] or host[name][1] != cycles:
                    raise AssertionError(f"{name} {tag}: {cycles} cycles, "
                                         f"closed form {OPS_CYCLES[name]}")
                if snap != host[name][2]:
                    raise AssertionError(f"{name} {tag}: SKIP_STATS {snap} "
                                         f"!= CPU {host[name][2]}")
            for name in ("multiply", "mac"):
                snap = card[name][2]
                if sparse and not (snap["words_skipped"]
                                   and snap["planes_skipped"]):
                    raise AssertionError(f"{name} {tag}: no elision {snap}")
            snap = card["multiply"][2]
            log(f"[bitserial-ops] {lanes} lanes {tag}: 7 ops bit-equal to "
                f"the CPU and to integer arithmetic, cycles "
                f"{ {k: v[1] for k, v in card.items()} }; multiply words "
                f"{snap['words_skipped']}/{snap['words_total']} elided, "
                f"planes {snap['planes_skipped']}/{snap['planes_total']}; "
                f"card wall {wall:.3f} s")


def phase_dots(bitserial, nc_layers, backends, bsm, dev, lanes):
    """``bitserial_dot`` at OPS_K over ``lanes / OPS_K`` rows and ``nc_dot``
    at FC_DOT at 8 and 4 bits through ``walk`` and ``gemm``: values equal
    to integer arithmetic and to each other, cycles equal; the gemm runs
    launch the 8-bit kernel, then the W4A4 kernel.  Returns those launches
    as (8-bit, W4A4)."""
    g = torch.Generator().manual_seed(21)
    rows = lanes // OPS_K
    x = torch.randint(0, 256, (rows, OPS_K), generator=g)
    w = torch.randint(0, 256, (rows, OPS_K), generator=g)
    bitserial.SKIP_STATS.reset()
    vals, cycles = bitserial.bitserial_dot(x.to(dev), w.to(dev))
    snap = bitserial.SKIP_STATS.snapshot()
    bitserial.SKIP_STATS.reset()
    cpu_vals, cpu_cycles = bitserial.bitserial_dot(x, w)
    if not torch.equal(vals.cpu(), cpu_vals) or snap != \
            bitserial.SKIP_STATS.snapshot():
        raise AssertionError("bitserial_dot: card != CPU")
    if not torch.equal(cpu_vals, (x * w).sum(dim=1)):
        raise AssertionError("bitserial_dot: values differ from x . w")
    if cycles != DOT_CYCLES or cpu_cycles != cycles:
        raise AssertionError(f"bitserial_dot: {cycles} cycles, closed form "
                             f"{DOT_CYCLES}")
    log(f"[bitserial-ops] bitserial_dot {rows} rows x K {OPS_K}: equal to "
        f"x . w and to the CPU, {cycles} cycles")
    launches = []
    M, K = FC_DOT
    for n_bits in (8, 4):
        x = torch.randint(0, 1 << n_bits, (M, K), generator=g)
        w = torch.randint(0, 1 << n_bits, (M, K), generator=g)
        truth = (x * w).sum(dim=1)
        got = {}
        for engine in ("walk", "gemm"):
            backends.dispatch_stats_clear()
            bsm.bitserial_matmul.launches = 0
            bsm.bitserial_matmul_a4.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, c = nc_layers.nc_dot(x.to(dev), w.to(dev), n_bits=n_bits,
                                    engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k8 = bsm.bitserial_matmul.launches
            k4 = bsm.bitserial_matmul_a4.launches
            d = backends.dispatch_stats()[engine]
            got[engine] = c
            if not torch.equal(v.cpu(), truth):
                raise AssertionError(f"nc_dot {n_bits}-bit {engine}: values "
                                     f"differ from x . w")
            if d != {"native": 1, "fallback": 0}:
                raise AssertionError(f"nc_dot {engine} dispatch {d}")
            log(f"[bitserial-ops] nc_dot {M} x K {K} at {n_bits} bits, "
                f"{engine}: {c} cycles, {wall * 1e3:.2f} ms, launches "
                f"8-bit {k8}, W4A4 {k4}")
            if engine == "gemm":
                want = (k8 > 0 and k4 == 0) if n_bits == 8 else (
                    k4 > 0 and k8 == 0)
                if not want:
                    raise AssertionError(f"nc_dot {n_bits}-bit gemm "
                                         f"launched 8-bit {k8}, W4A4 {k4}")
                launches.append(k8 if n_bits == 8 else k4)
            elif k8 or k4:
                raise AssertionError("nc_dot walk launched a kernel")
        if got["walk"] != got["gemm"]:
            raise AssertionError(f"nc_dot cycles {got}")
    return tuple(launches)


LAYERS_ON_CPU = ("Conv2d_1a_3x3", "FullyConnected")


def phase_walk_forward(inception, nc_layers, bitserial, backends, bsm,
                       params, image, dev, cfg):
    """One batch-1 ``nc_forward`` of ``image`` on ``walk`` (ZERO_SKIP on)
    beside the same on ``gemm``: logits byte-identical, reports equal, every
    layer's ``ConvStats`` equal but for ``engine_words_*``, which are
    nonzero on walk and 0 on gemm; the layers LAYERS_ON_CPU run again on
    CPU tensors give the card's ``ConvStats`` and ``SKIP_STATS`` field for
    field.  Returns the walk's wall."""
    real = nc_layers.nc_conv2d
    seen = []

    def capture(x, w, x_qp, w_qp, *a, **k):
        name = k["layer_spec"].name
        before = bitserial.SKIP_STATS.snapshot()
        out = real(x, w, x_qp, w_qp, *a, **k)
        after = bitserial.SKIP_STATS.snapshot()
        delta = {f: after[f] - before[f] for f in after}
        keep = ((x.clone(), w.clone(), x_qp, w_qp, a, k, out)
                if name in LAYERS_ON_CPU else None)
        seen.append((name, out[2], delta, keep))
        return out

    nc_layers.nc_conv2d = capture
    runs = {}
    try:
        for engine in ("gemm", "walk"):
            seen.clear()
            bitserial.SKIP_STATS.reset()
            backends.dispatch_stats_clear()
            bsm.bitserial_matmul.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, report = inception.nc_forward(params, image, config=cfg,
                                                  engine=engine, device=dev)
            torch.cuda.synchronize()
            runs[engine] = dict(
                logits=logits, report=report, seen=list(seen),
                wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=bsm.bitserial_matmul.launches,
                dispatch=backends.dispatch_stats()[engine])
    finally:
        nc_layers.nc_conv2d = real
    gemm, walk = runs["gemm"], runs["walk"]
    if not bits_equal(walk["logits"], gemm["logits"]):
        raise AssertionError("walk logits differ from gemm's")
    if walk["report"] != gemm["report"]:
        raise AssertionError("walk layer reports differ from gemm's")
    if (walk["launches"] or walk["dispatch"]["fallback"]
            or gemm["launches"] == 0):
        raise AssertionError(f"walk launched {walk['launches']} kernels, "
                             f"gemm {gemm['launches']}")
    words = ("engine_words_total", "engine_words_skipped")
    for (name, st_w, _, _), (name_g, st_g, _, _) in zip(walk["seen"],
                                                        gemm["seen"]):
        dw, dg = dataclasses.asdict(st_w), dataclasses.asdict(st_g)
        if name != name_g or any(dw[f] != dg[f] for f in dw
                                 if f not in words):
            raise AssertionError(f"{name}: walk ConvStats differ from gemm's")
        if st_w.engine_words_total == 0 or any(dg[f] for f in words):
            raise AssertionError(f"{name}: engine words walk "
                                 f"{st_w.engine_words_total}, gemm "
                                 f"{[dg[f] for f in words]}")
    total = sum(st.engine_words_total for _, st, _, _ in walk["seen"])
    skipped = sum(st.engine_words_skipped for _, st, _, _ in walk["seen"])
    for name, st, delta, (x, w, x_qp, w_qp, a, k, out) in (
            r for r in walk["seen"] if r[3] is not None):
        bitserial.SKIP_STATS.reset()
        res = nc_layers.nc_conv2d(x.cpu(), w.cpu(), x_qp, w_qp, *a, **k)
        if not torch.equal(res[0], out[0].cpu()) or res[1] != out[1]:
            raise AssertionError(f"{name}: CPU output differs from the card's")
        if dataclasses.asdict(res[2]) != dataclasses.asdict(st):
            raise AssertionError(f"{name}: CPU ConvStats differ from the "
                                 f"card's")
        if bitserial.SKIP_STATS.snapshot() != delta:
            raise AssertionError(f"{name}: CPU SKIP_STATS differ from the "
                                 f"card's")
        log(f"[bitserial-ops] {name} on CPU tensors: output, ConvStats "
            f"({st.engine_words_total} words, {st.engine_words_skipped} "
            f"elided) and SKIP_STATS equal to the card's")
    log(f"[bitserial-ops] batch-1 full-width nc_forward: walk "
        f"{walk['wall']:.2f} s (peak {walk['peak']:.2f} GiB), gemm "
        f"{gemm['wall']:.2f} s (peak {gemm['peak']:.2f} GiB); logits "
        f"byte-identical, {len(walk['report'].layers)} layer reports equal; "
        f"walk multiplier words {total}, elided {skipped} "
        f"({skipped / total:.4f}); walk dispatches {walk['dispatch']}")
    return walk["wall"]


def phase_bitserial_ops(inception, nc_layers, bitserial, backends, geometry,
                        bsm, params, image, dev, cfg, lanes=None):
    """The ``bitserial-ops`` phase: the §III ops over the LLC's compute bit
    lines (``geometry.XEON_E5_35MB.compute_slots`` unless ``lanes``), the
    dots, and the walk forward.  Returns the gemm nc_dot launches of the
    8-bit and the W4A4 kernel."""
    lanes = lanes or geometry.XEON_E5_35MB.compute_slots
    bitserial.ZERO_SKIP = True
    phase_ops_full_width(bitserial, lanes, dev)
    launches = phase_dots(bitserial, nc_layers, backends, bsm, dev, lanes)
    phase_walk_forward(inception, nc_layers, bitserial, backends, bsm,
                       params, image, dev, cfg)
    return launches


def phase_times(bsm, dev):
    g = torch.Generator().manual_seed(2)
    rows = []
    for name, M, K, N in MAIN_SHAPES:
        x = torch.randint(0, 256, (M, K), generator=g).to(torch.uint8).to(dev)
        planes = torch.randint(0, 256, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=8, out_dtype=torch.int32, signed=False)
        ms = graph_ms(lambda: bsm.bitserial_matmul(x, planes, **kw))
        eager_ms = cuda_ms(lambda: bsm.bitserial_matmul(x, planes, **kw))
        plain_ms = cuda_ms(lambda: bsm.bitserial_matmul_plain(x, planes, **kw),
                           reps=3, warmup=1)
        xf, wf = x.double(), planes.double()
        lib_ms = graph_ms(lambda: torch.matmul(xf, wf))
        if not torch.equal(torch.matmul(xf, wf).to(torch.int64),
                           bsm.bitserial_matmul(x, planes, **kw).to(torch.int64)):
            raise AssertionError(f"torch.matmul yardstick disagrees at {name}")
        # the function is one 8-bit GEMM: the plane weights fold into the
        # decoded weights before a single product (as torch.matmul shows)
        nbytes = M * K + K * N + 4 * M * N
        ops = 2 * M * N * K
        bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
        ops_ms = ops / H100_INT8_OPS_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms > ops_ms else "operations"
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bytes_ms=bytes_ms, ops_ms=ops_ms))
        log(f"[time] {name} {M}x{K}x{N} (split {bsm.split_k(M, N, K)[0]}): "
            f"kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, torch.matmul f64 {lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    return rows


def phase_times_a4(bsm, dev):
    g = torch.Generator().manual_seed(5)
    rows = []
    for name, M, K, N in MAIN_SHAPES:
        xp = torch.randint(0, 256, (M, (K + 1) // 2), generator=g)
        xp = xp.to(torch.uint8).to(dev)
        planes = torch.randint(0, 16, (K, N), generator=g).to(torch.uint8).to(dev)
        kw = dict(n_bits=4, out_dtype=torch.int32, signed=False)
        ms = graph_ms(lambda: bsm.bitserial_matmul_a4(xp, planes, **kw))
        eager_ms = cuda_ms(lambda: bsm.bitserial_matmul_a4(xp, planes, **kw))
        plain_ms = cuda_ms(
            lambda: bsm.bitserial_matmul_a4_plain(xp, planes, **kw),
            reps=3, warmup=1)
        b = xp.to(torch.int64)
        xf = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(M, -1)[:, :K]
        xf, wf = xf.double().contiguous(), planes.double()
        lib_ms = graph_ms(lambda: torch.matmul(xf, wf))
        if not torch.equal(torch.matmul(xf, wf).to(torch.int64),
                           bsm.bitserial_matmul_a4(xp, planes, **kw)
                           .to(torch.int64)):
            raise AssertionError(f"torch.matmul yardstick disagrees at {name}")
        # one GEMM of 2*M*N*K operations (no 4-bit tensor-core path faster
        # than int8 on Hopper); bytes: nibble-packed x, weight bytes, int32 out
        nbytes = M * ((K + 1) // 2) + K * N + 4 * M * N
        ops = 2 * M * N * K
        bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
        ops_ms = ops / H100_INT8_OPS_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms > ops_ms else "operations"
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bytes_ms=bytes_ms, ops_ms=ops_ms))
        log(f"[time-a4] {name} {M}x{K}x{N}: kernel {ms:.4f} ms (eager "
            f"{eager_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.matmul f64 "
            f"{lib_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by})")
    return rows


LM_ARCH = "qwen2-7b"
LM_PROMPTS = (37, 512, 1000, 2048)  # ragged, mixed prompt lengths
LM_NEW_TOKENS = 16
LM_MAX_LEN = 2112
LM_CALIB_PROMPT = 512  # the prompt whose captured inputs feed the W8A8 linears
# served (batch 4) against standalone (batch 1) decode logits: four bf16
# steps at the top logits' magnitude (about 4, where a bf16 step is 2^-5);
# a served token may differ from the standalone pick only where the
# standalone top-2 margin is below twice this
LM_LOGIT_TOL = 0.125
# the LM slice's kernel shapes (qwen2-7b, a 512-token prompt): every
# per-layer linear (M, K, N); the attention (B, H, Hkv, T, D) of every
# served prompt, checked, and of the 512- and 2048-token prompts, timed
QM_SHAPES = [("wq/wo", 512, 3584, 3584), ("wk/wv", 512, 3584, 512),
             ("wi/wg", 512, 3584, 18944), ("mlp wo", 512, 18944, 3584)]
# the PTQ head: the 4 prompts' last positions against the 152064-wide
# vocabulary; timed on a line of its own, outside the QM_SHAPES sums
QM_HEAD = ("head", 4, 3584, 152064)
FA_SERVED = [(f"T{T}", 1, 28, 4, T, 128) for T in LM_PROMPTS]
FA_SHAPES = [s for s in FA_SERVED if s[0] in ("T512", "T2048")]
H100_BF16_FLOPS_S = 989e12  # dense bf16 tensor-core rate, H100 SXM data sheet
FA_F32_TOL = 1e-5  # kernel vs plain, float32: rtol = atol
# kernel vs plain, bfloat16: both round the same float32 result once, so
# they differ by at most one bf16 ulp (rtol 2^-7); atol as in float32, for
# outputs that cancellation leaves near zero
FA_BF16_RTOL, FA_BF16_ATOL = 2 ** -7, FA_F32_TOL
# SDPA against the kernel: SDPA rounds p to bf16 before P.V, so it is a
# yardstick held loosely, not a reference
FA_SDPA_TOL = 8e-2


def _int8(g, shape, dev):
    return torch.randint(-128, 128, shape, generator=g,
                         dtype=torch.int64).to(torch.int8).to(dev)


def phase_quant_kernel(qm, dev) -> float:
    """``quant_matmul`` against its plain version at random ragged shapes
    (K not a multiple of 4 included), at split-K shapes (a few rows at
    K = 3584, both tiles), at QM_SHAPES and at the head (QM_HEAD), each
    with bias and without: bit-equal, since both round each epilogue step
    in the same order."""
    g = torch.Generator().manual_seed(6)
    cases = [(1, 1, 1), (7, 33, 5), (65, 31, 129), (130, 257, 67),
             (64, 64, 64), (3, 600, 200), (257, 1000, 130), (100, 522, 300),
             (513, 3584, 77)]
    split = [(M, 3584, N) for M in (1, 2, 5, 16, 17, 65)
             for N in (512, 1001, 3584)]
    cases += split + [(M, K, N) for _, M, K, N in QM_SHAPES + [QM_HEAD]]
    n = 0
    for M, K, N in cases:
        x, w = _int8(g, (M, K), dev), _int8(g, (K, N), dev)
        ws = (torch.rand(N, generator=g) * 0.01 + 1e-4).to(dev)
        bias = torch.randn(N, generator=g).to(dev)
        for b in (None, bias):
            got = qm.quant_matmul(x, w, 0.0123, ws, b)
            want = qm.quant_matmul_plain(x, w, 0.0123, ws, b)
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                diff = (got.double() - want.double()).abs().max().item()
                raise AssertionError(f"quant_matmul != plain at M,K,N="
                                     f"{M, K, N} bias={b is not None}: max "
                                     f"diff {diff}")
            n += 1
        del x, w, want, got
    log(f"[kernel-qm] {n} cases (random ragged, split along K in "
        f"splits {sorted({qm.quant_split_k(M, N, K)[0] for M, K, N in split})}"
        f", the slice's shapes and the head {QM_HEAD[1:]}) bit-equal to the "
        f"plain version")
    return 0.0


def phase_flash_kernel(fa, dev) -> tuple[float, float]:
    """``flash_attention`` against its plain version at random ragged
    (B, H, Hkv, Tq, Tk, D), causal and not, float32 and bfloat16, and at
    FA_SERVED (every served prompt's shape); returns the largest absolute
    differences (f32, bf16)."""
    g = torch.Generator().manual_seed(7)
    cases = [(1, 1, 1, 1, 1, 16), (2, 4, 4, 37, 37, 32), (1, 8, 2, 100, 130, 64),
             (2, 6, 3, 65, 64, 128), (1, 28, 4, 129, 129, 128),
             (3, 4, 1, 64, 200, 64), (1, 2, 2, 300, 100, 16)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for B, H, Hkv, Tq, Tk, D in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, H, Tq, D), generator=g).to(dtype).to(dev)
            k = torch.randn((B, Hkv, Tk, D), generator=g).to(dtype).to(dev)
            v = torch.randn((B, Hkv, Tk, D), generator=g).to(dtype).to(dev)
            for causal in (True, False):
                _flash_compare(fa, q, k, v, causal, worst,
                               f"{B, H, Hkv, Tq, Tk, D} {dtype} causal="
                               f"{causal}")
                n += 1
    # Tq and Tk ragged against the bf16 kernel's query and KV tiles on both
    # sides (Tq != Tk under causal masking too), every head size, and
    # B*H = 224 query heads, enough blocks for the heaviest-first order
    tiles = fa.kernel_tiles(torch.bfloat16)
    bq, bkv = tiles["bq"], tiles["bkv"]
    edges = [(1, 4, 2, bq + 1, bkv + 1, 16), (1, 4, 2, bq - 1, 3 * bkv - 1, 32),
             (2, 7, 1, 3 * bq - 1, 2 * bkv + 1, 64),
             (1, 4, 4, 2 * bq + 1, 5 * bkv - 1, 128),
             (1, 6, 3, 5 * bkv + 3, 2 * bq - 3, 128),
             (8, 28, 4, 5 * bq - 20, 5 * bq - 20, 128)]
    for B, H, Hkv, Tq, Tk, D in edges:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, H, Tq, D), generator=g).to(dtype).to(dev)
            k = torch.randn((B, Hkv, Tk, D), generator=g).to(dtype).to(dev)
            v = torch.randn((B, Hkv, Tk, D), generator=g).to(dtype).to(dev)
            for causal in (True, False):
                _flash_compare(fa, q, k, v, causal, worst,
                               f"tile edge {B, H, Hkv, Tq, Tk, D} {dtype} "
                               f"causal={causal}")
                n += 1
    # outputs near cancellation: nearly uniform p against V columns of
    # +1 and -1 that sum to zero, so the atol side of the bound counts
    near = 0.0
    for D in (64, 128):
        B, H, Hkv, T = 1, 8, 2, 256
        q = (0.5 * torch.randn((B, H, T, D), generator=g)).to(dev)
        k = torch.randn((B, Hkv, T, D), generator=g).to(dev)
        signs = torch.tensor([1.0, -1.0]).repeat(T // 2)
        v = torch.stack([signs[torch.randperm(T, generator=g)]
                         for _ in range(B * Hkv * D)])
        v = v.reshape(B, Hkv, D, T).transpose(2, 3).contiguous().to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
                _flash_compare(fa, qd, kd, vd, causal, worst,
                               f"near cancellation D={D} {dtype} "
                               f"causal={causal}")
                out = fa.flash_attention_plain(qd, kd, vd, causal=causal)
                near = max(near, out.float().abs().median().item())
                n += 1
    log(f"[kernel-fa] tile-edge and near-cancellation cases within "
        f"tolerance (bf16 tiles {tiles}; median |output| near cancellation "
        f"at most {near:.3g})")
    for name, B, H, Hkv, T, D in FA_SERVED:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, H, T, D), generator=g).to(dtype).to(dev)
            k = torch.randn((B, Hkv, T, D), generator=g).to(dtype).to(dev)
            v = torch.randn((B, Hkv, T, D), generator=g).to(dtype).to(dev)
            _flash_compare(fa, q, k, v, True, worst, f"{name} {dtype}")
            n += 1
    log(f"[kernel-fa] {n} cases (random ragged and the served shapes) "
        f"within tolerance of the plain version (f32 rtol=atol={FA_F32_TOL}: "
        f"max abs diff {worst[torch.float32]:.3g}; bf16 rtol={FA_BF16_RTOL} "
        f"atol={FA_BF16_ATOL}: max abs diff {worst[torch.bfloat16]:.3g})")
    return worst[torch.float32], worst[torch.bfloat16]


def _flash_compare(fa, q, k, v, causal, worst, what, got=None):
    """Hold the kernel's output ``got`` (launched here if not given) on
    q, k, v against the plain version's; ``worst[dtype]`` keeps the largest
    absolute difference."""
    if got is None:
        got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rtol, atol = ((FA_F32_TOL, FA_F32_TOL) if q.dtype == torch.float32
                  else (FA_BF16_RTOL, FA_BF16_ATOL))
    diff = (got.double() - want.double()).abs()
    if got.dtype != q.dtype or got.shape != q.shape or not bool(
            (diff <= atol + rtol * want.double().abs()).all()):
        raise AssertionError(f"flash_attention != plain at {what}: max diff "
                             f"{diff.max().item()}")
    worst[q.dtype] = max(worst[q.dtype], diff.max().item())


def _bound(nbytes: float, ops: float, peak: float) -> dict:
    bytes_ms = nbytes / H100_HBM_BYTES_S * 1e3
    ops_ms = ops / peak * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms)


def phase_times_quant(qm, dev):
    """``quant_matmul`` at QM_SHAPES (no bias, as the PTQ linears call it):
    kernel, plain version, and ``torch._int_mm`` plus the same epilogue;
    then the head (QM_HEAD) on a line of its own, whose ``torch._int_mm``
    runs on x padded to 32 rows (it takes more than 16)."""
    g = torch.Generator().manual_seed(8)
    rows = []
    for name, M, K, N in QM_SHAPES + [QM_HEAD]:
        x, w = _int8(g, (M, K), dev), _int8(g, (K, N), dev)
        ws = (torch.rand(N, generator=g) * 0.01 + 1e-4).to(dev)
        xs = torch.tensor(0.0123, dtype=torch.float32, device=dev)
        ms = graph_ms(lambda: qm.quant_matmul(x, w, 0.0123, ws))
        eager_ms = cuda_ms(lambda: qm.quant_matmul(x, w, 0.0123, ws))
        plain_ms = cuda_ms(lambda: qm.quant_matmul_plain(x, w, 0.0123, ws),
                           reps=3, warmup=1)
        xl = x if M > 16 else torch.cat([x, x.new_zeros((32 - M, K))])

        def library():
            acc = torch._int_mm(xl, w)[:M]
            return acc.to(torch.float32) * xs * ws[None, :]
        lib_ms = graph_ms(library)
        if not bits_equal(library(), qm.quant_matmul(x, w, 0.0123, ws)):
            raise AssertionError(f"torch._int_mm yardstick disagrees at {name}")
        b = _bound(M * K + K * N + 4 * N + 4 * M * N, 2 * M * N * K,
                   H100_INT8_OPS_S)
        splits = qm.quant_split_k(M, N, K)[0]
        row = dict(name=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   **b)
        log(f"[time-qm] {name} {M}x{K}x{N} (split {splits}): kernel "
            f"{ms:.4f} ms (eager "
            f"{eager_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, torch._int_mm + epilogue {lib_ms:.4f} ms, "
            f"bound {b['bound_ms']:.5f} ms ("
            f"{'bytes' if b['bytes_ms'] > b['ops_ms'] else 'operations'})"
            + (" (own line, not in the kernels line's sums)"
               if name == QM_HEAD[0] else ""))
        if name != QM_HEAD[0]:
            rows.append(row)
        del x, w
    return rows


def phase_times_flash(fa, dev, shapes=FA_SHAPES, tag="time-fa"):
    """``flash_attention`` at ``shapes`` in bfloat16, causal: kernel, plain
    version, and ``F.scaled_dot_product_attention(is_causal=True)`` on KV
    repeated to H heads."""
    g = torch.Generator().manual_seed(9)
    rows = []
    for name, B, H, Hkv, T, D in shapes:
        q = torch.randn((B, H, T, D), generator=g).to(torch.bfloat16).to(dev)
        k = torch.randn((B, Hkv, T, D), generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn((B, Hkv, T, D), generator=g).to(torch.bfloat16).to(dev)
        ms = graph_ms(lambda: fa.flash_attention(q, k, v))
        eager_ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                           reps=3, warmup=1)
        kr = k.repeat_interleave(H // Hkv, dim=1)
        vr = v.repeat_interleave(H // Hkv, dim=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = graph_ms(lambda: sdpa(q, kr, vr, is_causal=True))
        lib_diff = (sdpa(q, kr, vr, is_causal=True).double()
                    - fa.flash_attention(q, k, v).double()).abs().max().item()
        if lib_diff > FA_SDPA_TOL:
            raise AssertionError(f"SDPA yardstick disagrees at {name}: "
                                 f"{lib_diff}")
        pairs = T * (T + 1) // 2  # (query, key) pairs under the causal mask
        b = _bound(2 * (2 * B * H * T * D + 2 * B * Hkv * T * D),
                   4 * B * H * D * pairs, H100_BF16_FLOPS_S)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b))
        log(f"[{tag}] {name} (B,H,Hkv,T,D)={B, H, Hkv, T, D} bf16 causal: "
            f"kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} "
            f"ms (max diff to the kernel {lib_diff:.3g}), bound "
            f"{b['bound_ms']:.5f} ms ("
            f"{'bytes' if b['bytes_ms'] > b['ops_ms'] else 'operations'})")
    return rows


# the 4-bit PTQ sites (M x K x N, a 512-token prompt): bitserial_linear
# runs them through bitserial_matmul with signed 4-bit planes, int8
# activations and the float epilogue
PTQ4_SHAPES = [("wq/wo", 512, 3584, 3584), ("wk/wv", 512, 3584, 512),
               ("wi/wg", 512, 3584, 18944), ("mlp wo", 512, 18944, 3584)]


def phase_times_ptq4(bsm, dev):
    """``bitserial_matmul`` at PTQ4_SHAPES: kernel (graph replay), plain
    version, and ``torch.matmul`` on float64 copies of x and the decoded
    4-bit weights, beside the bound.  Printed on lines of their own; not
    part of the kernels line's sums."""
    g = torch.Generator().manual_seed(10)
    rows = []
    for name, M, K, N in PTQ4_SHAPES:
        x = _int8(g, (M, K), dev)
        planes = torch.randint(0, 16, (K, N), generator=g).to(torch.uint8)
        planes = planes.to(dev)
        ws = (torch.rand(N, generator=g) * 0.01 + 1e-4).to(dev)
        kw = dict(n_bits=4, signed=True, out_dtype=torch.float32)
        ms = graph_ms(lambda: bsm.bitserial_matmul(x, planes, 0.0123, ws,
                                                   **kw))
        plain_ms = cuda_ms(lambda: bsm.bitserial_matmul_plain(
            x, planes, 0.0123, ws, **kw), reps=3, warmup=1)
        w = planes.to(torch.int64)
        xf, wf = x.double(), ((w & 7) - (w & 8)).double()
        lib_ms = graph_ms(lambda: torch.matmul(xf, wf))
        got = bsm.bitserial_matmul(x, planes, n_bits=4, signed=True,
                                   out_dtype=torch.int32)
        if not torch.equal(torch.matmul(xf, wf).to(torch.int64),
                           got.to(torch.int64)):
            raise AssertionError(f"torch.matmul yardstick disagrees at "
                                 f"{name}")
        b = _bound(M * K + K * N + 4 * N + 4 * M * N, 2 * M * N * K,
                   H100_INT8_OPS_S)
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b))
        log(f"[time-ptq4] {name} {M}x{K}x{N} signed 4-bit planes, float "
            f"epilogue (split {bsm.split_k(M, N, K)[0]}): kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms, torch.matmul f64 {lib_ms:.4f} ms, "
            f"bound {b['bound_ms']:.5f} ms ("
            f"{'bytes' if b['bytes_ms'] > b['ops_ms'] else 'operations'})")
    log(f"[time-ptq4] sums (not in the kernels line): kernel "
        f"{sum(r['ms'] for r in rows):.4f} ms, torch.matmul f64 "
        f"{sum(r['library_ms'] for r in rows):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in rows):.5f} ms")
    return rows


def _lm_prompts(vocab: int, window: int = 0):
    """LM_PROMPTS' prompts and, for a sliding-window model, one of
    ``window - LM_WRAP_MARGIN`` tokens, seeded."""
    rng = np.random.default_rng(0)
    lengths = LM_PROMPTS + ((window - LM_WRAP_MARGIN,) if window else ())
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def _top2_margin(logits: torch.Tensor) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _full_attention_layers(transformer, cfg) -> int:
    """The layers whose prefill attention is full (``window == 0``), which
    the flash-attention kernel runs: every layer of an attention model, the
    global ones of a hybrid, none of an SSM."""
    if not cfg.has_attention:
        return 0
    return sum(st.length for st in transformer.plan_stages(cfg)
               if st.window == 0)


def _lm_desc(cfg) -> str:
    """A served LM's shape for the logs."""
    parts = [f"{cfg.n_layers} layers", f"d_model {cfg.d_model}"]
    if cfg.has_attention:
        parts.append(f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    if cfg.attn_window:
        parts.append(f"window {cfg.attn_window} outside global layers "
                     f"{list(cfg.global_layers)}")
    if cfg.has_ssm:
        parts.append(f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
                     f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    parts.append(cfg.dtype)
    if cfg.kv_dtype == "int8":
        parts.append("int8 KV cache")
    return ", ".join(parts)


# hymba-1.5b's served (batch 4) decode differs from a batch-1 loop's by
# more than LM_LOGIT_TOL in bf16 (about 0.25 on an H100): its GEMMs round
# differently at M = 1 and M = 4, and the random-weight model amplifies one
# bf16 rounding that far.  So its served decode is held bit-equal to a loop
# at the served batch shape (the request's cache in every row, its tokens
# fed to all, scalar positions: per-row positions and other rows' contents
# may change no bit), the batch-1 loop's distance is printed, and
# ``_float32_batch_check`` holds the same model in float32, where the
# batch sizes' rounding is 2^16 times finer, within LM_F32_BATCH_TOL of its
# batch-1 loop: a hundredth of LM_LOGIT_TOL, which rounding meets by far
# and a fault of the batched path would not.
LM_SERVED_SHAPE_LOOP = ("hymba-1.5b",)
LM_F32_BATCH_TOL = LM_LOGIT_TOL / 100


def _float32_batch_check(transformer, serve, cfg, params, prompts, dev):
    """The model with its weights cast to float32 decodes prompts[0]
    greedily at batch 1 and, fed the same tokens, in row 0 of a batch of
    4 whose other rows hold prompts[1:4] at their own positions (per-row
    positions, as the engine decodes); row 0's logits must lie within
    LM_F32_BATCH_TOL of the batch-1 loop's at every step.  Returns the
    largest difference."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.float() if tree.is_floating_point() else tree

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = cast(params)
    rows = [torch.as_tensor(p, device=dev)[None] for p in prompts[:4]]
    logits, one = transformer.prefill(cfg32, p32, rows[0], max_len=LM_MAX_LEN)
    want, toks, pos = [], [int(torch.argmax(logits[0]))], rows[0].shape[1]
    for _ in range(LM_NEW_TOKENS - 1):
        nxt = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
        lg, one = transformer.decode_step(cfg32, p32, nxt, one, pos)
        want.append(lg[0])
        toks.append(int(torch.argmax(lg[0])))
        pos += 1
    del one
    caches = transformer.init_caches(cfg32, 4, LM_MAX_LEN, device=dev)
    for i, r in enumerate(rows):
        _, c1 = transformer.prefill(cfg32, p32, r, max_len=LM_MAX_LEN)
        serve._write_slot(caches, c1, i)
    pos = torch.tensor([r.shape[1] for r in rows], dtype=torch.int32,
                       device=dev)
    nxt = torch.tensor([[int(r[0, -1])] for r in rows], dtype=torch.int32,
                       device=dev)
    worst = 0.0
    for t in range(LM_NEW_TOKENS - 1):
        nxt[0, 0] = toks[t]
        lg, caches = transformer.decode_step(cfg32, p32, nxt, caches, pos)
        worst = max(worst, (lg[0] - want[t]).abs().max().item())
        pos += 1
    del p32, caches
    log(f"[lm-serve] {cfg.name} in float32: request 0's decode in row 0 of "
        f"a batch of 4 (per-row positions) within {worst:.3g} of its "
        f"batch-1 loop (bound {LM_F32_BATCH_TOL})")
    if worst > LM_F32_BATCH_TOL:
        raise AssertionError(f"{cfg.name} in float32: batch-4 decode differs "
                             f"from batch 1 by {worst} > {LM_F32_BATCH_TOL}")
    return worst


def _served_shape_loop(transformer, serve, cfg, params, toks, out, batch,
                       dev):
    """One request's decode at the served batch shape: its prefill cache
    written into each of ``batch`` rows, the served tokens ``out`` fed to
    every row at scalar positions.  Returns row 0's logits, the prefill's
    first."""
    logits, one = transformer.prefill(cfg, params, toks, max_len=LM_MAX_LEN)
    caches = transformer.init_caches(cfg, batch, LM_MAX_LEN, device=dev)
    for i in range(batch):
        serve._write_slot(caches, one, i)
    rows, pos = [logits[0]], toks.shape[1]
    for tok in out[:-1]:
        nxt = torch.full((batch, 1), tok, dtype=torch.int32, device=dev)
        lg, caches = transformer.decode_step(cfg, params, nxt, caches, pos)
        rows.append(lg[0])
        pos += 1
    return rows


def phase_lm_serve(transformer, serve, ops, fa, cfg, params, prompts, dev,
                   record=None):
    """Full-width LM serving: ragged prompts through ``ServingEngine``;
    every prefill's full attention through the flash-attention kernel (a
    sliding-window layer's banded prefill and an SSM layer run torch
    operations).  Then,
    per request, a standalone batch-1 prefill (logits bit-equal to the
    served prefill's, so its attention inputs are the served ones) holds
    each of its attention calls against the plain version, and a standalone
    ``decode_step`` loop fed the served tokens holds every served decode
    step's logits within LM_LOGIT_TOL and its token equal to the standalone
    pick unless that pick's top-2 margin is below 2 * LM_LOGIT_TOL (for
    LM_SERVED_SHAPE_LOOP's models those are printed, and the served decode
    is held bit-equal to ``_served_shape_loop``).  For
    an MoE model the standalone loop takes the served decode's expert
    choices and capacity drops, held as ``_RouteReplay`` says.  Returns
    the launch count, the wall and the largest bf16 difference of the
    served attention from the plain version; ``record``, a dict if given,
    gets each request's tokens (``out``), served prefill and decode logits
    (``prefill``, ``decode``) by request id and the engine's caches'
    shapes (``cache_shapes``) and attention bytes (``attn_bytes``)."""
    engine = serve.ServingEngine(cfg, params, max_batch=4,
                                 max_len=LM_MAX_LEN, device=dev)
    replay = None
    if cfg.is_moe:
        from repro_torch.models import moe
        replay = _RouteReplay(moe, cfg)
    served_prefill, decode_logits = {}, {}
    walls = {"prefill": 0.0}
    real_prefill, real_decode = transformer.prefill, transformer.decode_step

    def prefill(c, p, toks, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(c, p, toks, **kw)
        torch.cuda.synchronize()
        walls["prefill"] += time.perf_counter() - t
        served_prefill[toks.shape[1]] = out[0][0].clone()
        return out

    def decode_step(*a, **k):
        if replay is not None:
            replay.calls = []
        out = real_decode(*a, **k)
        rows = [(i, slot.req.rid) for i, slot in enumerate(engine.slots)
                if slot.active]  # each slot's own row
        for i, rid in rows:
            decode_logits.setdefault(rid, []).append(out[0][i].clone())
        if replay is not None:
            replay.record(rows)
        return out

    real_fa = ops.flash_attention
    fa_events = []

    def timed_flash(*a, **k):
        # CUDA events around each served attention call: its device time,
        # with no synchronization added to the run
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_fa(*a, **k)
        stop.record()
        fa_events.append((start, stop))
        return out

    for i, p in enumerate(prompts):
        engine.submit(serve.Request(rid=i, prompt=p, max_tokens=LM_NEW_TOKENS))
    transformer.prefill, transformer.decode_step = prefill, decode_step
    ops.flash_attention = timed_flash
    if replay is not None:
        replay.install()
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        done = engine.run()
        torch.cuda.synchronize()
    finally:
        transformer.prefill, transformer.decode_step = real_prefill, real_decode
        ops.flash_attention = real_fa
        if replay is not None:
            replay.remove()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    fa_ms = sum(a.elapsed_time(b) for a, b in fa_events)
    peak = torch.cuda.max_memory_allocated(dev)
    n_tokens = sum(len(r.out) for r in done)
    decode_wall = wall - walls["prefill"]
    lengths = [len(p) for p in prompts]
    log(f"[lm-serve] {cfg.name} ({_lm_desc(cfg)}, seeded random weights, 4 "
        f"slots): {len(done)} requests, prompts "
        f"{lengths}, {n_tokens} tokens in {wall:.3f} s; prefill "
        f"wall {walls['prefill']:.3f} s ({sum(lengths)} prompt tokens), "
        f"decode {decode_wall:.3f} s for {n_tokens - len(done)} tokens in "
        f"{engine.steps} steps ({(n_tokens - len(done)) / decode_wall:.1f} "
        f"tok/s); peak device memory {peak / 2**30:.2f} GiB; "
        f"flash_attention launches {launches}, their device time "
        f"{fa_ms:.3f} ms ({100 * fa_ms / 1e3 / walls['prefill']:.2f}% of "
        f"the prefill wall)")
    if len(done) != len(prompts) or engine.failed:
        raise AssertionError(f"served {len(done)} of {len(prompts)}: "
                             f"{engine.errors}")
    if any(len(r.out) != LM_NEW_TOKENS for r in done):
        raise AssertionError(f"token counts {[len(r.out) for r in done]}, "
                             f"want {LM_NEW_TOKENS} each")
    want_launches = _full_attention_layers(transformer, cfg) * len(prompts)
    if launches != want_launches:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"want {want_launches}")
    if record is not None:
        record["out"] = {r.rid: list(r.out) for r in done}
        record["prefill"] = {
            r.rid: served_prefill[len(prompts[r.rid])] for r in done}
        record["decode"] = decode_logits
        record["cache_shapes"] = [
            {kind: {k: tuple(v.shape) for k, v in leaves.items()}
             for kind, leaves in c.items()} for c in engine.caches]
        record["attn_bytes"] = sum(
            v.nbytes for c in engine.caches
            for v in c.get("attn", {}).values())
    agree_total, near_total, worst_diff = 0, 0, 0.0
    worst_fa = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for r in sorted(done, key=lambda r: r.rid):
        toks = torch.as_tensor(prompts[r.rid], device=dev)[None]

        def checked_flash(q, k, v, *, causal=True):
            out = real_fa(q, k, v, causal=causal)
            _flash_compare(fa, q, k, v, causal, worst_fa,
                           f"the {toks.shape[1]}-token prefill", got=out)
            return out

        ops.flash_attention = checked_flash
        try:
            logits, caches = transformer.prefill(cfg, params, toks,
                                                 max_len=LM_MAX_LEN)
        finally:
            ops.flash_attention = real_fa
        if not bits_equal(served_prefill[toks.shape[1]], logits[0]):
            raise AssertionError(f"request {r.rid}: served prefill logits "
                                 f"differ from a standalone prefill")
        step_logits, pos = [logits[0]], toks.shape[1]
        if replay is not None:
            replay.install()
        try:
            for t, tok in enumerate(r.out[:-1]):  # fed the served tokens
                if replay is not None:
                    replay.force(r.rid, t)
                nxt = torch.tensor([[tok]], dtype=torch.int32, device=dev)
                lg, caches = transformer.decode_step(cfg, params, nxt,
                                                     caches, pos)
                step_logits.append(lg[0])
                pos += 1
        finally:
            if replay is not None:
                replay.remove()
        swaps0 = replay.swaps if replay is not None else 0
        if replay is not None:
            replay.check(r.rid)
        diffs = [0.0] + [(decode_logits[r.rid][t - 1].float()
                          - step_logits[t].float()).abs().max().item()
                         for t in range(1, LM_NEW_TOKENS)]
        margins = [_top2_margin(lg) for lg in step_logits]
        picks = [int(torch.argmax(lg)) for lg in step_logits]
        agree = sum(a == b for a, b in zip(r.out, picks))
        near = sum(m < 2 * LM_LOGIT_TOL for m in margins)
        agree_total, near_total = agree_total + agree, near_total + near
        worst_diff = max(worst_diff, max(diffs))
        log(f"[lm-serve] request {r.rid} (prompt {len(prompts[r.rid])}): "
            f"prefill logits bit-equal to standalone; {agree} of "
            f"{LM_NEW_TOKENS} tokens equal to the standalone pick on the "
            f"same inputs; {near} steps with a standalone top-2 margin below "
            f"{2 * LM_LOGIT_TOL}; served vs standalone decode logits max "
            f"diff {max(diffs):.4g} (margins {[round(m, 4) for m in margins]})"
            + ("" if replay is None else
               f"; {replay.swaps - swaps0} of "
               f"{cfg.n_layers * (LM_NEW_TOKENS - 1)} decode routings "
               f"replayed from the served run differed from the standalone "
               f"top-{cfg.top_k}"))
        if cfg.name in LM_SERVED_SHAPE_LOOP:
            shaped = _served_shape_loop(transformer, serve, cfg, params, toks,
                                        r.out, engine.max_batch, dev)
            for t in range(1, LM_NEW_TOKENS):
                if not bits_equal(decode_logits[r.rid][t - 1], shaped[t]):
                    raise AssertionError(
                        f"request {r.rid}: served decode step {t}'s logits "
                        f"differ from the loop at the served batch shape")
            log(f"[lm-serve] request {r.rid}: served decode logits "
                f"bit-equal to a loop at the served batch shape; the batch-1 "
                f"loop's distance above is printed, not held")
            continue
        if max(diffs) > LM_LOGIT_TOL:
            raise AssertionError(f"request {r.rid}: served decode logits "
                                 f"differ from the standalone loop's by "
                                 f"{max(diffs)} > {LM_LOGIT_TOL}")
        for t, (a, b) in enumerate(zip(r.out, picks)):
            if a != b and margins[t] >= 2 * LM_LOGIT_TOL:
                raise AssertionError(f"request {r.rid}: served token {t} "
                                     f"differs from the standalone pick at "
                                     f"a top-2 margin of {margins[t]}")
    if replay is not None:
        replay.finish()
    log(f"[lm-serve] {agree_total} of {LM_NEW_TOKENS * len(prompts)} tokens "
        f"equal to the standalone pick ({near_total} near-ties); largest "
        f"served-vs-standalone decode logit difference {worst_diff:.4g} "
        f"(bound {LM_LOGIT_TOL}"
        + (", not held: held bit-equal at the served batch shape"
           if cfg.name in LM_SERVED_SHAPE_LOOP else "")
        + f"); the {launches} served attention calls "
        f"within tolerance of the plain version (bf16 max abs diff "
        f"{worst_fa[torch.bfloat16]:.3g})"
        + ("" if replay is None else f"; {replay.summary()}"))
    return launches, wall, worst_fa[torch.bfloat16]


# The MoE routing replay's limits.  The served (batch 4) router logits may
# differ from the batch-1 loop's by what LM_LOGIT_TOL allows the output
# logits: both are a unit-RMS normed hidden state times weights of variance
# 1/d, so rounding moves them alike.  The logits are read back from the
# probabilities up to softmax's shift (log p less its mean over experts).
# Then a replayed choice that displaces one of the loop's own bridges a
# probability gap of at most 1 - exp(-2 * LM_LOGIT_TOL) = 22% of the loop's
# k-th probability, and at most MOE_SWAP_SHARE of the routings may swap.
MOE_SWAP_SHARE = 0.05
MOE_GAP_SHARE = 1.0 - math.exp(-2 * LM_LOGIT_TOL)


def _stable_topk(p: torch.Tensor, k: int) -> set:
    """The k largest entries' indices, ties to the lower index (a stable
    sort in float64 on the host, apart from the port's ``_topk``)."""
    return set(np.argsort(-p.double().numpy(), kind="stable")[:k].tolist())


def _router_logits(p: torch.Tensor) -> torch.Tensor:
    lp = torch.log(p.double().clamp_min(1e-300))
    return lp - lp.mean()


class _RouteReplay:
    """The served decode's MoE routing, replayed in the standalone loop.

    Top-k routing is discontinuous: where two experts' router
    probabilities nearly tie, the last-bit differences between a batch-4
    and a batch-1 GEMM can swap the choice, and a swapped expert moves
    that token's logits by far more than rounding.  So each served decode
    step records, per slot and layer, the router probabilities, the expert
    choices and which of them the capacity keeps (the step's (token,
    choice) pairs in order, each expert keeping its first C, computed here
    from the recorded choices of every row; kept on the device until the
    served run ends, so the recording adds no host sync to its wall); the
    standalone loop takes
    those choices, with its own probabilities renormalized over them and
    the dropped ones weighted 0 (``force``).  ``check`` then holds what
    was replayed, so that a wrong served choice cannot pass: each served
    choice is the top-k of the served probabilities, the served router
    logits lie within LM_LOGIT_TOL of the loop's own, and every swap of
    the loop's own choice bridges a gap below MOE_GAP_SHARE of its k-th
    probability; ``finish`` holds the share of swapped routings."""

    def __init__(self, moe, cfg):
        self.moe, self.real, self.cfg = moe, moe._topk, cfg
        self.steps: list = []  # served decode steps, on the device
        self.served: dict = {}  # rid -> [step][layer] (probs, choice, keep)
        self.own: dict = {}  # rid -> [step][layer] the loop's own probs
        self.calls = None  # recording one served decode step
        self.forced = None  # replaying one standalone decode step
        self.routings = self.swaps = self.drops = 0
        self.gap = self.gap_share = self.drift = 0.0

    def install(self):
        self.moe._topk = self.topk

    def remove(self):
        self.moe._topk = self.real
        self.calls = self.forced = None

    def record(self, rows):
        """After a served decode step: ``rows`` are the active slots'
        (row, request id)."""
        self.steps.append((rows, self.calls))
        self.calls = None

    def _settle(self):
        for rows, calls in self.steps:
            self._settle_step(rows, calls)
        self.steps = []

    def _settle_step(self, rows, calls):
        layers = []
        for probs, idx in calls:
            probs, idx = probs.float().cpu(), idx.cpu()
            S, k = idx.shape
            cap = max(int(S * k * self.cfg.capacity_factor
                          / self.cfg.n_experts), k)
            keep = torch.ones(idx.shape, dtype=torch.bool)
            taken: dict = {}
            for s in range(S):
                for j in range(k):
                    e = int(idx[s, j])
                    keep[s, j] = taken.get(e, 0) < cap
                    taken[e] = taken.get(e, 0) + 1
            layers.append((probs, idx, keep))
        for i, rid in rows:
            self.served.setdefault(rid, []).append(
                [(p[i], idx[i], keep[i]) for p, idx, keep in layers])
            self.drops += sum(int((~keep[i]).sum()) for _, _, keep in layers)

    def force(self, rid, step):
        self._settle()
        self.forced, self.mine = self.served[rid][step], []
        self.own.setdefault(rid, []).append(self.mine)

    def topk(self, probs, k):
        w, idx = self.real(probs, k)
        if self.calls is not None:  # a served decode step
            if probs.shape[0] != 1:
                raise AssertionError(f"a decode step routed in "
                                     f"{probs.shape[0]} groups, not one")
            self.calls.append((probs[0].clone(), idx[0].clone()))
        elif self.forced is not None:  # the standalone loop
            _, want, keep = self.forced[len(self.mine)]
            self.mine.append(probs[0, 0].float().cpu())
            want = want.to(probs.device)
            pw = probs[0, 0][want]
            w = (pw / torch.clamp_min(pw.sum(), 1e-9)
                 * keep.to(probs.device, torch.float32))[None, None]
            idx = want[None, None]
        return w, idx

    def check(self, rid):
        k = self.cfg.top_k
        for t, (steps, mine) in enumerate(zip(self.served[rid],
                                              self.own[rid])):
            if len(steps) != len(mine):
                raise AssertionError(f"request {rid}, decode step {t}: "
                                     f"{len(steps)} served routings, "
                                     f"{len(mine)} standalone")
            for layer, ((pb, want, _), ps) in enumerate(zip(steps, mine)):
                where = f"request {rid}, decode step {t}, MoE layer {layer}"
                top, want = _stable_topk(pb, k), set(want.tolist())
                if top != want:
                    raise AssertionError(
                        f"{where}: the served expert choice {sorted(want)} "
                        f"is not the top-{k} of the served router "
                        f"probabilities, {sorted(top)}")
                d = float((_router_logits(pb)
                           - _router_logits(ps)).abs().max())
                self.drift = max(self.drift, d)
                if d > LM_LOGIT_TOL:
                    raise AssertionError(
                        f"{where}: the served router logits differ from the "
                        f"standalone loop's by {d:.4g} > {LM_LOGIT_TOL}")
                self.routings += 1
                mine_top = _stable_topk(ps, k)
                if mine_top != want:
                    self.swaps += 1
                    kth = float(ps[sorted(mine_top)].min())
                    gap = kth - float(ps[sorted(want)].min())
                    self.gap = max(self.gap, gap)
                    self.gap_share = max(self.gap_share, gap / kth)
                    if gap > MOE_GAP_SHARE * kth:
                        raise AssertionError(
                            f"{where}: a replayed choice displaces one of "
                            f"the loop's own across a probability gap of "
                            f"{gap:.4g}, {gap / kth:.3f} of its k-th "
                            f"probability > {MOE_GAP_SHARE:.3f}")

    def finish(self):
        if self.swaps > MOE_SWAP_SHARE * self.routings:
            raise AssertionError(f"{self.swaps} of {self.routings} replayed "
                                 f"routings swapped, more than "
                                 f"{MOE_SWAP_SHARE:.0%}")

    def summary(self) -> str:
        return (f"{self.swaps} of {self.routings} replayed routings "
                f"differed from the standalone top-{self.cfg.top_k} (limit "
                f"{MOE_SWAP_SHARE:.0%}), the largest such gap {self.gap:.3g} "
                f"({self.gap_share:.3f} of the k-th probability, limit "
                f"{MOE_GAP_SHARE:.3f}); served router logits within "
                f"{self.drift:.4g} of the loop's (bound {LM_LOGIT_TOL}); "
                f"{self.drops} served choices dropped by capacity, replayed "
                f"as weight 0")


def _planted_routing_faults(transformer, serve, ops, fa, moe, cfg, params,
                            prompts, dev):
    """Faults planted in the served routing, each a row shift at batch > 1
    as a slot mix-up would make it: of the top-k's choices (a choice that
    is not the top-k of its own probabilities) and of the router's
    probabilities (another token's routing).  Each must fail the replay's
    checks in ``phase_lm_serve``."""
    real = {"_topk": moe._topk, "_router": moe._router}

    def shifted_topk(probs, k):
        w, idx = real["_topk"](probs, k)
        if probs.shape[-2] > 1:
            w, idx = w.roll(1, -2), idx.roll(1, -2)
        return w, idx

    def shifted_router(c, p, x):
        probs = real["_router"](c, p, x)
        return probs.roll(1, -2) if probs.shape[-2] > 1 else probs

    for attr, fake, expect in (("_topk", shifted_topk, "is not the top-"),
                               ("_router", shifted_router,
                                "router logits differ")):
        setattr(moe, attr, fake)
        try:
            phase_lm_serve(transformer, serve, ops, fa, cfg, params, prompts,
                           dev)
        except AssertionError as e:
            if expect not in str(e):
                raise
            log(f"[lm-families] {cfg.name}: a row shift planted in the "
                f"served {attr} fails the routing check: {e}")
        else:
            raise AssertionError(f"a row shift planted in the served {attr} "
                                 f"passed the routing checks")
        finally:
            setattr(moe, attr, real[attr])


# the audio, vision and MoE families at full width: (arch, layers kept or
# None for all).  arctic-480b keeps 2 of its 35 layers (13.4 B expert
# parameters a layer, 55 GB in bf16 at 2 layers: one card holds no more).
# Its decode capacity, max(int(4*2*1.25/128), 2) = 2 rows an expert for the
# 4 slots' tokens, can drop a choice; the replay carries the drops over.
# mamba2-2.7b and hymba-1.5b run at full width with nothing cut.
LM_FAMILIES = [("musicgen-large", None), ("internvl2-26b", None),
               ("moonshot-v1-16b-a3b", None), ("arctic-480b", 2),
               ("mamba2-2.7b", None), ("hymba-1.5b", None)]
# a sliding-window model serves one more prompt, of its window less 4
# tokens (1020 for hymba-1.5b's 1024): its decode, positions 1020..1034,
# crosses the ring's wrap from slot 1023 to slot 0 (the 2048-token prompt
# prefills the ring rolled)
LM_WRAP_MARGIN = 4
# the models served again with the int8 KV cache (``kv_dtype="int8"``)
KV8_ARCHS = ("qwen2-7b", "hymba-1.5b")
# (name, B, H, Hkv, T, D) of every served full-attention prefill of the
# families (hymba-1.5b's three global layers at its five prompts)
FA_FAMILY_SERVED = [(f"{arch} T{T}", 1, H, Hkv, T, D)
                    for arch, H, Hkv, D, Ts in (
                        ("musicgen-large", 32, 32, 64, LM_PROMPTS),
                        ("internvl2-26b", 48, 8, 128, LM_PROMPTS),
                        ("moonshot-v1-16b-a3b", 16, 16, 128, LM_PROMPTS),
                        ("arctic-480b", 56, 8, 128, LM_PROMPTS),
                        ("hymba-1.5b", 25, 5, 64,
                         LM_PROMPTS + (1024 - LM_WRAP_MARGIN,)))
                    for T in Ts]
# moonshot's scatter impl against the einsum impl on one prefill.  Layer by
# layer, on the same inputs, the two differ only by rounding: einsum rounds
# sum_k w_k * y_k once to bf16, scatter rounds each product and the sum, and
# the experts' outputs y_k may differ by one rounding between the two GEMM
# calls; with bf16's unit roundoff 2^-8 that is
# |einsum - scatter| <= 2^-7 * (sum_k |w_k * y_k| + |sum_k w_k * y_k|).
# Over 48 layers those differences compound and can flip near-tied router
# choices, so the last-position logits are held to a looser bound: 16 bf16
# steps at their magnitude (about 4, a step 2^-5); a float-for-float CPU
# emulation at reduced width (48 layers, 64 experts, top 6) moved them by
# 0.21
MOE_IMPL_LOGIT_TOL = 0.5


def _moe_impl_check(moe, cfg, p, x, y, worst):
    """Hold ``moe_apply_scatter`` on x against the einsum impl's output y
    within the rounding bound above; ``worst`` keeps the largest difference
    and the largest ratio of difference to bound."""
    ys = moe.moe_apply_scatter(cfg, p, x)
    xg, valid, S, G, ungroup = moe._group(cfg, x)
    C = moe._capacity(cfg, S)
    w, idx = moe._topk(moe._router(cfg, p, xg), cfg.top_k)
    w = w * valid.float()[..., None]
    onehot = torch.nn.functional.one_hot(idx, cfg.n_experts).float()
    onehot = onehot * valid.float()[..., None, None]
    flat = onehot.reshape(G, -1, cfg.n_experts)
    pos = ((torch.cumsum(flat, 1) - 1.0) * flat).sum(-1).reshape(w.shape)
    keep = pos < C
    slot = torch.where(keep, pos, float(C)).long()
    pos_oh = torch.nn.functional.one_hot(slot, C + 1)[..., :C].float()
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot, pos_oh,
                           torch.where(keep, w, 0.0))
    dispatch = torch.einsum("gske,gskc->gsec", onehot, pos_oh)
    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    ye = moe._expert_ffn(cfg, p, xe).float()
    exact = ungroup(torch.einsum("gsec,gecd->gsd",
                                 combine.to(x.dtype).float(), ye))
    mags = ungroup(torch.einsum("gsec,gecd->gsd",
                                combine.to(x.dtype).float().abs(), ye.abs()))
    bound = 2.0 ** -7 * (mags + exact.abs()) + 1e-6
    diff = (y.float() - ys.float()).abs()
    worst["diff"] = max(worst["diff"], diff.max().item())
    worst["ratio"] = max(worst["ratio"], (diff / bound).max().item())
    if not bool((diff <= bound).all()):
        raise AssertionError(f"moe scatter != einsum beyond rounding: max "
                             f"diff {diff.max().item()}")


def phase_lm_family(transformer, layers, serve, ops, fa, moe, frontends,
                    get_config, arch, keep_layers, dev):
    """One full-width LM family on the card, alone: seeded init straight
    on the device, the 4 served requests (5 for a sliding-window model)
    held as phase 8 holds Qwen2-7B, plus internvl2-26b's prefills from stub
    embeddings, moonshot's scatter impl against its einsum impl, on
    arctic-480b (2 layers, so cheap to serve again) the planted routing
    faults, on hymba-1.5b its caches' slots and its float32 batch check
    (``_float32_batch_check``) and, for KV8_ARCHS, the same
    requests from the int8 KV cache (``phase_kv8``).  Returns the
    flash_attention launches of each served run, by name, and the largest
    bf16 difference of the served attention from the plain version."""
    cfg = get_config(arch)
    cut = ""
    if keep_layers is not None:
        cut = f" (cut to {keep_layers} of {cfg.n_layers} layers)"
        cfg = dataclasses.replace(cfg, n_layers=keep_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    gib = 2 ** 30
    log(f"[lm-families] {arch}{cut}: {cfg.param_count() / 1e9:.2f} B "
        f"parameters ({cfg.dtype}) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / gib:.2f} GiB allocated, init "
        f"peak {torch.cuda.max_memory_allocated(dev) / gib:.2f} GiB")
    prompts = _lm_prompts(cfg.vocab_size, cfg.attn_window)
    record = {}
    launches, _, worst = phase_lm_serve(transformer, serve, ops, fa, cfg,
                                        params, prompts, dev, record=record)
    by_run = {arch: launches}
    if cfg.attn_window:
        want = [(st.length, min(st.window, LM_MAX_LEN) if st.window
                 else LM_MAX_LEN) for st in transformer.plan_stages(cfg)]
        got = [(c["attn"]["k"][0], c["attn"]["k"][3])
               for c in record["cache_shapes"]]
        log(f"[lm-families] {arch}: the engine's KV caches hold (layers, "
            f"slots) {got} by stage (windowed stages rings of "
            f"{cfg.attn_window}, global ones {LM_MAX_LEN})")
        if got != want:
            raise AssertionError(f"{arch}: cache (layers, slots) {got}, want "
                                 f"{want}")
    if arch in LM_SERVED_SHAPE_LOOP:
        _float32_batch_check(transformer, serve, cfg, params, prompts, dev)
    if arch in KV8_ARCHS:
        by_run[f"{arch} kv8"], w8 = phase_kv8(
            transformer, layers, serve, ops, fa, cfg, params, prompts, record,
            dev)
        worst = max(worst, w8)
    if arch == "arctic-480b":
        _planted_routing_faults(transformer, serve, ops, fa, moe, cfg,
                                params, prompts, dev)
    real_fa = ops.flash_attention
    worst_fa = {torch.float32: 0.0, torch.bfloat16: 0.0}
    if cfg.frontend == "vision_patch":
        g = torch.Generator(device=dev).manual_seed(1)
        for T in LM_PROMPTS:
            emb = frontends.stub_embeddings(cfg, g, 1, T, device=dev)

            def checked_flash(q, k, v, *, causal=True):
                out = real_fa(q, k, v, causal=causal)
                _flash_compare(fa, q, k, v, causal, worst_fa,
                               f"the {T}-embedding prefill", got=out)
                return out

            fa.flash_attention.launches = 0
            ops.flash_attention = checked_flash
            try:
                logits, _ = transformer.prefill(cfg, params, embeds=emb)
            finally:
                ops.flash_attention = real_fa
            if (logits.shape != (1, cfg.vocab_size)
                    or not bool(torch.isfinite(logits).all())
                    or fa.flash_attention.launches != cfg.n_layers):
                raise AssertionError(f"stub-embedding prefill at T={T}: "
                                     f"launches "
                                     f"{fa.flash_attention.launches}")
        toks = torch.as_tensor(prompts[1], device=dev)[None]
        by_tok, _ = transformer.prefill(cfg, params, toks)
        by_emb, _ = transformer.prefill(
            cfg, params, embeds=params["embed"][toks.long()])
        if not bits_equal(by_tok, by_emb):
            raise AssertionError("prefill from the embedding table's rows "
                                 "differs from the prefill by tokens")
        log(f"[lm-families] {arch}: stub-embedding prefills at T "
            f"{list(LM_PROMPTS)} finite, {cfg.n_layers} flash launches each,"
            f" attention within tolerance of the plain version (bf16 max "
            f"abs diff {worst_fa[torch.bfloat16]:.3g}); embeddings gathered "
            f"from the table give the tokens' prefill bit for bit")
    if cfg.is_moe and arch == "moonshot-v1-16b-a3b":
        toks = torch.as_tensor(prompts[0], device=dev)[None]
        real_moe = moe.moe_apply
        impl_worst = {"diff": 0.0, "ratio": 0.0}

        def checked_moe(c, p, x):
            y = real_moe(c, p, x)
            _moe_impl_check(moe, c, p, x, y, impl_worst)
            return y

        moe.moe_apply = checked_moe
        try:
            e_logits, _ = transformer.prefill(cfg, params, toks)
        finally:
            moe.moe_apply = real_moe
        s_logits, _ = transformer.prefill(
            dataclasses.replace(cfg, moe_impl="scatter"), params, toks)
        diff = (e_logits.float() - s_logits.float()).abs().max().item()
        log(f"[lm-families] {arch}: moe_impl scatter against einsum on the "
            f"{toks.shape[1]}-token prefill: every layer within the rounding "
            f"bound (max diff {impl_worst['diff']:.4g}, at most "
            f"{impl_worst['ratio']:.3f} of the bound); last-position logits "
            f"max diff {diff:.4g} (bound {MOE_IMPL_LOGIT_TOL}); argmax "
            f"{int(e_logits.argmax())} / {int(s_logits.argmax())}")
        if diff > MOE_IMPL_LOGIT_TOL:
            raise AssertionError(f"moe scatter logits differ from einsum by "
                                 f"{diff} > {MOE_IMPL_LOGIT_TOL}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return by_run, max(worst, worst_fa[torch.bfloat16])


def phase_kv8(transformer, layers, serve, ops, fa, cfg, params, prompts,
              base, dev):
    """The same requests served from the int8 KV cache
    (``kv_dtype="int8"``) and held as ``phase_lm_serve`` holds every model,
    plus what follows from the reference's arithmetic: the prefill attends
    to the float keys and values, so its logits are bit-equal to the float
    cache's run (``base``, phase_lm_serve's record of it); the prefill
    cache's int8 payload and scales equal ``kv_quantize`` of the float
    cache's keys and values, on the CPU, in the written slots (zero past
    them); the attention caches take exactly (1 + 4/hd)/2 of the float
    caches' bytes in bf16 ((1 + 4/hd)/4 in float32).  The decode logits'
    difference from the float run, relative to its largest |logit|, and
    the token agreement are printed, not held: the reference bounds them
    (0.08, 0.75) only at its reduced size.  Returns the flash_attention launches and the largest
    bf16 difference of the served attention from the plain version."""
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    rec = {}
    launches, _, worst = phase_lm_serve(transformer, serve, ops, fa, cfg8,
                                        params, prompts, dev, record=rec)
    for rid in sorted(rec["prefill"]):
        if not bits_equal(rec["prefill"][rid], base["prefill"][rid]):
            raise AssertionError(f"{cfg.name} kv8: request {rid}'s prefill "
                                 f"logits differ from the float cache's")
    slots = 0
    for p in prompts:
        toks = torch.as_tensor(p, device=dev)[None]
        _, cf = transformer.prefill(cfg, params, toks, max_len=LM_MAX_LEN)
        _, c8 = transformer.prefill(cfg8, params, toks, max_len=LM_MAX_LEN)
        for si, (sf, s8) in enumerate(zip(cf, c8)):
            f, q8 = sf["attn"], s8["attn"]
            n = min(len(p), f["k"].shape[3])
            slots += n * f["k"].shape[0]
            for name, scale in (("k", "ks"), ("v", "vs")):
                want_q, want_s = layers.kv_quantize(
                    f[name][:, :, :, :n].cpu())
                got_q, got_s = q8[name].cpu(), q8[scale].cpu()
                if not (torch.equal(got_q[:, :, :, :n], want_q)
                        and bits_equal(got_s[:, :, :, :n], want_s)
                        and not got_q[:, :, :, n:].any()
                        and not got_s[:, :, :, n:].any()):
                    raise AssertionError(
                        f"{cfg.name} kv8: the {len(p)}-token prefill's "
                        f"stage {si} {name} cache is not kv_quantize of the "
                        f"float cache's")
        del cf, c8
    # the float cache holds hd elements of es bytes a (position, head), the
    # int8 one hd bytes and a 4-byte scale: (1 + 4/hd)/es of its bytes
    hd, es = cfg.hd, torch.empty((), dtype=cfg.jdtype).element_size()
    if rec["attn_bytes"] * es * hd != base["attn_bytes"] * (hd + 4):
        raise AssertionError(f"{cfg.name} kv8: attention caches "
                             f"{rec['attn_bytes']} bytes against the float "
                             f"{base['attn_bytes']}, want (1 + 4/{hd})/{es}")
    # each run decodes greedily on its own tokens, as the reference's test
    # does; rows up to the first token where the two runs part have the
    # same inputs, so their distance is the int8 cache's own error
    rel, rel_same, same, agree, total = 0.0, 0.0, 0, 0, 0
    for rid in sorted(rec["out"]):
        rows8 = [rec["prefill"][rid]] + rec["decode"][rid]
        rowsf = [base["prefill"][rid]] + base["decode"][rid]
        top = max(r.float().abs().max().item() for r in rowsf)
        diffs = [(a.float() - b.float()).abs().max().item() / top
                 for a, b in zip(rows8, rowsf)]
        toks8, toksf = rec["out"][rid], base["out"][rid]
        parted = next((t for t, (a, b) in enumerate(zip(toks8, toksf))
                       if a != b), len(toks8) - 1)
        rel = max(rel, max(diffs))
        rel_same = max(rel_same, max(diffs[1:parted + 1], default=0.0))
        same += parted
        agree += sum(a == b for a, b in zip(toks8, toksf))
        total += len(toks8)
    log(f"[lm-kv8] {cfg.name}: prefill logits bit-equal to the float "
        f"cache's for all {len(prompts)} requests; the int8 payload and "
        f"scales of {slots} (layer, slot) positions equal kv_quantize of "
        f"the float prefill caches on the CPU; attention caches "
        f"{rec['attn_bytes'] / 2**20:.1f} MiB against "
        f"{base['attn_bytes'] / 2**20:.1f} MiB ((1 + 4/{hd})/{es} = "
        f"{(1 + 4 / hd) / es:.4f}); not held at full width: decode logits "
        f"differ from the float cache's run by {rel:.4f} of its largest "
        f"|logit| (the reference's reduced-size bound 0.08), by "
        f"{rel_same:.4f} over the {same} decode steps fed the same tokens "
        f"by both runs, {agree} of {total} tokens equal "
        f"({agree / total:.3f}; bound there 0.75)")
    return launches, worst


def phase_flash_family_shapes(fa, dev):
    """``flash_attention`` against its plain version at every served shape
    of the families (FA_FAMILY_SERVED), on random inputs, bfloat16 and
    float32; returns the largest absolute differences (f32, bf16)."""
    g = torch.Generator().manual_seed(11)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, B, H, Hkv, T, D in FA_FAMILY_SERVED:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, H, T, D), generator=g).to(dtype).to(dev)
            k = torch.randn((B, Hkv, T, D), generator=g).to(dtype).to(dev)
            v = torch.randn((B, Hkv, T, D), generator=g).to(dtype).to(dev)
            _flash_compare(fa, q, k, v, True, worst, f"{name} {dtype}")
    log(f"[kernel-fa] {2 * len(FA_FAMILY_SERVED)} cases at the families' "
        f"served shapes (MHA 32/32 and GQA 25/5 at D = 64, GQA 48/8, MHA "
        f"16/16, GQA 56/8 at D = 128; T {list(LM_PROMPTS)}, and 1020 for "
        f"25/5) within tolerance of the plain "
        f"version (f32 max abs diff {worst[torch.float32]:.3g}; bf16 "
        f"{worst[torch.bfloat16]:.3g})")
    return worst[torch.float32], worst[torch.bfloat16]


def _capture_sites(layers, transformer, sink):
    """Wrap the layer functions so that each linear site's input of every
    layer lands in ``sink[name]`` during a forward: ``attn_in`` (the input
    of wq/wk/wv), ``attn_out`` (of the attention wo), ``mlp_in`` (of wi/wg),
    ``mlp_hidden`` (of the MLP wo) and ``head_in`` (the last position's
    final hidden state).  Returns a function that undoes the wrapping."""
    saved = {(layers, "attention_apply"): layers.attention_apply,
             (layers, "flash_attention"): layers.flash_attention,
             (layers, "mlp_apply"): layers.mlp_apply,
             (transformer, "lm_logits"): transformer.lm_logits}
    state = {"layer": -1}

    def attention_apply(cfg, p, x, *a, **k):
        state["layer"] += 1
        sink[f"layer{state['layer']}/attn_in"] = x
        return saved[(layers, "attention_apply")](cfg, p, x, *a, **k)

    def flash_attention(q, *a, **k):
        out = saved[(layers, "flash_attention")](q, *a, **k)
        B, H, T, D = out.shape
        sink[f"layer{state['layer']}/attn_out"] = (
            out.transpose(1, 2).reshape(B, T, H * D))
        return out

    def mlp_apply(cfg, p, x):
        sink[f"layer{state['layer']}/mlp_in"] = x
        sink[f"layer{state['layer']}/mlp_hidden"] = (
            torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"]))
        return saved[(layers, "mlp_apply")](cfg, p, x)

    def lm_logits(cfg, params, hidden):
        sink["head_in"] = hidden
        state["layer"] = -1
        return saved[(transformer, "lm_logits")](cfg, params, hidden)

    for (mod, name), fn in zip(saved, (attention_apply, flash_attention,
                                       mlp_apply, lm_logits)):
        setattr(mod, name, fn)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return restore


# the per-layer linears: (site class, input site, parameter path)
LM_LINEARS = [("attn qkv", "attn_in", ("attn", "wq")),
              ("attn qkv", "attn_in", ("attn", "wk")),
              ("attn qkv", "attn_in", ("attn", "wv")),
              ("attn wo", "attn_out", ("attn", "wo")),
              ("mlp wi/wg", "mlp_in", ("mlp", "wi")),
              ("mlp wi/wg", "mlp_in", ("mlp", "wg")),
              ("mlp wo", "mlp_hidden", ("mlp", "wo"))]


def phase_lm_ptq(transformer, layers, ptq, ops, qm, bsm, cfg, params,
                 prompts, dev):
    """Full-width post-training quantization: calibrate every linear
    site's input over the float prefills of the served prompts, quantize
    the weights, and run every layer's linears (plus the head on the last
    positions) as W8A8 ``QuantizedLinear``s through the quant_matmul kernel,
    each bit-equal to the plain version; then one layer's linears at 4 bits
    through ``bitserial_linear``.  Returns the kernel's launch count."""
    sink, kept, heads = {}, {}, []

    def observe_sites(stats, toks, out):
        for name, x in sink.items():
            stats.observe(name, x)
        if toks.shape[1] == LM_CALIB_PROMPT:
            kept.update(sink)
        heads.append(sink["head_in"])
        sink.clear()

    restore = _capture_sites(layers, transformer, sink)
    t0 = time.perf_counter()
    try:
        stats = ptq.calibrate(
            lambda toks: transformer.prefill(cfg, params, toks),
            [torch.as_tensor(p, device=dev)[None] for p in prompts],
            ptq.CalibrationStats(), observe_sites)
        torch.cuda.synchronize()
    finally:
        restore()
    t_cal = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = ptq.quantize_lm_params(params)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    log(f"[lm-ptq] calibrated {len(stats.mins)} sites over {len(prompts)} "
        f"float prefills in {t_cal:.2f} s; quantize_lm_params (int8, "
        f"per-channel) in {t_quant:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    stage, qstage = params["stages"][0], qparams["stages"][0]
    calls = []  # (class, x, wq, x_qp, float weight)
    for lay in range(cfg.n_layers):
        for cls, site, (blk, name) in LM_LINEARS:
            leaf = qstage[blk][name]
            wq = {"q": leaf["q"][lay], "scale": leaf["scale"].reshape(-1)}
            name_in = f"layer{lay}/{site}"
            calls.append((cls, kept[name_in], wq, stats.qparams(name_in),
                          stage[blk][name][lay]))
    calls.append(("head", torch.cat(heads), qparams["head"],
                  stats.qparams("head_in"), params["head"]))
    qm.quant_matmul.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ptq.QuantizedLinear(wq, qp)(x) for _, x, wq, qp, _ in calls]
    torch.cuda.synchronize()
    t_w8a8 = time.perf_counter() - t0
    launches = qm.quant_matmul.launches
    log(f"[lm-ptq] {len(calls)} W8A8 QuantizedLinears ({cfg.n_layers} layers "
        f"x {len(LM_LINEARS)} linears on the {LM_CALIB_PROMPT}-token prompt's "
        f"inputs, plus the "
        f"head on the {len(heads)} prompts' last positions) in {t_w8a8:.3f} "
        f"s; quant_matmul launches {launches}")
    if launches < len(calls):
        raise AssertionError(f"quant_matmul launched {launches} times for "
                             f"{len(calls)} linears")
    real = ops.quant_matmul
    ops.quant_matmul = qm.quant_matmul_plain
    try:
        plain = [ptq.QuantizedLinear(wq, qp)(x) for _, x, wq, qp, _ in calls]
    finally:
        ops.quant_matmul = real
    errs: dict[str, list] = {}
    for (cls, x, _, _, w), y, yp in zip(calls, outs, plain):
        if not bits_equal(y, yp):
            raise AssertionError(f"{cls}: W8A8 kernel output != plain")
        ref = (x @ w).float()
        errs.setdefault(cls, []).append(
            ((y.float() - ref).abs().mean() / ref.abs().mean()).item())
    log("[lm-ptq] every site bit-equal to the plain version; mean relative "
        "error against the bf16 product: " + ", ".join(
            f"{cls} {np.mean(v):.4f}" for cls, v in errs.items()))
    # 4-bit weights of layer 0 through the bit-serial kernel (signed planes)
    sub = {blk: {name: stage[blk][name][0] for _, _, (b, name) in LM_LINEARS
                 if b == blk} for blk in ("attn", "mlp")}
    q4 = ptq.quantize_lm_params(sub, bits=4)

    def four_bit(gemm):
        """The 7 sites through ``bitserial_linear`` with ``gemm`` as its
        bit-serial GEMM; returns the outputs and each GEMM's raw float32
        result."""
        raw = []

        def call(*a, **k):
            raw.append(gemm(*a, **k))
            return raw[-1]
        real_bsm, ptq._bsm = ptq._bsm, types.SimpleNamespace(
            bitserial_matmul=call)
        try:
            ys = [ptq.QuantizedLinear(q4[blk][name], stats.qparams(
                f"layer0/{site}"), bits=4)(kept[f"layer0/{site}"])
                for _, site, (blk, name) in LM_LINEARS]
        finally:
            ptq._bsm = real_bsm
        torch.cuda.synchronize()
        return ys, raw

    bsm.bitserial_matmul.launches = 0
    ys, raw = four_bit(bsm.bitserial_matmul)
    launches4 = bsm.bitserial_matmul.launches
    ys_plain, raw_plain = four_bit(bsm.bitserial_matmul_plain)
    rel = []
    for (cls, site, (blk, name)), y, yp, g, gp in zip(
            LM_LINEARS, ys, ys_plain, raw, raw_plain):
        if not (bits_equal(g, gp) and bits_equal(y, yp)):
            raise AssertionError(f"layer 0 {blk}.{name} at 4 bits: bit-serial "
                                 f"kernel output != plain")
        x = kept[f"layer0/{site}"]
        ref = (x @ sub[blk][name]).float()
        rel.append(((y.float() - ref).abs().mean() / ref.abs().mean()).item())
    log(f"[lm-ptq] layer 0 at 4 bits through bitserial_linear: "
        f"bitserial_matmul launches {launches4}, each site's kernel result "
        f"and output bit-equal to the plain version; mean relative error "
        f"{np.mean(rel):.4f} against the bf16 product")
    if launches4 != len(LM_LINEARS) or len(raw) != len(LM_LINEARS):
        raise AssertionError("the 4-bit linears did not launch the "
                             "bit-serial kernel once each")
    return launches


# ---------------------------------------------------------------------------
# training (phase 10): lm_loss through autograd, AdamW, the loop
# ---------------------------------------------------------------------------
TRAIN_ARCH = "olmo-1b"
TRAIN_SHAPE = (1024, 4)  # (seq_len, global batch) of the train phase
TRAIN_STEPS, TRAIN_RESUMED_STEPS, TRAIN_CKPT_EVERY = 4, 6, 2
TRAIN_GRAD_LAYERS, TRAIN_GRAD_BATCH = 2, (2, 256)  # float32, card vs CPU
TRAIN_GRAD_TOL = 1e-4  # each leaf's max |card - CPU| / its max |g|
TRAIN_RESUME_RTOL = 1e-4  # the reference's own resume tolerance
TRAIN_OVERFIT_STEPS, TRAIN_OVERFIT_LR, TRAIN_OVERFIT_DROP = 16, 1e-3, 1.0
TRAIN_Q8_STEPS, TRAIN_Q8_BYTES = 3, 2.1  # moment bytes a parameter, at most
HYBRID_ARCH, HYBRID_SHAPE, HYBRID_STEPS = "hymba-1.5b", (1024, 2), 2
BF16_PEAK = 989e12  # one H100's dense bf16 rate (SXM data sheet, 700 W)
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _train_batch(cfg, seq_len: int, batch: int, index: int, dev):
    from repro_torch.data import SyntheticLMDataset
    return SyntheticLMDataset(cfg.vocab_size, seq_len, batch).global_arrays(
        index, device=dev)


def _fresh_card(dev):
    """Free what the last phase left and start the peak memory count (the
    synchronize also initializes CUDA before its memory calls)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def _profile_step(step, args, dev, tag) -> None:
    """One more train step under ``torch.profiler``: its wall, the device's
    busy time (the kernels' time, each counted once under the op that
    launched it) and idle share, the shares of the weight products
    (``aten::mm``), the batched products (``aten::bmm``: the attention
    scan's, the SSD's) and the optimizer (the step's ``adamw`` span), and
    the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if torch.device(dev).type != "cuda":  # no device time to read
        t0 = time.perf_counter()
        step(*args)
        log(f"[{tag}] profiled step: wall {time.perf_counter() - t0:.4f} "
            f"s; device time not measured (no card)")
        return
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = sorted(((e.self_device_time_total / 1e3, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU), reverse=True)
    busy = sum(ms for ms, _ in ops)
    by_name = {name: ms for ms, name in ops}
    adamw = sum(e.device_time_total for e in prof.events()
                if e.name == "adamw" and e.device_type == DeviceType.CPU)
    share = {"mm": by_name.get("aten::mm", 0.0) / busy,
             "bmm": by_name.get("aten::bmm", 0.0) / busy,
             "adamw": adamw / 1e3 / busy}
    log(f"[{tag}] profiled step: wall {wall:.4f} s, device busy "
        f"{busy / 1e3:.4f} s, idle share {1 - busy / 1e3 / wall:.3f}; of "
        f"the busy time aten::mm {share['mm']:.3f}, aten::bmm "
        f"{share['bmm']:.3f}, the adamw span {share['adamw']:.3f}; top ops "
        f"(device ms) {[(name, round(ms, 2)) for ms, name in ops[:8]]}")


def phase_train_grad(cfg, dev) -> float:
    """``lm_loss`` and its gradients of ``cfg`` (float32) on the card and,
    from the same parameters copied over, on the CPU: each leaf within
    TRAIN_GRAD_TOL of that leaf's max |g|, every attention leaf's
    gradient non-zero and no flash_attention launch under grad (the
    forward takes the scan).  Returns the worst ratio."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    _fresh_card(dev)
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu_params = tree.map(lambda p: p.cpu(), params)
    batch = _train_batch(cfg, TRAIN_GRAD_BATCH[1], TRAIN_GRAD_BATCH[0], 0,
                         "cpu")
    before = fa.flash_attention.launches
    t0 = time.perf_counter()
    loss, grads = steps.value_and_grad(
        cfg, params, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = fa.flash_attention.launches - before
    t0 = time.perf_counter()
    want_loss, want = steps.value_and_grad(cfg, cpu_params, batch)
    t_cpu = time.perf_counter() - t0
    worst, names = 0.0, tree.paths(params)
    for name, g, w in zip(names, tree.leaves(grads), tree.leaves(want)):
        g = g.cpu()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not bool(torch.isfinite(g).all()) or err > TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"train-grad {name}: card vs CPU max |d| "
                                 f"{err:.3e} against {TRAIN_GRAD_TOL} x "
                                 f"{scale:.3e}")
        if name.split("/")[-1] in ATTN_LEAVES and not bool((g != 0).any()):
            raise AssertionError(f"train-grad {name}: the attention leaf "
                                 f"has no gradient")
        worst = max(worst, err / scale if scale else 0.0)
    if launches:
        raise AssertionError(f"train-grad: {launches} flash_attention "
                             f"launches under grad, want 0")
    if abs(float(loss) - float(want_loss)) > 1e-5 * abs(float(want_loss)):
        raise AssertionError(f"train-grad: loss {float(loss)} on the card, "
                             f"{float(want_loss)} on the CPU")
    log(f"[train-grad] {cfg.name} float32, {cfg.n_layers} layers at full "
        f"width ({cfg.param_count() / 1e6:.0f} M parameters), batch "
        f"{TRAIN_GRAD_BATCH[0]} x {TRAIN_GRAD_BATCH[1]}: loss "
        f"{float(loss):.6f} (CPU {float(want_loss):.6f}); {len(names)} "
        f"gradient leaves, worst max |card - CPU| / max |g| {worst:.2e} "
        f"(limit {TRAIN_GRAD_TOL}), every attention leaf non-zero, "
        f"{launches} flash_attention launches under grad; card "
        f"{t_card:.2f} s, CPU {t_cpu:.2f} s")
    return worst


def phase_train(cfg, seq_len, batch, workdir, dev) -> dict:
    """The training loop at full width: ``train()`` for TRAIN_STEPS steps
    with a checkpoint every TRAIN_CKPT_EVERY, the last checkpoint restored
    bit-equal to the returned state, ``train()`` resumed to
    TRAIN_RESUMED_STEPS from it (the iterator at TRAIN_STEPS), and the same
    steps run straight through in a fresh directory: losses and grad norms
    finite, every leaf changed by the first step, resumed losses within
    TRAIN_RESUME_RTOL of the straight run's, no flash_attention launch.
    Returns the straight run's numbers."""
    import shutil

    from repro_torch import tree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    shape = ShapeSpec("card", seq_len, batch, "train")
    n_mb = steps.default_microbatches(cfg, shape)
    workdir = pathlib.Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    log(f"[train] {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters "
        f"({cfg.dtype}, tied embeddings {cfg.tie_embeddings}), batch {batch} "
        f"x {seq_len} tokens, default_microbatches {n_mb}, moments "
        f"{'int8' if steps.make_optimizer(cfg).quantize_moments else 'f32'};"
        f" free disk {shutil.disk_usage(workdir.parent).free / 1e9:.0f} GB")
    before = fa.flash_attention.launches

    # the first step moves every leaf (train()'s step 0, run alone)
    _fresh_card(dev)
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = steps.make_optimizer(cfg, total=TRAIN_STEPS)
    new, _, _ = steps.make_train_step(cfg, opt, n_mb)(
        params, opt.init(params), _train_batch(cfg, seq_len, batch, 0, dev))
    still = [name for name, a, b in zip(tree.paths(params),
                                        tree.leaves(params),
                                        tree.leaves(new))
             if torch.equal(a, b)]
    if still:
        raise AssertionError(f"train: leaves unchanged by step 1: {still}")
    del params, new, opt

    def run(n_steps, ckpt_dir, every):
        _fresh_card(dev)
        t0 = time.perf_counter()
        out = train_mod.train(cfg, shape, steps=n_steps,
                              ckpt_dir=str(ckpt_dir), ckpt_every=every,
                              log_every=1, device=dev)
        torch.cuda.synchronize()
        hist = out[2]
        for h in hist:
            if not (math.isfinite(h["loss"]) and math.isfinite(
                    h["grad_norm"])):
                raise AssertionError(f"train: step {h['step']} loss "
                                     f"{h['loss']}, grad norm "
                                     f"{h['grad_norm']}")
        return out, time.perf_counter() - t0

    (p4, o4, h4), wall4 = run(TRAIN_STEPS, workdir / "a", TRAIN_CKPT_EVERY)
    step, trees, extras = restore_checkpoint(
        workdir / "a", {"params": p4, "opt_state": o4}, device=dev)
    bad = [name for name, a, b in zip(
        tree.paths(trees), tree.leaves(trees),
        tree.leaves({"opt_state": o4, "params": p4}))
        if not bits_equal(a, b)]
    if step != TRAIN_STEPS or extras["data"] != {"next_index": TRAIN_STEPS}:
        raise AssertionError(f"train: checkpoint step {step}, extras "
                             f"{extras}")
    if bad:
        raise AssertionError(f"train: restored leaves differ from the saved "
                             f"state: {bad[:5]} ({len(bad)})")
    n_leaves = len(tree.leaves(trees))
    del p4, o4, trees
    (_, _, h6r), _ = run(TRAIN_RESUMED_STEPS, workdir / "a",
                         TRAIN_CKPT_EVERY)
    resumed = [h["step"] for h in h6r]
    if resumed != list(range(TRAIN_STEPS, TRAIN_RESUMED_STEPS)):
        raise AssertionError(f"train: the resumed run ran steps {resumed}")
    shutil.rmtree(workdir / "a")
    (p6, o6, h6), wall6 = run(TRAIN_RESUMED_STEPS, workdir / "b",
                              TRAIN_RESUMED_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(workdir)
    _profile_step(
        steps.make_train_step(cfg, steps.make_optimizer(
            cfg, total=TRAIN_RESUMED_STEPS), n_mb),
        (p6, o6, _train_batch(cfg, seq_len, batch, TRAIN_RESUMED_STEPS,
                              dev)), dev, "train")
    del p6, o6
    straight = [h["loss"] for h in h6[TRAIN_STEPS:]]
    got = [h["loss"] for h in h6r]
    for a, b in zip(got, straight):
        if abs(a - b) > TRAIN_RESUME_RTOL * abs(b):
            raise AssertionError(f"train: resumed losses {got}, straight "
                                 f"{straight}")
    launches = fa.flash_attention.launches - before
    if launches:
        raise AssertionError(f"train: {launches} flash_attention launches")
    tokens = batch * seq_len
    wall = float(np.median([h["time_s"] for h in h6[1:]]))
    share = 6 * cfg.param_count() * tokens / (wall * BF16_PEAK)
    out = {"n_mb": n_mb, "step_s": wall, "tok_s": tokens / wall,
           "share": share, "peak": peak,
           "step_walls": [h["time_s"] for h in h6[1:]],
           "losses": [h["loss"] for h in h6]}
    log(f"[train] checkpoint of step {TRAIN_STEPS}: {n_leaves} leaves "
        f"restored bit-equal to the saved state, iterator at "
        f"{extras['data']['next_index']}; resumed steps {resumed} losses "
        f"{[round(x, 6) for x in got]} vs straight "
        f"{[round(x, 6) for x in straight]} (rtol {TRAIN_RESUME_RTOL}); "
        f"{launches} flash_attention launches")
    log(f"[train] straight run of {TRAIN_RESUMED_STEPS} steps: losses "
        f"{[round(h['loss'], 4) for h in h6]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in h6]}, step walls "
        f"{[round(h['time_s'], 4) for h in h6]} s; run walls (init, "
        f"checkpoints included) {wall4:.1f} s for {TRAIN_STEPS} steps, "
        f"{wall6:.1f} s for {TRAIN_RESUMED_STEPS}")
    log(f"[train] step wall {wall:.4f} s (median of steps 1-"
        f"{TRAIN_RESUMED_STEPS - 1}; step 0 {h6[0]['time_s']:.2f} s), "
        f"{tokens / wall:.0f} tokens/s, share of the bf16 dense peak "
        f"(6 N tokens / (wall x 989 TFLOP/s)) {share:.4f}, peak "
        f"{peak / 2 ** 30:.2f} GiB, {n_mb} microbatches")
    return out


def phase_train_compress(cfg, params, batch, dev):
    """One step's gradients through two rounds of
    ``error_feedback_update``: each new error feedback equal to g + ef -
    the reconstruction within float32 rounding, the effective gradient the
    reconstruction in the gradient's dtype.  Returns the float32
    gradient of the first leaf (the embedding) for ``phase_train_q8``."""
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.optim import compression
    _, grads = steps.value_and_grad(cfg, params, batch)
    ef = compression.ef_init(grads)
    worst = 0.0
    for _ in range(2):  # the second round carries the first's residual
        comp, new_ef = compression.compress_gradients(grads, ef)
        eff, again = compression.error_feedback_update(grads, ef)
        for g, e, c, ne, ne2, ge in zip(
                tree.leaves(grads), tree.leaves(ef),
                tree.leaves(comp, is_leaf=compression._is_compressed),
                tree.leaves(new_ef), tree.leaves(again), tree.leaves(eff)):
            recon = (c.q.float() * c.scale).reshape(-1)[:g.numel()]
            want = (g.float() + e).reshape(-1) - recon
            err = float((ne.reshape(-1) - want).abs().max())
            tol = 2 * float(torch.finfo(torch.float32).eps) * max(
                float((g.float() + e).abs().max()), 1e-30)
            worst = max(worst, err / tol)
            if (err > tol or not torch.equal(ne, ne2)
                    or not torch.equal(ge, recon.reshape(g.shape).to(
                        g.dtype))):
                raise AssertionError(f"compression: new ef off by {err:.3e}"
                                     f" (limit {tol:.3e})")
        ef = new_ef
    n = sum(g.numel() for g in tree.leaves(grads))
    sent = sum(c.q.numel() + 4 * c.scale.numel() for c in tree.leaves(
        comp, is_leaf=compression._is_compressed))
    log(f"[train-compress] error feedback over {n / 1e9:.3f} B gradient "
        f"values, two rounds: new ef = g + ef - recon within float32 "
        f"rounding (worst {worst:.2f} of the limit); {sent / 1e9:.3f} GB "
        f"sent against {4 * n / 1e9:.3f} GB of float32 ({4 * n / sent:.2f}"
        f"x fewer; {2 * n / 1e9:.3f} GB as bf16)")
    return tree.leaves(grads)[0].float()


def phase_train_q8(cfg, params, batch, n_mb, probe, dev) -> dict:
    """TRAIN_Q8_STEPS steps with int8 moments: losses finite, at most
    TRAIN_Q8_BYTES moment bytes a parameter (float32 moments take 8), and
    ``_q8_pack`` of ``probe`` on the card bit-equal to it on the CPU."""
    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW, _q8_pack
    opt = AdamW(quantize_moments=True)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, n_mb)
    losses = []
    for _ in range(TRAIN_Q8_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train-q8: losses {losses}")
    n = sum(p.numel() for p in tree.leaves(params))
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.leaves((state["m"], state["v"])))
    if nbytes / n > TRAIN_Q8_BYTES:
        raise AssertionError(f"train-q8: {nbytes / n:.3f} moment bytes a "
                             f"parameter, limit {TRAIN_Q8_BYTES}")
    got, want = _q8_pack(probe), _q8_pack(probe.cpu())
    if not (torch.equal(got.q.cpu(), want.q)
            and bits_equal(got.scale.cpu(), want.scale)):
        raise AssertionError("train-q8: _q8_pack on the card differs from "
                             "the CPU's")
    log(f"[train-q8] {TRAIN_Q8_STEPS} steps with int8 moments: losses "
        f"{[round(x, 4) for x in losses]}; moments {nbytes / 1e9:.3f} GB, "
        f"{nbytes / n:.4f} bytes a parameter (float32 moments: 8, "
        f"{8 * n / 1e9:.3f} GB); _q8_pack of a {tuple(probe.shape)} "
        f"gradient bit-equal on the card and the CPU")
    return {"q8_bytes": nbytes, "f32_bytes": 8 * n}


def phase_train_overfit(cfg, params, batch, n_mb, dev) -> list:
    """TRAIN_OVERFIT_STEPS steps of AdamW(lr=TRAIN_OVERFIT_LR) on one
    batch: the loss falls by at least TRAIN_OVERFIT_DROP nats."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamW
    opt = AdamW(lr=TRAIN_OVERFIT_LR)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, n_mb)
    losses = []
    for _ in range(TRAIN_OVERFIT_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    drop = losses[0] - losses[-1]
    log(f"[train-overfit] {TRAIN_OVERFIT_STEPS} steps of AdamW(lr="
        f"{TRAIN_OVERFIT_LR}) on one batch: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (ln V = {math.log(cfg.vocab_size):.4f}), a fall "
        f"of {drop:.4f} nats (at least {TRAIN_OVERFIT_DROP}); losses "
        f"{[round(x, 3) for x in losses]}")
    if not (math.isfinite(drop) and drop >= TRAIN_OVERFIT_DROP):
        raise AssertionError(f"train-overfit: the loss fell {drop} nats")
    return losses


def phase_train_family(cfg, seq_len, batch, dev) -> dict:
    """Full-width loss and gradients of another family (hymba-1.5b: the
    banded scan, the SSD mixer's backward, the grad routing of its global
    layers) on the first microbatch, then HYBRID_STEPS train steps: losses
    finite, every gradient leaf finite, every attention and mixer leaf's
    gradient non-zero, no flash_attention launch."""
    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    _fresh_card(dev)
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_mb = steps.default_microbatches(
        cfg, ShapeSpec("card", seq_len, batch, "train"))
    data = _train_batch(cfg, seq_len, batch, 0, dev)
    before = fa.flash_attention.launches
    loss, grads = steps.value_and_grad(
        cfg, params, {k: v[:batch // n_mb] for k, v in data.items()})
    for name, g in zip(tree.paths(grads), tree.leaves(grads)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train-hybrid {name}: non-finite grad")
        kind = name.split("/")
        if ("attn" in kind or "ssm" in kind) and not bool((g != 0).any()):
            raise AssertionError(f"train-hybrid {name}: zero gradient")
    del grads
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, n_mb)
    losses, walls = [float(loss)], []
    for i in range(HYBRID_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state,
                                _train_batch(cfg, seq_len, batch, i, dev))
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    _profile_step(step, (params, state, _train_batch(
        cfg, seq_len, batch, HYBRID_STEPS, dev)), dev, "train-hybrid")
    launches = fa.flash_attention.launches - before
    if not all(math.isfinite(x) for x in losses) or launches:
        raise AssertionError(f"train-hybrid: losses {losses}, {launches} "
                             f"flash_attention launches")
    tokens = batch * seq_len
    log(f"[train-hybrid] {cfg.name}: {cfg.n_layers} layers, "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({cfg.dtype}), batch "
        f"{batch} x {seq_len}, {n_mb} microbatches: every gradient leaf "
        f"finite, every attention and mixer leaf non-zero; losses (the "
        f"first microbatch's, then the steps') "
        f"{[round(x, 4) for x in losses]}; step walls "
        f"{[round(w, 3) for w in walls]} s, {tokens / walls[-1]:.0f} "
        f"tokens/s, share of the bf16 dense peak "
        f"{6 * cfg.param_count() * tokens / (walls[-1] * BF16_PEAK):.4f}, "
        f"peak {peak / 2 ** 30:.2f} GiB, {launches} flash_attention "
        f"launches")
    return {"n_mb": n_mb, "step_s": walls[-1], "peak": peak}


def phase_training(timed, get_config, transformer, workdir, dev) -> dict:
    """Phase 10: the training phases in order, one model on the card at a
    time, each through ``timed``; checkpoints go under ``workdir``.
    Returns the ``train`` phase's numbers."""
    olmo = get_config(TRAIN_ARCH)
    timed("train-grad", phase_train_grad, dataclasses.replace(
        olmo, n_layers=TRAIN_GRAD_LAYERS, dtype="float32"), dev)
    seq_len, batch = TRAIN_SHAPE
    trained = timed("train", phase_train, olmo, seq_len, batch, workdir,
                    dev)
    _fresh_card(dev)
    train_params = transformer.init_lm(
        olmo, torch.Generator(device=dev).manual_seed(1), device=dev)
    train_batch = _train_batch(olmo, seq_len, batch, 0, dev)
    n_mb = trained["n_mb"]
    probe = timed("train-compress", phase_train_compress, olmo, train_params,
                  {k: v[:batch // n_mb] for k, v in train_batch.items()},
                  dev)
    moments = timed("train-q8", phase_train_q8, olmo, train_params,
                    train_batch, n_mb, probe, dev)
    timed("train-overfit", phase_train_overfit, olmo, train_params,
          train_batch, n_mb, dev)
    del train_params, train_batch, probe
    hybrid = timed("train-hybrid", phase_train_family,
                   get_config(HYBRID_ARCH), *HYBRID_SHAPE, dev)
    log(f"[train] summary: {TRAIN_ARCH} step {trained['step_s']:.4f} s, "
        f"{trained['tok_s']:.0f} tokens/s, {trained['share']:.4f} of the "
        f"bf16 dense peak, peak {trained['peak'] / 2 ** 30:.2f} GiB, "
        f"{trained['n_mb']} microbatches, moments f32 "
        f"{moments['f32_bytes'] / 1e9:.3f} GB vs int8 "
        f"{moments['q8_bytes'] / 1e9:.3f} GB; {HYBRID_ARCH} step "
        f"{hybrid['step_s']:.4f} s, peak {hybrid['peak'] / 2 ** 30:.2f} GiB, "
        f"{hybrid['n_mb']} microbatches; 0 flash_attention launches on the "
        f"training path")
    return trained


# ---------------------------------------------------------------------------
# phase 11: the distributed layer
# ---------------------------------------------------------------------------
DIST_TRAIN_STEPS = 6
DIST_TRAIN_RUNS = 2  # train(mesh=) and unsharded train() runs, in turns
DIST_DECODE_TOKENS = 16
DIST_DRYRUN_CELLS = (("olmo-1b", "train_4k"),
                     ("moonshot-v1-16b-a3b", "decode_32k"))
DIST_DRYRUN_TIMEOUT_S = 170
EX_DRYRUN = "multipod_dryrun"  # the example among the host's dry runs
DIST_PHASE_LIMIT_S = 180


def _one_rank_mesh(dev):
    """A world of one rank in this process (NCCL on a card, gloo on the
    CPU) and its 1 x 1 ``(data, model)`` mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.HashStore())
    return make_local_mesh(1, 1, device=dev)


def _start_dryruns(outdir, cells=DIST_DRYRUN_CELLS, example=()) -> list:
    """The host's dry runs, started together: one ``repro_torch.launch.
    dryrun`` subprocess for each of ``cells`` and the ``multipod_dryrun``
    example with ``example``'s arguments (by default qwen2-7b x train_4k on
    the (2, 16, 16) mesh of a fake 512-rank world).  A fake world cannot
    share a process with the card's world, so each runs on the host with
    the card hidden and one thread, its stdout and stderr in ``outdir/<name>
    .out`` and ``.err``.  Returns ``[(key, process)]``, key ``(arch,
    shape)`` for a cell (:func:`_finish_dryruns` waits for them) and
    EX_DRYRUN for the example (:func:`phase_ex_dryrun`)."""
    import os
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")

    def start(name, argv):
        with open(outdir / f"{name}.out", "w") as fo, \
                open(outdir / f"{name}.err", "w") as fe:
            return subprocess.Popen([sys.executable, "-m", *argv], env=env,
                                    cwd=ROOT, stdout=fo, stderr=fe)

    procs = []
    for arch, shape in cells:
        (outdir / f"{arch}__{shape}__single.json").unlink(missing_ok=True)
        procs.append(((arch, shape), start(f"{arch}__{shape}", [
            "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            "--mesh", "single", "--out", str(outdir)])))
    procs.append((EX_DRYRUN, start(EX_DRYRUN, [
        "repro_torch.examples.multipod_dryrun", *example, "--device",
        "cpu"])))
    return procs


def _tail(path, n: int = 3000) -> str:
    path = pathlib.Path(path)
    return path.read_text()[-n:] if path.exists() else ""


def _stop(procs) -> None:
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish_dryruns(procs, outdir, t0) -> list:
    """Wait for each dry-run cell; a non-zero exit or a record without
    ``"ok": true`` fails.  Prints each cell's peak bytes a device, FLOPs,
    bytes, collectives by kind, dominant term and sharding fallbacks."""
    recs = []
    for key, p in procs:
        if key == EX_DRYRUN:
            continue
        arch, shape = key
        left = max(1.0, DIST_DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        if p.wait(timeout=left) != 0:
            raise AssertionError(f"dryrun {arch} {shape}: exit "
                                 f"{p.returncode}:\n"
                                 f"{_tail(pathlib.Path(outdir) / f'{arch}__{shape}.err')}")
        rec = json.loads((pathlib.Path(outdir)
                          / f"{arch}__{shape}__single.json").read_text())
        if rec.get("ok") is not True:
            raise AssertionError(f"dryrun {arch} {shape}: {rec.get('error')}")
        rl, coll = rec["roofline"], rec["collectives"]
        log(f"[dryrun] {arch} x {shape} x {rec['mesh']} ({rec['chips']} "
            f"ranks, fake world, meta tensors, dispatched in "
            f"{rec['compile_s']} s on the host): peak "
            f"{rec['peak_bytes_per_device'] / 2 ** 30:.2f} GiB a device "
            f"(arguments {rec['memory_analysis']['argument_size_in_bytes'] / 2 ** 30:.3f}"
            f" GiB, temporaries {rec['memory_analysis']['temp_size_in_bytes'] / 2 ** 30:.3f}"
            f" GiB), fits 80 GiB {rec['fits_hbm']}; {rl['hlo_flops_per_device']:.4e} "
            f"FLOPs and {rl['hlo_bytes_per_device']:.4e} bytes a device; "
            f"collectives {coll['ops']}, wire bytes {coll['wire_bytes']}; "
            f"terms on H100_SXM (datasheet) compute {rl['t_compute']:.4g} s, "
            f"memory {rl['t_memory']:.4g} s, collective "
            f"{rl['t_collective']:.4g} s -> {rl['dominant']}; useful FLOPs "
            f"ratio {rl['useful_flops_ratio']:.3f}; fallbacks "
            f"{rec['sharding_fallbacks']}")
        recs.append(rec)
    return recs


def _full(x):
    """A DTensor's global value (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _event_wall(fn, *args):
    """``fn(*args)`` and its device wall in seconds (CUDA events around
    it; host wall on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _roofline_line(tag, name, kind, cost, cfg, shape, wall):
    """Price ``cost`` (a StepCost of one rank) on H100_SXM and print its
    terms beside the measured wall; returns the RooflineReport."""
    from repro_torch.distributed.roofline import H100_SXM, roofline
    rl = roofline(name, kind, "1x1", 1,
                  {"flops": cost.flops, "bytes accessed": cost.bytes_accessed},
                  cost.collectives, cfg, shape, H100_SXM)
    log(f"[{tag}] roofline of the sharded step (analyze_step on the 1 x 1 "
        f"mesh, priced on H100_SXM datasheet rates): {cost.flops:.4e} FLOPs "
        f"({cost.contraction_flops:.4e} in contractions), "
        f"{cost.bytes_accessed:.4e} bytes, collectives {cost.collective_ops}"
        f"; t_compute {rl.t_compute:.4g} s, t_memory {rl.t_memory:.4g} s, "
        f"bound_time {rl.bound_time:.4g} s ({rl.dominant}); measured wall "
        f"{wall:.4f} s; bound_time / wall {rl.bound_time / wall:.4f}")
    return rl


def _shares(mf, walls):
    """(median share, spread) of the bf16 peak over step ``walls``: the
    share ``mf / (wall x peak)`` at the median wall, and the share at the
    fastest wall less the share at the slowest."""
    from repro_torch.distributed.roofline import H100_SXM
    peak = H100_SXM.peak_flops
    return (mf / (float(np.median(walls)) * peak),
            mf / (min(walls) * peak) - mf / (max(walls) * peak))


def phase_dist_train(cfg, seq_len, batch, mesh, dev, phase10=None) -> dict:
    """(a) + (c): the sharded train step of ``cfg`` on ``mesh`` (DTensor
    parameters, optimizer state and batch; ``remat_none``, the policy
    phase 10's ``train()`` runs) from seeded parameters: its gradients
    against the unsharded ``value_and_grad``'s (each leaf within
    TRAIN_GRAD_TOL of its max |g|), then DIST_TRAIN_STEPS steps in turns
    with the unsharded ``make_train_step``'s from the same parameters and
    batch (losses within TRAIN_RESUME_RTOL, each parameter leaf within
    TRAIN_GRAD_TOL of its update's max), printing whether all are
    bit-equal; the step under ``analyze_step``, priced on H100_SXM beside
    its median device wall; the sharded step's share of the bf16 peak held
    against its twin's, timed in turns with it.  Then ``train(mesh=)``
    runs phase 10's straight run (``phase10``: its losses and step walls)
    on the mesh, DIST_TRAIN_RUNS times in turns with the same ``train()``
    call unsharded: every run's losses within TRAIN_RESUME_RTOL of phase
    10's, and the mesh runs' share of the bf16 peak (steps 1-5 of each,
    timed by ``train()`` as phase 10's are) held against the unsharded
    runs'; phase 10's own share, timed minutes earlier, is printed beside
    them.  Two shares may differ by at most the sum of their spreads, each
    from its own walls alone (the share at the fastest step less the share
    at the slowest)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.roofline import model_flops
    from repro_torch.distributed.trace_analysis import analyze_step
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer
    shape = ShapeSpec("card", seq_len, batch, "train")
    _fresh_card(dev)
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    data = _train_batch(cfg, seq_len, batch, 0, dev)
    bundle = steps.build_sharded_step(cfg, shape, mesh, variant="remat_none",
                                      params=params, batch=data)
    ucfg = dataclasses.replace(bundle.cfg, act_spec=None)
    n_mb = steps.default_microbatches(cfg, shape, mesh)
    if n_mb != steps.default_microbatches(cfg, shape):
        raise AssertionError("dist-train: the 1 x 1 mesh changed "
                             "default_microbatches")
    dp, do, db = bundle.example_args
    # gradients of one microbatch, sharded vs unsharded
    with implicit_replication():
        loss_s, g_s = steps.value_and_grad(
            bundle.cfg, dp, {k: v[:batch // n_mb] for k, v in db.items()})
    loss_u, g_u = steps.value_and_grad(
        ucfg, params, {k: v[:batch // n_mb] for k, v in data.items()})
    worst_g, g_bits = 0.0, True
    for name, a, b in zip(tree.paths(params), tree.leaves(g_s),
                          tree.leaves(g_u)):
        a = a.to_local()
        g_bits &= bits_equal(a, b)
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        if not math.isfinite(err) or err > TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"dist-train {name}: sharded vs unsharded "
                                 f"gradient {err:.3e} against "
                                 f"{TRAIN_GRAD_TOL} x {scale:.3e}")
        worst_g = max(worst_g, err / scale if scale else 0.0)
    del g_s, g_u
    # the steps, sharded and unsharded in turns from the same state
    opt = steps.make_optimizer(ucfg)
    step = steps.make_train_step(ucfg, opt, n_mb)
    p, o = dp, do
    up, uo = params, opt.init(params)
    walls, losses, uwalls, ulosses = [], [], [], []
    for _ in range(DIST_TRAIN_STEPS):
        (p, o, m), w = _event_wall(bundle.step, p, o, db)
        walls.append(w)
        losses.append(float(_full(m["loss"])))
        (up, uo, um), w = _event_wall(step, up, uo, data)
        uwalls.append(w)
        ulosses.append(float(um["loss"]))
    del uo
    cost = analyze_step(bundle.step, p, o, db)
    got = [x.to_local() for x in tree.leaves(p)]
    del p, o, m
    p_bits = all(bits_equal(a, b) for a, b in zip(got, tree.leaves(up)))
    for a, b in zip(losses, ulosses):
        if abs(a - b) > TRAIN_RESUME_RTOL * abs(b):
            raise AssertionError(f"dist-train: sharded losses {losses}, "
                                 f"unsharded {ulosses}")
    worst_p = 0.0
    for name, a, b, p0 in zip(tree.paths(params), got, tree.leaves(up),
                              tree.leaves(params)):
        scale = float((b.float() - p0.float()).abs().max())
        err = float((a.float() - b.float()).abs().max())
        if err > TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"dist-train {name}: sharded vs unsharded "
                                 f"parameters {err:.3e} after "
                                 f"{DIST_TRAIN_STEPS} steps, update max "
                                 f"{scale:.3e}")
        worst_p = max(worst_p, err / scale if scale else 0.0)
    log(f"[dist-train] {cfg.name} ({cfg.param_count() / 1e9:.3f} B "
        f"parameters, {cfg.dtype}) at batch {batch} x {seq_len}, "
        f"{n_mb} microbatches, on a 1 x 1 DeviceMesh "
        f"{tuple(mesh.mesh_dim_names)} (one-rank "
        f"{torch.distributed.get_backend()} world), act_spec "
        f"{bundle.cfg.act_spec[:3]}: gradients worst |sharded - unsharded| "
        f"/ max |g| {worst_g:.2e} (limit {TRAIN_GRAD_TOL}), bit-equal "
        f"{g_bits}; losses {[round(x, 6) for x in losses]} vs unsharded "
        f"{[round(x, 6) for x in ulosses]} (rtol {TRAIN_RESUME_RTOL}), "
        f"bit-equal {losses == ulosses}; parameters after "
        f"{DIST_TRAIN_STEPS} steps worst |d| / update max {worst_p:.2e}, "
        f"bit-equal {p_bits}; device walls sharded "
        f"{[round(w, 4) for w in walls]} s, unsharded "
        f"{[round(w, 4) for w in uwalls]} s")
    wall, uwall = float(np.median(walls[1:])), float(np.median(uwalls[1:]))
    rl = _roofline_line("dist-train", cfg.name, "train", cost, bundle.cfg,
                        shape, wall)
    del got, up, params, data, bundle, dp, do, db
    mf = model_flops(cfg, shape)
    share, spread = _shares(mf, walls[1:])
    ushare, uspread = _shares(mf, uwalls[1:])
    msg = (f"[dist-train] model_flops / (wall x peak), steps 2-"
           f"{DIST_TRAIN_STEPS} in turns: sharded {share:.4f} (spread "
           f"{spread:.4f}), unsharded twin {ushare:.4f} (spread "
           f"{uspread:.4f}); |difference| {abs(share - ushare):.4f} against "
           f"the spreads' sum {spread + uspread:.4f}")
    if abs(share - ushare) > spread + uspread:
        raise AssertionError(msg + ": the sharded step is slower than its "
                             "twin")
    log(msg)
    # train(mesh=) and phase 10's straight run (the same train() call
    # unsharded) in turns, each run timed by train() as phase 10's is
    runs = {"mesh": [], "unsharded": []}
    for _ in range(DIST_TRAIN_RUNS):
        for key, m in (("unsharded", None), ("mesh", mesh)):
            _fresh_card(dev)
            _, _, hist = train_mod.train(cfg, shape,
                                         steps=TRAIN_RESUMED_STEPS,
                                         ckpt_dir=None, mesh=m,
                                         log_every=TRAIN_RESUMED_STEPS,
                                         device=dev)
            torch.cuda.synchronize()
            runs[key].append(hist)
    tlosses = [[h["loss"] for h in hist] for hist in runs["mesh"]]
    twalls = [h["time_s"] for hist in runs["mesh"] for h in hist[1:]]
    rwalls = [h["time_s"] for hist in runs["unsharded"] for h in hist[1:]]
    tshare, tspread = _shares(mf, twalls)
    rshare, rspread = _shares(mf, rwalls)
    msg = (f"[dist-train] train(mesh=) of {TRAIN_RESUMED_STEPS} steps on the "
           f"1 x 1 mesh, {DIST_TRAIN_RUNS} runs in turns with phase 10's "
           f"straight run unsharded: losses "
           f"{[round(x, 6) for x in tlosses[0]]}, bit-equal across runs "
           f"{all(x == tlosses[0] for x in tlosses)}; step walls (steps 1-"
           f"{TRAIN_RESUMED_STEPS - 1}) on the mesh "
           f"{[round(w, 4) for w in twalls]} s, unsharded "
           f"{[round(w, 4) for w in rwalls]} s; model_flops / (wall x peak) "
           f"on the mesh {tshare:.4f} (spread {tspread:.4f}), unsharded "
           f"{rshare:.4f} (spread {rspread:.4f}); |difference| "
           f"{abs(tshare - rshare):.4f} against the spreads' sum "
           f"{tspread + rspread:.4f}")
    if phase10 is not None:
        ref_losses = phase10["losses"]
        for hist in runs["mesh"] + runs["unsharded"]:
            losses = [h["loss"] for h in hist]
            if len(losses) != len(ref_losses) or any(
                    abs(a - b) > TRAIN_RESUME_RTOL * abs(b)
                    for a, b in zip(losses, ref_losses)):
                raise AssertionError(f"dist-train: train() losses {losses},"
                                     f" phase 10's straight run {ref_losses}")
        ref, ref_spread = _shares(mf, phase10["step_walls"])
        msg += (f"; phase 10's losses bit-equal "
                f"{all(x == ref_losses for x in tlosses)}, its own walls "
                f"{[round(w, 4) for w in phase10['step_walls']]} s gave "
                f"{ref:.4f} (spread {ref_spread:.4f}) minutes earlier")
    if abs(tshare - rshare) > tspread + rspread:
        raise AssertionError(msg + ": the shares disagree")
    log(msg)
    return {"wall": wall, "uwall": uwall, "train_wall":
            float(np.median(twalls)), "share": tshare, "ushare": rshare,
            "bound": rl.bound_time}


def phase_dist_serve(cfg, params, prompts, mesh, dev) -> tuple:
    """(b) + (c): each prompt through the sharded prefill step on
    ``mesh`` (its attention through ``local_map`` into the flash kernel),
    its logits bit-equal to the unsharded ``prefill``'s; then
    DIST_DECODE_TOKENS greedy tokens through the sharded decode step from
    the unsharded prefill's caches, each step's logits within
    LM_LOGIT_TOL of the unsharded ``decode_step``'s on the same token;
    every prefill and decode step timed (CUDA events) beside its
    unsharded twin; the longest prompt's sharded prefill analysed and
    priced on H100_SXM.  Returns (flash launches in the sharded prefills, worst decode
    difference)."""
    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import distribute, make_batch_sharding
    from repro_torch.distributed.trace_analysis import analyze_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    launches, worst, decode_bits, rows = 0, 0.0, True, []
    for toks in prompts:
        T = len(toks)
        tok = torch.from_numpy(toks)[None].to(dev)
        shape = ShapeSpec(f"p{T}", T, 1, "prefill")
        b = steps.build_sharded_step(cfg, shape, mesh, params=params,
                                     batch={"tokens": tok})
        with torch.no_grad():
            before = fa.flash_attention.launches
            (logits, _), wall = _event_wall(b.step, *b.example_args)
            n = fa.flash_attention.launches - before
            launches += n
            (want, _), uwall = _event_wall(transformer.prefill, cfg, params,
                                           tok)
            if not bits_equal(logits.to_local(), want):
                raise AssertionError(f"dist-serve prompt {T}: sharded "
                                     f"prefill logits differ from the "
                                     f"unsharded prefill's")
            if T == max(len(t) for t in prompts):
                cost = analyze_step(b.step, *b.example_args)
                _roofline_line("dist-serve", cfg.name, f"prefill {T}", cost,
                               b.cfg, shape, wall)
            del b, logits
            # decode from the unsharded prefill's caches
            first, caches = transformer.prefill(
                cfg, params, tok, max_len=T + DIST_DECODE_TOKENS)
            dshape = ShapeSpec(f"d{T}", T + DIST_DECODE_TOKENS, 1, "decode")
            nxt = torch.argmax(first, dim=-1)[:, None].to(torch.int32)
            d = steps.build_sharded_step(
                cfg, dshape, mesh, params=params, batch={"tokens": nxt},
                caches=tree.map(torch.clone, caches), pos=T)
            dparams, dcaches, _ = d.example_args
            tok_sh = make_batch_sharding(d.cfg, mesh, dshape)
            err, dwalls, udwalls = 0.0, [], []
            for i in range(DIST_DECODE_TOKENS):
                (ls, dcaches), w = _event_wall(d.step, dparams, dcaches, {
                    "tokens": distribute(nxt, tok_sh), "pos": T + i})
                dwalls.append(w)
                (lu, caches), w = _event_wall(transformer.decode_step, cfg,
                                              params, nxt, caches, T + i)
                udwalls.append(w)
                decode_bits &= bits_equal(ls.to_local(), lu)
                err = max(err, float((ls.to_local().float()
                                      - lu.float()).abs().max()))
                nxt = torch.argmax(lu, dim=-1)[:, None].to(torch.int32)
            if err > LM_LOGIT_TOL:
                raise AssertionError(f"dist-serve prompt {T}: sharded "
                                     f"decode logits {err} from the "
                                     f"unsharded decode's")
            worst = max(worst, err)
            rows.append((T, n, round(wall, 4), round(uwall, 4),
                         round(float(np.median(dwalls)), 5),
                         round(float(np.median(udwalls)), 5), err))
            del d, dparams, dcaches, caches
    if launches <= 0:
        raise AssertionError("dist-serve: no flash_attention launch in the "
                             "sharded prefills")
    log(f"[dist-serve] {cfg.name} on the 1 x 1 mesh: (prompt, flash "
        f"launches, prefill device wall s sharded, unsharded, decode step "
        f"median device wall s sharded, unsharded, decode max |d|) {rows}; "
        f"prefill logits bit-equal to the unsharded prefill's for all "
        f"{len(prompts)} prompts; {DIST_DECODE_TOKENS} decode steps each "
        f"within {worst:.4g} of the unsharded decode (bound {LM_LOGIT_TOL}),"
        f" bit-equal {decode_bits}; {launches} flash_attention launches")
    return launches, worst


def phase_distributed(timed, get_config, transformer, phase10, host,
                      dev) -> int:
    """Phase 11: the distributed layer.  On a one-rank mesh of the card
    the sharded train step (olmo-1b, phase 10's shape) runs against its
    unsharded twin and the roofline; then the host's dry runs start in
    subprocesses (:func:`_start_dryruns`, appended to ``host``, which the
    caller stops) while the sharded serve steps (qwen2-7b, phase 8's
    prompts) run on the card; the two cells are waited for last, the
    example by phase 12.  Returns the flash launches of the sharded
    prefills."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    outdir = ROOT / "build" / "dryrun"
    mesh = _one_rank_mesh(dev)
    try:
        seq_len, batch = TRAIN_SHAPE
        timed("dist-train", phase_dist_train, get_config(TRAIN_ARCH),
              seq_len, batch, mesh, dev, phase10)
        # the dry runs' host work starts after the timed train steps,
        # which are host-bound
        host.extend(_start_dryruns(outdir))
        _fresh_card(dev)
        cfg = get_config(LM_ARCH)
        params = transformer.init_lm(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        launches, _ = timed("dist-serve", phase_dist_serve, cfg, params,
                            _lm_prompts(cfg.vocab_size), mesh, dev)
        del params
    finally:
        dist.destroy_process_group()
    timed("dist-dryrun", _finish_dryruns, host, outdir, t0)
    wall = time.perf_counter() - t0
    if wall > DIST_PHASE_LIMIT_S:
        raise AssertionError(f"distributed: phase 11 took {wall:.1f} s, "
                             f"limit {DIST_PHASE_LIMIT_S} s")
    log(f"[distributed] phase 11 wall {wall:.1f} s (limit "
        f"{DIST_PHASE_LIMIT_S} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the examples users start from
# ---------------------------------------------------------------------------
EX_FAULTS = "seed=7,filter=0.1,compute=0.05"
EX_SLO_MS = 5000.0  # the reference example's default
EX_NC_REQUESTS = 6
EX_TRAIN_STEPS = 300  # the reference example's run
EX_TRAIN_SHAPE = (8, 256)  # (batch, seq) of the reference example's run
EX_CYCLES = {"add": 9, "multiply": 102}  # n + 1 and n^2 + 5n - 2 at n = 8
EX_SIMULATOR = ("4.72", "18.3", "7.7")  # ms, x over CPU, x over GPU (paper)
EX_DRYRUN_TIMEOUT_S = 400  # from phase 11's start (the run: 172.5 s)


def phase_ex_quickstart(quickstart, bsm, qm, dev) -> dict:
    """The quickstart's three demos on the card: §III add and multiply
    bit-exact at 9 and 102 cycles, the 8-lane reduce exact, the
    simulator's 4.72 ms / 18.3x / 7.7x; then the W8A8 GEMM and the
    bit-serial GEMM at 8, 4 and 2 bits (1 quant_matmul and 3
    bitserial_matmul launches), each relative error equal to the same
    demo's with both kernels swapped for their plain versions on the
    card, which launches nothing.  Returns the launches by kernel."""
    bits = quickstart.demo_bitserial(dev)
    if not (bits["add_exact"] and bits["mul_exact"]
            and bits["reduce"] == bits["reduce_want"]):
        raise AssertionError(f"quickstart: §III results not exact: {bits}")
    if (bits["add_cycles"], bits["mul_cycles"]) != (EX_CYCLES["add"],
                                                    EX_CYCLES["multiply"]):
        raise AssertionError(f"quickstart: cycles {bits}")
    sim = quickstart.demo_simulator()
    got = (f"{sim['ms']:.2f}", f"{sim['vs_cpu']:.1f}", f"{sim['vs_gpu']:.1f}")
    if got != EX_SIMULATOR:
        raise AssertionError(f"quickstart: simulator {got}, paper "
                             f"{EX_SIMULATOR}")
    x, w = quickstart.gemm_operands(torch.Generator().manual_seed(7), dev)
    bsm.bitserial_matmul.launches = 0
    qm.quant_matmul.launches = 0
    errs = quickstart.demo_kernels(x, w)
    torch.cuda.synchronize()
    launches = {"bitserial_matmul": bsm.bitserial_matmul.launches,
                "quant_matmul": qm.quant_matmul.launches}
    want = {"bitserial_matmul": len(quickstart.GEMM_BITS), "quant_matmul": 1}
    if launches != want:
        raise AssertionError(f"quickstart: launches {launches}, want {want}")
    real_bsm, real_qm = bsm.bitserial_matmul, qm.quant_matmul
    bsm.bitserial_matmul = bsm.bitserial_matmul_plain
    qm.quant_matmul = qm.quant_matmul_plain
    try:
        plain = quickstart.demo_kernels(x, w)
    finally:
        bsm.bitserial_matmul, qm.quant_matmul = real_bsm, real_qm
    if (bsm.bitserial_matmul.launches, qm.quant_matmul.launches) != (
            want["bitserial_matmul"], want["quant_matmul"]):
        raise AssertionError("quickstart: the plain run launched a kernel")
    if errs != plain:
        raise AssertionError(f"quickstart: relative errors through the "
                             f"kernels {errs} differ from the plain "
                             f"versions' {plain}")
    log(f"[ex-quickstart] §III add/multiply bit-exact at "
        f"{bits['add_cycles']}/{bits['mul_cycles']} cycles, reduce "
        f"{bits['reduce']} at {bits['reduce_cycles']} cycles; simulator "
        f"{sim['ms']:.4f} ms ({sim['vs_cpu']:.2f}x, {sim['vs_gpu']:.2f}x); "
        f"relative errors {errs}, equal to the plain versions' on the card; "
        f"launches {launches}")
    return launches


def phase_ex_serve_nc(serve_quantized, inception, backends, ops, bsm,
                      dev) -> dict:
    """``serve_quantized --neural-cache --fault-profile EX_FAULTS
    --compressed --warmup-replan`` on the card: the reduced Inception's 6
    images through ``NCServingEngine(max_batch=4)``, every request's logits
    byte-identical to a standalone ``nc_forward`` (the example itself
    holds request 0's) and to a standalone one with the kernels swapped
    for their plain versions (as phase 7's plain forward), ``detected ==
    corrupt_attempts``, none failed or degraded, the ``gemm`` backend
    native and the bit-serial kernel launched.  Returns the launches and
    the wall."""
    cfg = serve_quantized.nc_config()
    params = inception.init_params(torch.Generator().manual_seed(0),
                                   config=cfg, device=dev)
    images = serve_quantized.nc_images(cfg, EX_NC_REQUESTS)
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    backends.dispatch_stats_clear()
    res = serve_quantized.main_neural_cache(
        params, cfg, images, EX_SLO_MS, EX_FAULTS, compressed=True,
        warmup_replan=True, device=dev)
    launches = bsm.bitserial_matmul.launches
    _minmax_take("examples serve-nc", dev)  # reduced width
    _requant_take("examples serve-nc", dev)  # reduced width
    gemm = backends.dispatch_stats()["gemm"]
    fs, s = res["faults"], res["stats"]
    if len(res["done"]) != EX_NC_REQUESTS or s["failed"]:
        raise AssertionError(f"serve-nc: served {len(res['done'])} of "
                             f"{EX_NC_REQUESTS}, {s['failed']} failed")
    if any(r.degraded for r in res["done"]):
        raise AssertionError("serve-nc: a batch left the emulation")
    for r in res["done"]:
        alone, _ = inception.nc_forward(params, images[r.rid], config=cfg,
                                        device=dev)
        if not bits_equal(r.logits, alone):
            raise AssertionError(f"serve-nc: request {r.rid}'s logits "
                                 f"differ from a standalone nc_forward")
    real, before = ops.bitserial_matmul_exact, bsm.bitserial_matmul.launches
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    try:
        plain = {r.rid: inception.nc_forward(params, images[r.rid],
                                             config=cfg, device=dev)[0]
                 for r in res["done"]}
    finally:
        ops.bitserial_matmul_exact = real
    if bsm.bitserial_matmul.launches != before:
        raise AssertionError("serve-nc: the plain forwards launched the "
                             "kernel")
    for r in res["done"]:
        if not bits_equal(r.logits, plain[r.rid]):
            raise AssertionError(f"serve-nc: request {r.rid}'s logits "
                                 f"differ from the plain versions' "
                                 f"standalone nc_forward")
    if fs["detected"] != fs["corrupt_attempts"] or fs["injected"] == 0:
        raise AssertionError(f"serve-nc: fault ledger {fs}")
    if gemm["native"] == 0 or launches == 0:
        raise AssertionError(f"serve-nc: gemm dispatch {gemm}, launches "
                             f"{launches}")
    log(f"[ex-serve-nc] {cfg.name}: {EX_NC_REQUESTS} images in "
        f"{res['wall_s']:.3f} s ({EX_NC_REQUESTS / res['wall_s']:.2f} "
        f"images/s), batches {s['batch_histogram']}; faults {fs['injected']} "
        f"injected, {fs['detected']} detected of {fs['corrupt_attempts']} "
        f"corrupt passes; every request's logits byte-identical to a "
        f"standalone nc_forward through the kernel and to one through the "
        f"plain versions; gemm dispatch {gemm}; bitserial_matmul launches "
        f"{launches}")
    return {"bitserial_matmul": launches, "wall_s": res["wall_s"]}


def phase_ex_serve_lm(serve_quantized, transformer, layers, fa, dev) -> dict:
    """The LM demo on the card: fp32, W8 and W4 reduced qwen2-7b each
    serving the 8 prompts of 24 tokens, 8 tokens each (64 a run), every
    prefill's attention through the flash kernel (4 layers x 8 prompts x
    3 runs), each served attention call's output held against the plain
    version on its q, k, v (captured in the run, compared after it); then
    each fp32 request decoded greedily by a batch-1 loop fed the served
    tokens: each served token equal to the loop's pick unless that pick's
    top-2 margin is below 2 * LM_LOGIT_TOL (phase 8's rule).  Returns the
    launches, each run's tok/s and the largest difference of a served
    attention call from the plain version."""
    cfg = serve_quantized.lm_config()
    params = transformer.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = serve_quantized.lm_prompts(cfg)
    real_fa, served = layers.flash_attention, []

    def captured(q, k, v, *, causal=True, window=0, **kw):
        out = real_fa(q, k, v, causal=causal, window=window, **kw)
        if window == 0:  # the calls the kernel takes
            served.append((q.clone(), k.clone(), v.clone(), causal,
                           out.clone()))
        return out

    fa.flash_attention.launches = 0
    layers.flash_attention = captured
    try:
        runs = serve_quantized.main_lm(cfg, params, prompts, dev)
    finally:
        layers.flash_attention = real_fa
    launches = fa.flash_attention.launches
    want = _full_attention_layers(transformer, cfg) * len(prompts) * len(runs)
    if launches != want or len(served) != want:
        raise AssertionError(f"serve-lm: flash_attention launched {launches} "
                             f"times, {len(served)} calls captured, want "
                             f"{want}")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (q, k, v, causal, out) in enumerate(served):
        _flash_compare(fa, q, k, v, causal, worst,
                       f"served prefill call {i}", got=out)
    del served
    total = len(prompts) * serve_quantized.LM_MAX_TOKENS
    if any(r["tokens"] != total for r in runs.values()):
        raise AssertionError(f"serve-lm: tokens "
                             f"{ {t: r['tokens'] for t, r in runs.items()} }")
    near = 0
    for rid, out in sorted(runs["fp32"]["out"].items()):
        toks = torch.as_tensor(prompts[rid], device=dev)[None]
        logits, caches = transformer.prefill(cfg, params, toks, max_len=128)
        steps, pos = [logits[0]], toks.shape[1]
        for tok in out[:-1]:
            nxt = torch.tensor([[tok]], dtype=torch.int32, device=dev)
            lg, caches = transformer.decode_step(cfg, params, nxt, caches, pos)
            steps.append(lg[0])
            pos += 1
        for t, (tok, lg) in enumerate(zip(out, steps)):
            margin = _top2_margin(lg)
            near += margin < 2 * LM_LOGIT_TOL
            if tok != int(torch.argmax(lg)) and margin >= 2 * LM_LOGIT_TOL:
                raise AssertionError(f"serve-lm: request {rid} token {t} "
                                     f"differs from the batch-1 loop at a "
                                     f"top-2 margin of {margin}")
    log(f"[ex-serve-lm] {cfg.name} ({_lm_desc(cfg)}): "
        + "; ".join(f"{tag} {r['tokens']} tokens in {r['wall_s']:.3f} s "
                    f"({r['tok_s']:.1f} tok/s, {r['steps']} steps"
                    + (f", greedy agreement {r['agreement']:.3f}"
                       if "agreement" in r else "") + ")"
                    for tag, r in runs.items())
        + f"; each served attention call within f32 rtol=atol={FA_F32_TOL} "
        f"of the plain version (max abs diff {worst[torch.float32]:.3g}); "
        f"fp32 tokens equal to a batch-1 loop's picks ({near} near-ties "
        f"under {2 * LM_LOGIT_TOL}); flash_attention launches {launches}")
    return {"flash_attention": launches,
            "tok_s": {t: r["tok_s"] for t, r in runs.items()},
            "worst": max(worst.values())}


def phase_ex_train(train_lm, fa, cfg, steps, batch, seq, workdir, dev):
    """``train_lm`` on the card: ``cfg`` trained ``steps`` steps of
    ``batch`` x ``seq`` through ``launch.train.train`` with a checkpoint
    every 100 steps under ``workdir`` (deleted after), the loss improved
    (the example holds it) and every loss finite, no flash launch (under
    grad attention takes the scan).  Returns the example's numbers."""
    import shutil
    shutil.rmtree(workdir, ignore_errors=True)
    fa.flash_attention.launches = 0
    try:
        res = train_lm.run(cfg, steps=steps, batch=batch, seq=seq,
                           ckpt_dir=str(workdir), device=dev)
        ckpts = sorted(p.name for p in pathlib.Path(workdir).iterdir())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError("train_lm: a non-finite loss")
    if fa.flash_attention.launches:
        raise AssertionError("train_lm: flash_attention launched under grad")
    res["tok_s"] = batch * seq / res["step_s"]
    log(f"[ex-train] {cfg.param_count() / 1e6:.1f}M-param {cfg.dtype} "
        f"{cfg.family} LM, {steps} steps of {batch} x {seq}: loss "
        f"{res['first']:.4f} -> {res['last']:.4f} (first/last {res['k']} "
        f"steps); step {res['step_s']:.4f} s ({1 / res['step_s']:.2f} "
        f"step/s, {res['tok_s']:.0f} tokens/s); checkpoints {ckpts}; 0 "
        f"flash_attention launches")
    return res


def phase_ex_dryrun(host, outdir, t_start: float) -> dict:
    """Wait for the ``multipod_dryrun`` example among ``host``'s dry runs
    (:func:`_start_dryruns` into ``outdir``, at most EX_DRYRUN_TIMEOUT_S
    from ``t_start``, phase 11's start): exit 0, the record printed as JSON with
    ``peak_bytes_per_device``, ``fits_hbm`` and the roofline's
    ``dominant`` term, and the example's closing lines, printed here."""
    proc = dict(host)[EX_DRYRUN]
    left = max(1.0, EX_DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start))
    code = proc.wait(timeout=left)
    out = pathlib.Path(outdir) / f"{EX_DRYRUN}.out"
    if code != 0:
        raise AssertionError(f"multipod_dryrun: exit {code}:\n"
                             f"{_tail(out.with_suffix('.err'))}")
    text = out.read_text()
    body, tail = text.split("\n\n[", 1)
    rec = json.loads(body)
    for key in ("peak_bytes_per_device", "fits_hbm"):
        if rec.get(key) is None:
            raise AssertionError(f"multipod_dryrun: record lacks {key}")
    if rec["roofline"].get("dominant") not in ("compute", "memory",
                                               "collective"):
        raise AssertionError(f"multipod_dryrun: dominant {rec['roofline']}")
    for line in ("[" + tail).splitlines():
        log(f"[ex-dryrun] {line}")
    log(f"[ex-dryrun] {rec['arch']} x {rec['shape']} @ {rec['mesh']} "
        f"({rec['chips']} ranks, fake world, meta tensors): built and "
        f"dispatched in {rec['compile_s']} s on the host (started in "
        f"phase 11), peak {rec['peak_bytes_per_device'] / 2 ** 30:.2f} GiB "
        f"a device, fits 80 GiB {rec['fits_hbm']}, dominant "
        f"{rec['roofline']['dominant']}")
    return rec


def phase_examples(timed, transformer, inception, backends, layers, ops,
                   bsm, qm, fa, card, host, t11, dev) -> tuple:
    """Phase 12: three examples of ``repro_torch.examples`` in this process
    on the card, through their functions, at the reference examples'
    sizes; then the wait for ``multipod_dryrun`` (started by phase 11
    among ``host``'s dry runs; ``t11`` is phase 11's start).  Returns the
    kernel launches by kernel and the largest difference of a served
    attention call from the plain version."""
    from repro_torch.examples import quickstart, serve_quantized, train_lm
    t0 = time.perf_counter()
    _fresh_card(dev)
    q = timed("ex-quickstart", phase_ex_quickstart, quickstart, bsm, qm, dev)
    nc = timed("ex-serve-nc", phase_ex_serve_nc, serve_quantized, inception,
               backends, ops, bsm, dev)
    lm = timed("ex-serve-lm", phase_ex_serve_lm, serve_quantized,
               transformer, layers, fa, dev)
    _fresh_card(dev)
    tr = timed("ex-train", phase_ex_train, train_lm, fa,
               train_lm.example_config(), EX_TRAIN_STEPS, *EX_TRAIN_SHAPE,
               ROOT / "build" / "train_lm-smoke", dev)
    timed("ex-dryrun", phase_ex_dryrun, host, ROOT / "build" / "dryrun", t11)
    wall = time.perf_counter() - t0
    launches = {"bitserial_matmul": q["bitserial_matmul"]
                + nc["bitserial_matmul"],
                "quant_matmul": q["quant_matmul"],
                "flash_attention": lm["flash_attention"]}
    log(f"[examples] on {card}: phase wall {wall:.1f} s; serve-nc "
        f"{nc['wall_s']:.3f} s for {EX_NC_REQUESTS} images; serve-lm tok/s "
        f"{ {t: round(v, 1) for t, v in lm['tok_s'].items()} }; train_lm "
        f"{tr['step_s']:.4f} s a step, {tr['tok_s']:.0f} tokens/s; kernel "
        f"launches {launches}")
    return launches, lm["worst"]


# ---------------------------------------------------------------------------
# paper: the paper's evaluation (phase 13)
# ---------------------------------------------------------------------------
PAPER_LINES = 65  # the paper_repro example's lines, the reference's count
# headline rows of the example, as the reference prints them (modeled
# Xeon-cache times and the paper's baselines, not the card's)
PAPER_HEADLINES = (
    "  fig13/TOTAL,4722.8920,sum over layers",
    "  fig15/speedup_vs_cpu,0.0000,18.3x (paper 18.3x)",
    "  fig15/speedup_vs_gpu,0.0000,7.7x (paper 7.7x)",
    "  fig16/vs_cpu,0.0000,12.6x (paper 12.4x)",
    "  fig16/vs_gpu,0.0000,2.2x (paper 2.2x)",
    "  tab4/35MB,4722.8920,4.72 ms (paper 4.72)",
    "  tab4/45MB,4203.4117,4.20 ms (paper 4.12)",
    "  tab4/60MB,3811.1384,3.81 ms (paper 3.79)",
)
# sched_breakdown rows printed (the rest are per block)
SCHED_PRINTED = ("sched13/TOTAL", "sched13/throughput_shape",
                 "sparsity/TOTAL", "compression/", "overlap/TOTAL",
                 "overlap/measured_b4", "slo/calibration", "slo/batch_for")


def _inception_params(inception, cfg, dev):
    """Phase 4's seeded Inception weights (drawn on the CPU, so a seed
    gives the same weights on every device)."""
    return inception.init_params(torch.Generator().manual_seed(0),
                                 config=cfg, device=dev)


def phase_paper_repro(paper_repro, dev) -> list:
    """The ``paper_repro`` example's command line in this process: its
    lines printed, their count and the headline rows held."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = paper_repro.main(["--device", str(dev)])
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"[paper-repro] {line}")
    if rc != 0 or len(lines) != PAPER_LINES:
        raise AssertionError(f"paper_repro: exit {rc}, {len(lines)} lines, "
                             f"want 0 and {PAPER_LINES}")
    missing = [h for h in PAPER_HEADLINES if h not in lines]
    if missing:
        raise AssertionError(f"paper_repro: headline rows off the "
                             f"reference's: {missing}")
    return lines


def phase_lm_nc(lm_neural_cache, registry) -> list:
    """One modeled ``lm_neural_cache`` row per registered arch."""
    rows = lm_neural_cache.run()
    for r in rows:
        log(f"[lm-nc] {r}")
    names = [r.split(",", 1)[0] for r in rows]
    if names != [f"lm_nc/{a}" for a in registry]:
        raise AssertionError(f"lm_nc rows {names}")
    return rows


def phase_sched(sched_breakdown, ops, bsm, card, dev) -> int:
    """``sched_breakdown`` with its two measured inputs taken on the card
    (every wall printed beside it) and every gate held; the logits of each
    measuring forward (dense and sparse calibration, serial and overlapped
    stem) byte-identical to the same forward through the plain versions.
    Returns the bit-serial kernel's launches in the measuring forwards."""
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    kernel = {}
    cal_walls = sched_breakdown.calibration_walls(dev, logits=kernel)
    serial, overlapped = sched_breakdown.measure_overlap(dev, logits=kernel)
    launches = bsm.bitserial_matmul.launches
    _minmax_take("sched", dev)  # reduced widths
    _requant_take("sched", dev)  # reduced widths
    cal = min(cal_walls["dense"])
    ws, wo, spread = sched_breakdown.overlap_gate(serial, overlapped)
    log(f"[sched] on {card}: calibration wall {cal:.4f} s (batch-4 "
        f"reduced_config(), 50% of filters pruned, min of the dense walls "
        f"{[round(w, 4) for w in cal_walls['dense']]} s, in turns with the "
        f"sparse schedule's {[round(w, 4) for w in cal_walls['sparse']]} s)")
    log(f"[sched] on {card}: overlap pair (batch-4 reduced stem, 1/4-scale "
        f"array, in turns) serial {[round(w, 4) for w in serial]} s, "
        f"overlapped {[round(w, 4) for w in overlapped]} s; medians "
        f"{ws:.4f} / {wo:.4f} s, spread {spread:.4f} s; bitserial_matmul "
        f"launches {launches}")
    if launches == 0:
        raise AssertionError("sched: the measuring forwards launched no "
                             "kernel")
    forwards = {**sched_breakdown.calibration_case(dev),
                **sched_breakdown.overlap_case(dev)}
    saved = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = _exact_plain(bsm)
    try:
        plain = {name: forward()[0] for name, forward in forwards.items()}
    finally:
        ops.bitserial_matmul_exact = saved
    if bsm.bitserial_matmul.launches != launches:
        raise AssertionError("sched: the plain forwards launched the kernel")
    for name, logits in plain.items():
        if not bits_equal(logits, kernel[name]):
            raise AssertionError(f"sched: the {name} forward's logits differ "
                                 f"from the plain versions' forward")
    log(f"[sched] the {sorted(plain)} forwards' logits byte-identical to "
        f"the same forwards through the plain versions")
    rows = sched_breakdown.run(device=dev, calibration_wall_s=cal,
                               overlap_walls=(serial, overlapped))
    for r in rows:
        if r.startswith(SCHED_PRINTED):
            log(f"[sched] {r}")
    emulated = [r for r in rows if r.split(",", 1)[0].endswith("_emulated")]
    if len(emulated) != len(sched_breakdown.SLO_BUDGETS_EMU_S):
        raise AssertionError(f"sched: {len(emulated)} emulation SLO rows")
    return launches


def phase_replay(traffic_replay, serve, inception, ops, bsm, params,
                 images, served, dev, cfg) -> int:
    """``run_quick()``, then the real fleet at ``cfg``'s width on phase 4's
    images and weights: every routed logit row byte-identical to phase 4's
    ``served`` (by ``_real_fleet_bitidentity``), and ``served`` reproduced
    byte for byte by one forward of all the images with the kernels swapped
    for their plain versions.  Each forward makes the same GEMMs whatever
    its batch and array, so the fleet's launches must be the plain
    forward's GEMM count times the batches the sockets ran.  Returns the
    fleet's bit-serial kernel launches."""
    for r in traffic_replay.run_quick():
        log(f"[replay] {r}")
    bsm.bitserial_matmul.launches = 0
    _minmax().launches = 0
    _requant().launches = 0
    stats = {}
    line = traffic_replay._real_fleet_bitidentity(
        params, cfg, images, served, device=dev, stats=stats)
    launches = bsm.bitserial_matmul.launches
    _minmax_take("replay", dev, sum(stats["forwards"].values()))
    _requant_take("replay", dev, sum(stats["forwards"].values()))
    x = torch.from_numpy(np.stack(images)).to(dev)
    saved = ops.bitserial_matmul_exact
    ops.bitserial_matmul_exact = exact = _exact_plain(bsm)
    try:
        plain, _ = inception.nc_forward(params, x, config=cfg, device=dev)
    finally:
        ops.bitserial_matmul_exact = saved
    if bsm.bitserial_matmul.launches != launches:
        raise AssertionError("replay: the plain forward launched the kernel")
    per_socket = {n: exact.calls * b for n, b in stats["forwards"].items()}
    log(f"[replay] {line}; config {cfg.name}; batches by socket "
        f"{stats['forwards']}, dispatched {stats['dispatched']}; "
        f"bitserial_matmul launches {launches} = {exact.calls} GEMMs a "
        f"forward x {sum(stats['forwards'].values())} batches "
        f"({per_socket} by socket)")
    if launches == 0 or sum(per_socket.values()) != launches:
        raise AssertionError(f"replay: fleet launches {launches}, want "
                             f"{per_socket}")
    for i in range(len(images)):
        if not bits_equal(plain[i], served[i]):
            raise AssertionError(f"replay: image {i}: phase 4's served "
                                 f"logits differ from the plain versions' "
                                 f"forward")
    log(f"[replay] phase 4's {len(images)} served logit rows byte-identical "
        f"to one batch-{len(images)} forward through the plain versions")
    return launches


def phase_paper(timed, inception, serve, ops, bsm, card, images, served,
                dev, cfg) -> int:
    """Phase 13: the paper's evaluation on the port.  Returns the
    bit-serial kernel's launches (the measuring forwards and the real
    fleet)."""
    from repro_torch.benchmarks import (lm_neural_cache, sched_breakdown,
                                        traffic_replay)
    from repro_torch.configs import REGISTRY
    from repro_torch.examples import paper_repro
    t0 = time.perf_counter()
    _fresh_card(dev)
    timed("paper-repro", phase_paper_repro, paper_repro, dev)
    timed("lm-nc", phase_lm_nc, lm_neural_cache, REGISTRY)
    sched = timed("sched", phase_sched, sched_breakdown, ops, bsm, card,
                  dev)
    params = _inception_params(inception, cfg, dev)
    fleet = timed("replay", phase_replay, traffic_replay, serve, inception,
                  ops, bsm, params, images, served, dev, cfg)
    log(f"[paper] on {card}: phase wall {time.perf_counter() - t0:.1f} s; "
        f"bitserial_matmul launches: sched {sched}, real fleet {fleet}")
    return sched + fleet


def phase_registers(cuda_build):
    """Each kernel's registers a thread and spill bytes over its entry
    functions (template instantiations), from the build's ``-Xptxas -v``
    report."""
    for name in KERNELS:
        report = cuda_build.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
        if not regs:
            raise AssertionError(f"{name}: no register report in the build "
                                 f"log")
        log(f"[time] {name}: {len(regs)} entry functions, {min(regs)}-"
            f"{max(regs)} registers a thread, {sum(spills)} bytes spilled")


def _kernel_entry(name, source, replaces, launches, worst, rows):
    """One entry of the kernels line; times and bound summed over the
    kernel's shapes (``rows``)."""
    total = {k: sum(r[k] for r in rows) for k in
             ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
              "ops_ms")}
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": worst,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if total["bytes_ms"] > total["ops_ms"]
                     else "operations"),
        "library_ms": total["library_ms"],
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import backends, bitserial, cache_geometry, faults
    from repro_torch.core import nc_layers, quantize
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import minmax_rows as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import requant_rows as rq
    from repro_torch.launch import orchestrator, serve
    from repro_torch.models import frontends, inception, layers, moe
    from repro_torch.models import transformer
    from repro_torch.quant import ptq

    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        log(f"[wall] {name}: {walls[name]:.1f} s")
        return out

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    timed("build", cuda_build.build_all)
    for name in KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] flash_attention tiles (query rows, keys, K/V ring depth): "
        f"bf16 {fa.kernel_tiles(torch.bfloat16)}, float32 "
        f"{fa.kernel_tiles(torch.float32)}")
    worst = timed("kernel", phase_kernel, bsm, dev)
    worst_a4 = timed("kernel-a4", phase_kernel_a4, bsm, dev)
    worst_qm = timed("kernel-qm", phase_quant_kernel, qm, dev)
    worst_fa = max(timed("kernel-fa", phase_flash_kernel, fa, dev))
    worst_fa = max(worst_fa, *timed("kernel-fa-families",
                                    phase_flash_family_shapes, fa, dev))
    worst_mm = timed("kernel-minmax", phase_minmax, inception, mm, dev)
    worst_rq = timed("kernel-requant", phase_requant, inception, rq, dev)
    cfg = inception.FULL
    params = _inception_params(inception, cfg, dev)
    rng = np.random.default_rng(0)
    images = [rng.random((cfg.img, cfg.img, 3), dtype=np.float32)
              for _ in range(4)]
    launches, _, served = timed("serve", phase_serve, inception, serve,
                                backends, bsm, params, images, dev, cfg)
    launches_a4 = timed("4-bit", phase_four_bit, nc_layers, quantize, ops,
                        backends, bsm, dev)
    faulted_wall, reexec = timed(
        "faults", phase_faulted_serve, inception, serve, faults, nc_layers,
        backends, bsm, params, images[:B], served, dev, cfg)
    x = torch.from_numpy(np.stack(images[:B])).to(dev)
    t_forward, wpack = timed("forward", phase_plain_forward, inception, ops,
                             bsm, mm, params, x, dev, cfg)
    log(f"[faults] checked, compressed, faulted batch-{B} serving "
        f"{faulted_wall:.2f} s against the clean batch-{B} forward "
        f"{t_forward:.2f} s ({reexec} passes re-run)")
    timed("split", phase_split, inception, params, x, wpack, dev, cfg)
    timed("inception-quant", phase_inception_quant, inception, params, x,
          served, cfg)
    launches_chunk = timed("stream-chunk", phase_stream_chunk, inception,
                           bsm, params, x, served, t_forward, dev, cfg)
    launches_fleet = timed("fleet", phase_fleet, serve, orchestrator,
                           cache_geometry, bsm, params, images, served, dev,
                           cfg)
    dot8, dot4 = timed("bitserial-ops", phase_bitserial_ops, inception,
                       nc_layers, bitserial, backends, cache_geometry, bsm,
                       params, images[0], dev, cfg)
    log(f"[serve] bitserial_matmul launches by path: serve {launches}, "
        f"stream-chunk {launches_chunk}, fleet {launches_fleet}, nc_dot "
        f"{dot8}; bitserial_matmul_a4: 4-bit {launches_a4}, nc_dot {dot4}")
    launches += launches_chunk + launches_fleet + dot8
    launches_a4 += dot4
    del params, wpack, x  # phase 13 draws the weights again
    lm_cfg = get_config(LM_ARCH)
    lm_params = timed("lm-init", lambda: transformer.init_lm(
        lm_cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    prompts = _lm_prompts(lm_cfg.vocab_size)
    lm_record = {}
    launches_fa, _, worst_served = timed(
        "lm-serve", phase_lm_serve, transformer, serve, ops, fa, lm_cfg,
        lm_params, prompts, dev, lm_record)
    worst_fa = max(worst_fa, worst_served)
    fa_by_path = {LM_ARCH: launches_fa}
    fa_by_path[f"{LM_ARCH} kv8"], worst_served = timed(
        "lm-kv8", phase_kv8, transformer, layers, serve, ops, fa, lm_cfg,
        lm_params, prompts, lm_record, dev)
    worst_fa = max(worst_fa, worst_served)
    del lm_record
    launches_qm = timed("lm-ptq", phase_lm_ptq, transformer, layers, ptq,
                        ops, qm, bsm, lm_cfg, lm_params, prompts, dev)
    del lm_params
    for arch, keep_layers in LM_FAMILIES:
        by_run, w = timed(f"lm-{arch}", phase_lm_family, transformer, layers,
                          serve, ops, fa, moe, frontends, get_config, arch,
                          keep_layers, dev)
        fa_by_path.update(by_run)
        worst_fa = max(worst_fa, w)
    log(f"[lm-families] flash_attention launches by served model: "
        f"{fa_by_path}")
    launches_fa = sum(fa_by_path.values())
    trained = phase_training(timed, get_config, transformer,
                             ROOT / "build" / "train-ckpt", dev)
    host, t11 = [], time.perf_counter()
    try:
        fa_by_path[f"{LM_ARCH} sharded prefill"] = timed(
            "distributed", phase_distributed, timed, get_config,
            transformer, trained, host, dev)
        examples, worst_ex = timed(
            "examples", phase_examples, timed, transformer, inception,
            backends, layers, ops, bsm, qm, fa, card, host, t11, dev)
    finally:
        _stop(host)
    worst_fa = max(worst_fa, worst_ex)
    fa_by_path["examples"] = examples["flash_attention"]
    launches_fa = sum(fa_by_path.values())
    log(f"[examples] launches added to the kernels line: {examples}; "
        f"before them bitserial_matmul {launches}, quant_matmul "
        f"{launches_qm}, flash_attention "
        f"{launches_fa - examples['flash_attention']}")
    launches += examples["bitserial_matmul"]
    launches_qm += examples["quant_matmul"]
    launches_paper = timed("paper", phase_paper, timed, inception, serve,
                           ops, bsm, card, images, served, dev, cfg)
    log(f"[paper] bitserial_matmul launches added to the kernels line: "
        f"{launches_paper}; before them {launches}")
    launches += launches_paper
    del served
    rows = timed("times", phase_times, bsm, dev)
    rows_a4 = timed("times-a4", phase_times_a4, bsm, dev)
    rows_qm = timed("times-qm", phase_times_quant, qm, dev)
    rows_fa = timed("times-fa", phase_times_flash, fa, dev)
    rows_fam = timed("times-fa-families", phase_times_flash, fa, dev,
                     FA_FAMILY_SERVED, "time-fa-families")
    log(f"[time-fa-families] sums (not in the kernels line): kernel "
        f"{sum(r['ms'] for r in rows_fam):.4f} ms, SDPA "
        f"{sum(r['library_ms'] for r in rows_fam):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in rows_fam):.5f} ms")
    timed("times-ptq4", phase_times_ptq4, bsm, dev)
    launches_mm = sum(MINMAX_BY_PATH.values())
    log(f"[minmax] minmax_rows launches by main-path run: {MINMAX_BY_PATH} "
        f"(total {launches_mm})")
    rows_mm = timed("times-minmax", phase_times_minmax, inception, mm, dev)
    launches_rq = sum(REQUANT_BY_PATH.values())
    log(f"[requant] requant_rows launches by main-path run: "
        f"{REQUANT_BY_PATH} (total {launches_rq})")
    rows_rq = timed("times-requant", phase_times_requant, inception, rq, dev)
    phase_registers(cuda_build)
    kernels = [
        _kernel_entry("bitserial_matmul",
                      "src/repro_torch/csrc/bitserial_gemm.cu",
                      "src/repro/kernels/bitserial_matmul.py:148",
                      launches, worst, rows),
        _kernel_entry("bitserial_matmul_a4",
                      "src/repro_torch/csrc/bitserial_gemm_a4.cu",
                      "src/repro/kernels/bitserial_matmul.py:219",
                      launches_a4, worst_a4, rows_a4),
        _kernel_entry("quant_matmul", "src/repro_torch/csrc/quant_gemm.cu",
                      "src/repro/kernels/quant_matmul.py:52",
                      launches_qm, worst_qm, rows_qm),
        _kernel_entry("flash_attention",
                      "src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:88",
                      launches_fa, worst_fa, rows_fa),
        _kernel_entry("minmax_rows", "src/repro_torch/csrc/minmax_rows.cu",
                      None, launches_mm, worst_mm, rows_mm),
        _kernel_entry("requant_rows", "src/repro_torch/csrc/requant_rows.cu",
                      None, launches_rq, worst_rq, rows_rq),
    ]
    log(f"[wall] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
