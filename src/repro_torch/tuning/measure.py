"""Measurement harness: candidate timing on the card, the analytic
surrogate on the CPU.

A copy of the reference's ``repro.tuning.measure`` for the port's Hopper
kernels.  One candidate is one fused ``KernelChoice`` (implementation +
block targets) at one op-shape context; ``measure_candidate`` returns the
latency the tuner scores it with and where that number came from:

  * On a card the candidate's kernel family is launched in isolation
    through a per-family driver that draws operands at the config's
    widths and dtype (``torch.Generator(device).manual_seed(0)``) and
    times it with CUDA events, the median of ``REPS`` launches after
    ``WARMUP`` (``source="measured"``).  The card spins first while the
    host queues every timed launch, each behind a write of ``FLUSH_BYTES``
    that evicts the L2: an event pair then times the kernel alone, not the
    host's launch overhead, on cold weights as the model finds them.  A failed build, launch or
    allocation raises: there is no fallback to the surrogate (the
    reference's ``except Exception`` is not carried over).  The cases a
    CUDA build refuses never get here: the tuner prunes them with the
    kernel lint's ``unsupported-case`` first.
  * On the CPU the wall-clock of the plain versions says nothing about
    the card, so the harness returns ``analytic_estimate``, a
    block-sensitive surrogate (``source="analytic"``), unless ``force``:
    forcing times the plain versions, the counterpart of timing the
    reference's interpreter.

The surrogate is the reference's, verbatim (the TPU's 128-lane padding of
the head dim included), so that CPU-tuned plans equal the reference's on
the same platform constants.  Families without a driver (the paged decode
and verify kernels, whose operands are pool and page-table state, and the
MoE / SSD / wkv mixers) keep the surrogate on the card too, as in the
reference, and say so in the source they return.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.itensor import dtype_bytes
from ..core.platforms import Platform
from ..core.stream_plan import LANE, KernelChoice, StreamPlan
from ..kernels.common import DeviceLike, pick_block, resolve_device, round_up

# Median-of-k protocol: one warmup launch absorbs the build and the first
# allocation, then k timed launches; the median is robust to a stray
# scheduling hiccup.
WARMUP = 1
REPS = 5
# Card-side timing: the L2 (50 MB on the H100) rewritten before each
# launch, and the card held (``torch.cuda._sleep``, in clock cycles: about
# 2 ms) while the host queues the launches.
FLUSH_BYTES = 64 << 20
HOLD_CYCLES = 4_000_000

# Pipeline-fill overhead charged per grid step by the surrogate: the
# same fixed stage-fill depth ``Platform.kernel_timing`` models.
_PIPELINE_DEPTH = 32.0
# The families with a driver (timed on the card): K3, K5, K7, K4/K6, K11.
DRIVEN = ("rmsnorm_matmul", "block_matmul", "flash_attention",
          "streamed_ffn", "streamed_mlp", "streamed_xent")


def measure(fn: Callable[[], object], device: DeviceLike = None, *,
            reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median seconds of ``reps`` calls of ``fn`` after ``warmup`` calls:
    CUDA events around each call on a card (``device`` None is the card;
    the L2 flushed before each call, every call queued behind a spin so
    that the events time the card), ``time.perf_counter`` on the CPU."""
    dev = resolve_device(device)
    for _ in range(max(0, warmup)):
        fn()
    samples = []
    if dev.type == "cuda":
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(HOLD_CYCLES)
        events = []
        for _ in range(max(1, reps)):
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize(dev)
        samples = [a.elapsed_time(b) * 1e-3 for a, b in events]
    else:
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    return float(statistics.median(samples))


def _eff(extent: int, target: int) -> int:
    """Effective block after the reference wrapper's ``pick_block`` clip."""
    return pick_block(max(1, int(extent)), max(1, int(target)))


def _cdiv(a: int, b: int) -> int:
    return -(-int(a) // max(1, int(b)))


def analytic_estimate(cfg: ModelConfig, plan: StreamPlan, stage: str,
                      choice: KernelChoice, platform: Platform) -> float:
    """Block-sensitive latency surrogate for one candidate (seconds).

    roofline(flops, streamed bytes) + grid_steps * pipeline fill.  The
    streamed-bytes term restreams the stage's weights once per token
    block, so the argmin over a candidate lattice is meaningful even
    though the absolute number is a model, not a measurement.
    """
    impl = choice.implementation
    dt = dtype_bytes(cfg.dtype)
    t = max(1, plan.tokens)
    s = max(1, plan.kv_len)
    d = cfg.d_model
    flops = 0.0
    stream = 0.0
    steps = 1

    if impl in ("rmsnorm_matmul", "block_matmul"):
        n = max(1, min(cfg.q_dim, cfg.kv_dim))
        bt = _eff(t, choice.block("block_t", t))
        bn = _eff(n, choice.block("block_n", n))
        restreams = _cdiv(t, bt)
        steps = restreams * _cdiv(n, bn)
        flops = 2.0 * t * d * n
        stream = restreams * d * n * dt + t * d * dt
    elif impl in ("streamed_ffn", "streamed_mlp"):
        f = max(1, cfg.d_ff)
        mats = 3 if impl == "streamed_ffn" else 2
        bt = _eff(t, choice.block("block_t", t))
        bf = _eff(f, choice.block("block_f", f))
        restreams = _cdiv(t, bt)
        steps = restreams * _cdiv(f, bf)
        flops = 2.0 * mats * t * d * f
        stream = restreams * mats * d * f * dt + t * d * dt
    elif impl == "moe_experts":
        f = max(1, cfg.d_ff)
        e = max(1, cfg.num_experts)
        bt = _eff(t, choice.block("block_t", t))
        restreams = _cdiv(t, bt)
        steps = restreams * e
        flops = 2.0 * 3 * t * d * f
        stream = restreams * 3 * d * f * e * dt + t * d * dt
    elif impl == "flash_attention":
        dp = round_up(max(1, cfg.head_dim_), LANE)
        h = max(1, cfg.num_heads)
        bq = _eff(t, choice.block("block_q", t))
        bkv = _eff(s, choice.block("block_kv", s))
        qb = _cdiv(t, bq)
        steps = h * qb * _cdiv(s, bkv)
        flops = 4.0 * h * t * s * dp
        stream = qb * 2.0 * h * s * dp * dt + h * t * dp * dt
    elif impl in ("paged_attention", "verify_attention"):
        dp = round_up(max(1, cfg.head_dim_), LANE)
        hkv = max(1, cfg.num_kv_heads)
        ps = max(1, choice.block("page_size", 16))
        steps = hkv * _cdiv(s, ps)
        flops = 4.0 * max(1, cfg.num_heads) * s * dp
        stream = 2.0 * hkv * s * dp * dt
    elif impl in ("mamba2_scan", "rwkv6_wkv"):
        # Chunked recurrences: within-chunk work is quadratic in the
        # chunk length while the sequential state carry costs one
        # pipeline fill per chunk.
        width = max(1, cfg.d_inner if impl == "mamba2_scan" else d)
        q = _eff(t, choice.block("chunk", t))
        steps = _cdiv(t, q)
        flops = 4.0 * t * q * width
        stream = 2.0 * t * width * dt
    elif impl == "streamed_xent":
        v = max(1, cfg.vocab_size)
        bt = _eff(t, choice.block("block_t", t))
        bv = _eff(v, choice.block("block_v", v))
        restreams = _cdiv(t, bt)
        steps = restreams * _cdiv(v, bv)
        flops = 2.0 * t * d * v
        stream = restreams * d * v * dt + t * d * dt
    else:
        # Unknown family: a flat (block-insensitive) floor; the tuner
        # keeps the original choice on ties.
        flops = 2.0 * t * d * d
        stream = t * d * dt

    roofline = max(flops / platform.peak_flops, stream / platform.hbm_bw)
    return roofline + steps * (_PIPELINE_DEPTH / platform.freq_hz)


# --------------------------------------------------------------------- #
# Isolation drivers: operands at the config's widths, one call of the
# stage's kernel wrapper.
# --------------------------------------------------------------------- #

def _driver(cfg: ModelConfig, plan: StreamPlan, stage: str,
            choice: KernelChoice, device: torch.device
            ) -> Optional[Callable[[], object]]:
    """A zero-argument call of the candidate's kernel wrapper on operands
    drawn on ``device`` at the reference driver's shapes
    (``repro/tuning/measure.py:181-244``), or None when the family has no
    driver (paged, verify, MoE, SSD, wkv: the surrogate scores them).
    The call takes the config's activation and the norm folded in where
    the choice says so (the cases the card builds); a ``w8`` stage is
    timed as its full-precision kernel, as in the reference."""
    from .. import kernels as K

    impl = choice.implementation
    if impl not in DRIVEN:
        return None     # paged / verify / moe / ssm / rwkv: the surrogate
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    t = max(1, plan.tokens)
    s = max(1, plan.kv_len)
    d = cfg.d_model
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    if impl in ("rmsnorm_matmul", "block_matmul"):
        n = max(1, min(cfg.q_dim, cfg.kv_dim))
        x, w = rand(t, d), rand(d, n)
        if impl == "block_matmul":
            return lambda: K.block_matmul(x, w)
        scale = torch.ones((d,), dtype=dtype, device=device)
        return lambda: K.rmsnorm_matmul(x, scale, w)

    if impl == "flash_attention":
        hq = max(1, cfg.num_heads)
        hkv = max(1, cfg.num_kv_heads)
        dp = max(1, cfg.head_dim_)
        q, k, v = rand(hq, t, dp), rand(hkv, s, dp), rand(hkv, s, dp)
        bkv = choice.block("block_kv", 512)
        return lambda: K.flash_attention_2d(
            q, k, v, causal=True, kv_group=hq // hkv, block_kv=bkv)

    if impl in ("streamed_ffn", "streamed_mlp"):
        f = max(1, cfg.d_ff)
        x, wu, wd = rand(t, d), rand(d, f), rand(f, d)
        norm = (torch.ones((d,), dtype=dtype, device=device)
                if choice.block("fuse_norm") else None)
        act = cfg.activation
        if impl == "streamed_ffn":
            wg = rand(d, f)
            return lambda: K.streamed_ffn(x, wg, wu, wd, activation=act,
                                          norm_scale=norm)
        return lambda: K.streamed_mlp(x, wu, wd, activation=act,
                                      norm_scale=norm)

    v = max(1, cfg.vocab_size)             # streamed_xent
    hid, head = rand(t, d), rand(d, v)
    labels = torch.randint(0, v, (t,), generator=gen, device=device)
    return lambda: K.streamed_xent_loss(hid, head, labels, vocab_size=v)


def measure_candidate(cfg: ModelConfig, plan: StreamPlan, kind: str,
                      stage: str, choice: KernelChoice, *,
                      platform: Platform, device: DeviceLike = None,
                      force: bool = False, reps: int = REPS,
                      warmup: int = WARMUP) -> Tuple[float, str]:
    """Latency for one lint-legal candidate: ``(seconds, source)``.

    On the CPU the surrogate unless ``force`` (which times the plain
    versions); on the card (``device`` None) the driver's CUDA-event
    median.  Nothing here catches a failure: a build, launch or
    allocation that fails raises to the caller.
    """
    dev = resolve_device(device)
    if dev.type == "cpu" and not force:
        return analytic_estimate(cfg, plan, stage, choice, platform), \
            "analytic"
    fn = _driver(cfg, plan, stage, choice, dev)
    if fn is None:
        return analytic_estimate(cfg, plan, stage, choice, platform), \
            "analytic"
    latency = measure(fn, dev, reps=reps, warmup=warmup)
    del fn          # the operands go back to the allocator
    return latency, "measured"
