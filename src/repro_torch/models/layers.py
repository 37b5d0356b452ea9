"""Model layers in PyTorch (functions over parameter dicts).

The eager functions mirror ``repro.models.layers`` — the reference's own
``use_fused_kernels=False`` path — cast for cast: norms and softmax in
float32, matmuls in the compute dtype, attention scores accumulated in
float32.  The ``fused_*`` wrappers reshape model-layout tensors for the
kernels the StreamPlan selected (single device; the sharded dispatch comes
with the distributed slice).

Gradients (``_kernel_fwd_eager_bwd``, the reference's
``_pallas_fwd_eager_bwd``): where an input requires grad and grad mode is
on, a wrapper runs its kernel for the forward value and recomputes the
backward through the eager formulation it replaces, from the saved
inputs; there is no backward kernel, as the reference has none.  A w8
stage's forward quantizes its live weight and runs the int8 twin; its
eager formulation is the reference's straight-through one (``w8_ste``).
Serving runs under ``torch.no_grad()`` and calls the kernel directly,
with no autograd node.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import kernels as K
from ..kernels.ref import NEG_INF, act, wkv6, xent_nll_mean

Params = Dict[str, Any]
# A weight on a w8 stage: the tensor itself (quantized at each call, as the
# reference does) or its cached (int8 codes, float32 scales) pair
# (``params.quantize_weights``).
W8Weight = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


# --------------------------------------------------------------------- #
# Dispatch effect signatures (static analysis, ``analysis/effects.py``)
# --------------------------------------------------------------------- #
# Declarative read/write effects of the serving engine's dispatches over
# the cache they update, as the reference declares them
# (``repro/models/layers.py:79-135``): the facts the alias checker verifies
# without running anything.  One entry per dispatch; ops in program order.
# The port runs no donated jit programs: "donated" reads as "written in
# place", and a read of such a buffer's pre-dispatch contents after an
# in-place write to it is the same bug.  Op fields:
#
#   reads          buffers read wherever they currently are;
#   reads_initial  buffers whose pre-dispatch state the op needs;
#   writes         buffers the op updates in place;
#   page_indexed   the write scatters through the page table: it must set
#                  null_routed (dead rows land on ``kv_cache.NULL_PAGE``)
#                  and, under a KV quant mode, updates_scales (the
#                  per-page scale rows move with the codes);
#   cow            copy-on-write: pool page ``src`` duplicated onto ``dst``
#                  before any scatter; ``fresh_dst`` declares that dst is a
#                  freshly allocated private page.
#
# The declarations follow serving/engine.py (``_admit``,
# ``_dispatch_chunk``, ``_decode_block``, ``_speculative_block``) and
# models/model.py.  Every op order is the reference's but one:
# ``prefill_chunk`` has no copy-on-write step.  The reference's chunk
# program carries one, always fed NULL pages by its engine; the port's
# engine makes each pending copy in ``_copy_on_write`` before the next
# decode or verify dispatch, and ``prefill_chunk`` takes no such operands.
DISPATCH_EFFECTS: Dict[str, Dict[str, Any]] = {
    "prefill": {
        "donated": ("slot_cache",),
        "ops": (
            {"name": "model_prefill", "reads": ("params", "tokens"),
             "writes": ("fresh",)},
            # ``kv_cache.place_prefill``: the slot's own pages only.
            {"name": "place_prefill", "reads": ("fresh", "pages"),
             "writes": ("slot_cache",), "page_indexed": True,
             "null_routed": True, "updates_scales": True},
        ),
    },
    "prefill_chunk": {
        "donated": ("slot_cache",),
        "ops": (
            {"name": "chunk_scatter",
             "reads": ("params", "tokens", "table_row", "chunk_pages",
                       "slot_cache"),
             "writes": ("slot_cache",), "page_indexed": True,
             "null_routed": True, "updates_scales": True},
        ),
    },
    "decode": {
        "donated": ("cache",),
        "ops": (
            # ``ServingEngine._copy_on_write`` before the block's steps.
            {"name": "cow_copy",
             "reads_initial": ("cache",), "writes": ("cache",),
             "page_indexed": True, "null_routed": True,
             "updates_scales": True,
             "cow": {"src": "cow_src", "dst": "cow_dst",
                     "fresh_dst": True}},
            {"name": "decode_scan",
             "reads": ("params", "tok", "cache", "table"),
             "writes": ("cache",), "page_indexed": True,
             "null_routed": True, "updates_scales": True},
        ),
    },
    "verify": {
        "donated": ("cache",),
        "ops": (
            {"name": "cow_copy",
             "reads_initial": ("cache",), "writes": ("cache",),
             "page_indexed": True, "null_routed": True,
             "updates_scales": True,
             "cow": {"src": "cow_src", "dst": "cow_dst",
                     "fresh_dst": True}},
            {"name": "verify_window",
             "reads": ("params", "toks", "cache", "table"),
             "writes": ("cache",), "page_indexed": True,
             "null_routed": True, "updates_scales": True},
        ),
    },
}


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Raw ``y * scale + bias`` (not ``1 + scale``), population variance
    (``layers.py:195``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Params) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# --------------------------------------------------------------------- #
# Weight-only int8 (DESIGN.md §14)
# --------------------------------------------------------------------- #

def quantize_channelwise(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 (``layers.py:216``): w [D, N] ->
    (codes int8, scales [N] float32 = amax|column| / 127).  An all-zero
    column encodes to zero codes with scale 0."""
    w32 = w.float()
    scales = w32.abs().amax(dim=0) / 127.0
    safe = torch.where(scales > 0.0, scales, 1.0)
    codes = torch.clamp(torch.round(w32 / safe), -127.0, 127.0)
    return codes.to(torch.int8), scales


def dequantize_channelwise(codes: torch.Tensor, scales: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scales[None, :]).to(dtype)


def w8_ste(w: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (``_w8_ste``,
    ``layers.py:233``): the value carries the int8 rounding, the gradient
    passes through as if ``w`` were untouched."""
    wq = dequantize_channelwise(*quantize_channelwise(w), w.dtype)
    return w + (wq - w).detach()


def w8_codes(w: W8Weight) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, scales) of a w8 stage's weight, cached or quantized now."""
    return w if isinstance(w, tuple) else quantize_channelwise(w)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] -> rotate-half RoPE, float32 angles."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs               # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# M-RoPE (Qwen2-VL, ``layers.py:265``): the rotary half dim is cut into
# (temporal, height, width) sections, each rotated by its own position
# stream; fractions of the half dim, the last section takes the remainder.
MROPE_SECTIONS = (2, 1, 1)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """x [B, S, H, D]; positions [3, B, S] (temporal, height, width) ->
    rotate-half RoPE with each section's angles from its own axis, float32
    angles.  With the three axes equal it is ``apply_rope``."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    total = sum(MROPE_SECTIONS)
    sizes = [half * s // total for s in MROPE_SECTIONS]
    sizes[-1] = half - sum(sizes[:-1])
    parts, start = [], 0
    for sec, size in enumerate(sizes):
        parts.append(positions[sec][..., None].float()
                     * freqs[start:start + size])
        start += size
    angles = torch.cat(parts, dim=-1)                           # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_positional(kind: str, x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    if kind == "rope":
        return apply_rope(x, positions, theta)
    if kind == "mrope":
        return apply_mrope(x, positions, theta)
    if kind == "none":               # learned positions, added at the embed
        return x
    raise NotImplementedError(f"positional encoding {kind!r} is not ported")


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        window: int = 0, chunk_size: int = 1024,
                        kv_len: Optional[int] = None,
                        scale: Optional[float] = None,
                        remat_chunk: bool = False) -> torch.Tensor:
    """Chunked online-softmax attention (``layers.py:313``).

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D]; query i at position
    ``q_offset + i``; keys at or past ``kv_len`` masked -> [B, Sq, Hq, D].
    ``remat_chunk`` recomputes each chunk's scores in the backward
    (``torch.utils.checkpoint`` per chunk, the reference's
    ``jax.checkpoint(step)``, ``layers.py:385``) instead of keeping them.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    kv_len = skv if kv_len is None else kv_len
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q * sc).reshape(b, sq, hkv, g, d).float()
    c = min(chunk_size, skv)
    if skv % c:
        pad = c - skv % c
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nc = k.shape[1] // c
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)

    def step(m, l, acc, kb, vb, ci):
        kv_pos = ci * c + torch.arange(c, device=q.device)
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kb.float())
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, c), dtype=torch.bool, device=q.device)
        mask = mask & (kv_pos[None, :] < kv_len)
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        return m_new, l, acc * corr[..., None] + pv

    for ci in range(nc):
        kb = k[:, ci * c:(ci + 1) * c]
        vb = v[:, ci * c:(ci + 1) * c]
        if remat_chunk and torch.is_grad_enabled():
            m, l, acc = checkpoint(step, m, l, acc, kb, vb, ci,
                                   use_reentrant=False)
        else:
            m, l, acc = step(m, l, acc, kb, vb, ci)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, remat_chunk: bool = False) -> torch.Tensor:
    """Sliding-window attention over whole sequences (``layers.py:392``):
    ``streaming_attention`` with chunks of ``max(128, min(window, Skv))``
    keys."""
    return streaming_attention(q, k, v, causal=True, window=window,
                               chunk_size=max(128, min(window, k.shape[1])),
                               remat_chunk=remat_chunk)


def _cache_scores(qg: torch.Tensor, k_cache: torch.Tensor,
                  layout: str) -> torch.Tensor:
    """Scores ``[B, Hkv, G, Q, S]`` float32 of grouped queries qg [B, Q,
    Hkv, G, D] against a dense cache.  Under "bshd" (k_cache [B, S, Hkv,
    D]) they accumulate in float32; under "bhsd" (k_cache [B, Hkv, S, D])
    they are emitted in the cache dtype and then widened, as the
    reference's attention-native einsum (``layers.py:421-429``)."""
    if layout == "bhsd":
        s = torch.einsum("bqhgd,bhsd->bhgqs", qg.float(), k_cache.float())
        return s.to(k_cache.dtype).float()
    return torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_cache.float())


def _cache_pv(p: torch.Tensor, v_cache: torch.Tensor,
              layout: str) -> torch.Tensor:
    """p [B, Hkv, G, Q, S] float32 times the dense V cache, in float32 ->
    [B, Q, Hkv, G, D]."""
    eq = "bhgqs,bhsd->bqhgd" if layout == "bhsd" else "bhgqs,bshd->bqhgd"
    return torch.einsum(eq, p, v_cache.float())


def _cache_dims(k_cache: torch.Tensor, layout: str) -> Tuple[int, int]:
    """(S, Hkv) of a dense cache in ``layout``."""
    if layout == "bhsd":
        return k_cache.shape[2], k_cache.shape[1]
    return k_cache.shape[1], k_cache.shape[2]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0, layout: str = "bshd") -> torch.Tensor:
    """One-token attention against a dense cache (``layers.py:403``): q
    [B, 1, Hq, D]; caches [B, S, Hkv, D] ("bshd") or [B, Hkv, S, D]
    ("bhsd"); cache_len [B] valid entries; keys past it, and under a
    ``window`` those ``window`` or more behind it, are masked.  Softmax and
    PV in float32; the scores as ``_cache_scores``."""
    b, _, hq, d = q.shape
    s, hkv = _cache_dims(k_cache, layout)
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, 1, hkv, g, d)
    scores = _cache_scores(qg, k_cache, layout)
    pos = torch.arange(s, device=q.device)
    lens = cache_len.reshape(-1, 1).long()
    valid = pos[None] < lens
    if window:
        valid = valid & (pos[None] >= lens - window)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _cache_pv(p, v_cache, layout)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_off: torch.Tensor, *,
                     window: int = 0, layout: str = "bshd") -> torch.Tensor:
    """W-token speculative-verify attention against a dense cache
    (``layers.py:447``): q [B, W, Hq, D]; caches as ``decode_attention``;
    q_off [B] the position of window row 0, so row i attends to the first
    ``q_off + i + 1`` positions.  The W-row twin of ``decode_attention``
    under the same numerics, so row i computes what ``decode_attention``
    computes at length ``q_off + i + 1``."""
    b, w, hq, d = q.shape
    s, hkv = _cache_dims(k_cache, layout)
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, w, hkv, g, d)
    scores = _cache_scores(qg, k_cache, layout)
    pos = torch.arange(s, device=q.device)
    qlen = (q_off.reshape(-1, 1).long()
            + torch.arange(w, device=q.device)[None] + 1)       # [B, W]
    valid = pos[None, None] < qlen[..., None]                   # [B, W, S]
    if window:
        valid = valid & (pos[None, None] >= qlen[..., None] - window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _cache_pv(p, v_cache, layout)
    return out.reshape(b, w, hq, d).to(q.dtype)


def ffn(x: torch.Tensor, p: Params, *, activation: str,
        gated: bool) -> torch.Tensor:
    if gated:
        return (act(activation, x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return act(activation, x @ p["wu"]) @ p["wd"]


def gates_from_logits(logits: torch.Tensor, top_k: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Renormalised top-k gate weights [..., E] from router logits
    (``layers.py:509-517``): softmax in float32, the k-th largest
    probability as the threshold, every expert at or above it kept (ties
    keep more than k), renormalised with a 1e-9 floor, cast to ``dtype``.
    ``topk`` gives only the threshold value, never indices."""
    probs = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    gates = torch.where(probs >= thresh, probs, 0.0)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates.to(dtype)


def moe_gates(x: torch.Tensor, wr: torch.Tensor,
              top_k: int) -> torch.Tensor:
    """Router: ``x @ wr`` in x's dtype, then ``gates_from_logits``
    (``layers.py:509``)."""
    return gates_from_logits(x @ wr, top_k, x.dtype)


def moe_experts_eager(x: torch.Tensor, gates: torch.Tensor,
                      wg: Optional[torch.Tensor], wu: torch.Tensor,
                      wd: torch.Tensor, *, activation: str) -> torch.Tensor:
    """Every expert on every token, gate-weighted and summed (the
    dense-gather formulation, ``layers.py:533-541``): x [..., D], gates
    [..., E], wg/wu [E, D, F] (wg None: ungated), wd [E, F, D]."""
    up = torch.einsum("...d,edf->...ef", x, wu)
    h = (act(activation, torch.einsum("...d,edf->...ef", x, wg)) * up
         if wg is not None else act(activation, up))
    y = torch.einsum("...ef,efd->...ed", h, wd)
    return torch.einsum("...ed,...e->...d", y, gates)


def moe_ffn(x: torch.Tensor, p: Params, *, activation: str, gated: bool,
            top_k: int) -> torch.Tensor:
    """Dense-gather MoE (``layers.py:520``): the router's gates, then
    ``moe_experts_eager``."""
    return moe_experts_eager(x, moe_gates(x, p["wr"], top_k),
                             p["wg"] if gated else None, p["wu"], p["wd"],
                             activation=activation)


# --------------------------------------------------------------------- #
# Mamba2 (chunked SSD, ``layers.py:545-653``)
# --------------------------------------------------------------------- #

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<k<=i}
    x[..., k], -inf above the diagonal (``layers.py:545``)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
               chunk: int = 128, init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-dual scan (``layers.py:554``): x [B, S, H, P],
    dt [B, S, H] (softplus-ed steps), a_log [H] (A = -exp(a_log)), b/c
    [B, S, N] (one group), d_skip [H], init_state [B, H, P, N] -> (y [B,
    S, H, P] in x's dtype, final state [B, H, P, N] float32).  The
    inter-chunk ``lax.scan`` is a Python loop over the chunks."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must divide by chunk {q}")
    nc = s // q
    a = -torch.exp(a_log.float())                               # [H]
    da = dt.float() * a                                         # [B,S,H]
    xdt = x.float() * dt.float()[..., None]
    dac = da.reshape(bsz, nc, q, h)
    xc = xdt.reshape(bsz, nc, q, h, p)
    bc = b.float().reshape(bsz, nc, q, n)
    cc = c.float().reshape(bsz, nc, q, n)
    # Intra-chunk (diagonal blocks): y_ij = C_i . B_j exp(segsum) x_j.
    l_mat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))         # [B,nc,H,Q,Q]
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", cb, l_mat, xc)
    # Chunk-final states: S_c = sum_j exp(sum_{k>j} da) B_j x_j.
    da_cum = torch.cumsum(dac, dim=2)                           # [B,nc,Q,H]
    da_tot = da_cum[:, :, -1:, :]
    decay_to_end = torch.exp(da_tot - da_cum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bc, decay_to_end, xc)
    # Inter-chunk recurrence: the state before each chunk.
    chunk_decay = torch.exp(da_tot[:, :, 0, :])                 # [B,nc,H]
    carry = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device))
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                      # [B,nc,H,P,N]
    # Inter-chunk contribution: y += C_i exp(cum da_i) S_{c-1}.
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(da_cum),
                         prev_states)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), carry


def mamba2_decode_step(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       d_skip: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSM update (``layers.py:627``): x [B, H, P], dt [B,
    H], b/c [B, N], state [B, H, P, N] float32 -> (y [B, H, P] in x's
    dtype, new state)."""
    a = -torch.exp(a_log.float())
    da = torch.exp(dt.float() * a)                              # [B,H]
    xdt = x.float() * dt.float()[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt, b.float())
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c.float())
    y = y + x.float() * d_skip[None, :, None]
    return y.to(x.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  init: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + SiLU (``layers.py:642``): x [B, S, D], w
    [K, D], bias [D], init [B, K - 1, D] (zeros by default) -> (y [B, S,
    D], the last K - 1 inputs), in x's dtype."""
    k = w.shape[0]
    if init is None:
        init = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([init, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None, :]
    tail = xp[:, xp.shape[1] - (k - 1):]
    return torch.nn.functional.silu(y + bias[None, None, :]), tail


# --------------------------------------------------------------------- #
# RWKV6 (Finch): data-dependent decay linear recurrence (``:656-694``).
# The eager recurrence ``wkv6`` (``layers.py:659``) is K14's plain version,
# ``ref.wkv6``: the reference computes the same recurrence in both places.
# --------------------------------------------------------------------- #

def token_shift(x: torch.Tensor,
                prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RWKV token shift (``layers.py:690``): x [B, S, D] -> x[t - 1], the
    row at t = 0 from ``prev`` [B, 1, D] (zeros by default)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None, *,
                 chunk: int = 16, min_log_w: float = -5.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel wkv6 (``layers.py:1186``), the eager plan's mixer
    when ``cfg.rwkv_chunk > 0``: the state is carried once per ``chunk``
    tokens and the intra-chunk part is matmuls through the factored decay
    ``s[t, j] = sum_k (r[t, k] e^{L[t-1, k]}) (k[j, k] e^{-L[j, k]})``,
    j < t, with L the in-chunk cumulative log decay, each step's log decay
    clamped at ``min_log_w`` so ``e^{-L}`` stays finite (the clamp changes
    decays below e^-5, as in the reference).  Shapes as ``wkv6``."""
    bsz, s, h, n = r.shape
    c = min(chunk, s)
    if s % c:
        c = math.gcd(s, c)
    nc = s // c
    rr = r.float().reshape(bsz, nc, c, h, n)
    kk = k.float().reshape(bsz, nc, c, h, n)
    vv = v.float().reshape(bsz, nc, c, h, n)
    lw = torch.clamp(torch.log(torch.clamp(w.float(), min=1e-30)),
                     min_log_w, 0.0).reshape(bsz, nc, c, h, n)
    el = torch.cumsum(lw, dim=2)          # inclusive log decay (<= 0)
    a = rr * torch.exp(el - lw)           # r e^{L[t-1]}, bounded by |r|
    bmat = kk * torch.exp(-el)            # bounded by e^{-min_log_w * c}
    scores = torch.einsum("bcthn,bcjhn->bchtj", a, bmat)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)         # strictly lower: j < t
    y_intra = torch.einsum("bchtj,bcjhn->bcthn",
                           torch.where(tri, scores, 0.0), vv)
    # The diagonal bonus: y += (sum_k r u k) v at each t.
    coef = torch.einsum("bcthn,hn,bcthn->bcth", rr, u.float(), kk)
    y_diag = coef[..., None] * vv
    # The inter-chunk recurrence.
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, n, n), dtype=torch.float32,
                              device=r.device))
    chunk_decay = torch.exp(el[:, :, -1])                  # [B,nc,H,N]
    kdec = bmat * chunk_decay[:, :, None]                  # k e^{L[-1]-L[j]}
    s_updates = torch.einsum("bcjhk,bcjhv->bchkv", kdec, vv)
    y_cross = []
    for ci in range(nc):
        y_cross.append(torch.einsum("bthk,bhkv->bthv", a[:, ci], state))
        state = state * chunk_decay[:, ci][..., None] + s_updates[:, ci]
    y = (y_intra + y_diag + torch.stack(y_cross, dim=1)).reshape(bsz, s,
                                                                 h, n)
    return y.to(r.dtype), state


# --------------------------------------------------------------------- #
# Kernel forward, eager backward (``layers.py:697-716``)
# --------------------------------------------------------------------- #

class _KernelFwdEagerBwd(torch.autograd.Function):
    """The kernel computes the forward value (grad mode is off inside);
    the backward reruns ``eager`` on detached copies of the saved inputs
    with grad on and returns ``torch.autograd.grad`` of it.  Inputs that
    need no gradient (integer labels, frozen tensors) get None."""

    @staticmethod
    def forward(ctx, fused: Callable, eager: Callable, *args):
        ctx.eager = eager
        ctx.save_for_backward(*args)
        return fused(*args)

    @staticmethod
    def backward(ctx, *grads):
        wants = ctx.needs_input_grad[2:]
        inputs = [a.detach().requires_grad_(w)
                  for a, w in zip(ctx.saved_tensors, wants)]
        with torch.enable_grad():
            out = ctx.eager(*inputs)
        diff = [a for a, w in zip(inputs, wants) if w]
        got = iter(torch.autograd.grad(out, diff, grads, allow_unused=True)
                   if diff else ())
        return (None, None) + tuple(next(got) if w else None for w in wants)


def _kernel_fwd_eager_bwd(fused: Callable, eager: Callable) -> Callable:
    """``fused`` with ``eager``'s gradient.  Without grad mode, or when no
    input requires grad (serving), ``fused`` runs as it is.  A w8 stage's
    cached ``(codes, scales)`` pair (``params.quantize_weights``) is for
    serving: under grad it is refused, as its codes would be those of
    weights the optimizer has since moved."""
    def apply(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            if any(isinstance(a, tuple) for a in args):
                raise ValueError("cached int8 weights "
                                 "(params.quantize_weights) are for "
                                 "serving: train on the weight tensors, "
                                 "which each call quantizes anew")
            return _KernelFwdEagerBwd.apply(fused, eager, *args)
        return fused(*args)
    return apply


# --------------------------------------------------------------------- #
# Fused wrappers (the plan's kernels)
# --------------------------------------------------------------------- #

def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B * S, D], contiguous, for the token-major kernels."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def fused_norm_matmul(x: torch.Tensor, scale: torch.Tensor, w: W8Weight,
                      *, eps: float = 1e-6, w8: int = 0) -> torch.Tensor:
    """rms_norm(x) @ w through ``rmsnorm_matmul``: x [B, S, D] -> [B, S, N]
    (``layers.py:725``).  ``w8`` (the plan's block flag): weight-only int8
    through the ``rmsnorm_matmul_w8`` twin, the weight quantized at each
    call; its backward is the reference's straight-through estimator
    (x's gradient through the dequantized weight, w's as if unquantized)."""
    b, s, _ = x.shape

    def fused(x, scale, w):
        if w8:
            codes, ws = w8_codes(w)
            y = K.rmsnorm_matmul_w8(_rows(x), scale, codes, w_scale=ws,
                                    eps=eps)
        else:
            y = K.rmsnorm_matmul(_rows(x), scale, w, eps=eps)
        return y.reshape(b, s, y.shape[-1])

    def eager(x, scale, w):
        return rms_norm(x, scale, eps) @ (w8_ste(w) if w8 else w)

    return _kernel_fwd_eager_bwd(fused, eager)(x, scale, w)


def fused_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w through ``block_matmul``: x [B, S, D] -> [B, S, N]
    (``layers.py:772``)."""
    b, s, _ = x.shape

    def fused(x, w):
        return K.block_matmul(_rows(x), w).reshape(b, s, w.shape[-1])

    return _kernel_fwd_eager_bwd(fused, lambda x, w: x @ w)(x, w)


def fused_norm(kind: str, x: torch.Tensor, p: Params) -> torch.Tensor:
    """``apply_norm`` on the kernel plan's serving path, through the
    row-norm kernel, whose rows do not depend on the row count (its
    LayerNorm or RMSNorm mode).  Serving only: training keeps
    ``apply_norm``, as the reference leaves the norm to XLA."""
    b, s, d = x.shape
    if kind == "rmsnorm":
        y = K.rms_norm_rows(_rows(x), p["scale"])
    else:
        y = K.layer_norm_rows(_rows(x), p["scale"], p["bias"])
    return y.reshape(b, s, d)


def fused_ffn(x: torch.Tensor, p: Params, *, activation: str, gated: bool,
              norm_scale: Optional[torch.Tensor] = None,
              w8: int = 0) -> torch.Tensor:
    """GLU FFN through ``streamed_ffn``, or the ungated MLP through
    ``streamed_mlp``; with ``norm_scale`` the pre-FFN RMSNorm is folded
    into the kernel (``layers.py:795``).  ``w8``: weight-only int8 on
    every projection through the ``_w8`` twins, each weight quantized at
    each call, with the straight-through backward (``layers.py:835``,
    ``:856``)."""
    b, s, d = x.shape
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    args = (x,) + tuple(p[n] for n in names)
    if norm_scale is not None:
        args += (norm_scale,)

    def split(args):
        ws = args[1:1 + len(names)]
        norm = args[1 + len(names)] if norm_scale is not None else None
        return args[0], ws, norm

    def fused(*args):
        x, ws, norm = split(args)
        if w8:
            codes, scales = zip(*(w8_codes(w) for w in ws))
            fn = K.streamed_ffn_w8 if gated else K.streamed_mlp_w8
            y = fn(_rows(x), *codes, activation=activation, norm_scale=norm,
                   **{n + "_scale": sc for n, sc in zip(names, scales)})
        else:
            kernel = K.streamed_ffn if gated else K.streamed_mlp
            y = kernel(_rows(x), *ws, activation=activation, norm_scale=norm)
        return y.reshape(b, s, d)

    def eager(*args):
        x, ws, norm = split(args)
        h = rms_norm(x, norm) if norm is not None else x
        if w8:
            ws = [w8_ste(w) for w in ws]
        return ffn(h, dict(zip(names, ws)), activation=activation,
                   gated=gated)

    return _kernel_fwd_eager_bwd(fused, eager)(*args)


def fused_moe_ffn(x: torch.Tensor, p: Params, *, activation: str,
                  top_k: int, block_t: int = 128,
                  router_kernel: bool = True) -> torch.Tensor:
    """The router outside the kernel, the experts through ``moe_experts``
    (K12; ``layers.py:872``, single device): x [B, S, D] -> [B, S, D].
    ``router_kernel``: the router product through ``block_matmul`` (the
    serving path, whose rows must not depend on the row count), else
    ``@`` (training, as the reference).  The eager backward recomputes
    ``moe_experts_eager`` from (x, gates, wg, wu, wd); the router's
    gradient flows through ``gates`` eagerly.  ``block_t`` is the plan's
    hint; the kernel picks its own tiles."""
    del block_t
    b, s, d = x.shape
    logits = fused_matmul(x, p["wr"]) if router_kernel else x @ p["wr"]
    gates = gates_from_logits(logits, top_k, x.dtype)

    def fused(x, gates, wg, wu, wd):
        return K.moe_experts(_rows(x), _rows(gates), wg, wu, wd,
                             activation=activation).reshape(b, s, d)

    def eager(x, gates, wg, wu, wd):
        return moe_experts_eager(x, gates, wg, wu, wd, activation=activation)

    return _kernel_fwd_eager_bwd(fused, eager)(x, gates, p["wg"], p["wu"],
                                              p["wd"])


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """Whole-sequence attention through the static flash kernel
    (``layers.py:915``); its backward recomputes ``streaming_attention``
    (``local_attention`` under a window)."""

    def fused(q, k, v):
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 block_kv=block_kv)

    def eager(q, k, v):
        if window:
            return local_attention(q, k, v, window=window)
        return streaming_attention(q, k, v, causal=causal)

    return _kernel_fwd_eager_bwd(fused, eager)(q, k, v)


def fused_streamed_xent(hidden: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor, vocab_size: int, *,
                        block_t: int = 128,
                        block_v: int = 512) -> torch.Tensor:
    """Mean cross-entropy through ``streamed_xent`` (``layers.py:1124``,
    single device): hidden [B, S, D], head [D, Vp], labels [B, S] with
    negative labels ignored.  The forward never holds the [T, Vp] logits;
    the backward recomputes them through the eager formulation, which
    rounds ``hidden @ head`` to the compute dtype before the float32 cast
    (the kernel does not), as the reference does.  ``block_t`` and
    ``block_v`` are the plan's hints; the kernel picks its own tiles."""
    del block_t, block_v
    b, s, d = hidden.shape

    def fused(hidden, head, labels):
        return K.streamed_xent_loss(_rows(hidden), head, labels.reshape(-1),
                                    vocab_size=vocab_size)

    def eager(hidden, head, labels):
        logits = (hidden.reshape(b * s, d) @ head).float()
        pad = torch.arange(logits.shape[-1],
                           device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
        lf = labels.reshape(-1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1,
                            torch.clamp(lf, min=0).long()[:, None])[:, 0]
        return xent_nll_mean(lse, gold, lf)

    return _kernel_fwd_eager_bwd(fused, eager)(hidden, head, labels)


def fused_mamba2_ssd(x: torch.Tensor, dt: torch.Tensor,
                     a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     d_skip: torch.Tensor, *, chunk: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan through ``mamba2_scan`` (K13;
    ``layers.py:1071``, single device), shapes as ``mamba2_ssd``; its
    backward recomputes ``mamba2_ssd`` at the same chunk."""

    def fused(x, dt, a_log, b, c, d_skip):
        return K.mamba2_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)

    def eager(x, dt, a_log, b, c, d_skip):
        return mamba2_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)

    return _kernel_fwd_eager_bwd(fused, eager)(x, dt, a_log, b, c, d_skip)


def fused_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence through ``rwkv6_wkv`` (K14; ``layers.py:1098``,
    single device), shapes as ``wkv6`` with the state starting at zero;
    its backward recomputes the eager ``wkv6``."""

    def fused(r, k, v, w, u):
        return K.wkv6(r, k, v, w, u, chunk=chunk)

    def eager(r, k, v, w, u):
        return wkv6(r, k, v, w, u)

    return _kernel_fwd_eager_bwd(fused, eager)(r, k, v, w, u)


def fused_attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: int, kv_len: int, *, causal: bool = True,
                          window: int = 0, block_kv: int = 512,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Chunked-prefill attention through the offset flash kernel; with
    ``k_scale``/``v_scale`` [B, Skv, Hkv] (per-position scales) k/v are
    codes and its quantized twin runs (``layers.py:949``)."""
    return K.flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window, block_kv=block_kv,
                             k_scale=k_scale, v_scale=v_scale)


def fused_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode attention through the paged kernel (pools read in place);
    with ``k_scale``/``v_scale`` [P, Hkv] the pools hold codes and the
    quantized twin runs (``layers.py:993``)."""
    if k_scale is not None:
        return K.paged_decode_attention_q(q.contiguous(), k_pool, v_pool,
                                          page_table, lengths,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window)
    return K.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, lengths, window=window)


def fused_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative-verify attention through the paged verify kernel: one
    launch scores every window row of every slot (``layers.py:1034``,
    single device); quantized pools as ``fused_paged_attention``."""
    if k_scale is not None:
        return K.paged_verify_attention_q(q.contiguous(), k_pool, v_pool,
                                          page_table, q_off,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window)
    return K.paged_verify_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, q_off, window=window)
