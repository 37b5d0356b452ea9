"""Accuracy gate for quantized serving (port of ``repro.serving.accuracy``,
DESIGN.md §14).

Every quant mode is scored against the unquantized (``quant="none"``)
reference along the reference's own greedy trajectory (teacher forcing),
so logits are comparable at every step:

* ``max_logit_err`` — max absolute logit difference across the prefill
  read-out and every decode step;
* ``tokens_equal`` — whether the quantized argmax agrees with the
  reference at every step (under teacher forcing, greedy-stream equality).

``python -m repro_torch.serving.accuracy`` prints the table for the port's
registry (``--device cpu`` on a machine without a card) and exits non-zero
when kv_int8 or w8_kv8 diverges on gpt2 or llama3-8b.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..configs import ARCHS, ModelConfig, get_config
from ..kernels.common import DeviceLike, resolve_device
from ..models.model import decode_step, prefill_chunk
from ..models.params import Tree, init_params, map_tree, quantize_weights
from .kv_cache import PagedKVCache, stage_chunk

QUANT_MODES: Tuple[str, ...] = ("kv_int8", "kv_fp8", "w8", "w8_kv8")


def jitter_params(params: Tree, generator: torch.Generator,
                  sigma: float = 0.05) -> Tree:
    """Add ``sigma`` times standard normal noise (float32 draws from
    ``generator``, which must live on the leaves' device) to every floating
    leaf, keeping its dtype.

    ``init_params`` zero-initialises norm scales, which under the raw
    ``layer_norm`` convention (``y * scale + bias``) makes every gpt2 logit
    zero: a fused/eager or port/reference comparison of such a model would
    pass for nothing.  Jittered weights make it real."""

    def leaf(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            return t
        noise = torch.randn(t.shape, generator=generator,
                            dtype=torch.float32, device=t.device)
        return (t.float() + sigma * noise).to(t.dtype)

    return map_tree(leaf, params)


def _greedy_rollout(params: Tree, cfg: ModelConfig, kv: PagedKVCache,
                    prompt: np.ndarray, steps: int,
                    forced: Optional[List[int]] = None
                    ) -> Tuple[List[int], List[np.ndarray]]:
    """Prefill ``prompt`` into slot 0 in one chunk, then decode ``steps -
    1`` tokens; with ``forced`` each decode step's input token comes from
    it (teacher forcing), while the returned tokens are still the model's
    own argmax.  Returns (tokens, float32 logits per step), entry 0 the
    prefill read-out (``accuracy.py:54``)."""
    dev = kv.device
    cache = kv.init_cache()
    plen = len(prompt)
    kv.ensure(0, plen + steps + 1)
    row = kv.table_row(0)
    chunk = max(kv.page_size, 1 << (plen - 1).bit_length())
    toks, cpages, last = stage_chunk(prompt, 0, chunk, row, kv.page_size)
    _, logits, cache = prefill_chunk(
        params, cfg, torch.as_tensor(toks, device=dev)[None], cache,
        torch.as_tensor(row, device=dev),
        torch.as_tensor(cpages, device=dev), 0, last)
    step_logits = [logits.float().reshape(-1).cpu().numpy()]
    out = [int(step_logits[0].argmax())]
    table = kv.page_table
    for i in range(steps - 1):
        tok = forced[i] if forced is not None else out[-1]
        pos = torch.tensor([plen + i], dtype=torch.int32, device=dev)
        _, logits, cache = decode_step(
            params, cfg, torch.tensor([[tok]], dtype=torch.int32, device=dev),
            cache, pos, pos, page_table=table)
        step_logits.append(logits.float().reshape(-1).cpu().numpy())
        out.append(int(step_logits[-1].argmax()))
    return out, step_logits


@torch.no_grad()
def run_accuracy(cfg_or_arch, modes: Iterable[str] = QUANT_MODES, *,
                 params: Optional[Tree] = None, prompt_len: int = 16,
                 steps: int = 8, seed: int = 0, page_size: int = 8,
                 fused: Optional[bool] = None,
                 device: DeviceLike = None) -> Dict[str, Dict[str, object]]:
    """Score ``modes`` against the ``quant="none"`` reference for one
    config (``accuracy.py:90``), in float32.

    An arch name means its reduced config.  ``params`` (compute dtype
    float32) defaults to weights drawn from ``seed`` and jittered.  Returns
    ``{mode: {"max_logit_err", "tokens_equal", "kv_itemsize",
    "tokens"}}`` plus a ``"none"`` entry holding the reference tokens and
    its largest logit magnitude (``max_abs_logit``), the scale the errors
    read against."""
    dev = resolve_device(device)
    cfg = (get_config(cfg_or_arch).reduced()
           if isinstance(cfg_or_arch, str) else cfg_or_arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if fused is not None:
        cfg = dataclasses.replace(cfg, use_fused_kernels=fused)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = jitter_params(init_params(cfg, gen, device=dev), gen)
    prompt = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, prompt_len).astype(np.int32)
    max_len = prompt_len + steps + page_size

    def fresh_kv(c):
        return PagedKVCache(c, slots=1, max_len=max_len,
                            page_size=page_size, device=dev)

    ref_cfg = dataclasses.replace(cfg, quant="none")
    ref_tokens, ref_logits = _greedy_rollout(
        params, ref_cfg, fresh_kv(ref_cfg), prompt, steps)
    scale = max(float(np.abs(a[:cfg.vocab_size]).max()) for a in ref_logits)
    report: Dict[str, Dict[str, object]] = {
        "none": {"tokens": ref_tokens, "max_logit_err": 0.0,
                 "tokens_equal": True, "kv_itemsize": 4.0,
                 "max_abs_logit": scale}}
    for mode in modes:
        qcfg = dataclasses.replace(cfg, quant=mode)
        qkv = fresh_kv(qcfg)
        q_tokens, q_logits = _greedy_rollout(
            quantize_weights(qcfg, params), qcfg, qkv, prompt, steps,
            forced=ref_tokens[:-1])
        report[mode] = {
            "max_logit_err": max(float(np.abs(a - b).max())
                                 for a, b in zip(ref_logits, q_logits)),
            "tokens_equal": q_tokens == ref_tokens,
            "kv_itemsize": float(qkv.kv_itemsize_effective),
            "tokens": q_tokens,
        }
    return report


def run_suite(archs: Optional[Iterable[str]] = None,
              modes: Iterable[str] = QUANT_MODES, **kw
              ) -> Dict[str, Dict[str, Dict[str, object]]]:
    """Accuracy reports for every arch of the port's registry (all of them
    decoders with attention KV pages)."""
    return {a: run_accuracy(a, modes, **kw) for a in (archs or ARCHS)}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch ids (default: all)")
    ap.add_argument("--modes", default=",".join(QUANT_MODES))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--fused", action="store_true",
                    help="the kernel plan (default: the config's plan)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain kernel versions (default: "
                         "the card)")
    args = ap.parse_args(argv)
    suite = run_suite(args.archs.split(",") if args.archs else None,
                      modes=args.modes.split(","), steps=args.steps,
                      fused=True if args.fused else None,
                      device=args.device)
    bad = 0
    for arch, rep in suite.items():
        for mode, r in rep.items():
            if mode == "none":
                continue
            bad += (not r["tokens_equal"] and mode in ("kv_int8", "w8_kv8")
                    and arch in ("gpt2", "llama3-8b"))
            print(f"{arch:>22s} {mode:>8s}  "
                  f"{'OK ' if r['tokens_equal'] else 'DIV'}  "
                  f"max|dlogit|={r['max_logit_err']:.4g}  "
                  f"itemsize={r['kv_itemsize']:.3f}B")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
