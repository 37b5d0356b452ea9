"""Quickstart of the PyTorch/CUDA port: the StreamTensor pipeline end to
end on one block (``examples/quickstart.py``).

Traces a transformer block to the dataflow graph, explores the tiling
space, fuses kernels under the on-chip budget, sizes FIFOs with the LP,
validates the schedule in the discrete-event simulator (for the H100),
then runs two of the Hopper kernels the plan lowers to against their
plain versions (``kernels/ref.py``): the streamed FFN (K4) and GQA flash
attention 8:2 (K7), float32, at the reference example's shapes.  Two
cases differ where the CUDA builds do: K4 runs SwiGLU with the RMSNorm
folded in (the build refuses SiLU without a norm) and K7 head dim 64
(the build has no head dim 32).

    PYTHONPATH=src python examples/torch_quickstart.py [--arch llama3-8b]
        [--device cpu]

Runs on the card unless ``--device cpu`` (the kernels' plain versions).
"""

import argparse
import math

import torch

from repro_torch import kernels as K
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import compile_model
from repro_torch.core.platforms import H100
from repro_torch.kernels import ref
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.simulator import simulate_dataflow


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)

    # 1) The compiler: trace -> tile -> fuse -> size FIFOs -> lower.
    print(f"== StreamTensor compile: one {cfg.name} block ==")
    c = compile_model(cfg, tokens=256, platform=H100, dse_budget=8)
    s = c.summary()
    print(f" kernels={s['kernels']} fusion_groups={s['fusion_groups']} "
          f"memory_ratio={s['memory_ratio']*100:.1f}% "
          f"fifo_depth={s['fifo_total_depth']}")
    print(f" lowered implementations: {s['implementations']}")

    # 2) Deadlock-freedom: LP-sized FIFOs complete in the simulator.
    timings = {k.name: k.timing for k in c.graph.kernels()}
    sim = simulate_dataflow(c.graph, timings, plan=c.fifo)
    print(f" simulator: completed={sim.completed} "
          f"makespan={sim.makespan:.0f} cycles")

    # 3) The Hopper kernels themselves against their plain versions.
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(128, 64)
    wg, wu, wd = randn(64, 128, scale=0.1), randn(64, 128, scale=0.1), \
        randn(128, 64, scale=0.1)
    norm = randn(64, scale=0.1)
    out = K.streamed_ffn(x, wg, wu, wd, norm_scale=norm)
    ffn_err = _rel(out, ref.streamed_ffn(x, wg, wu, wd, norm_scale=norm))
    print(f" streamed_ffn max err: {ffn_err:.2e}")

    b, sq, hq, hkv, d = 2, 128, 8, 2, 64
    q, k, v = randn(b, sq, hq, d), randn(b, sq, hkv, d), randn(b, sq, hkv, d)
    fa = K.flash_attention(q, k, v, block_kv=32)
    # The plain version over K7's layout: query heads kv-head-major.
    g = hq // hkv
    qk = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * hq, sq, d)
    kk = k.permute(0, 2, 1, 3).reshape(b * hkv, sq, d)
    vk = v.permute(0, 2, 1, 3).reshape(b * hkv, sq, d)
    fr = ref.flash_attention_static(qk, kk, vk, kv_len=sq, kv_group=g,
                                    scale=1.0 / math.sqrt(d))
    fr = fr.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, sq, hq, d)
    fa_err = _rel(fa, fr)
    print(f" flash_attention (GQA 8:2) max err: {fa_err:.2e}")
    print("quickstart OK")
    return {"completed": sim.completed, "streamed_ffn_err": ffn_err,
            "flash_attention_err": fa_err}


if __name__ == "__main__":
    main()
