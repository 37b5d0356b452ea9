"""Design-space exploration walkthrough for every assigned architecture,
on the H100 (``examples/dataflow_explorer.py``).

Shows the three hierarchical design spaces of the paper on real block
graphs: tiling (hyperparameter search with fusion feedback), fusion
(Algorithm 2 under C_max), and resource allocation (LP FIFO sizing +
memory tiers) — and how the decisions differ per architecture family.
Each arch's kernel plan at the same 256 tokens is then verified for the
device it would run on: on the card the lint also reports the cases the
CUDA builds refuse.

    PYTHONPATH=src python examples/torch_dataflow_explorer.py [--device cpu]
"""

import argparse
import dataclasses

from repro_torch.analysis import verify_plan
from repro_torch.analysis.diagnostics import clean
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import compile_model
from repro_torch.core.platforms import H100
from repro_torch.core.stream_plan import plan_for
from repro_torch.kernels.common import resolve_device

TOKENS = 256


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the plans run: default the card, or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{'arch':24s} {'kernels':>7s} {'groups':>6s} {'mem%':>6s} "
          f"{'fifoKB':>7s} {'latency_ms':>10s} {'plan':>6s}  "
          "implementations")
    verified = {}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        c = compile_model(cfg, tokens=TOKENS, platform=H100, dse_budget=8)
        s = c.summary()
        fused = dataclasses.replace(cfg, use_fused_kernels=True)
        verified[arch] = clean(verify_plan(plan_for(fused, TOKENS), fused,
                                           device=dev.type))
        impls = sorted(set(s["implementations"]))
        print(f"{arch:24s} {s['kernels']:7d} {s['fusion_groups']:6d} "
              f"{s['memory_ratio']*100:6.1f} "
              f"{c.fifo.total_bytes/1024:7.1f} "
              f"{s['modeled_latency_s']*1e3:10.2f} "
              f"{'clean' if verified[arch] else 'FAIL':>6s}  "
              f"{','.join(impls)}")
    assert all(verified.values()), f"plans not clean on {dev.type}: " \
        f"{[a for a, ok in verified.items() if not ok]}"
    print("dataflow_explorer OK")
    return verified


if __name__ == "__main__":
    main()
