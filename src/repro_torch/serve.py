"""Serving entry point: the aggregation engine behind a request loop.

  PYTHONPATH=src python -m repro_torch.serve --arch qwen2-moe-a2.7b \
      [--reduced] [--device cpu] [--requests 32] [--max-batch 8]

Builds the model from a seeded generator (at its published widths and
depth unless ``--reduced``), warms the engine up on two requests, then
serves ``--requests`` synthetic requests arriving two per step and prints
the requests served, tokens/s after warmup, the engine's launches and
bucket histogram, and each kernel's launches (0 on the CPU, where the
plain versions run).  Runs on the card unless ``--device cpu``.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, reduced as reduce_cfg
from repro_torch.configs.base import AggregationConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.grouped_gemm import grouped_gemm_cuda
from repro_torch.models import model as model_mod
from repro_torch.serving import Request, ServingEngine


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(eng: ServingEngine, reqs) -> float:
    """Drip the requests in, two per step, until all are done; returns the
    wall seconds."""
    t0 = time.perf_counter()
    it = iter(reqs)
    while eng.pending or eng.active or any(not r.done for r in reqs):
        for _ in range(2):
            r = next(it, None)
            if r is not None:
                eng.submit(r)
        if not eng.step() and not eng.pending:
            break
    sync(eng.device)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = model_mod.init_params(cfg, seed=0, device=device)
    sync(device)

    def engine():
        return ServingEngine(cfg, model, max_batch=args.max_batch,
                             max_len=args.max_len, device=device,
                             agg=AggregationConfig(
                                 max_aggregated=args.max_batch))

    warm = [Request(-1 - i, [1 + i], 2) for i in range(2)]
    serve(engine(), warm)
    decode_attention_cuda.launches = grouped_gemm_cuda.launches = 0
    eng = engine()
    reqs = [Request(i, [(7 * i + 3) % cfg.vocab_size], args.max_new_tokens)
            for i in range(args.requests)]
    wall = serve(eng, reqs)
    done = sum(r.done for r in reqs)
    print(f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}) on {device}: served {done}/{len(reqs)} requests, "
          f"{eng.stats['tokens']} tokens in {wall:.2f} s "
          f"({eng.stats['tokens'] / wall:.1f} tok/s after warmup)")
    print(f"aggregated launches: {eng.stats['launches']} "
          f"histogram={dict(sorted(eng.stats['aggregated_hist'].items()))}")
    print(f"kernel launches: decode_attention_cuda "
          f"{decode_attention_cuda.launches}, grouped_gemm_cuda "
          f"{grouped_gemm_cuda.launches}"
          + (" (the plain versions run on the CPU)"
             if device.type == "cpu" else ""))


if __name__ == "__main__":
    main()
