"""The training loop: data -> train_step -> checkpoint, resumable
(``repro.launch.train``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 100 --seq-len 256 --batch 8 [--reduced] [--ckpt-dir DIR] \\
        [--microbatch N] [--device cpu]

``--reduced`` shrinks the architecture (family-preserving) so the run
runs on the CPU; without ``--device cpu`` it runs on the card and raises
without one.  The run resumes from the latest step in ``--ckpt-dir``; the
(seed, step)-addressable stream and the stub inputs drawn per step make
the trajectory exact across restarts.  Checkpoints hold the reference's
keys (``convert.params_to_reference``, ``opt_state_to_reference``), so
either package restores the other's files.

On the card the run takes ``torch.use_deterministic_algorithms(True)``
(restored afterwards) with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the
backward of the embedding gather, the MoE slab's accumulating scatter and
its combine's gather add with atomics otherwise, and a resumed run would
not repeat the uninterrupted one bit for bit.  The variable is read when
cuBLAS first runs in the process, so it is set before the first CUDA call
where possible (``main``; ``chip_smoke.py`` sets it at its top).
"""
from __future__ import annotations

import argparse
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.pipeline import (
    DataConfig, SyntheticLMStream, keyed_generator,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import convert
from repro_torch.models import model as model_mod
from repro_torch.optim.adamw import OptConfig, opt_init

CUBLAS_WORKSPACE = ":4096:8"
STUB_SCALE = 0.02          # the stub vision / frames inputs' scale


def add_extra_inputs(cfg, batch: Dict[str, torch.Tensor], step: int,
                     device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """The stub memory of the vlm and audio families, fp32, drawn on the
    CPU from a generator seeded by ``(0, step)``: ``vision (B,
    vision_tokens, d)`` or ``frames (B, S * encoder_seq_ratio, d)``."""
    b, s = batch["tokens"].shape
    shape = {"vlm": ("vision", (b, cfg.vision_tokens, cfg.d_model)),
             "audio": ("frames", (b, s * cfg.encoder_seq_ratio,
                                  cfg.d_model))}.get(cfg.family)
    if shape is not None:
        name, shp = shape
        x = torch.randn(shp, generator=keyed_generator(0, step))
        batch[name] = (STUB_SCALE * x).to(device)
    return batch


@contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` on the card for the
    block, the previous setting restored after it."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def save_state(ckpt_dir: str, step: int, model: model_mod.Model,
               opt_state) -> str:
    """Step ``step`` of a run in the reference's checkpoint layout, the
    architecture's name in its sidecar."""
    return save_checkpoint(ckpt_dir, step, convert.params_to_reference(model),
                           convert.opt_state_to_reference(model, opt_state),
                           meta={"arch": model.cfg.name})


def restore_state(ckpt_dir: str, step: int, model: model_mod.Model
                  ) -> Tuple[dict, dict]:
    """Step ``step``'s weights copied into ``model``; returns (the
    optimizer state on the model's device, the sidecar's meta)."""
    layout = convert.reference_layout(model)
    np_params, np_opt, meta = restore_checkpoint(
        ckpt_dir, step, layout, {"m": layout, "v": layout, "step": 0})
    convert.fill_from_reference(np_params, model)
    return convert.opt_state_from_reference(np_opt, model), meta


def train(arch: str, steps: int, seq_len: int, batch_size: int,
          reduced: bool, ckpt_dir: str = "", save_every: int = 50,
          lr: float = 3e-4, microbatch: int = 0, log_every: int = 10, *,
          total_steps: Optional[int] = None, n_layers: Optional[int] = None,
          device: DeviceLike = None
          ) -> Tuple[model_mod.Model, dict, List[float]]:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint), on the card unless ``device="cpu"``; returns (the
    model, the optimizer state, the loss of each step this call ran).
    ``total_steps`` (default ``steps``) sets the schedule's length,
    ``n_layers`` overrides the config's depth.  The weights are drawn from
    seed 0 on the device."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    total = total_steps or steps
    data = SyntheticLMStream(DataConfig(
        seq_len=seq_len, global_batch=batch_size, vocab_size=cfg.vocab_size))
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(total // 20, 5),
                        total_steps=total)

    model = model_mod.init_params(cfg, 0, dev).requires_grad_(True)
    opt_state = opt_init(dict(model.named_parameters()))
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            opt_state, _ = restore_state(ckpt_dir, last, model)
            start = last
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg, microbatch=microbatch,
                              device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"tokens/step={batch_size * seq_len} device={dev}")

    losses = []
    t0 = time.perf_counter()
    with deterministic(dev):
        for step in range(start, steps):
            batch = add_extra_inputs(cfg, data.batch(step, dev), step, dev)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / log_every
                print(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"{dt * 1e3:.0f} ms/step")
                t0 = time.perf_counter()
            if ckpt_dir and (step + 1) % save_every == 0:
                save_state(ckpt_dir, step + 1, model, opt_state)
    return model, opt_state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    _, _, losses = train(args.arch, args.steps, args.seq_len, args.batch,
                         args.reduced, args.ckpt_dir, args.save_every,
                         args.lr, args.microbatch, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
