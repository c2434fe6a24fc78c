"""Deterministic synthetic training data and the serving engine's bucket
choice (``repro.data.pipeline``'s counterpart).

``SyntheticLMStream`` is addressable by ``(seed, step)``: the data cursor
of a training run is its step counter, so a resumed run replays the same
batches with no iterator state to save.  The reference draws with
``jax.random``, whose bits the port cannot reproduce; the port keeps its
own generator with the same properties:

* a Zipf(``zipf_a``) unigram over the vocabulary;
* a fixed table of 4 successors per token, drawn from ``seed ^ 0x5EED``;
* half of the positions follow ``succ(prev)``, the successor (one of the
  4, drawn per position) of the unigram draw one position back (wrapping
  at the start of the row), so the loss can fall;
* ``labels = roll(tokens, -1)``, the wrap included.

Batches are drawn on the CPU with a ``torch.Generator`` and moved to the
device asked for, so the CPU and the card see the same batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

N_SUCCESSORS = 4
FOLLOW_SHARE = 0.5


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 256
    seed: int = 0
    zipf_a: float = 1.2


def keyed_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from the integers ``key`` (``(seed, step)``
    addresses one batch)."""
    seed = np.random.SeedSequence([k & 0xFFFF_FFFF for k in key])
    gen = torch.Generator()
    gen.manual_seed(int(seed.generate_state(1, np.uint64)[0]))
    return gen


class SyntheticLMStream:
    """Deterministic (seed, step)-addressable LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.unigram = torch.from_numpy(p / p.sum())          # fp64 (V,)
        self.succ = torch.randint(
            0, cfg.vocab_size, (cfg.vocab_size, N_SUCCESSORS),
            generator=keyed_generator(cfg.seed ^ 0x5EED))

    def draw(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s draws on the CPU: the unigram ``base``, the
        successor ``pick`` and the ``follow`` mask, each (B, S)."""
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        gen = keyed_generator(cfg.seed, step)
        base = torch.multinomial(self.unigram, b * s, replacement=True,
                                 generator=gen).reshape(b, s)
        pick = torch.randint(0, N_SUCCESSORS, (b, s), generator=gen)
        follow = torch.rand((b, s), generator=gen) < FOLLOW_SHARE
        return {"base": base, "pick": pick, "follow": follow}

    def batch(self, step: int,
              device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
        """Step ``step``'s ``tokens`` and ``labels``, int32 ``(B, S)``, on
        ``device`` (drawn on the CPU whatever the device)."""
        d = self.draw(step)
        prev = torch.roll(d["base"], 1, dims=1)
        tokens = torch.where(d["follow"], self.succ[prev, d["pick"]],
                             d["base"]).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=1)
        return {"tokens": tokens.to(device), "labels": labels.to(device)}


def length_bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (static-shape aggregation ladder)."""
    for b in sorted(buckets):
        if b >= n:
            return b
    return max(buckets)


def make_batch_specs(cfg, shape, extra_dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """The inputs ``train_step`` / ``serve_step`` take for one (arch,
    shape) cell, as meta tensors of the reference's shapes and dtypes:
    int32 ``tokens`` (and ``labels`` to train) ``(B, S)``, ``vision (B,
    vision_tokens, d)`` for vlm, ``frames (B, S * encoder_seq_ratio, d)``
    for audio; decode ``tokens (B, 1)``."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind not in ("train", "prefill"):
        return {"tokens": meta((b, 1), torch.int32)}
    batch = {"tokens": meta((b, s), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = meta((b, s), torch.int32)
    if cfg.family == "vlm":
        batch["vision"] = meta((b, cfg.vision_tokens, cfg.d_model),
                               extra_dtype)
    if cfg.family == "audio":
        batch["frames"] = meta((b, s * cfg.encoder_seq_ratio, cfg.d_model),
                               extra_dtype)
    return batch
