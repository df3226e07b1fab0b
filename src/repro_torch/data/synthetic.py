"""Synthetic datasets (the machines this runs on are offline: no
Fashion-MNIST / CIFAR-10 downloads).

Images: class-conditional prototype + noise, thresholdable at 0.5 so a
BNN can learn them (stands in for Fashion-MNIST / CIFAR-10).  Pure
NumPy, the JAX package's function line for line: the same seed gives
``np.array_equal`` arrays in both packages.

Tokens: a k-gram Markov language over a given vocab, so an LM's loss can
fall within a few hundred steps.  The JAX package draws it from
``jax.random``, whose bits torch cannot reproduce, so this stream is the
port's own: it keeps the reference's properties (a pure function of
``(seed, step)``, so training resumes exactly; each step's tokens
differ; the next token depends on the last ``order`` tokens through a
fixed random transition law), not its bits.  Nor its cost: the
reference draws ``vocab`` normals for every token it samples, O(batch x
seq x vocab) work a batch, which a host cannot keep up with at a full
LM vocab; here each context's law is a fixed table row of ``SUPPORT``
candidates, so a token costs O(``SUPPORT``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray  # (N, H, W, C) float32 in [0,1]
    y: np.ndarray  # (N,) int32
    n_classes: int


def make_image_dataset(
    seed: int,
    n: int,
    hw: tuple,
    channels: int,
    n_classes: int = 10,
    noise: float = 0.35,
) -> ImageDataset:
    rng = np.random.default_rng(seed)
    h, w = hw
    protos = rng.random((n_classes, h, w, channels)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    eps = rng.normal(0.0, noise, size=(n, h, w, channels)).astype(np.float32)
    x = np.clip(protos[y] + eps, 0.0, 1.0)
    return ImageDataset(x=x, y=y, n_classes=n_classes)


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded by a hash of `words` (NumPy's
    ``SeedSequence``: stable across runs and platforms)."""
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(seed & (2**63 - 1))


# the token law: each context hashes to one of BUCKETS table rows of
# SUPPORT candidate tokens with fixed logits
SUPPORT = 64
BUCKETS = 1 << 14


def make_token_stream(
    seed: int, vocab: int, order: int = 2, temperature: float = 0.5
):
    """Returns ``sample(step, batch, seq)`` -> int32 CPU tokens (batch,
    seq) drawn from a fixed random k-gram process: a pure function of
    ``(seed, step)``, so resumable.  The context ``ctx`` (the last
    ``order`` tokens) picks the table row ``h = sum(ctx * folds) mod
    BUCKETS``; the next token is one of the row's ``SUPPORT`` candidates,
    drawn from ``softmax(logits[h] / temperature)`` (by Gumbel-max).
    Candidates follow a Zipf law over the vocab (token ``t`` about as
    often as ``1 / (t + 1)``), as words do, and the logits are standard
    normal; both tables are drawn once from generators seeded by
    ``(seed, 13)``."""
    folds = torch.randint(1, 2**20, (order,), generator=_generator(seed, 7),
                          dtype=torch.int64)
    table = _generator(seed, 13)
    u = torch.rand((BUCKETS, SUPPORT), generator=table, dtype=torch.float64)
    cand = torch.clamp(torch.floor((vocab + 1.0) ** u).long() - 1,
                       0, vocab - 1)
    logits = torch.randn((BUCKETS, SUPPORT), generator=table) / temperature

    def sample(step: int, batch: int, seq: int) -> torch.Tensor:
        gen = _generator(seed, 1, step)
        ctx = torch.randint(0, vocab, (batch, order), generator=gen,
                            dtype=torch.int64)
        gumbel = -torch.log(-torch.log(
            torch.rand((seq, batch, SUPPORT), generator=gen)))
        toks = torch.empty((batch, seq), dtype=torch.int64)
        for i in range(seq):
            h = (ctx * folds).sum(dim=-1) % BUCKETS
            pick = torch.argmax(logits[h] + gumbel[i], dim=-1)
            nxt = cand[h, pick]
            toks[:, i] = nxt
            ctx = torch.cat([ctx[:, 1:], nxt[:, None]], dim=1)
        return toks.to(torch.int32)

    return sample
