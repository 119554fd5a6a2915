"""RANSAC sample indices drawn where the generator lives.

The JAX package draws its samples with `jax.random`, whose draws do not
depend on the backend.  torch's generators do: a CUDA generator and a CPU
generator seeded alike draw different samples, so a System on a card would
initialize (and relocalize, close loops, merge maps) from other samples
than the same System on the CPU.  A System therefore keeps one CPU
generator, and every site that draws with it calls `multinomial`: on a
card the weights are read back to the host (one blocking read per draw),
the indices drawn there and sent back, so that the card makes the CPU's
draws.
"""

from __future__ import annotations

import torch


def multinomial(w: torch.Tensor, n: int, generator: torch.Generator | None = None
                ) -> torch.Tensor:
    """`torch.multinomial(w, n, replacement=True)` drawn with `generator` on
    the generator's device; the indices on `w`'s device."""
    if generator is None or generator.device == w.device:
        return torch.multinomial(w, n, replacement=True, generator=generator)
    return torch.multinomial(w.to(generator.device), n, replacement=True,
                             generator=generator).to(w.device)
