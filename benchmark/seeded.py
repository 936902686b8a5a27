"""Seeded inputs drawn on the card, after `chip_smoke.py`'s `rand_field` at
commit c2af7b2 (its `msm_inputs` lives on in entries/msm.py and
reference/msm.py): the same seed gives the same inputs."""

from __future__ import annotations


def generator(torch, seed: int, device):
    """A torch.Generator on `device` seeded from `seed` (any whole number)."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def field_rows(torch, gen, p: int, shape: tuple, device):
    """Canonical field elements below p as int32[*shape, 16] limbs, drawn on
    `device`: 16-bit limbs with the top one below p's top limb."""
    x = torch.randint(0, 1 << 16, (*shape, 16), generator=gen, dtype=torch.int32, device=device)
    x[..., 15] = torch.randint(0, p >> 240, shape, generator=gen, dtype=torch.int32,
                               device=device)
    return x
