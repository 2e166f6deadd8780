"""``card_route``: the card's attention route for a CPU run.

On the CPU the program routes attention to its plain version, which draws
attention dropout from a generator; on the card it takes the fused kernel,
whose dropout is a hash of a seed. The fixture gives the CPU run the card's
route (the kernel's plain version, same hash), the path the reference
follows."""
from __future__ import annotations

import pytest


@pytest.fixture
def card_route(monkeypatch):
    from transformer_gan_torch.models import xl
    monkeypatch.setattr(xl, "attention_route",
                        lambda core_out, mem_len: "v2" if mem_len else "v1")
