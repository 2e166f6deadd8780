"""The reference against the program's CPU path at a tiny width, on the
same seeded inputs: in float32 the two agree to rounding. (The limits hold
the configuration's bf16 at the cells' own sizes on the card; the CPU's
bf16 at other sizes rounds otherwise.)"""
from __future__ import annotations

import torch

from portbench.reference import xl as ref_xl

from portbench.tests.tiny import tiny_run

MLE = "xl_baseline.mle_b128"
GEN = "xl_baseline.evalgen_b128"


def test_forward_matches_the_programs(card_route):
    from transformer_gan_torch.models import xl
    cfg = xl.XLConfig(n_token=11, n_layer=2, n_head=2, d_model=16,
                      d_inner=24, compute_dtype="float32")
    w = ref_xl.make_weights(ref_xl.leaf_shapes(2, 16, 2, 8, 24, 11), 3,
                            "cpu", std=0.2)
    inp = torch.randint(0, 11, (6, 3), generator=torch.Generator()
                        .manual_seed(0))
    mems = xl.init_mems(cfg, 5, 3)
    # a first segment fills the memory, a second attends over it
    _, mems = xl.forward_generate(w, cfg, inp, mems)
    got, _ = xl.forward_generate(w, cfg, inp.flip(0), mems)
    mem = ref_xl.empty_memory(2, 3, 2, 5, 8, "cpu")
    _, kv = ref_xl.forward(w, inp, mem, 0, None, H=2, dh=8)
    mem, count = ref_xl.roll_memory(mem, kv, 0)
    h, _ = ref_xl.forward(w, inp.flip(0), mem, count, None, H=2, dh=8)
    torch.testing.assert_close(got, ref_xl.logits(w, h), rtol=1e-5,
                               atol=1e-5)


def test_mle_fp32_agrees(card_route):
    out = tiny_run(MLE, dtype="float32")
    c = {k: v["value"] for k, v in out["checks"].items()}
    assert c["loss"] < 1e-6 and c["grad"] < 1e-4 and c["change"] < 1e-3, c
    assert c["grad_last"] < 1e-4, c


def test_evalgen_fp32_agrees(card_route):
    out = tiny_run(GEN, dtype="float32", calibrate=True)
    assert out["calibration"]["program"]["gap"] < 1e-5
