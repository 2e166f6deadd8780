"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have, under the cells' own limits; and so does
the control, the reference in fp8 put in the program's place."""
from __future__ import annotations

from portbench.tests.tiny import FULL_WIDTHS, tiny_run

MLE = "xl_baseline.mle_b128"
GEN = "xl_baseline.evalgen_b128"


def test_state_returned_unchanged(card_route, monkeypatch):
    from transformer_gan_torch.train import optim

    monkeypatch.setattr(optim.FusedOptimizer, "update",
                        lambda self, flat, grad, state: state)
    out = tiny_run(MLE)
    assert not out["correct"] and out["checks"]["change"]["value"] == 1.0


def test_half_batch_left_out(card_route, monkeypatch):
    from transformer_gan_torch.train import step as tstep

    real = tstep.make_mle_train_step

    def broken(*args, **kw):
        step = real(*args, **kw)

        def half(state, data_c, target_c, reset_c, status_c=None):
            target_c = target_c.clone()
            target_c[..., target_c.shape[-1] // 2:] = 1   # <PAD>
            return step(state, data_c, target_c, reset_c, status_c)

        return half

    monkeypatch.setattr(tstep, "make_mle_train_step", broken)
    out = tiny_run(MLE)
    grad = out["checks"]["grad"]
    assert not out["correct"] and grad["value"] > 10 * grad["limit"]


def test_token_altered(card_route, monkeypatch):
    from transformer_gan_torch.train import loop

    real = loop.generate_tokens_gumbel

    def altered(*args, **kw):
        toks = real(*args, **kw).clone()
        toks[5, 1] = (toks[5, 1] - 1) % (toks.max() - 1) + 2
        return toks

    monkeypatch.setattr(loop, "generate_tokens_gumbel", altered)
    out = tiny_run(GEN)
    gap = out["checks"]["mean_gap"]
    assert not out["correct"] and gap["value"] > 10 * gap["limit"]
    sq = out["checks"]["sq_gap"]
    assert sq["value"] > 10 * sq["limit"]


def test_mle_control_fails(card_route):
    """At the configuration's widths (8 rows of 32 tokens over 32 slots):
    the control reads above the limits of loss and grad where the program
    reads below the limit of grad."""
    cal = tiny_run(MLE, calibrate=True, seed=1, MODEL=FULL_WIDTHS,
                   TRAIN={"batch_size": 8, "tgt_length": 32,
                          "mem_length": 32})
    ctl, checks = cal["calibration"]["control"], cal["checks"]
    assert checks["grad"]["value"] <= checks["grad"]["limit"]
    for k in ("loss", "grad"):
        assert ctl[k] > checks[k]["limit"], (k, ctl[k])


def test_evalgen_control_fails(card_route):
    """At the configuration's widths (4 pieces of 512 tokens): the control
    reads above the limit where the program reads below it."""
    cal = tiny_run(GEN, calibrate=True, seed=2 ** 31 + 1,
                   MODEL=FULL_WIDTHS,
                   traffic={"num_samples": 4, "batch_size": 4, "seq_len": 512,
                            "warmup_samples": 4, "check_block_lanes": 4})
    limit = cal["checks"]["mean_gap"]["limit"]
    assert cal["calibration"]["program"]["mean_gap"] <= limit
    assert cal["calibration"]["control"]["mean_gap"] > limit
