"""PPO's phases on 2 gloo ranks against the JAX package's ``GanPhases``
on a 2-device mesh, fp32 on the CPU (the BERT critic under ppo and a BERT
dis_D at the tiny width of ``test_torch_ppo.py``; the harness and the
draws of ``test_torch_ddp_gan.py``): one dis update, whose weights W are a
softmax over every rank's rows, then a gen phase (the classifier update,
P0 snapshotted, the gen update). Adam's first moments of the three
updates, the worst leaf within ``kernel_check.GAN_REF_TOL
["grad_leaf_rel"]`` of JAX's (the rule of ``test_torch_ppo.py``); each
rank's P0 within 1e-6 of its rows of JAX's; the logged losses within rtol
1e-5 of JAX's and of the port's one-process run; the generator's move
equal to the one-process move once scaled by the world size."""

import numpy as np
import torch

from test_torch_ddp_gan import LR, V, WORLD, _close_moves, _mesh_case
from transformer_gan_torch.parallel import sharding as psh

torch.set_num_threads(1)


def test_ppo_phases_and_P0_match_jax_mesh(tmp_path):
    """PPO at 2 ranks: the dis update (W over every rank's rows), then a
    gen phase (the classifier update, P0 snapshotted, the gen update);
    P0's rows on each rank."""
    import jax
    from test_torch_gan_bert import JaxBertDraws
    from test_torch_ppo import _leaf_err, _ppo_cfg
    from transformer_gan_torch import kernel_check as kc
    over = _ppo_cfg(tmp_path, "bert")
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128) for _ in range(2)]

    def keys(jph):
        rngs, rest = [], jph.rng
        for _ in range(3):
            rest, r = jax.random.split(rest)
            rngs.append(r)
        return [k for r in rngs for k in jax.random.split(r, 2)]

    P0s = {}
    from transformer_gan_tpu.train import gan_loop as jloop
    gen_phase = jloop.GanPhases.gen_phase

    def keep_P0(self, step):
        out = gen_phase(self, step)
        P0s[step] = np.asarray(jax.device_get(self.P0))
        return out

    jloop.GanPhases.gen_phase = keep_P0
    try:
        jph, jtr, single, ranks, layouts, jdis_mu = _mesh_case(
            over, batches, keys,
            lambda k, jph: JaxBertDraws(k, 2, jph.dis_cfg), ("dis", 0),
            ppo=True)
    finally:
        jloop.GanPhases.gen_phase = gen_phase
    rank = ranks[0]
    tol = kc.GAN_REF_TOL["grad_leaf_rel"]
    from test_torch_gan import _adam_mu
    for got, ref, lay in (
            (rank["dis_mu"], _adam_mu(jdis_mu), layouts["dis"]),
            (rank["gen_mu"], _adam_mu(jph.gen_opt_state), layouts["gen"]),
            (rank["clf_mu"], _adam_mu(jph.disD_opt_state), layouts["clf"])):
        assert _leaf_err(got, ref, lay) <= tol
    for r, res in enumerate(ranks):
        assert res["P0"][0].shape == (2,)
        np.testing.assert_allclose(
            res["P0"][0].numpy(), psh.rank_rows(P0s[0], r, WORLD), rtol=1e-6,
            atol=1e-6)
    np.testing.assert_allclose(rank["stats"], single["stats"], rtol=1e-5)
    np.testing.assert_allclose(rank["stats"], jph.pop_log_stats(),
                               rtol=1e-5)
    _close_moves(rank["gen_move"] * WORLD, single["gen_move"], LR)
