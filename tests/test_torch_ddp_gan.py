"""The port's GAN phases on 2 gloo ranks (``parallel/mesh.spawn``, a
``file://`` store) against the JAX package's ``GanPhases`` on a 2-device
mesh, fp32 on the CPU at the tiny width of ``test_torch_gan.py`` (batch 8,
two micro-batches of 4 rows, 2 a rank):

* the RelGAN CNN under rsgan and the BERT critic under wgan-gp (dropout
  0.1, layer 0 and the embeddings frozen): one dis and one gen update
  (PPO: ``test_torch_ddp_ppo.py``).
* each rank's own stream of a training step's random numbers: the
  phases' gumbel noise and dropout and the MLE step's dropout seeds, rank
  0's those of one process, rank 1's others.

The random numbers are the JAX package's (``JaxDraws``, ``JaxBertDraws``):
recorded at the global shape from a one-process run of the port, replayed
on each rank through ``parallel/sharding.GanRowDraws``, which hands the rank
its rows. Held as the JAX suite holds its mesh against one device
(``tests/test_gan_mesh.py``) and with the bounds of ``test_torch_gan.py``:
Adam's first moment (the clipped gradient over all rows) within rtol 2e-4,
atol 1e-8 of JAX's on the mesh (PPO: the worst leaf within
``kernel_check.GAN_REF_TOL["grad_leaf_rel"]``, the rule of
``test_torch_ppo.py``); the moves within 1e-3 lr but for at most 0.1% of
the weights, each within 2 lr; the logged losses within rtol 1e-5; P0's
rows within 1e-6; the ranks' parameters bitwise equal; and against the
port's own one-process update: the critic's move equal, the generator's
equal once scaled by the world size (its lr is gen_lr / world).

JAX is imported inside the tests only: the rank processes import this
module to find their functions."""

import types
from collections import namedtuple

import numpy as np
import pytest
import torch

from transformer_gan_torch.config import training_config
from transformer_gan_torch.models import gan as tgan
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.parallel import mesh as pmesh
from transformer_gan_torch.parallel import sharding as psh
from transformer_gan_torch.train import gan_loop as tloop
from transformer_gan_torch.train import optim as topt

torch.set_num_threads(1)

V, WORLD, LR = 310, 2, 1e-3


class _Recorder(tgan.Draws):
    """Hands out ``inner``'s draws and keeps each, in order."""

    def __init__(self, inner):
        self.inner, self.out = inner, []

    def _keep(self, x):
        self.out.append(x.detach().clone())
        return x

    def gumbel(self, chunk, n, bsz, V):
        return self._keep(self.inner.gumbel(chunk, n, bsz, V))

    def dropout_u(self, chunk, shape):
        return self._keep(self.inner.dropout_u(chunk, shape))

    def gp_alpha(self, chunk, bsz):
        return self._keep(self.inner.gp_alpha(chunk, bsz))


class _Replay(tgan.Draws):
    """Hands out recorded draws in order, checking each shape."""

    def __init__(self, draws):
        self.it = iter(draws)

    def _next(self, shape):
        x = next(self.it)
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), shape)
        return x

    def gumbel(self, chunk, n, bsz, V):
        return self._next((n, bsz, V))

    def dropout_u(self, chunk, shape):
        return self._next(shape)

    def gp_alpha(self, chunk, bsz):
        return self._next((bsz, 1, 1))


def _port_phases(over, params, batches, n_devices):
    """The port's GanPhases on a flat generator made from ``params``,
    fed the rank's rows of ``batches``."""
    tcfg = training_config().merge(over)
    layout = topt.FlatLayout.of(params)
    flat = layout.flatten(params).requires_grad_(True)
    state = types.SimpleNamespace(flat=flat, layout=layout,
                                  params=lambda: layout.unflatten(state.flat))
    bc = tcfg.DISCRIMINATOR.batch_chunk
    local = [(psh.batch_rows(b, bc), n) for b, n in batches]
    tr = types.SimpleNamespace(
        xcfg=txl.XLConfig.from_cfg(tcfg, V), vocab=list(range(V)),
        state=state, n_devices=n_devices, device=torch.device("cpu"),
        dis_iter=lambda: iter(local))
    return tloop.GanPhases(tr, tcfg), state


def _run(ph, state, draws, steps, critic=None):
    """``steps``: "dis" or a gen phase's step; after the dis update the
    critic is ``critic`` when given. Returns what the tests read."""
    ph._draws = lambda: next(draws)
    dis0, gen0 = ph.dis_flat.clone(), state.flat.detach().clone()
    out = {"P0": []}
    for s in steps:
        if s == "dis":
            ph.dis_phase(0)
            out["dis_mu"] = ph.dis_opt_state.mu.clone()
            out["dis_move"] = ph.dis_flat - dis0
            if critic is not None:
                with torch.no_grad():
                    ph.dis_flat.copy_(critic)
        else:
            ph.gen_phase(s)
            out["P0"].append(ph.P0.clone())
    out["stats"] = ph.pop_log_stats()
    out["gen_mu"] = ph.gen_opt_state.mu.clone()
    out["gen_move"] = state.flat.detach() - gen0
    out["dis_flat"], out["gen_flat"] = ph.dis_flat.clone(), state.flat.detach()
    if ph.disD_flat is not None:
        out["clf_mu"] = ph.disD_opt_state.mu.clone()
        out["clf_flat"] = ph.disD_flat.clone()
    out["frozen"] = ph.dis_layout.mask(lambda n: n in ph.dis_frozen)
    return out


def _gan_rank(mesh, over, params, batches, records, steps, critic):
    ph, state = _port_phases(over, params, batches, mesh.world)
    draws = (psh.GanRowDraws(_Replay(r)) for r in records)
    return _run(ph, state, draws, steps, critic)


def _own_streams(over, params):
    """The rank's own random numbers: a GAN micro-batch's gumbel noise and
    critic dropout from the phases' generator, at the rank's shape, and an
    MLE step's dropout seeds."""
    from transformer_gan_torch.train import step as tstep
    ph, _ = _port_phases(over, params, [], pmesh.current().world)
    draws = ph._draws()
    return {"gumbel": draws.gumbel(0, 3, 2, V),
            "dropout": draws.dropout_u(0, (4, 5)),
            "seeds": torch.tensor(tstep.chunk_seeds(5, 3, 2))}


def _streams_rank(mesh, over, params):
    return _own_streams(over, params)


def test_each_rank_draws_its_own_stream():
    """A training step's random numbers are each rank's own: rank 0 draws
    the one-process run's, rank 1 others (the same masks on other rows
    would be one stream repeated)."""
    from test_torch_gan import PHASE_CFG
    tcfg = training_config().merge(PHASE_CFG)
    params = txl.init_xl_params(txl.XLConfig.from_cfg(tcfg, V), seed=0)
    one = _own_streams(PHASE_CFG, params)
    ranks = pmesh.spawn(_streams_rank, WORLD, PHASE_CFG, params)
    for k, ref in one.items():
        assert torch.equal(ranks[0][k], ref), k
        assert ranks[1][k].shape == ref.shape
        assert not torch.equal(ranks[1][k], ref), k


def _close_moves(got, ref, lr):
    diff = (got - ref).abs()
    assert float((diff > 1e-3 * lr).float().mean()) < 1e-3
    assert float(diff.max()) <= 2 * lr


def _mesh_case(over, batches, keys, draws_of, steps, ppo=False):
    """JAX on a 2-device mesh, the port on one process (recording the JAX
    draws) and on 2 ranks; returns (JAX phases, its trainer, the
    one-process result, the ranks' results, the layouts, JAX's dis
    optimizer state after the dis update)."""
    from test_torch_bert import to_torch
    from test_torch_gan import _jax_cfg
    from transformer_gan_tpu.models import xl as jxl
    from transformer_gan_tpu.parallel import mesh as jmesh
    from transformer_gan_tpu.train import gan_loop as jloop

    jcfg = _jax_cfg(over)
    jxcfg = jxl.XLConfig.from_cfg(jcfg, V)
    jp = jxl.init_xl_params(jxcfg, seed=0, base_init=("normal", 0.1))
    jtr = types.SimpleNamespace(
        xcfg=jxcfg, vocab=list(range(V)),
        state=namedtuple("JState", "params")(jp), n_devices=WORLD,
        batch_size=8, multi_device=True, mesh=jmesh.make_mesh(WORLD),
        dis_iter=lambda: iter(batches))
    jph = jloop.GanPhases(jtr, jcfg)
    key_list = keys(jph)            # the JAX phases' keys, before they run
    params = to_torch(jp)
    critic = None
    for s in steps:
        if s == "dis":
            jph.dis_phase(0)
            jdis_mu = jph.dis_opt_state
            if ppo:      # the gen phases start from JAX's critic
                critic = topt.FlatLayout.of(to_torch(jph.dis_params)
                                            ).flatten(to_torch(jph.dis_params))
        else:
            jph.gen_phase(s)
    one, state = _port_phases(over, params, batches, 1)
    recs = [_Recorder(draws_of(k, jph)) for k in key_list]
    single = _run(one, state, iter(recs), steps, critic)
    ranks = pmesh.spawn(_gan_rank, WORLD, over, params, batches,
                        [r.out for r in recs], steps, critic)
    for key in ("dis_flat", "gen_flat", "clf_flat"):
        if key in single:
            assert all(torch.equal(r[key], ranks[0][key]) for r in ranks)
    layouts = {"dis": one.dis_layout, "gen": state.layout,
               "clf": one.disD_layout}
    return jph, jtr, single, ranks, layouts, jdis_mu


def _phase_keys(jph):
    import jax
    k1, r_dis = jax.random.split(jph.rng)
    _, r_gen = jax.random.split(k1)
    return list(jax.random.split(r_dis, 2)) + list(jax.random.split(r_gen, 2))


def _check_update(jph, jtr, single, rank, layouts, jdis_mu):
    from test_torch_bert import to_torch
    from test_torch_gan import _adam_mu
    for got, ref, lay in ((rank["dis_mu"], _adam_mu(jdis_mu), layouts["dis"]),
                          (rank["gen_mu"], _adam_mu(jph.gen_opt_state),
                           layouts["gen"])):
        np.testing.assert_allclose(
            got.numpy(), lay.flatten(to_torch(ref)).numpy(), rtol=2e-4,
            atol=1e-8)
    dis0 = rank["dis_flat"] - rank["dis_move"]
    gen0 = rank["gen_flat"] - rank["gen_move"]
    _close_moves(rank["dis_move"],
                 layouts["dis"].flatten(to_torch(jph.dis_params)) - dis0, LR)
    _close_moves(rank["gen_move"], layouts["gen"].flatten(
        to_torch(jtr.state.params)) - gen0, LR / WORLD)
    # the mesh rule against one process: the critic's move equal, the
    # generator's once scaled by the world size
    _close_moves(rank["dis_move"], single["dis_move"], LR)
    _close_moves(rank["gen_move"] * WORLD, single["gen_move"], LR)
    np.testing.assert_allclose(rank["stats"], single["stats"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["cnn", "spanbert"])
def test_gan_phases_match_jax_mesh(tmp_path, kind):
    from test_torch_gan import PHASE_CFG, JaxDraws
    from test_torch_gan_bert import JaxBertDraws, _bert_phase_cfg
    over = (PHASE_CFG if kind == "cnn"
            else _bert_phase_cfg(tmp_path, ["0"]))
    rng = np.random.RandomState(2)
    batches = [(rng.randint(2, V, (16, 8)), 128) for _ in range(2)]
    draws_of = ((lambda k, jph: JaxDraws(k, 2)) if kind == "cnn"
                else (lambda k, jph: JaxBertDraws(k, 2, jph.dis_cfg)))
    jph, jtr, single, ranks, layouts, jdis_mu = _mesh_case(
        over, batches, _phase_keys, draws_of, ("dis", 0))
    rank = ranks[0]
    _check_update(jph, jtr, single, rank, layouts, jdis_mu)
    np.testing.assert_allclose(rank["stats"], jph.pop_log_stats(),
                               rtol=1e-5)
    frozen = rank["frozen"]
    assert frozen.any() == (kind == "spanbert")
    assert not rank["dis_move"][frozen].any()
