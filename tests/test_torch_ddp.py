"""Data-parallel training of the port (``transformer_gan_torch.parallel``)
on the CPU: real gloo ranks in fresh processes, joined on a ``file://``
store (``parallel/mesh.spawn``; no TCP port, since the suite runs in
parallel workers), fp32 at tiny sizes.

* ``rank_rows`` and the batch / memory rows against the JAX package's
  placement rule (rank r holds rows [r b / N, (r + 1) b / N) of every
  micro-batch);
* the MLE step at 2 and 4 ranks against JAX ``make_mle_train_step`` on a 2-
  and a 4-device mesh over the same global batches (lr / N on both sides,
  dropout 0), with pads that differ between the ranks' rows: each rank
  divides its NLL sum by the global micro-batch's token count, as JAX
  does, where a mean of per-rank means would not match. The summed
  weighted loss within rtol 1e-5, the token counts exact, the grad norm
  within rtol 5e-4, the parameters and each rank's memory rows within atol
  2e-5 (the bounds of ``test_torch_train.test_four_step_trajectory_matches
  _jax``), the ranks' parameters bitwise equal;
* coordination as JAX ``tests/test_multihost.py`` checks it: the host
  all-reduce, a barrier around a rank-0 write, eval pieces sharded over
  the ranks summing to the split's token count;
* the training CLI on 2 ranks with ``--restart``: one run directory, one
  set of checkpoint files, a log per rank, the ranks' parameters bitwise
  equal after the steps and after the restore;
* ``dryrun.dryrun_multichip(2)``;
* the cases that must raise rather than fall back.

JAX is imported inside the tests only: the rank processes import this
module to find their functions."""

import glob
import os
import time

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import write_random_corpus
from transformer_gan_torch.config import PACKAGED_VOCAB, training_config
from transformer_gan_torch.models import xl as txl
from transformer_gan_torch.parallel import mesh as pmesh
from transformer_gan_torch.parallel import sharding as psh
from transformer_gan_torch.train import optim as topt
from transformer_gan_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(n_layer=2, n_head=2, d_model=16, d_inner=32, n_token=310,
            dropout=0.0, dropatt=0.0)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,groups", [(2, 1), (2, 2), (4, 2), (2, 3)])
def test_rank_rows_split_every_block(world, groups):
    x = np.arange(2 * groups * world * 3 * 5).reshape(2, groups * world * 3, 5)
    parts = [psh.rank_rows(x, r, world, axis=1, groups=groups)
             for r in range(world)]
    per = 3
    for r, p in enumerate(parts):
        want = np.concatenate([x[:, g * world * per + r * per:
                                 g * world * per + (r + 1) * per]
                               for g in range(groups)], axis=1)
        np.testing.assert_array_equal(p, want)
        t = psh.rank_rows(torch.from_numpy(x), r, world, axis=1,
                          groups=groups)
        assert t.is_contiguous() and torch.equal(t, torch.from_numpy(want))
    with pytest.raises(ValueError):
        psh.rank_rows(x[:, :-1], 0, world, axis=1, groups=groups)


def test_batch_rows_are_the_mesh_rows_of_every_micro_batch(monkeypatch):
    """``chunk_batch`` of a rank's batch gives the rank's rows of every
    global micro-batch: the rows JAX ``place_batch`` puts on device r of
    the ``[C, tgt, bsz_c]`` batch sharded on its last axis."""
    data = np.random.RandomState(0).randint(0, 310, (6, 16))
    C, N = 2, 4
    glob_c = tstep.chunk_batch(data, C)
    for r in range(N):
        monkeypatch.setattr(pmesh, "_MESH", pmesh.Mesh(rank=r, world=N))
        local = tstep.chunk_batch(psh.batch_rows(data, C), C)
        np.testing.assert_array_equal(local, glob_c[:, :, r * 2:(r + 1) * 2])
    mems = txl.XLMems(hids=torch.arange(2 * 2 * 3 * 8 * 4 * 5.0).reshape(
        2, 2, 3, 8, 4, 5), count=4)
    monkeypatch.setattr(pmesh, "_MESH", pmesh.Mesh(rank=1, world=2))
    part = psh.mems_rows(mems)
    assert torch.equal(part.hids, mems.hids[:, :, :, 4:]) and part.count == 4


# ---------------------------------------------------------------------------
# The MLE step against the JAX mesh
# ---------------------------------------------------------------------------

C, TGT, MEM = 2, 8, 12


def _mle_batches(bsz: int):
    rng = np.random.RandomState(5)
    out = []
    for k in range(2):
        data = rng.randint(2, 310, (TGT, bsz))
        target = rng.randint(2, 310, (TGT, bsz))
        # pads on rank 0's rows only: micro-batch 0 (rows 0..bsz/C) row 0,
        # micro-batch 1 its first row
        target[-5 + k:, 0] = 1
        target[-2:, bsz // C] = 1
        reset = rng.rand(bsz) < 0.3
        out.append((data, target, reset))
    return out


def _mle_rank(mesh, params, batches, lr):
    tcfg = txl.XLConfig(cache_kv=True, **BASE)
    opt = topt.FusedOptimizer(
        "adam", lr / mesh.world,
        topt.make_schedule("inv_sqrt", lr, 100, 1e-4, 2), 0.25,
        layout=topt.FlatLayout.of(params))
    bsz = batches[0][0].shape[1] // mesh.world
    state = tstep.init_train_state(params, opt, tcfg, C, MEM, bsz // C, 1111)
    fn = tstep.make_mle_train_step(tcfg, opt, C, pad_id=1)
    out = []
    for data, target, reset in batches:
        d, t = (psh.batch_rows(x, C) for x in (data, target))
        r = psh.batch_rows(reset, C, axis=0)
        args = (tstep.chunk_batch(d, C), tstep.chunk_batch(t, C),
                tstep.chunk_rows(r, C))
        state, met = fn(state, *map(torch.from_numpy, args))
        out.append({"metrics": {k: float(v) for k, v in met.items()},
                    "flat": state.flat.detach().clone(),
                    "mems": [m.hids.clone() for m in state.mems],
                    "counts": [m.count for m in state.mems]})
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_mle_step_matches_jax_mesh(world):
    import jax
    import jax.numpy as jnp
    from transformer_gan_torch import convert
    from transformer_gan_tpu.models import xl as jxl
    from transformer_gan_tpu.parallel import mesh as jmesh
    from transformer_gan_tpu.parallel import sharding as jsh
    from transformer_gan_tpu.train import optim as jopt
    from transformer_gan_tpu.train import step as jstep

    lr, bsz = 2e-3, 4 * world
    jcfg = jxl.XLConfig(cache_kv=True, use_pallas=False, **BASE)
    jp = jxl.init_xl_params(jcfg, seed=0, base_init=("normal", 0.1))
    batches = _mle_batches(bsz)
    # the trap's precondition: a micro-batch whose ranks hold different
    # pad counts
    pads = [(psh.rank_rows(batches[0][1], r, world, axis=1, groups=C)
             [:, :bsz // world // C] == 1).sum() for r in range(world)]
    assert len(set(pads)) > 1, pads
    ranks = pmesh.spawn(_mle_rank, world, convert.params_from_jax(jp),
                        batches, lr)

    mesh = jmesh.make_mesh(world)
    jo = jopt.make_optimizer(
        "adam", lr / world, jopt.make_schedule("inv_sqrt", lr, 100, 1e-4, 2),
        0.25)
    jstate = jsh.place_train_state(
        jstep.init_train_state(jp, jo, jcfg, C, MEM, bsz // C, 1111), mesh)
    jfn = jstep.make_mle_train_step(jcfg, jo, C, pad_id=1, donate=False)
    for k, (data, target, reset) in enumerate(batches):
        args = (tstep.chunk_batch(data, C), tstep.chunk_batch(target, C),
                tstep.chunk_rows(reset, C))
        with mesh:
            jstate, jmet = jfn(jstate, *jsh.place_batch(
                mesh, *map(jnp.asarray, args)))
        mets = [r[k]["metrics"] for r in ranks]
        np.testing.assert_allclose(sum(m["loss_weighted"] for m in mets),
                                   float(jmet["loss_weighted"]), rtol=1e-5)
        assert sum(m["tokens"] for m in mets) == int(jmet["tokens"])
        for m in mets:
            np.testing.assert_allclose(m["grad_norm"],
                                       float(jmet["grad_norm"]), rtol=5e-4)
        flat0 = ranks[0][k]["flat"]
        assert all(torch.equal(r[k]["flat"], flat0) for r in ranks[1:])
        layout = topt.FlatLayout.of(convert.params_from_jax(jp))
        ref = layout.flatten(convert.params_from_jax(jstate.params))
        np.testing.assert_allclose(flat0.numpy(), ref.numpy(), rtol=0,
                                   atol=2e-5, err_msg=f"step {k}")
        jh = torch.from_numpy(np.asarray(jax.device_get(jstate.mems.hids)))
        for r, res in enumerate(ranks):
            for c in range(C):
                want = psh.rank_rows(jh[c], r, world, axis=3)
                np.testing.assert_allclose(res[k]["mems"][c].numpy(),
                                           want.numpy(), rtol=0, atol=2e-5)
                assert res[k]["counts"][c] == int(jstate.mems.count[c])


# ---------------------------------------------------------------------------
# Coordination (JAX tests/test_multihost.py)
# ---------------------------------------------------------------------------

def _coord_rank(mesh, out_dir, data_dir):
    from transformer_gan_torch.data.dataset import MusicDataset
    n = mesh.world
    local = np.asarray([mesh.rank + 1.0, 10.0 * (mesh.rank + 1)])
    reduced = pmesh.host_allreduce_sum(local)
    np.testing.assert_allclose(reduced, [n * (n + 1) / 2,
                                         10 * n * (n + 1) / 2])
    marker = os.path.join(out_dir, "rank0_wrote")
    if mesh.rank == 0:
        time.sleep(0.3)
        open(marker, "w").write("x")
    pmesh.sync_global_devices("test_barrier")
    assert os.path.exists(marker), "barrier released before rank 0 wrote"
    ds = MusicDataset(data_dir, training_config())
    it = ds.eval_iterator(2, 16, split="valid", local_rank=mesh.rank,
                          world_size=n)
    tok = sum(b[3] for b in it())
    total = pmesh.host_allreduce_sum([tok])
    return {"tok": tok, "total": int(total[0]),
            "want": int((ds.valid_seq_length - 1).sum())}


def test_coordination_on_two_ranks(tmp_path):
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=7, train_len=120,
                        n_eval=7, eval_len=120, seed=3)
    res = pmesh.spawn(_coord_rank, 2, str(tmp_path), data)
    assert res[0]["total"] == res[0]["want"] == res[1]["total"]
    assert 0 < res[0]["tok"] < res[0]["want"]


# ---------------------------------------------------------------------------
# The CLI on two ranks, with a restart
# ---------------------------------------------------------------------------

def _cli_cfg(tmp_path, **train):
    with open(os.path.join(ROOT, "training_config",
                           "experiment_baseline.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"].update(num_layers=2, num_heads=2, units=16, inner_size=32,
                        dropout=0.1, attention_dropout=0.1)
    cfg["TRAIN"].update({"batch_size": 4, "batch_chunk": 2, "max_step": 4,
                         "log_interval": 2, "eval_interval": 2,
                         "mem_length": 12, "tgt_length": 8, "warmup_step": 2,
                         **train})
    cfg["EVALUATE"].update(batch_size=2, mem_length=16, tgt_length=8)
    path = tmp_path / f"cfg{len(train)}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cli_rank(mesh, argv, restore_only):
    from transformer_gan_torch.cli import train as tcli
    from transformer_gan_torch.train.loop import Trainer
    if restore_only:
        args = tcli.parse_args(argv)
        tr = Trainer(training_config(args.cfg), args.data_dir, args.work_dir,
                     restart=True, device=args.device)
    else:
        tr = tcli.main(argv)
    return {"flat": tr.state.flat.detach().clone(), "step": tr.train_step_num,
            "work_dir": tr.work_dir, "mu": tr.state.opt_state.mu.clone(),
            "count": tr.state.opt_state.count}


def test_cli_two_ranks_restart(tmp_path):
    from transformer_gan_torch.train import checkpoint as ckpt
    data = str(tmp_path / "data")
    write_random_corpus(data, PACKAGED_VOCAB, n_train=12, train_len=60,
                        n_eval=3, eval_len=40, seed=0)
    argv = ["--data_dir", data, "--cfg", _cli_cfg(tmp_path), "--work_dir",
            str(tmp_path / "work"), "--device", "cpu"]
    first = pmesh.spawn(_cli_rank, 2, argv, False)
    run = first[0]["work_dir"]
    assert first[1]["work_dir"] == run and first[0]["step"] == 4
    assert os.listdir(tmp_path / "work") == [os.path.basename(run)]
    assert torch.equal(first[0]["flat"], first[1]["flat"])
    assert torch.equal(first[0]["mu"], first[1]["mu"])
    names = sorted(os.listdir(run))
    assert names == sorted(
        ["config.yml", "train_rank0.log", "train_rank1.log"]
        + [f"checkpoint_{n}{s}" for n in ("last", "best")
           for s in (".pt", ".opt.pt", ".json")]), names
    with open(os.path.join(run, "train_rank0.log")) as f:
        log = f.read()
    assert "Train Step 4/4" in log and "| End of training | test nll" in log

    restart = ["--data_dir", data, "--cfg", _cli_cfg(tmp_path, max_step=6),
               "--work_dir", run, "--restart", "--device", "cpu"]
    restored = pmesh.spawn(_cli_rank, 2, restart, True)
    params, opt, meta = ckpt.load_checkpoint(run, "checkpoint_last")
    saved = topt.FlatLayout.of(params).flatten(params)
    for r in restored:
        assert r["step"] == 4 == meta["train_step"] and r["count"] == 4
        assert torch.equal(r["flat"], saved) and torch.equal(r["mu"], opt.mu)
    resumed = pmesh.spawn(_cli_rank, 2, restart, False)
    assert [r["step"] for r in resumed] == [6, 6]
    assert torch.equal(resumed[0]["flat"], resumed[1]["flat"])
    assert resumed[0]["count"] == 6
    assert not glob.glob(os.path.join(run, "*.tmp"))
    assert len(glob.glob(os.path.join(run, "checkpoint_last*"))) == 3


def test_dryrun_multichip_two_ranks(capsys):
    from transformer_gan_torch.dryrun import dryrun_multichip
    ranks = dryrun_multichip(2, "cpu")
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip(2): ") == 3
    assert "gan ok" in out and "spanbert ok" in out
    assert ranks[0]["gan"]["steps"] == 2


# ---------------------------------------------------------------------------
# No fallback
# ---------------------------------------------------------------------------

def test_mesh_shape_must_match_the_world(monkeypatch):
    cfg = training_config()
    two = pmesh.Mesh(rank=0, world=2, backend="gloo")
    monkeypatch.setattr(pmesh, "_MESH", two)
    assert pmesh.make_mesh_from_cfg(cfg) is two
    cfg.TPU.mesh_shape = [2]
    assert pmesh.make_mesh_from_cfg(cfg) is two
    cfg.TPU.mesh_shape = [4]
    with pytest.raises(ValueError, match="mesh_shape"):
        pmesh.make_mesh_from_cfg(cfg)
    cfg.TPU.mesh_shape, cfg.TPU.mesh_axes = [1, 2], ["data", "model"]
    with pytest.raises(NotImplementedError, match="only the 1-D"):
        pmesh.make_mesh_from_cfg(cfg)


def test_no_fallback(monkeypatch):
    """A world size without a reachable rendezvous, NCCL without a card and
    a card other than the rank's all raise; nothing joins a group."""
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pmesh.initialize_distributed("cpu")
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
        pmesh.initialize_distributed()
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
        pmesh.initialize_distributed("cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="was given card 0"):
        pmesh.initialize_distributed("cuda:1")
    assert not pmesh.current().distributed
    assert not torch.distributed.is_initialized()
