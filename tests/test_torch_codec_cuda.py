"""``cli.batch_generate`` on the card (``gpu`` marker; skipped where CUDA is
absent): at the baseline model's full width (L 6, H 10, d 500, bf16,
seeded parameters), memory 4146 and a 50-token prefix, a short generation
primes through K1f and samples through K3, and each generated piece is
written as MIDI that the codec reads back. Run on a machine with an H100:
``python -m pytest tests/test_torch_codec_cuda.py -q``."""

import os

import numpy as np
import pytest
import torch

from transformer_gan_torch import _native
from transformer_gan_torch.cli import batch_generate as bcli
from transformer_gan_torch.config import training_config
from transformer_gan_torch.convert import save_params
from transformer_gan_torch.data.codec import PerformanceEventRepo
from transformer_gan_torch.models import xl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


def test_batch_generate_full_width_launches_k1f_and_k3(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = training_config(os.path.join(ROOT, "training_config",
                                       "experiment_baseline.yml"))
    model = tmp_path / "model"
    model.mkdir()
    (model / "config.yml").write_text(cfg.dump())
    save_params(str(model / "checkpoint_last.pt"),
                xl.init_xl_params(xl.XLConfig.from_cfg(cfg, 310), seed=0))
    prefix = str(tmp_path / "prefix.npy")
    np.save(prefix, np.random.RandomState(0).randint(2, 310, 80)
            .astype(np.int32))
    _native.reset_launches()
    runs = bcli.main(["--model_directory", str(model),
                      "--checkpoint_name", "checkpoint_last",
                      "--output_base", str(tmp_path / "gen"),
                      "--prefix", prefix, "--techniques", "topk,random",
                      "--generation_length", "96"])
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    for k in ("xl_attn_fwd_v2", "xl_attn_fwd_v2_tc", "generate_chunk",
              "generate_chunk_tc"):
        assert launches[k] > 0, (k, launches)
    assert [r["summary"]["tokens"] for r in runs] == [96, 96]
    repo = PerformanceEventRepo()
    for r in runs:
        assert len(r["midi"]) == 1
        repo.encode(r["midi"][0])
