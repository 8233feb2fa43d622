"""The EgoMCQ inference slice of egovlpv2_torch against egovlpv2_tpu on the
CPU, and the port's `egomcq` command."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlpv2_tpu.core.config import replace
from egovlpv2_tpu.models.egovlp import EgoVLPv2 as JaxEgoVLPv2
from egovlpv2_tpu.tasks import egomcq as jtask
from egovlpv2_torch import cli
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.tasks import egomcq as ttask
from torch_parity import TINY, TINY_OVERRIDES, load_flax, perturb

torch.set_num_threads(2)


def _batches():
    out = []
    for i in range(2):
        rs = np.random.RandomState(10 + i)
        ids = rs.randint(3, 120, (2, 6)).astype(np.int32)
        ids[:, 0] = 0
        ids[0, 4:] = 1  # padding in the first item
        out.append({
            "video5": rs.randn(2, 5, 2, 32, 32, 3).astype(np.float32),
            "ids": ids,
            "mask": (ids != 1).astype(np.int32),
            "answer": rs.randint(0, 5, 2),
            "type": np.array([1, 2]),
        })
    return out


def test_egomcq_step_and_metrics_match_jax():
    cfg = replace(TINY, attn_impl="xla")
    jmodel = JaxEgoVLPv2(cfg)
    v = cfg.video
    params = jmodel.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, v.num_frames, v.img_size, v.img_size, 3)),
        jnp.zeros((1, 6), jnp.int32), jnp.ones((1, 6), jnp.int32),
        method=jmodel.init_all)["params"]
    params = perturb(params, seed=1)
    jstep = jtask.make_egomcq_eval_step(jmodel)

    tmodel = load_flax(EgoVLPv2(cfg), params)
    tstep = ttask.make_egomcq_eval_step(tmodel)

    for batch in _batches():
        ref = jstep(params, batch["video5"], batch["ids"], batch["mask"])
        got = tstep(batch["video5"], batch["ids"], batch["mask"])
        for key in ("vtc", "vtm"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    ref_metrics = jtask.evaluate_egomcq(jstep, params, _batches())
    got_metrics = ttask.evaluate_egomcq(tstep, _batches())
    assert got_metrics == ref_metrics


def test_cli_egomcq_runs_on_cpu():
    res = cli.main(["egomcq", "--device", "cpu", "--batch_size", "2",
                    "--val_batches", "2", "--set", *TINY_OVERRIDES])
    assert set(res["scores"]) == {"vtc", "vtm"}
    for scores in res["scores"].values():
        assert scores.shape == (4, 5) and np.isfinite(scores).all()
    assert len(res["step_seconds"]) == 2 and res["clips_per_step"] == 10
    assert {k.split("/")[0] for k in res["metrics"]} == {"vtc", "vtm",
                                                          "ensemble"}
    assert all(0.0 <= v <= 100.0 for v in res["metrics"].values())


def test_cli_refuses_what_it_cannot_do(tmp_path):
    # a directory is read as a training run's checkpoints, and this one
    # holds none; a .pth file imports
    with pytest.raises(FileNotFoundError, match="no checkpoint found under"):
        cli.main(["egomcq", "--device", "cpu", "--ckpt", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("the CUDA refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["egomcq", "--device", "cuda"])
