"""The port's training driver (``launch/train.py``), its quickstart
(``launch/quickstart.py``) and the synthetic data they read, against the
reference (``repro.launch.train``, ``examples/quickstart.py``,
``repro.data``): the same tokens and labels, and the same losses from
carried weights (1e-5 relative, f32). Reduced configs on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint.npz import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data import make_batch as ref_make_batch
from repro.launch import train as ref_train
from repro.models import init_params as ref_init_params
from repro.train import TrainConfig as RefTrainConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import make_jit_train_step
from repro.train import wsd_schedule as ref_wsd
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.launch import quickstart, train
from repro_torch.train import TrainConfig, wsd_schedule
from _torch_threads import one_torch_thread  # noqa: F401


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(get_config(name).reduced(), dtype=dtype),
            dataclasses.replace(ref_get_config(name).reduced(), dtype=dtype))


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    if "vision_embeds" in want:
        np.testing.assert_array_equal(got["vision_embeds"].numpy(),
                                      np.asarray(want["vision_embeds"]))


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("seed,step", [(0, 0), (1, 5), (101, 2)])
def test_make_batch_equals_the_reference(name, structured, seed, step):
    cfg, ref_cfg = _cfgs(name)
    got = make_batch(cfg, 3, 24, step=step, seed=seed, structured=structured,
                     device="cpu")
    want = ref_make_batch(ref_cfg, 3, 24, step=step, seed=seed,
                          structured=structured)
    _same_batch(got, want)
    if structured:      # affine sequences: each token follows the last
        a, b = 5 * (seed % 97) + 3, (seed % 1009) + 1
        toks = got["tokens"]
        assert torch.equal(toks[:, 1:], (a * toks[:, :-1] + b) % cfg.vocab)


def test_synthetic_lm_equals_the_reference():
    cfg, ref_cfg = _cfgs("qwen2-vl-2b")
    port = SyntheticLM(cfg, 2, 16, seed=3, structured=True, device="cpu")
    ref = RefSyntheticLM(ref_cfg, 2, 16, seed=3, structured=True)
    batches = [next(port) for _ in range(3)]
    for got in batches:
        _same_batch(got, next(ref))
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])


def _ref_loop(ref_cfg, params, *, steps, batch, seq, accum, lr,
              structured=False):
    """The reference driver's loop (``repro.launch.train.main``)."""
    sched = ref_wsd(peak_lr=lr, warmup_steps=max(steps // 20, 1),
                    stable_steps=int(steps * 0.7),
                    decay_steps=max(int(steps * 0.25), 1))
    step = make_jit_train_step(
        ref_cfg, RefTrainConfig(accum_steps=accum, schedule=sched))
    opt = ref_adamw_init(params)
    losses = []
    data = RefSyntheticLM(ref_cfg, batch, seq, structured=structured)
    for _, b in zip(range(steps), data):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("name,accum", [("minicpm-2b", 2),
                                        ("qwen2-vl-2b", 1)])
def test_driver_loop_matches_reference_losses(name, accum):
    cfg, ref_cfg = _cfgs(name)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(ref_flatten(ref_params), device="cpu")
    steps, lr = 3, 3e-3
    want = _ref_loop(ref_cfg, ref_params, steps=steps, batch=4, seq=32,
                     accum=accum, lr=lr)
    sched = wsd_schedule(peak_lr=lr, warmup_steps=max(steps // 20, 1),
                         stable_steps=int(steps * 0.7),
                         decay_steps=max(int(steps * 0.25), 1))
    _, opt, got = train.train_loop(
        cfg, params, SyntheticLM(cfg, 4, 32, device="cpu"),
        TrainConfig(accum_steps=accum, schedule=sched), steps)
    assert opt.step == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_main_matches_the_reference_main(tmp_path, monkeypatch):
    """Both drivers' ``main`` with the same flags from the same weights
    (the reference's PRNGKey(0) init, carried into the port's): the same
    final loss, and checkpoints the reference can restore."""
    cfg, ref_cfg = _cfgs("minicpm-2b")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    flat = ref_flatten(ref_params)
    monkeypatch.setattr(
        train, "init_params",
        lambda c, seed, device: params_from_numpy(flat, device=device))
    args = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
            "--accum-steps", "2", "--log-every", "1"]
    path = str(tmp_path / "port.npz")
    got = train.main(args + ["--device", "cpu", "--checkpoint", path])
    want = ref_train.main(args)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, opt, step = ref_restore(path, params_like=ref_params,
                               opt_like=ref_adamw_init(ref_params))
    assert step == 3 and int(opt.step) == 3


def test_argparser_defaults_and_no_distributed():
    """The reference's flags and defaults, ``--distributed`` off unless
    given (it is accepted since the sharding slice)."""
    port = vars(train.build_argparser().parse_args([]))
    ref = vars(ref_train.build_argparser().parse_args([]))
    assert port.pop("device") is None
    assert port == ref and port["distributed"] is False
    assert train.build_argparser().parse_args(["--distributed"]).distributed


def test_quickstart_loss_falls_on_a_tiny_config():
    cfg, _ = _cfgs("minicpm-2b")
    losses = quickstart.run(cfg, steps=30, batch=4, seq=32, accum_steps=2,
                            device="cpu")
    assert len(losses) == 30 and all(np.isfinite(losses))
    first, last = quickstart.check_falls(losses)
    assert last < first


def test_quickstart_config_is_the_reference_shrink():
    cfg = quickstart.shrunk_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype) == (
        8, 768, 12, 12, 64, 2048, 32768, "float32")
