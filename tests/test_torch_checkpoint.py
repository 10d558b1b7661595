"""The port's checkpoints, data pipeline and restart contract:
``checkpoint.manager`` (roundtrip, keep-last GC, atomic async publish, a
partial checkpoint ignored, bf16 and ``NamedTuple`` leaves), the
``SyntheticTokenPipeline`` against the reference's (batches BITWISE:
both draw from numpy's ``default_rng``), the straggler monitor, and
kill-and-resume of the port's ``Trainer`` on the CPU, bitwise within
the port (params and optimizer state)."""

import os

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_intra_op_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline  # noqa: E402,E501
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core.kahan import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import StragglerMonitor, Trainer  # noqa: E402


def _tiny_cfg():
    return t_reduced(t_get_config("qwen1.5-0.5b")).with_(
        num_layers=1, d_model=32, vocab_size=64)


def test_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.tensor(3.5)},
            "layers": [{"w": torch.ones(4, dtype=torch.bfloat16) / 3}] * 2,
            "step": torch.tensor(1)}
    for s in (1, 2, 3, 4):
        mgr.save(s, dict(tree, step=torch.tensor(s)))
    assert mgr.all_steps() == [3, 4]       # GC keeps the last 2
    out = mgr.restore(4, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["layers"][1]["w"].dtype == torch.bfloat16
    assert torch.equal(out["layers"][1]["w"], tree["layers"][1]["w"])
    assert int(out["step"]) == 4
    with pytest.raises(ValueError):
        mgr.restore(4, dict(tree, a=torch.zeros(3, 2)))
    with pytest.raises(KeyError):
        mgr.restore(4, dict(tree, extra=torch.zeros(1)))


def test_optimizer_state_roundtrip(tmp_path):
    """A NamedTuple state with None fields (no master copy) restores into
    its own structure, every leaf bitwise."""
    params = {"w": torch.randn(5, 3, generator=torch.Generator()
                               .manual_seed(0))}
    cfg = adamw.AdamWConfig(kahan=True)
    state = adamw.init(params, cfg)
    params, state = adamw.update({"w": torch.ones(5, 3)}, state, params,
                                 cfg)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": params, "opt": state})
    out = mgr.restore(1, {"params": params, "opt": state})
    assert isinstance(out["opt"], adamw.AdamWState)
    assert out["opt"].master is None
    want = tree_leaves({"params": params, "opt": state})
    assert len(want) == 1 + 4          # params, count, m, v, carry
    for a, b in zip(tree_leaves(out), want):
        assert torch.equal(a, b)


def test_async_save_publishes_atomically(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(10, {"w": torch.ones((128, 128))})
    mgr.wait()
    assert mgr.latest_step() == 10
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def test_partial_checkpoint_ignored(tmp_path):
    """A directory without a manifest (a crash mid-write) is never the
    latest."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_9")
    os.makedirs(tmp_path / ".tmp_step_11_1")
    assert mgr.latest_step() == 5


def test_kill_and_resume_bitexact(tmp_path):
    """6 steps with checkpoints every 2 against 4 steps, a 'crash', a
    restore into a fresh Trainer and 2 more: params and optimizer state
    bitwise equal (deterministic data + checkpointed state)."""
    cfg = _tiny_cfg()
    kw = dict(seq_len=16, global_batch=4, n_microbatches=2, ckpt_every=2,
              seed=3, device="cpu")
    t_full = Trainer(cfg, ckpt_dir=str(tmp_path / "full"), **kw)
    t_full.run(6, log_every=0)

    t_a = Trainer(cfg, ckpt_dir=str(tmp_path / "ab"), **kw)
    t_a.run(4, log_every=0)               # saves step_4, then "crashes"
    del t_a
    t_b = Trainer(cfg, ckpt_dir=str(tmp_path / "ab"), **kw)
    assert t_b.maybe_restore() and t_b.step == 4
    t_b.run(2, log_every=0)
    assert t_b.step == t_full.step == 6
    full = tree_leaves({"p": t_full.params, "o": t_full.opt_state})
    resumed = tree_leaves({"p": t_b.params, "o": t_b.opt_state})
    assert len(full) == len(resumed)
    for a, b in zip(full, resumed):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 5, 123])
def test_pipeline_bitwise_reference(step):
    cfg, tcfg = reduced(get_config("qwen1.5-0.5b")), _tiny_cfg().with_(
        vocab_size=256)
    want = RefPipeline(cfg, 16, 4, seed=7, num_hosts=2,
                       host_index=1).batch_for_step(step)
    got = SyntheticTokenPipeline(tcfg, 16, 4, seed=7, num_hosts=2,
                                 host_index=1).batch_for_step(step)
    assert set(got) == set(want) == {"tokens", "labels", "weights"}
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape == (2, 16)
        np.testing.assert_array_equal(got[k], w)


def test_pipeline_deterministic_and_skippable():
    cfg = _tiny_cfg()
    p1 = SyntheticTokenPipeline(cfg, 16, 4, seed=7)
    p2 = SyntheticTokenPipeline(cfg, 16, 4, seed=7)
    np.testing.assert_array_equal(p1.batch_for_step(123)["tokens"],
                                  p2.batch_for_step(123)["tokens"])
    it = p1.iterate(start_step=5)
    s, batch = next(it)
    assert s == 5
    np.testing.assert_array_equal(batch["tokens"],
                                  p2.batch_for_step(5)["tokens"])
    it.close()


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(alpha=0.5, threshold=3.0)
    for s in range(10):
        assert not mon.observe(s, 0.1)
    assert mon.observe(10, 1.0)            # 10x the EWMA -> straggler
    assert mon.flagged and mon.flagged[0][0] == 10
    assert mon.ewma < 0.2                  # the outlier stays out of it


def test_trainer_loss_decreases():
    t = Trainer(_tiny_cfg(), seq_len=16, global_batch=4, lr=5e-3, seed=0,
                device="cpu")
    out = t.run(25, log_every=0)
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert out["mean_loss"] == pytest.approx(np.mean(losses), rel=1e-6)
