"""Checkpoint/resume: a restored engine continues bit-identically."""

import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.train.engine import Engine


def _cfg():
    return CFConfig(
        emb_dim=8,
        num_negs=4,
        max_his=6,
        l_r=0.05,
        batch_size=128,
        milestones=[10],
        seed=5,
    )


def test_save_restore_resumes_identically(tmp_path):
    from heat_cf.checkpoint import CheckpointManager

    train, test = synthetic_click_dataset(
        num_users=60, num_items=120, clicks_per_user=15, max_his=6, seed=2
    )

    # Run 1: two epochs, checkpoint after the first.
    e1 = Engine(_cfg(), train, test)
    e1.train_one_epoch()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(e1)
    loss_full = e1.train_one_epoch()
    mgr.close()

    # Run 2: fresh engine, restore, re-run epoch 2.
    e2 = Engine(_cfg(), train, test)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr2.restore_latest(e2) == 1
    assert e2.epoch == 1
    loss_resumed = e2.train_one_epoch()
    mgr2.close()

    np.testing.assert_allclose(loss_resumed, loss_full, rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(e1.state.user_emb), np.asarray(e2.state.user_emb)
    )
    np.testing.assert_array_equal(
        np.asarray(e1.state.item_emb), np.asarray(e2.state.item_emb)
    )


def test_save_restore_with_sharded_state(tmp_path):
    """Checkpoint a mesh-sharded state and restore it onto the mesh."""
    import jax

    from heat_cf.checkpoint import CheckpointManager
    from heat_cf.parallel.mesh import make_mesh

    train, test = synthetic_click_dataset(
        num_users=64, num_items=128, clicks_per_user=15, max_his=6, seed=4
    )
    mesh = make_mesh(2, 4, jax.devices()[:8])
    e1 = Engine(_cfg(), train, test, mesh=mesh)
    e1.train_one_epoch()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(e1)
    loss_full = e1.train_one_epoch()
    mgr.close()

    e2 = Engine(_cfg(), train, test, mesh=mesh)
    mgr2 = CheckpointManager(str(tmp_path / "ck"))
    assert mgr2.restore_latest(e2) == 1
    loss_resumed = e2.train_one_epoch()
    mgr2.close()
    np.testing.assert_allclose(loss_resumed, loss_full, rtol=1e-6)
    assert "data" in str(e2.state.user_emb.sharding)
