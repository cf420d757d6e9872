"""Embedding export: portable f32 .npz, sharded-state and bf16 safe."""

import numpy as np

from heat_cf.config import CFConfig
from heat_cf.data.synthetic import synthetic_click_dataset
from heat_cf.export import export_embeddings, load_embeddings
from heat_cf.train.engine import Engine


def test_export_roundtrip(tmp_path):
    train, test = synthetic_click_dataset(
        num_users=40, num_items=100, clicks_per_user=10, max_his=6, seed=2
    )
    cfg = CFConfig(
        emb_dim=8, num_negs=4, max_his=6, l_r=0.05, batch_size=64,
        param_dtype="bfloat16",
    )
    eng = Engine(cfg, train, test)
    eng.train_one_epoch()
    p = str(tmp_path / "emb.npz")
    export_embeddings(eng.state, p, cfg=cfg)
    back = load_embeddings(p)
    assert back["user_emb"].dtype == np.float32
    assert back["user_emb"].shape == (40, 8)
    assert back["item_emb"].shape == (100, 8)
    assert back["w0"].shape == (8, 8)
    np.testing.assert_allclose(
        back["user_emb"], np.asarray(eng.state.user_emb, np.float32)
    )
    np.testing.assert_allclose(float(back["meta_gamma"]), cfg.gamma, rtol=1e-6)


def test_export_sharded_state(tmp_path):
    import jax

    from heat_cf.parallel.mesh import default_mesh_shape, make_mesh

    train, _ = synthetic_click_dataset(
        num_users=64, num_items=128, clicks_per_user=10, max_his=6, seed=3
    )
    n = min(8, len(jax.devices()))
    mesh = make_mesh(*default_mesh_shape(n), jax.devices()[:n])
    cfg = CFConfig(
        emb_dim=8, num_negs=4, max_his=6, l_r=0.05, batch_size=64,
        aggregator="self_attention",
    )
    eng = Engine(cfg, train, mesh=mesh)
    eng.train_one_epoch()
    p = str(tmp_path / "emb.npz")
    export_embeddings(eng.state, p, cfg=cfg)
    back = load_embeddings(p)
    assert back["user_emb"].shape == (64, 8)
    assert "attn_q" in back
